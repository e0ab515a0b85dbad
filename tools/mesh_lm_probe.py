"""``chip_smoke.py``'s 16b, 16f, 16g and 16h alone: phi3.5-moe at full
width and 2 layers trained on four gloo ranks at (2, 2) on one card with
AdamW (16b) and Adafactor (16f), and served through ``launch/serve.py
--model-axis 2`` (16g); mamba2-2.7b and zamba2-1.2b served at full depth
and trained cut in depth (16h); each against one process under a
shape-only (2, 2) mesh, with chip_smoke's own checks and limits.

    python3 tools/mesh_lm_probe.py            # 16b, 16f, 16g and 16h
    python3 tools/mesh_lm_probe.py 16h        # some of them
    python3 tools/mesh_lm_probe.py tie        # 16h's near-tie, alone

Needs one CUDA card (~3 minutes for 16b-16g).  Prints 16b's losses,
gradient norms, gaps and gathered-weight gaps per rank and step, then the
other phases' check lines; exits non-zero if a check fails.  ``tie``
serves mamba2-2.7b at full depth in one process twice, the whole batch
at once and each data rank's rows in turn (``chip_smoke.serve_by_rows``),
and prints, for each row whose tokens differ, the first such step, each
run's top-2 logit margin there and the runs' largest logit difference.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("16b", "16f", "16g", "16h")


def near_tie(CS, arch: str = "mamba2-2.7b") -> None:
    """:func:`chip_smoke.serve_by_rows` of ``arch`` with the whole batch
    at once against each data rank's rows in turn, row by row."""
    rows_t, rows_l, rows_ms = CS.serve_by_rows(arch)
    whole_t, whole_l, whole_ms = CS.serve_by_rows(
        arch, rows=CS.TP_SERVE["batch"])
    print(f"tie {arch}: decode step ms, the whole batch "
          f"{[round(x, 1) for x in whole_ms]}; by rows "
          f"{[round(x, 1) for x in rows_ms]}")
    for i in range(whole_t.shape[0]):
        margins = [float(m[0] - m[1]) for m in whole_l[i].topk(2).values]
        off = (whole_t[i] != rows_t[i]).nonzero()
        if not len(off):
            print(f"tie {arch} row {i}: tokens equal; smallest top-2 "
                  f"margin {min(margins):.6g}")
            continue
        s = int(off[0])
        a, b = whole_l[i, s].topk(2), rows_l[i, s].topk(2)
        gap_a = float(a.values[0] - a.values[1])
        gap_b = float(b.values[0] - b.values[1])
        print(f"tie {arch} row {i}: tokens part at step {s} (the whole "
              f"batch {a.indices.tolist()}, by rows {b.indices.tolist()}, "
              f"top two ids); top-2 logit margin {gap_a:.6g} (the whole "
              f"batch), {gap_b:.6g} "
              f"(by rows); largest logit difference at that step "
              f"{float((whole_l[i, s] - rows_l[i, s]).abs().max()):.6g}")


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as CS
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import spmd
    phases = tuple(sys.argv[1:] if argv is None else argv) or PHASES
    if not set(phases) <= set(PHASES) | {"tie"}:
        print(f"mesh_lm_probe: phases are {PHASES} and tie, got {phases}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("mesh_lm_probe: no CUDA device is visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(CS.phase_device())
    if "tie" in phases:
        near_tie(CS)
        phases = tuple(p for p in phases if p != "tie")
        if not phases:
            return 0
    CS.phase_build()
    cfg = dataclasses.replace(get_config(CS.LM_ARCH), n_layers=CS.TRAIN_LAYERS)
    d = CS.MESH_LM_DIR
    os.makedirs(d, exist_ok=True)
    single = CS.phase_mesh_single(cfg) if {"16b", "16f"} & set(phases) \
        else None
    single_af = (CS.phase_mesh_single_adafactor(cfg) if "16f" in phases
                 else None)
    single_tp = CS.phase_mesh_single_serve() if "16g" in phases else None
    single_ssm = CS.phase_mesh_single_ssm() if "16h" in phases else None
    full, af = os.path.join(d, "16b"), os.path.join(d, "16f")
    ext = ["--model-axis", "2", "--device", "cuda:0", "--backend", "gloo"]
    jobs = []
    if "16b" in phases:
        jobs.append(dict(kind="train-full", out=full,
                         argv=CS.mesh_lm_argv(CS.MESH_LM_STEPS, ext)))
    if "16f" in phases:
        jobs.append(dict(kind="train-adafactor", out=af,
                         argv=CS.mesh_lm_argv(CS.MESH_LM_STEPS, ext)))
    if "16g" in phases:
        jobs.append(dict(kind="serve-tp", out=os.path.join(d, "16g"),
                         argv=CS.tp_serve_argv(ext)))
    if "16h" in phases:
        jobs += CS.ssm_rank_jobs(d)
    path = os.path.join(d, "probe-jobs.json")
    with open(path, "w") as f:
        json.dump(jobs, f)
    spmd.launch([os.path.join(ROOT, "chip_smoke.py"), "--mesh-rank", path],
                4, os.path.join(d, "probe-ranks"),
                deadline_s=CS.MESH_RANK_DEADLINE_S,
                env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    failures = []
    if "16b" in phases:
        ranks = []
        for k in range(4):
            with open(f"{full}-rank{k}.json") as f:
                ranks.append(json.load(f))
        gaps = CS.step_gaps(ranks[0], single)
        updates = CS.weight_gaps(torch.load(f"{full}-leaves.pt"),
                                 single["leaves"], single["init"])
        for k, r in enumerate(ranks):
            print(f"16b rank {k}: step ms {r['step_ms']}, bytes a step "
                  f"{r['coll_bytes_per_step']:.0f} {r['coll_counts']}, peak "
                  f"{r['peak_gib']:.2f} GiB")
        print(f"16b losses {ranks[0]['losses']} against {single['losses']}; "
              f"gradient norms {ranks[0]['grad_norms']} against "
              f"{single['grad_norms']}; gaps {gaps} (limits "
              f"{CS.MESH_LM_REL_TOL}); weights {updates} (limit "
              f"{CS.MESH_LM_UPDATE_TOL})")
        if any(gaps[k] > CS.MESH_LM_REL_TOL[k] for k in gaps) or max(
                u for u, _ in updates.values()) > CS.MESH_LM_UPDATE_TOL:
            failures.append("16b")
    checks = {
        "16f": lambda: CS.check_mesh_adafactor(cfg, single_af,
                                               single["init"], af),
        "16g": lambda: CS.check_mesh_serve(cfg, single_tp,
                                           os.path.join(d, "16g")),
        "16h": lambda: print(json.dumps({"16h": CS.check_mesh_ssm(
            single_ssm, d)})),
    }
    for name, check in checks.items():
        if name not in phases:
            continue
        try:
            check()
        except AssertionError as exc:
            print(f"{name} failed: {exc}")
            failures.append(name)
    print(f"probe took {time.perf_counter() - t0:.1f} s; failed: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
