"""``chip_smoke.py``'s 16b, 16f and 16g alone: phi3.5-moe at full width and
2 layers trained on four gloo ranks at (2, 2) on one card with AdamW (16b)
and Adafactor (16f), and served through ``launch/serve.py --model-axis 2``
(16g), each against one process under a shape-only (2, 2) mesh, with
chip_smoke's own checks and limits.

    python3 tools/mesh_lm_probe.py

Needs one CUDA card (~3 minutes).  Prints 16b's losses, gradient norms,
gaps and gathered-weight gaps per rank and step, then 16f's and 16g's
check lines; exits non-zero if a check fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as CS
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import spmd
    if not torch.cuda.is_available():
        print("mesh_lm_probe: no CUDA device is visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(CS.phase_device())
    CS.phase_build()
    cfg = dataclasses.replace(get_config(CS.LM_ARCH), n_layers=CS.TRAIN_LAYERS)
    d = CS.MESH_LM_DIR
    os.makedirs(d, exist_ok=True)
    single = CS.phase_mesh_single(cfg)
    single_af = CS.phase_mesh_single_adafactor(cfg)
    single_tp = CS.phase_mesh_single_serve()
    full, af = os.path.join(d, "16b"), os.path.join(d, "16f")
    ext = ["--model-axis", "2", "--device", "cuda:0", "--backend", "gloo"]
    jobs = [dict(kind="train-full", out=full,
                 argv=CS.mesh_lm_argv(CS.MESH_LM_STEPS, ext)),
            dict(kind="train-adafactor", out=af,
                 argv=CS.mesh_lm_argv(CS.MESH_LM_STEPS, ext)),
            dict(kind="serve-tp", out=os.path.join(d, "16g"),
                 argv=CS.tp_serve_argv(ext))]
    path = os.path.join(d, "probe-jobs.json")
    with open(path, "w") as f:
        json.dump(jobs, f)
    spmd.launch([os.path.join(ROOT, "chip_smoke.py"), "--mesh-rank", path],
                4, os.path.join(d, "probe-ranks"),
                deadline_s=CS.MESH_RANK_DEADLINE_S,
                env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    failures = []
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
    for name, check in (
            ("16f", lambda: CS.check_mesh_adafactor(cfg, single_af,
                                                    single["init"], af)),
            ("16g", lambda: CS.check_mesh_serve(cfg, single_tp,
                                                os.path.join(d, "16g")))):
        try:
            check()
        except AssertionError as exc:
            print(f"{name} failed: {exc}")
            failures.append(name)
    print(f"probe took {time.perf_counter() - t0:.1f} s; failed: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
