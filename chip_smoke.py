#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage, from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result line:

  1. device  — a CUDA card is required; prints its name and power limit.
  2. build   — compiles every kernel under src/repro_torch/kernels/csrc
               with nvcc (one process per source, all at once).
  3. kernels — each kernel against its plain PyTorch version on the same
               inputs, at the main path's operands and at two small ragged
               shapes (an empty row or row block, a row longer than one
               slot tile, a run that spans several tiles and three or more
               F-COO chunks, a dictionary larger than shared memory), in
               fp32 and bf16 storage, a second launch of each bit-identical
               to the first, and B5 and B6 (which write y = M w and
               w = M^T y) also against the TPU kernels' partials folded by
               the seg_rows combine; an empty
               F-COO Phi, which launches nothing; plus the kernel,
               kernel-sell and kernel-fcoo executors against the dense
               oracle on a small problem.
  4. main    — the single-subject solve at full width (STN96: Ntheta = 96,
               a 64^3 voxel grid, 50,000 fibers) through LifeEngine with
               the ``kernel`` executor and a compaction rebuild; the
               kernels' launch counts, the losses, and the weights against
               the ``opt`` executor on the same card.
  5. formats — the same solve with ``format="sell"`` (kernels B3/B4) and
               ``format="fcoo"`` (B5/B6), each with its launch counts,
               losses, peak memory, a torch.profiler breakdown of a step
               and weights against ``opt``; a second full fcoo solve gives
               bit-identical weights and the fcoo step runs no index_add_;
               the F-COO layout's encoded and card-resident bytes; then
               ``format="auto"``, whose FormatPlan is logged and whose
               chosen executor runs a few iterations.
  6. timing  — each kernel at the main path's shapes (CUDA events) beside
               its bound, its plain version and one PyTorch library call;
               for B6 also the bound if every slot read its Y row from
               device memory.
  7. lm      — kernel B7 (the MoE expert FFN's grouped matmul) against its
               plain version in bf16 and fp32 at the prefill gate shape,
               the decode down shape, ragged shapes and expert layouts that
               change at every tile, unsorted and out of range; then MoE serving
               at full width: Phi-3.5-MoE cut to 8 layers (bf16, seeded
               random weights on the card), batch 4, a 512-token prompt,
               16 generated tokens through repro_torch.launch, once on B7
               and once, teacher-forced with the first run's tokens, on
               the plain expert path; B7's launches, the logits' agreement
               at every step, prefill and decode times, peak memory and a
               torch.profiler breakdown of the prefill and of one decode
               step; B7 timed at both shapes beside torch.bmm, and with
               every tile on one expert (that expert's W from L2).

Then it prints one JSON line describing the kernels, the card's name and
power limit as nvidia-smi gives them, and, last, the result line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: fp32 tolerance of the conformance matrix (tests/test_conformance.py:77)
FP32_TOL = dict(rtol=2e-4, atol=2e-5)
#: bf16-storage contract, copied from repro/tune/plan.py:25-26
BF16_RTOL = BF16_ATOL = 2e-2
#: the conformance trajectory bound for weights (tests/test_conformance.py)
TRAJ_TOL = dict(rtol=2e-2, atol=2e-3)
#: NVIDIA H100 SXM data sheet: HBM3 rate and fp32 rate outside the tensor
#: cores (both at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
#: shared memory one block may opt in to on an H100 (227 KB)
SMEM_OPTIN_BYTES = 232_448
#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate (700 W)
BF16_FLOPS_PER_S = 989e12

MAIN_PROBLEM = dict(n_fibers=50_000, n_theta=96, n_atoms=96,
                    grid=(64, 64, 64), algorithm="PROB", seed=0)
MAIN_ITERS = 100
COMPACT_EVERY = 50
TIMED_LAUNCHES = 20
AUTO_ITERS = 10

REDUCED = ("reduced: coefficients per fiber {:.1f} (the generator's "
           "streamlines) vs ~1000 at the dry run's scales "
           "(launch/dryrun.py:139-143); the generator is a pure-Python loop "
           "and runs at this size in tens of seconds")

KERNELS = {
    "dsc_coo": dict(source="src/repro_torch/kernels/csrc/dsc.cu",
                    replaces="src/repro/kernels/dsc.py:94"),
    "wc_coo": dict(source="src/repro_torch/kernels/csrc/wc.cu",
                   replaces="src/repro/kernels/wc.py:77"),
    "dsc_sell": dict(source="src/repro_torch/kernels/csrc/dsc_sell.cu",
                     replaces="src/repro/kernels/dsc.py:152"),
    "wc_sell": dict(source="src/repro_torch/kernels/csrc/wc_sell.cu",
                    replaces="src/repro/kernels/wc.py:136"),
    "dsc_fcoo": dict(source="src/repro_torch/kernels/csrc/dsc_fcoo.cu",
                     replaces="src/repro/kernels/fcoo.py:65"),
    "wc_fcoo": dict(source="src/repro_torch/kernels/csrc/wc_fcoo.cu",
                    replaces="src/repro/kernels/fcoo.py:116"),
}
KERNELS["moe_gmm"] = dict(source="src/repro_torch/kernels/csrc/moe_gmm.cu",
                          replaces="src/repro/kernels/moe_gmm.py:33")
#: the two kernels each full-width path runs, by LifeConfig.format
PATH_KERNELS = {"coo": ("dsc_coo", "wc_coo"), "sell": ("dsc_sell", "wc_sell"),
                "fcoo": ("dsc_fcoo", "wc_fcoo")}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ----------------------------------------------------------------------------
# 1. device
# ----------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    # fp32 everywhere: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------------------
# 2. build
# ----------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build()
    log("build", f"{len(seconds)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(per source: {', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())})")
    # one line per kernel: its name (demangled by the toolkit's cu++filt
    # where it has one), registers, shared memory and spills
    rows = []
    for name in seconds:
        path = _build.log_path(name)
        if not path.exists():
            continue
        entry = spills = ""
        for line in path.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                rows.append((name, entry,
                             f"{line.split(':', 1)[1].strip()}; {spills}"))
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    names = [entry for _, entry, _ in rows]
    if rows and os.path.exists(filt):
        names = subprocess.run([filt, *names], capture_output=True, text=True,
                               check=True, timeout=60).stdout.splitlines()
    for (name, _, usage), entry in zip(rows, names, strict=True):
        log("build", f"{name}: {entry}: {usage}")


# ----------------------------------------------------------------------------
# 3. kernels against their plain versions
# ----------------------------------------------------------------------------

def random_phi(nc: int, na: int, nv: int, nf: int, seed: int, *,
               hot: int = 0, skip_blocks: tuple = (), row_tile: int = 8):
    """A random Phi on the card, made with numpy from ``seed``.

    ``hot`` extra coefficients all land on voxel 3 and fiber 5 (a run that
    spans several tiles in both ops); voxels and fibers in the row blocks
    ``skip_blocks`` get no coefficient (row blocks no tile visits)."""
    from repro_torch.core.std import PhiTensor
    r = np.random.default_rng(seed)
    skipped = np.asarray([b * row_tile + i for b in skip_blocks
                          for i in range(row_tile)], np.int64)

    def ids(n, hot_id):
        allowed = np.setdiff1d(np.arange(n), skipped)
        return np.concatenate([r.choice(allowed, nc), np.full(hot, hot_id)])

    atoms = r.integers(0, na, nc + hot)
    voxels, fibers = ids(nv, 3), ids(nf, 5)
    values = r.normal(size=nc + hot)

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device="cuda")

    return PhiTensor(atoms=t(atoms, torch.int32), voxels=t(voxels, torch.int32),
                     fibers=t(fibers, torch.int32),
                     values=t(values, torch.float32),
                     n_atoms=na, n_voxels=nv, n_fibers=nf)


def kernel_operands(phi, *, c_tile: int, row_tile: int, compute_dtype: str):
    """The two kernels' operands for ``phi``, as the kernel executor builds
    them (output-side sorts, tile plans, padded tiles)."""
    from repro_torch.core.inspector import plan_tiles
    from repro_torch.core.restructure import sort_by_host
    from repro_torch.kernels.ops import coo_tiles
    phi_v, _ = sort_by_host(phi, "voxel")
    phi_w, _ = sort_by_host(phi, "fiber")
    dsc_plan = plan_tiles(phi_v.voxels.cpu().numpy(), phi.n_voxels,
                          c_tile=c_tile, row_tile=row_tile)
    wc_plan = plan_tiles(phi_w.fibers.cpu().numpy(), phi.n_fibers,
                         c_tile=c_tile, row_tile=row_tile)
    return (coo_tiles(phi_v, dsc_plan, phi_v.fibers, phi.n_voxels,
                      compute_dtype=compute_dtype),
            coo_tiles(phi_w, wc_plan, phi_w.voxels, phi.n_fibers,
                      compute_dtype=compute_dtype))


def run_dsc(t, d, w, plain: bool = False):
    from repro_torch.kernels import dsc
    fn = dsc.dsc_coo_plain if plain else dsc.dsc_coo
    return fn(t.tile_ptr, t.tile_len, t.atoms_p, t.others_p, t.values_p,
              t.local_row_p, d, w, row_tile=t.row_tile)


def run_wc(t, d, y, plain: bool = False):
    from repro_torch.kernels import wc
    fn = wc.wc_coo_plain if plain else wc.wc_coo
    return fn(t.tile_ptr, t.tile_len, t.atoms_p, t.others_p, t.values_p,
              t.local_row_p, d, y, row_tile=t.row_tile)


def compare(name: str, case: str, got, want, dtype: str, errors: dict) -> None:
    torch.cuda.synchronize()
    tol = FP32_TOL if dtype == "fp32" else dict(rtol=BF16_RTOL, atol=BF16_ATOL)
    diff = (got - want).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    big = want.abs() > tol["atol"]      # relative error where it means one
    max_rel = float((diff[big] / want.abs()[big]).max()) if big.any() else 0.0
    log("kernels", f"{name} {case} {dtype}: max abs err {max_abs:.3e}, "
        f"max rel err {max_rel:.3e} where |plain| > atol (rtol "
        f"{tol['rtol']}, atol {tol['atol']})")
    torch.testing.assert_close(got, want, **tol)
    errors[name] = max(errors.get(name, 0.0), max_abs)


def check_kernels(case: str, phi, d32, *, c_tile: int, row_tile: int,
                  errors: dict, seed: int) -> dict:
    """Both kernels against their plain versions on ``phi``, fp32 and bf16
    storage.  Returns the shape facts this case exercised."""
    from repro_torch.kernels.ops import storage_cast
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.rand(phi.n_fibers, generator=g, device="cuda")
    y = torch.randn(phi.n_voxels, d32.shape[1], generator=g, device="cuda")
    facts = {}
    for dtype in ("fp32", "bf16"):
        t_dsc, t_wc = kernel_operands(phi, c_tile=c_tile, row_tile=row_tile,
                                      compute_dtype=dtype)
        d = storage_cast(d32, dtype).contiguous()
        got = run_dsc(t_dsc, d, w)
        got_wc = run_wc(t_wc, d, y)
        compare("dsc_coo", case, got, run_dsc(t_dsc, d, w, plain=True),
                dtype, errors)
        compare("wc_coo", case, got_wc, run_wc(t_wc, d, y, plain=True),
                dtype, errors)
        # no atomics, one summation order: a second launch is bit-identical
        if not (torch.equal(got, run_dsc(t_dsc, d, w))
                and torch.equal(got_wc, run_wc(t_wc, d, y))):
            raise AssertionError(f"{case} {dtype}: a second launch differs")
        # row blocks no tile visits come out exactly zero
        spans = t_dsc.tile_ptr.diff().cpu()
        empty = torch.nonzero(spans == 0).flatten()
        if empty.numel():
            rows = (empty[:, None] * row_tile
                    + torch.arange(row_tile)[None, :]).flatten().cuda()
            if torch.count_nonzero(got[rows]).item():
                raise AssertionError(f"dsc_coo {case}: unvisited row block "
                                     "is not zero")
        facts = dict(empty_row_blocks=int(empty.numel()),
                     max_tiles_per_row_block=int(spans.max()),
                     dict_bytes={dt: d32.numel() * sz for dt, sz in
                                 (("fp32", 4), ("bf16", 2))})
    log("kernels", f"{case}: {facts}")
    return facts


def format_operands(phi, *, c_tile: int, row_tile: int, compute_dtype: str):
    """The four format kernels' layouts and device operands for ``phi``, as
    the kernel-sell and kernel-fcoo executors build them."""
    from repro_torch.formats.fcoo import FcooPhi
    from repro_torch.formats.sell import SellPhi
    from repro_torch.kernels import ops
    sd = SellPhi.encode(phi, op="dsc", row_tile=row_tile)
    sw = SellPhi.encode(phi, op="wc", row_tile=row_tile)
    fc = FcooPhi.encode(phi, c_tile=c_tile)
    return (sd, sw, fc,
            dict(dsc_sell=ops.sell_operands(sd, "cuda",
                                            compute_dtype=compute_dtype),
                 wc_sell=ops.sell_operands(sw, "cuda",
                                           compute_dtype=compute_dtype),
                 fcoo=ops.fcoo_operands(fc, "cuda",
                                        compute_dtype=compute_dtype)))


def run_format(name: str, o, d, x, plain: bool = False):
    """Format kernel ``name`` (or its plain version) on operands ``o``."""
    from repro_torch.kernels import dsc, fcoo, wc
    if name == "dsc_sell":
        fn = dsc.dsc_sell_plain if plain else dsc.dsc_sell
        return fn(o.atoms, o.others, o.values, o.row_nnz, d, x,
                  row_tile=o.row_tile)
    if name == "wc_sell":
        fn = wc.wc_sell_plain if plain else wc.wc_sell
        return fn(o.atoms, o.others, o.values, o.row_nnz, d, x)
    if name == "dsc_fcoo":
        fn = fcoo.dsc_fcoo_fused_plain if plain else fcoo.dsc_fcoo
        return fn(o.atoms, o.fibers, o.values, o.voxels, d, x,
                  n_voxels=o.n_voxels)
    fn = fcoo.wc_fcoo_fused_plain if plain else fcoo.wc_fcoo
    return fn(o.wc_perm, o.wc_fibers, o.atoms.reshape(-1),
              o.voxels.reshape(-1), o.values.reshape(-1), d, x,
              n_fibers=o.n_fibers)


def runs_across_chunks(fc, op: str) -> int:
    """Output rows whose run of one op continues from a chunk into the
    next (the case the carries and the ordered fold exist for)."""
    seg_rows = fc.seg_rows_dsc if op == "dsc" else fc.seg_rows_wc
    ranks = (fc.dsc_ranks if op == "dsc" else fc.wc_ranks).reshape(
        fc.n_chunks, fc.c_tile)
    last = seg_rows[np.arange(fc.n_chunks), ranks[:, -1]]
    return int(np.sum(last[:-1] == seg_rows[1:, 0]))


def longest_run_chunks(fc, op: str) -> int:
    """The most chunks one output row's run of one op touches."""
    ids = fc.voxels if op == "dsc" else fc.fibers[fc.wc_perm]
    chunk = np.arange(ids.size) // fc.c_tile
    _, first = np.unique(ids, return_index=True)
    last = ids.size - 1 - np.unique(ids[::-1], return_index=True)[1]
    return int((chunk[last] - chunk[first]).max(initial=-1) + 1)


def check_format_kernels(case: str, phi, d32, *, c_tile: int, row_tile: int,
                         errors: dict, seed: int) -> dict:
    """B3-B6 against their plain versions on ``phi``, fp32 and bf16
    storage.  Returns the shape facts this case exercised."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import storage_cast
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.rand(phi.n_fibers, generator=g, device="cuda")
    y = torch.randn(phi.n_voxels, d32.shape[1], generator=g, device="cuda")
    for dtype in ("fp32", "bf16"):
        sd, sw, fc, o = format_operands(phi, c_tile=c_tile,
                                        row_tile=row_tile,
                                        compute_dtype=dtype)
        d = storage_cast(d32, dtype).contiguous()
        for name, ops_, x in (("dsc_sell", o["dsc_sell"], w),
                              ("wc_sell", o["wc_sell"], y),
                              ("dsc_fcoo", o["fcoo"], w),
                              ("wc_fcoo", o["fcoo"], y)):
            got = run_format(name, ops_, d, x)
            compare(name, case, got, run_format(name, ops_, d, x, plain=True),
                    dtype, errors)
            # no atomics, one summation order: a second launch is identical
            if not torch.equal(got, run_format(name, ops_, d, x)):
                raise AssertionError(f"{name} {case} {dtype}: a second "
                                     "launch differs")
            if name in ("dsc_fcoo", "wc_fcoo"):
                # the fused B5 / B6 against the TPU kernel's partials
                # (plain) folded by the seg_rows combine
                folded = (ops.fcoo_dsc_folded if name == "dsc_fcoo"
                          else ops.fcoo_wc_folded)
                compare(name, f"{case} vs partials + combine", got,
                        folded(fc, ops_, d, x), dtype, {})
    facts = dict(
        empty_rows=int(np.sum(sd.row_nnz == 0) + np.sum(sw.row_nnz == 0)),
        longest_row=int(max(sd.row_nnz.max(initial=0),
                            sw.row_nnz.max(initial=0))),
        slot_tile=sd.slot_tile, sell_widths=(sd.width, sw.width),
        fcoo_chunks=fc.n_chunks, k=(fc.k_dsc, fc.k_wc),
        runs_across_chunks=(runs_across_chunks(fc, "dsc"),
                            runs_across_chunks(fc, "wc")),
        longest_run_chunks=(longest_run_chunks(fc, "dsc"),
                            longest_run_chunks(fc, "wc")))
    log("kernels", f"{case} (formats): {facts}")
    return facts


def check_empty_fcoo() -> None:
    """An empty Phi: the F-COO ops launch nothing and give zeros."""
    from repro_torch.formats.fcoo import FcooPhi
    from repro_torch.kernels import _build, ops
    fc = FcooPhi.encode(random_phi(0, 8, 20, 10, seed=4))
    before = dict(_build.LAUNCHES)
    matvec, rmatvec = ops.make_fcoo_ops(
        fc, torch.randn(8, 16, device="cuda"))
    y = matvec(torch.rand(10, device="cuda"))
    w = rmatvec(torch.randn(20, 16, device="cuda"))
    torch.cuda.synchronize()
    if (tuple(y.shape), tuple(w.shape)) != ((20, 16), (10,)) \
            or y.count_nonzero() or w.count_nonzero() \
            or dict(_build.LAUNCHES) != before:
        raise AssertionError("empty F-COO Phi: expected zeros and no launch")
    log("kernels", "empty F-COO Phi: zeros of shape (Nv, Ntheta) and (Nf,), "
        "no launch")


def check_small_engine() -> None:
    """The kernel executors against the dense oracle on a small problem."""
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.core.std import materialize_dense
    from repro_torch.data.dmri import synth_connectome
    p = synth_connectome(n_fibers=64, n_theta=16, n_atoms=24,
                         grid=(10, 10, 10), seed=1, device="cuda")
    m = materialize_dense(p.phi, p.dictionary).double()
    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.rand(p.phi.n_fibers, generator=g, device="cuda")
    y = torch.randn(p.phi.n_voxels, 16, generator=g, device="cuda")
    for executor in ("kernel", "kernel-sell", "kernel-fcoo"):
        eng = LifeEngine(p, LifeConfig(executor=executor, c_tile=64,
                                       plan_cache_dir=""), device="cuda")
        got_mv = eng.matvec(w).double().reshape(-1)
        got_rmv = eng.rmatvec(y).double()
        torch.cuda.synchronize()
        torch.testing.assert_close(got_mv, m @ w.double(), **FP32_TOL)
        torch.testing.assert_close(got_rmv, m.T @ y.double().reshape(-1),
                                   **FP32_TOL)
        log("kernels", f"small problem: {executor} executor matches the "
            f"dense oracle (max abs err matvec "
            f"{float((got_mv - m @ w.double()).abs().max()):.3e}, rmatvec "
            f"{float((got_rmv - m.T @ y.double().reshape(-1)).abs().max()):.3e})")


def phase_kernels(problem, errors: dict) -> None:
    check_kernels("main-path", problem.phi, problem.dictionary, c_tile=256,
                  row_tile=8, errors=errors, seed=11)
    check_format_kernels("main-path", problem.phi, problem.dictionary,
                         c_tile=256, row_tile=8, errors=errors, seed=14)
    g = np.random.default_rng(2)
    ragged = random_phi(6000, 96, 1000, 300, seed=1, hot=700,
                        skip_blocks=(10, 11, 20))
    ragged_d = torch.as_tensor(g.normal(size=(96, 37)), dtype=torch.float32,
                               device="cuda")
    facts = check_kernels("ragged", ragged, ragged_d, c_tile=64,
                          row_tile=8, errors=errors, seed=12)
    if facts["empty_row_blocks"] == 0 or facts["max_tiles_per_row_block"] < 2:
        raise AssertionError(f"ragged case did not exercise its edges: {facts}")
    facts = check_format_kernels("ragged", ragged, ragged_d, c_tile=64,
                                 row_tile=8, errors=errors, seed=15)
    if (facts["empty_rows"] == 0 or facts["longest_row"] <= facts["slot_tile"]
            or min(facts["runs_across_chunks"]) == 0
            or min(facts["longest_run_chunks"]) < 3):
        raise AssertionError("ragged case did not exercise the format "
                             f"kernels' edges: {facts}")
    big_d = torch.as_tensor(g.normal(size=(2048, 96)), dtype=torch.float32,
                            device="cuda")
    big = random_phi(20000, 2048, 3001, 999, seed=3, hot=300)
    facts = check_kernels("large-dictionary", big, big_d, c_tile=128,
                          row_tile=4, errors=errors, seed=13)
    if min(facts["dict_bytes"].values()) <= SMEM_OPTIN_BYTES:
        raise AssertionError("large-dictionary case fits in shared memory")
    check_format_kernels("large-dictionary", big, big_d, c_tile=128,
                         row_tile=4, errors=errors, seed=16)
    # every width that B3 and B6 dispatch on, with D staged in shared memory
    # (96 atoms) and read from global memory (8192 atoms): Ntheta 16, 64
    # and 128 take B6's float4 paths of 1, 2 and 4 vectors per lane and
    # B3's 1, 2 and 4 columns per lane, 160 B6's scalar path and B3's two
    # passes over the columns (96 and 37 ran above)
    huge = random_phi(20000, 8192, 3001, 999, seed=5, hot=300)
    for n_theta in (16, 64, 128, 160):
        for label, p, na, c_tile, row_tile in (
                ("", ragged, 96, 64, 8),
                ("-global-dictionary", huge, 8192, 128, 4)):
            d_n = torch.as_tensor(g.normal(size=(na, n_theta)),
                                  dtype=torch.float32, device="cuda")
            if label and na * n_theta * 2 <= SMEM_OPTIN_BYTES:
                raise AssertionError(f"{na} x {n_theta} fits in shared "
                                     "memory")
            check_format_kernels(f"width-{n_theta}{label}", p, d_n,
                                 c_tile=c_tile, row_tile=row_tile,
                                 errors=errors, seed=17)
    check_empty_fcoo()
    check_small_engine()


# ----------------------------------------------------------------------------
# 4. main path at full width
# ----------------------------------------------------------------------------

def solve_and_check(phase: str, engine, problem, fmt: str) -> tuple:
    """Run ``engine`` (MAIN_ITERS iterations, compaction every
    COMPACT_EVERY) with every launch count set to 0 just before, and check
    its two kernels' counts (2 DSC + 1.5 WC per iteration), its losses and
    its weights.  Returns (weights, launches of the path's kernels)."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    built_s = engine.inspector_seconds
    _build.reset_launches()
    t0 = time.perf_counter()
    start.record()
    w, losses = engine.run()
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    dsc_name, wc_name = PATH_KERNELS[fmt]
    launches = {dsc_name: counts.get(dsc_name, 0),
                wc_name: counts.get(wc_name, 0)}
    want = {dsc_name: 2 * MAIN_ITERS, wc_name: MAIN_ITERS + MAIN_ITERS // 2}
    log(phase, f"launches {counts} (expected {want}: 2 DSC + 1.5 WC per "
        f"iteration, no probes, no other kernel); run of {MAIN_ITERS} "
        f"iterations: {start.elapsed_time(stop):.3f} ms by CUDA events, "
        f"{wall:.3f} s wall, of which the compaction rebuild (host "
        f"inspector) {engine.inspector_seconds - built_s:.3f} s; compaction "
        f"kept {engine.phi.n_coeffs} of {problem.phi.n_coeffs} coefficients;"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")

    ls = losses.cpu().numpy()
    log(phase, f"loss {ls[0]:.6e} -> {ls[-1]:.6e} "
        f"(first 10 mean {ls[:10].mean():.6e}, last 10 mean "
        f"{ls[-10:].mean():.6e})")
    if not np.all(np.isfinite(ls)):
        raise AssertionError("non-finite loss")
    if not (ls[-10:].mean() < ls[:10].mean() and ls[-1] < ls[0]):
        raise AssertionError("losses did not decrease over the window")
    if tuple(w.shape) != (problem.phi.n_fibers,) or not torch.isfinite(w).all():
        raise AssertionError("weights are not finite of shape (Nf,)")
    return w, launches


def steady_step(phase: str, engine, w) -> list:
    """Steady-state iteration time on the compacted operator, and where it
    goes on the device: returns profile_step's rows."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    state = engine.init_state(w)
    state, _ = engine.step(state, 2)
    start.record()
    engine.step(state, 20)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / 20
    log(phase, f"steady-state step: {step_ms:.4f} ms per iteration (CUDA "
        "events over 20 iterations, compacted Phi)")
    return profile_step(phase, engine, state, step_ms)


def phase_main(problem) -> tuple:
    from repro_torch.core.life import LifeConfig, LifeEngine
    cfg = LifeConfig(executor="kernel", n_iters=MAIN_ITERS,
                     compact_every=COMPACT_EVERY, plan_cache_dir="")
    t0 = time.perf_counter()
    engine = LifeEngine(problem, cfg, device="cuda")
    log("main", f"kernel engine built in {time.perf_counter() - t0:.2f} s "
        f"(inspector {engine.inspector_seconds:.2f} s); dsc tiles "
        f"{engine.executor.plans['dsc_tiles'].n_tiles} x 256, occupancy "
        f"{engine.executor.plans['dsc_tiles'].occupancy():.3f}; wc tiles "
        f"{engine.executor.plans['wc_tiles'].n_tiles} x 256, occupancy "
        f"{engine.executor.plans['wc_tiles'].occupancy():.3f}")
    w, launches = solve_and_check("main", engine, problem, "coo")
    steady_step("main", engine, w)

    opt = LifeEngine(problem, dataclasses.replace(cfg, executor="opt"),
                     device="cuda")
    w_opt, _ = opt.run()
    torch.cuda.synchronize()
    diff = (w - w_opt).abs()
    log("main", f"weights vs opt executor: max abs diff {float(diff.max()):.3e}"
        f" (rtol {TRAJ_TOL['rtol']}, atol {TRAJ_TOL['atol']})")
    torch.testing.assert_close(w, w_opt, **TRAJ_TOL)
    log("main", f"prune stats {engine.prune_stats(w)}")
    log("main", REDUCED.format(problem.phi.n_coeffs / problem.phi.n_fibers))
    return launches, w_opt


def profile_step(phase: str, engine, state, step_ms: float,
                 k: int = 10) -> list:
    """Device time per iteration by kernel (torch.profiler over ``k``
    iterations) and the device's busy share of the iteration measured
    without the profiler.  Returns (ms, calls, name) per device kernel per
    iteration, [] if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step(state, k)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue                  # host ops: their kernels are listed
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            name = evt.key
            for short in ("dsc_coo_kernel", "wc_coo_kernel",
                          "dsc_sell_kernel", "wc_sell_kernel",
                          "dsc_fcoo_kernel", "dsc_fcoo_fold_kernel",
                          "wc_fcoo_kernel", "wc_fcoo_fold_kernel"):
                if short in name:
                    name = short
            rows.append((us / k / 1e3, evt.count / k, name[:60]))
    if not rows:
        log(phase, "profiler saw no device time: breakdown not measured")
        return rows
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(phase, f"device time per iteration {busy:.4f} ms = "
        f"{busy / step_ms:.1%} of the {step_ms:.4f} ms step (torch.profiler "
        f"over {k} iterations); by kernel:")
    for ms, calls, name in rows[:10]:
        log(phase, f"  {ms:.4f} ms  {ms / busy:6.1%}  {calls:4.1f} calls  "
            f"{name}")
    return rows


# ----------------------------------------------------------------------------
# 5. the format paths at full width
# ----------------------------------------------------------------------------

def phase_formats(problem, w_opt) -> dict:
    """``format="sell"`` and ``format="fcoo"`` through LifeEngine at full
    width, each against ``opt``; then ``format="auto"``.  Returns the
    launches of B3-B6 on their paths."""
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.formats.select import DEFAULT_CANDIDATES
    cfg = LifeConfig(n_iters=MAIN_ITERS, compact_every=COMPACT_EVERY,
                     plan_cache_dir="")
    launches, layouts = {}, {}
    n_theta = problem.dictionary.shape[1]
    for fmt in ("sell", "fcoo"):
        phase = f"format-{fmt}"
        t0 = time.perf_counter()
        engine = LifeEngine(problem, dataclasses.replace(cfg, format=fmt),
                            device="cuda")
        plans = engine.executor.plans
        if fmt == "sell":
            sd, sw = plans["sell_dsc"], plans["sell_wc"]
            layouts[fmt] = sd.nbytes + sw.nbytes
            shape = (f"SELL dsc {sd.atoms.shape[0]} x {sd.width} (overhead "
                     f"{sd.padding_overhead:.2f}), wc {sw.atoms.shape[0]} x "
                     f"{sw.width} (overhead {sw.padding_overhead:.2f}), "
                     f"{layouts[fmt] / 2**20:.1f} MiB for the two encodes")
        else:
            fc = plans["fcoo"]
            layouts[fmt] = fc.nbytes
            card_bytes = plans["fcoo_operands"].nbytes
            shape = (f"F-COO {fc.n_chunks} chunks of {fc.c_tile}, k_dsc "
                     f"{fc.k_dsc}, k_wc {fc.k_wc}; FcooPhi.nbytes "
                     f"{fc.nbytes} ({fc.nbytes / 2**20:.1f} MiB, the host "
                     "encoding's nine arrays), FcooOperands.nbytes "
                     f"{card_bytes} ({card_bytes / 2**20:.1f} MiB on the "
                     "card: the stream, wc_perm and wc_fibers; the ranks and"
                     " segment maps stay on the host); per call B5 writes y "
                     f"and {fc.n_chunks * 2 * n_theta * 4 / 2**20:.2f} MiB of"
                     f" carries, B6 w and {fc.n_chunks * 2 * 8 / 2**20:.3f} "
                     "MiB of carries and their fibers (the TPU kernels' "
                     "partials would be "
                     f"{fc.n_chunks * fc.k_dsc * n_theta * 4 / 2**20:.1f} and"
                     f" {fc.n_chunks * fc.k_wc * 4 / 2**20:.2f} MiB, "
                     f"{np.mean(fc.seg_rows_dsc == fc.n_voxels):.1%} and "
                     f"{np.mean(fc.seg_rows_wc == fc.n_fibers):.1%} of their "
                     "rows padding segments)")
        log(phase, f"{engine.executor.name} engine built in "
            f"{time.perf_counter() - t0:.2f} s ({engine.format_plan.describe()}); "
            f"{shape}")
        w, launches_fmt = solve_and_check(phase, engine, problem, fmt)
        launches.update(launches_fmt)
        rows = steady_step(phase, engine, w)
        if fmt == "fcoo":
            check_fcoo_deterministic(problem, cfg, w, rows)
        diff = (w - w_opt).abs()
        log(phase, f"weights vs opt executor: max abs diff "
            f"{float(diff.max()):.3e} (rtol {TRAJ_TOL['rtol']}, atol "
            f"{TRAJ_TOL['atol']})")
        torch.testing.assert_close(w, w_opt, **TRAJ_TOL)
        del engine
        torch.cuda.empty_cache()
    log("formats", f"F-COO encoded bytes over the two SELL encodes: "
        f"{layouts['fcoo'] / layouts['sell']:.4f} (the reference's table12 "
        "gate is 0.6)")

    t0 = time.perf_counter()
    engine = LifeEngine(problem, dataclasses.replace(
        cfg, format="auto", n_iters=AUTO_ITERS, compact_every=0),
        device="cuda")
    plan = engine.format_plan
    st = plan.stats
    log("format-auto", f"resolved {plan.describe()} -> executor "
        f"{engine.executor.name} in {time.perf_counter() - t0:.2f} s; SELL "
        f"overhead dsc {st['dsc.sell_overhead']:.3f}, wc "
        f"{st['wc.sell_overhead']:.3f} (accept <= {cfg.sell_accept}, reject "
        f">= {cfg.sell_reject}); run mean dsc {st['dsc.run_mean']:.2f}, wc "
        f"{st['wc.run_mean']:.2f}")
    if plan.format not in DEFAULT_CANDIDATES or plan.reason not in (
            "heuristic", "autotune"):
        raise AssertionError(f"format=auto resolved to {plan.describe()}")
    w, losses = engine.run()
    torch.cuda.synchronize()
    ls = losses.cpu().numpy()
    if ls.shape != (AUTO_ITERS,) or not np.all(np.isfinite(ls)) \
            or not torch.isfinite(w).all():
        raise AssertionError("format=auto run is not finite")
    log("format-auto", f"{AUTO_ITERS} iterations on the chosen executor: "
        f"loss {ls[0]:.6e} -> {ls[-1]:.6e}")
    return launches


def check_fcoo_deterministic(problem, cfg, w, rows: list) -> None:
    """A second full ``format="fcoo"`` solve (a new engine, the same
    problem) gives the first one's weights bit for bit, and the F-COO
    step's profile holds no ``index_add_`` (B5 and B6 fold their chunks
    themselves, without atomics)."""
    from repro_torch.core.life import LifeEngine
    engine = LifeEngine(problem, dataclasses.replace(cfg, format="fcoo"),
                        device="cuda")
    w2, _ = engine.run()
    torch.cuda.synchronize()
    same = torch.equal(w, w2)
    log("format-fcoo", f"a second full fcoo solve gives bit-identical "
        f"weights: {same} (max abs diff {float((w - w2).abs().max()):.3e})")
    if not same:
        raise AssertionError("two fcoo solves differ")
    if not rows:
        log("format-fcoo", "index_add_ in the step: not measured (the "
            "profiler saw no device time)")
        return
    scatters = [name for _, _, name in rows
                if "indexfunc" in name.lower() or "index_add" in name.lower()]
    log("format-fcoo", f"index_add_ kernels in the step's profile: "
        f"{scatters or 'none'}")
    if scatters:
        raise AssertionError(f"the fcoo step runs an index_add_: {scatters}")


# ----------------------------------------------------------------------------
# 6. timing
# ----------------------------------------------------------------------------

def time_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_operator(phi, d, transpose: bool):
    """M (or M^T) as a torch CSR matrix: the library yardstick (the paper's
    STD-vs-CSR comparison).  The port never calls it."""
    n_theta = d.shape[1]
    rows = (phi.voxels.long()[:, None] * n_theta
            + torch.arange(n_theta, device="cuda")[None, :]).reshape(-1)
    cols = phi.fibers.long()[:, None].expand(-1, n_theta).reshape(-1)
    vals = (d[phi.atoms.long()] * phi.values[:, None]).reshape(-1)
    shape = (phi.n_voxels * n_theta, phi.n_fibers)
    idx = torch.stack([rows, cols])
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    m = torch.sparse_coo_tensor(idx, vals, shape).coalesce().to_sparse_csr()
    del rows, cols, vals, idx
    return m



def phase_timing(problem, launches: dict, errors: dict) -> list:
    phi, d = problem.phi, problem.dictionary
    t_dsc, t_wc = kernel_operands(phi, c_tile=256, row_tile=8,
                                  compute_dtype="fp32")
    sd, sw, fc, o = format_operands(phi, c_tile=256, row_tile=8,
                                    compute_dtype="fp32")
    fo = o["fcoo"]
    nc, n_theta = phi.n_coeffs, d.shape[1]
    nv, nf = phi.n_voxels, phi.n_fibers
    w = torch.rand(nf, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(5))
    y = (run_dsc(t_dsc, d, w)[:nv] - problem.b).contiguous()
    d_bytes = d.numel() * d.element_size()
    tile_bytes = lambda t: 4 * (t.tile_ptr.numel() + t.tile_len.numel())
    flops = 2.0 * nc * n_theta + nc
    # per kernel: its call, its plain version, its result over the function
    # y = M w or w = M^T y, and the compulsory bytes: each index and value
    # of a real coefficient read once, D and the dense input read once, the
    # output (y or w) written once
    rows = [
        ("dsc_coo", w, lambda pl=False: run_dsc(t_dsc, d, w, plain=pl),
         lambda out: out[:nv],
         nc * 16 + tile_bytes(t_dsc) + nf * 4
         + t_dsc.n_row_blocks * t_dsc.row_tile * n_theta * 4),
        ("dsc_sell", w,
         lambda pl=False: run_format("dsc_sell", o["dsc_sell"], d, w, pl),
         lambda out: out[:nv],
         nc * 12 + sd.row_nnz.nbytes + nf * 4
         + sd.atoms.shape[0] * n_theta * 4),
        ("dsc_fcoo", w, lambda pl=False: run_format("dsc_fcoo", fo, d, w, pl),
         lambda out: out,
         nc * 16 + nf * 4 + nv * n_theta * 4),
        ("wc_coo", y, lambda pl=False: run_wc(t_wc, d, y, plain=pl),
         lambda out: out[:nf],
         nc * 16 + tile_bytes(t_wc) + nv * n_theta * 4
         + t_wc.n_row_blocks * t_wc.row_tile * 4),
        ("wc_sell", y,
         lambda pl=False: run_format("wc_sell", o["wc_sell"], d, y, pl),
         lambda out: out[:nf],
         nc * 12 + sw.row_nnz.nbytes + nv * n_theta * 4
         + sw.atoms.shape[0] * 4),
        ("wc_fcoo", y, lambda pl=False: run_format("wc_fcoo", fo, d, y, pl),
         lambda out: out, nc * 20 + nv * n_theta * 4 + nf * 4),
    ]
    csr = {}
    entries = []
    for name, x, run, result, bytes_moved in rows:
        op = name.split("_")[0]
        if op not in csr:
            csr.clear()
            torch.cuda.empty_cache()
            csr[op] = csr_operator(phi, d, transpose=(op == "wc"))
        m = csr[op]
        xv = x.reshape(-1, 1)
        lib_out = torch.sparse.mm(m, xv).reshape(-1)
        mine = result(run()).reshape(-1)
        torch.testing.assert_close(mine, lib_out, **FP32_TOL)
        ms = time_ms(run)
        plain_ms = time_ms(lambda: run(True))
        library_ms = time_ms(lambda: torch.sparse.mm(m, xv))
        bound_ms, bound_by = bound(bytes_moved + d_bytes, flops)
        entry = dict(name=name, route="cuda", **KERNELS[name],
                     launches=launches[name], max_abs_err=errors[name],
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms)
        extra = ""
        if name == "wc_fcoo":
            # fiber order gathers one Y row per slot; if no gathered row hit
            # in L2 (an estimate, not a bound: L2 hits are not measured)
            no_reuse_ms, _ = bound(
                bytes_moved + d_bytes + nc * n_theta * 4 - nv * n_theta * 4,
                flops)
            extra = (f"; estimate with a Y row read from memory per slot "
                     f"(no L2 reuse) {no_reuse_ms:.4f} ms")
        log("timing", f"{name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it){extra}; plain "
            f"{plain_ms:.4f} ms; torch.sparse.mm CSR {library_ms:.4f} ms; "
            f"Nc {nc}")
        entries.append(entry)
    csr.clear()
    torch.cuda.empty_cache()
    return entries


# ----------------------------------------------------------------------------
# 7. MoE serving at full width, on kernel B7
# ----------------------------------------------------------------------------

LM_ARCH = "phi3.5-moe-42b-a6.6b"
#: 32 layers are 83.3 GB in bf16, more than the card's 80 GB
LM_LAYERS = 8
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 16
#: teacher-forced logits of the B7 run against the plain expert path, as a
#: share of the logits' largest magnitude (bf16 products summed in another
#: order round differently in the last place)
LM_LOGIT_TOL = 2e-2
#: B7's plain-version contract (tests/test_torch_moe_gmm.py)
GMM_TOL = {"fp32": dict(rtol=1e-4, atol=1e-4),
           "bf16": dict(rtol=2e-2, atol=2e-2)}


def gmm_case(m: int, k: int, n: int, t_tile: int, ids, seed: int, *,
             zero_tiles: int = 0, n_experts: int = 0):
    """x (m, k) and W (E, k, n) in float32 on the card, made from ``seed``,
    W scaled as the model's experts are; E is ``n_experts`` or one past the
    largest id; the first ``zero_tiles`` tiles of x are zero rows (empty
    capacity slots)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.as_tensor(ids, dtype=torch.int32, device="cuda")
    e = n_experts or int(ids.max()) + 1
    x = torch.randn(m, k, generator=g, device="cuda")
    x[:zero_tiles * t_tile] = 0
    w = torch.randn(e, k, n, generator=g, device="cuda") * (2 / (k + n)) ** 0.5
    return ids, x, w


def check_gmm(case: str, ids, x32, w32, t_tile: int, errors: dict,
              zero_rows: int = 0) -> None:
    """B7 against its plain version in fp32 and bf16 on one case; a second
    launch is bit-identical and zero rows stay zero."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    m, k = x32.shape
    n = w32.shape[2]
    for dtype, x, w in (("fp32", x32, w32),
                        ("bf16", x32.bfloat16(), w32.bfloat16())):
        got = moe_gmm(ids, x, w, t_tile=t_tile, f_tile=8)
        want = moe_gmm_ref(x.view(-1, t_tile, k), w, ids).view(m, n)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        log("lm", f"B7 {case} {dtype} ({m} x {k} -> {n}, t_tile {t_tile}, "
            f"{ids.numel()} tiles, {w.shape[0]} experts): max abs err "
            f"{float(diff.max()):.3e} (rtol {GMM_TOL[dtype]['rtol']}, atol "
            f"{GMM_TOL[dtype]['atol']}); elements that differ at all "
            f"{float((diff > 0).float().mean()):.3e}")
        torch.testing.assert_close(got, want, **GMM_TOL[dtype])
        errors["moe_gmm"] = max(errors.get("moe_gmm", 0.0), float(diff.max()))
        if not torch.equal(got, moe_gmm(ids, x, w, t_tile=t_tile, f_tile=8)):
            raise AssertionError(f"B7 {case} {dtype}: a second launch differs")
        if zero_rows and got[:zero_rows].count_nonzero():
            raise AssertionError(f"B7 {case} {dtype}: zero rows are not zero")
        del got, want, diff
    torch.cuda.empty_cache()


def lm_shapes(cfg) -> dict:
    """B7's two shapes on the serve path: the prefill's gate product and
    the decode step's down product (expert-sorted rows, capacity per
    expert from the reference's formula)."""
    from repro_torch.models.moe import capacity_of, t_tile_of
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    out = {}
    for name, tokens, k, n in (("prefill gate", LM_BATCH * LM_PROMPT, d, f),
                               ("decode down", LM_BATCH, f, d)):
        cap = capacity_of(tokens, cfg.top_k, e, cfg.capacity_factor)
        t_tile = t_tile_of(cap)
        out[name] = dict(m=e * cap, k=k, n=n, t_tile=t_tile, capacity=cap,
                         ids=np.repeat(np.arange(e), cap // t_tile))
    return out


def phase_lm_kernels(cfg, errors: dict) -> None:
    shapes = lm_shapes(cfg)
    for i, (name, s) in enumerate(shapes.items()):
        # at decode most tiles are empty capacity slots: zero rows
        zero_tiles = 12 if name == "decode down" else 0
        ids, x, w = gmm_case(s["m"], s["k"], s["n"], s["t_tile"], s["ids"],
                             seed=20 + i, zero_tiles=zero_tiles)
        check_gmm(name, ids, x, w, s["t_tile"], errors,
                  zero_rows=zero_tiles * s["t_tile"])
        del x, w
    r = np.random.default_rng(22)
    for case, (t_tile, n_tiles, k, n) in {"ragged": (24, 37, 1000, 776),
                                          "ragged-long-tile": (72, 9, 264,
                                                               200)}.items():
        ids = r.integers(0, 16, n_tiles)
        ids[0] = 15                     # E = 16, ids not sorted
        ids, x, w = gmm_case(t_tile * n_tiles, k, n, t_tile, ids, seed=23)
        check_gmm(case, ids, x, w, t_tile, errors)
    # expert layouts at the model's widths: a new expert at every tile of
    # 64 rows (both groups of every 128-row block differ), at every tile of
    # 32 rows, and unsorted ids with some out of range (clamped to [0, 16))
    d, f = cfg.d_model, cfg.moe_d_ff
    for case, (t_tile, ids) in {
            "expert-every-tile": (64, np.arange(32) % 16),
            "expert-every-32-rows": (32, np.arange(48) % 16),
            "unsorted-out-of-range": (64, np.r_[r.integers(0, 16, 14),
                                                -2, 40])}.items():
        ids, x, w = gmm_case(t_tile * len(ids), d, f, t_tile, ids, seed=24,
                             n_experts=16)
        check_gmm(case, ids, x, w, t_tile, errors)
        del x, w


def profile_lm(label: str, fn) -> None:
    """Device time of one call of ``fn`` by kernel (torch.profiler): B7's
    share, the attention sub-layers' and MoE layers' (record_function
    ranges around them) and the rest, against the call's wall time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    originals = {(L, "attention_prefill"): L.attention_prefill,
                 (L, "attention_decode"): L.attention_decode,
                 (MOE, "moe_ffn"): MOE.moe_ffn}

    def ranged(range_name, f):
        def wrapped(*a, **kw):
            with record_function(range_name):
                return f(*a, **kw)
        return wrapped

    for (mod, attr), f in originals.items():
        setattr(mod, attr, ranged("lm." + ("moe" if attr == "moe_ffn"
                                           else "attention"), f))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, attr), f in originals.items():
            setattr(mod, attr, f)
    kernels, ranges, spans = [], {}, {}
    on_card = torch.autograd.DeviceType.CUDA
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = getattr(evt, "cuda_time_total", 0.0)
        if evt.key.startswith("lm."):
            # the host-side range sums its kernels' device time; the
            # card-side annotation spans first to last kernel, gaps included
            if evt.device_type == on_card:
                spans[evt.key] = us / 1e3
            else:
                ranges[evt.key] = total / 1e3
        elif evt.device_type == on_card and us > 0:
            kernels.append((us / 1e3, evt.count, evt.key[:70]))
    if not kernels:
        log("lm", f"{label}: profiler saw no device time: breakdown not "
            "measured")
        return
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    b7 = sum(k[0] for k in kernels if "moe_gmm_" in k[2])
    # B7 launches through ctypes, not a PyTorch op, so the profiler files
    # it under no range: the MoE range holds the layer's other kernels
    att, moe = ranges.get("lm.attention", 0.0), ranges.get("lm.moe", 0.0)
    rest = busy - b7 - att - moe
    log("lm", f"{label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
        f"({busy / wall_ms:.1%}; torch.profiler, one call): B7 {b7:.3f} ms "
        f"({b7 / busy:.1%}); by record_function range, attention sub-layers "
        f"{att:.3f} ms ({att / busy:.1%}), the MoE layers' other kernels "
        f"(router, sort, dispatch, SiLU, combine) {moe:.3f} ms "
        f"({moe / busy:.1%}), the rest {rest:.3f} ms ({rest / busy:.1%}) "
        f"(0.000 for a range: not measured); the ranges' spans on the card, "
        f"gaps included: attention {spans.get('lm.attention', 0.0):.3f} ms, "
        f"MoE {spans.get('lm.moe', 0.0):.3f} ms")
    for ms, calls, name in kernels[:8]:
        log("lm", f"  {ms:.4f} ms  {ms / busy:6.1%}  {calls:4d} calls  {name}")


class LmRecording:
    """Within the block, every MoE layer appends its router's expert ids
    (T, k) to ``routes``; with ``errors`` a list, every expert FFN call
    also runs the plain expert products on the same input and appends the
    largest difference of B7's output from theirs, which must lie within
    the bf16 tolerance."""

    def __init__(self, routes: list, errors):
        self.routes, self.errors = routes, errors

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.saved = MOE._top_k, MOE.expert_ffn
        top_k, ffn = self.saved

        def recording_top_k(probs, k):
            vals, idx = top_k(probs, k)
            self.routes.append(idx.cpu())
            return vals, idx

        def checked_ffn(p, xe, capacity):
            ye = ffn(p, xe, capacity)
            p.plain = True
            want = ffn(p, xe, capacity)
            p.plain = False
            torch.testing.assert_close(ye, want, **GMM_TOL["bf16"])
            self.errors.append(float((ye.float() - want.float()).abs().max()))
            return ye

        MOE._top_k = recording_top_k
        if self.errors is not None:
            MOE.expert_ffn = checked_ffn
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE._top_k, MOE.expert_ffn = self.saved
        return False


def phase_lm_serve(cfg) -> int:
    """Full-width serving on B7, then teacher-forced on the plain expert
    path.  Returns B7's launches in the B7 run."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import capacity_of
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log("lm", f"{LM_ARCH} at {cfg.n_layers} of 32 layers (d {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, {cfg.n_experts} "
        f"experts of ff {cfg.moe_d_ff}, top-{cfg.top_k}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}): {n_bytes / 1e9:.2f} GB of weights "
        f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size,
                                          (LM_BATCH, LM_PROMPT)),
        dtype=torch.int32, device="cuda")
    generate(cfg, model, prompts[:, :64], 2)           # warm-up, not counted

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tokens, logits, secs = generate(cfg, model, prompts, LM_GEN)
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"moe_gmm": cfg.n_layers * 3 * LM_GEN}
    n_dec = LM_GEN - 1
    log("lm", f"serve batch {LM_BATCH} x prompt {LM_PROMPT}, {LM_GEN} tokens "
        f"(1 prefill + {n_dec} decode steps): launches {counts} (expected "
        f"{want}: 3 per MoE layer per forward); prefill "
        f"{secs['prefill'] * 1e3:.3f} ms ({LM_BATCH * LM_PROMPT / secs['prefill']:.1f} "
        f"prompt tokens/s); decode {secs['decode'] * 1e3 / n_dec:.3f} ms per "
        f"step, {LM_BATCH * n_dec / secs['decode']:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; capacity per expert: prefill "
        f"{capacity_of(LM_BATCH * LM_PROMPT, cfg.top_k, cfg.n_experts, cfg.capacity_factor)}"
        f", decode {capacity_of(LM_BATCH, cfg.top_k, cfg.n_experts, cfg.capacity_factor)}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if tuple(tokens.shape) != (LM_BATCH, LM_GEN) or not all(
            torch.isfinite(lg).all() for lg in logits) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("serve output is not finite tokens of the "
                             "expected shape")
    log("lm", f"generated tokens (first row): {tokens[0].tolist()}")

    # the same forwards again, teacher-forced with the B7 run's tokens: on
    # B7 with each MoE layer's expert FFN also run by the plain version on
    # the same input (the kernel held on the path's own activations), then
    # on the plain expert path; both runs record every router decision
    b7_routes, layer_err = [], []
    with LmRecording(b7_routes, layer_err):
        _, checked_logits, _ = generate(cfg, model, prompts, LM_GEN,
                                        forced=tokens)
    same_again = all(torch.equal(a, b) for a, b in zip(logits,
                                                       checked_logits))
    log("lm", f"B7 on the path's own activations: {len(layer_err)} expert "
        f"FFN calls (3 B7 products each) against the plain expert products "
        f"on the same input, max abs err {max(layer_err):.3e} (rtol "
        f"{GMM_TOL['bf16']['rtol']}, atol {GMM_TOL['bf16']['atol']}); the "
        f"teacher-forced B7 run's logits equal the first run's bit for bit: "
        f"{same_again}")
    plain_routes = []
    model.use_plain_experts(True)
    _build.reset_launches()
    with LmRecording(plain_routes, None):
        _, plain_logits, plain_secs = generate(cfg, model, prompts, LM_GEN,
                                               forced=tokens)
    model.use_plain_experts(False)
    if dict(_build.LAUNCHES):
        raise AssertionError(f"the plain expert path launched "
                             f"{dict(_build.LAUNCHES)}")
    per_step = cfg.n_layers
    worst, worst_same_route, alike = 0.0, 0.0, 0
    for i, (a, b) in enumerate(zip(logits, plain_logits)):
        peak_logit = float(b.float().abs().max())
        rel = float((a.float() - b.float()).abs().max()) / peak_logit
        routes = slice(i * per_step, (i + 1) * per_step)
        flips = sum(int((x != y).any(dim=-1).sum()) for x, y in
                    zip(b7_routes[routes], plain_routes[routes]))
        worst = max(worst, rel)
        if not flips:
            alike += 1
            worst_same_route = max(worst_same_route, rel)
        ulp = 2.0 ** (np.floor(np.log2(peak_logit)) - 7)
        log("lm", f"step {i}: max |logit diff| / max |logit| = {rel:.3e} "
            f"(max |logit| {peak_logit:.4f}, bf16 spacing there {ulp:.4g} = "
            f"{ulp / peak_logit:.2e} of it); tokens routed to another expert "
            f"than on B7: {flips} of {per_step * b7_routes[routes.start].shape[0]}"
            f" token-layers; argmax agrees on "
            f"{int((a.argmax(-1) == b.argmax(-1)).sum())} of {LM_BATCH} rows")
    log("lm", f"teacher-forced plain expert path: prefill "
        f"{plain_secs['prefill'] * 1e3:.3f} ms, decode "
        f"{plain_secs['decode'] * 1e3 / n_dec:.3f} ms per step; worst "
        f"relative logit difference {worst:.3e} over all steps, "
        f"{worst_same_route:.3e} over the {alike} of {LM_GEN} steps routed "
        f"alike in both runs (limit {LM_LOGIT_TOL} on those)")
    if not alike or worst_same_route > LM_LOGIT_TOL:
        raise AssertionError(f"B7 and the plain expert path disagree on a "
                             f"step routed alike: {worst_same_route:.3e} > "
                             f"{LM_LOGIT_TOL}")

    # where the time goes: the prefill and one decode step
    from repro_torch.launch.steps import make_prefill, make_serve_step
    from repro_torch.launch.serve import pad_cache
    prefill_step, serve_step = make_prefill(cfg), make_serve_step(cfg)
    state = {}

    def run_prefill():
        _, cache = prefill_step(model, {"tokens": prompts})
        state["cache"] = pad_cache(cache, LM_PROMPT + LM_GEN)

    profile_lm("prefill", run_prefill)
    profile_lm("decode step", lambda: serve_step(model, dict(
        tokens=tokens[:, :1], cache=state["cache"], cache_index=LM_PROMPT)))
    del model, state
    torch.cuda.empty_cache()
    return counts["moe_gmm"]


def gmm_bound(s: dict) -> tuple:
    """Least time of one bf16 product of shape ``s``: x, the selected
    experts' W and out moved once over HBM, against 2 M K N operations on
    the bf16 tensor cores."""
    m, k, n = s["m"], s["k"], s["n"]
    n_sel = len(np.unique(s["ids"]))
    t_bytes = 2 * (m * k + n_sel * k * n + m * n) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_lm_timing(cfg, launches: int, errors: dict) -> dict:
    """B7 at its two serve shapes in bf16 (CUDA events, 20 launches) beside
    its bound, itself with every tile on one expert, its plain version and
    torch.bmm over (E, capacity, K)."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    rows = {}
    for i, (name, s) in enumerate(lm_shapes(cfg).items()):
        ids, x, w = gmm_case(s["m"], s["k"], s["n"], s["t_tile"], s["ids"],
                             seed=30 + i)
        x, w = x.bfloat16(), w.bfloat16()
        e = w.shape[0]
        ms = time_ms(lambda: moe_gmm(ids, x, w, t_tile=s["t_tile"]))
        # every tile on expert 0: W (one expert's) is read from device
        # memory once and then hit in L2, so the gap to ms is what the
        # misses on 16 experts' W cost
        ids0 = torch.zeros_like(ids)
        one_expert_ms = time_ms(lambda: moe_gmm(ids0, x, w,
                                                t_tile=s["t_tile"]))
        plain_ms = time_ms(lambda: moe_gmm_ref(
            x.view(-1, s["t_tile"], s["k"]), w, ids))
        xb = x.view(e, s["capacity"], s["k"])
        library_ms = time_ms(lambda: torch.bmm(xb, w))
        bound_ms, bound_by = gmm_bound(s)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms,
                          one_expert_ms=one_expert_ms,
                          shape=f"{s['m']} x {s['k']} -> {s['n']}, t_tile "
                                f"{s['t_tile']}, {e} experts, bf16")
        log("timing", f"moe_gmm {name} ({rows[name]['shape']}): {ms:.4f} ms "
            f"(bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of "
            f"it; {2.0 * s['m'] * s['k'] * s['n'] / ms / 1e9:.1f} TFLOP/s); "
            f"every tile on expert 0 "
            f"{one_expert_ms:.4f} ms; plain {plain_ms:.4f} ms; "
            f"torch.bmm {library_ms:.4f} ms ({ms / library_ms:.2f}x)")
        del x, w, xb
        torch.cuda.empty_cache()
    main_row = rows["prefill gate"]
    return dict(name="moe_gmm", route="cuda", **KERNELS["moe_gmm"],
                launches=launches, max_abs_err=errors["moe_gmm"],
                ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                library_ms=main_row["library_ms"], shape=main_row["shape"],
                one_expert_ms=main_row["one_expert_ms"],
                decode=rows["decode down"])


def phase_lm(errors: dict) -> dict:
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    phase_lm_kernels(cfg, errors)
    launches = phase_lm_serve(cfg)
    return phase_lm_timing(cfg, launches, errors)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()

    from repro_torch.data.dmri import synth_connectome
    t0 = time.perf_counter()
    problem = synth_connectome(**MAIN_PROBLEM, device="cuda")
    log("main", f"problem {MAIN_PROBLEM}: {problem.phi.n_coeffs} coefficients, "
        f"Nv {problem.phi.n_voxels}, Nf {problem.phi.n_fibers}, made in "
        f"{time.perf_counter() - t0:.1f} s")

    errors: dict = {}
    phase_kernels(problem, errors)
    launches, w_opt = phase_main(problem)
    launches.update(phase_formats(problem, w_opt))
    entries = phase_timing(problem, launches, errors)
    del problem, w_opt
    torch.cuda.empty_cache()
    entries.append(phase_lm(errors))
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
