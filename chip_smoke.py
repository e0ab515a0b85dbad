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
               shapes (an empty row block, a row block whose run spans
               several tiles, a dictionary larger than shared memory), in
               fp32 and bf16 storage; plus the kernel executor against the
               dense oracle on a small problem.
  4. main    — the single-subject solve at full width (STN96: Ntheta = 96,
               a 64^3 voxel grid, 50,000 fibers) through LifeEngine with
               the ``kernel`` executor and a compaction rebuild; the
               kernels' launch counts, the losses, and the weights against
               the ``opt`` executor on the same card.
  5. timing  — each kernel at the main path's shapes (CUDA events) beside
               its bound, its plain version and one PyTorch library call.

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

MAIN_PROBLEM = dict(n_fibers=50_000, n_theta=96, n_atoms=96,
                    grid=(64, 64, 64), algorithm="PROB", seed=0)
MAIN_ITERS = 100
COMPACT_EVERY = 50
TIMED_LAUNCHES = 20

REDUCED = ("reduced: coefficients per fiber {:.1f} (the generator's "
           "streamlines) vs ~1000 at the dry run's scales "
           "(launch/dryrun.py:139-143); the generator is a pure-Python loop "
           "and runs at this size in tens of seconds")

KERNELS = {
    "dsc_coo": dict(source="src/repro_torch/kernels/csrc/dsc.cu",
                    replaces="src/repro/kernels/dsc.py:94"),
    "wc_coo": dict(source="src/repro_torch/kernels/csrc/wc.cu",
                   replaces="src/repro/kernels/wc.py:77"),
}


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
    for name in seconds:
        path = _build.log_path(name)
        if path.exists():
            for line in path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log("build", f"{name}: {line.strip()}")


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


def check_small_engine() -> None:
    """The kernel executor against the dense oracle on a small problem."""
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.core.std import materialize_dense
    from repro_torch.data.dmri import synth_connectome
    p = synth_connectome(n_fibers=64, n_theta=16, n_atoms=24,
                         grid=(10, 10, 10), seed=1, device="cuda")
    m = materialize_dense(p.phi, p.dictionary).double()
    eng = LifeEngine(p, LifeConfig(executor="kernel", c_tile=64,
                                   plan_cache_dir=""), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.rand(p.phi.n_fibers, generator=g, device="cuda")
    y = torch.randn(p.phi.n_voxels, 16, generator=g, device="cuda")
    got_mv = eng.matvec(w).double().reshape(-1)
    got_rmv = eng.rmatvec(y).double()
    torch.cuda.synchronize()
    torch.testing.assert_close(got_mv, m @ w.double(), **FP32_TOL)
    torch.testing.assert_close(got_rmv, m.T @ y.double().reshape(-1),
                               **FP32_TOL)
    log("kernels", "small problem: kernel executor matches the dense "
        f"oracle (max abs err matvec "
        f"{float((got_mv - m @ w.double()).abs().max()):.3e})")


def phase_kernels(problem, errors: dict) -> None:
    check_kernels("main-path", problem.phi, problem.dictionary, c_tile=256,
                  row_tile=8, errors=errors, seed=11)
    g = np.random.default_rng(2)
    ragged = random_phi(6000, 96, 1000, 300, seed=1, hot=700,
                        skip_blocks=(10, 11, 20))
    ragged_d = torch.as_tensor(g.normal(size=(96, 37)), dtype=torch.float32,
                               device="cuda")
    facts = check_kernels("ragged", ragged, ragged_d, c_tile=64,
                          row_tile=8, errors=errors, seed=12)
    if facts["empty_row_blocks"] == 0 or facts["max_tiles_per_row_block"] < 2:
        raise AssertionError(f"ragged case did not exercise its edges: {facts}")
    big_d = torch.as_tensor(g.normal(size=(2048, 96)), dtype=torch.float32,
                            device="cuda")
    big = random_phi(20000, 2048, 3001, 999, seed=3, hot=300)
    facts = check_kernels("large-dictionary", big, big_d, c_tile=128,
                          row_tile=4, errors=errors, seed=13)
    if min(facts["dict_bytes"].values()) <= SMEM_OPTIN_BYTES:
        raise AssertionError("large-dictionary case fits in shared memory")
    check_small_engine()


# ----------------------------------------------------------------------------
# 4. main path at full width
# ----------------------------------------------------------------------------

def phase_main(problem) -> dict:
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.kernels import dsc, wc
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    dsc.launches = 0
    wc.launches = 0
    built_s = engine.inspector_seconds
    t0 = time.perf_counter()
    start.record()
    w, losses = engine.run()
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(dsc_coo=dsc.launches, wc_coo=wc.launches)
    want = dict(dsc_coo=2 * MAIN_ITERS, wc_coo=MAIN_ITERS + MAIN_ITERS // 2)
    log("main", f"launches {launches} (expected {want}: 2 DSC + 1.5 WC per "
        f"iteration, no probes); run of {MAIN_ITERS} iterations: "
        f"{start.elapsed_time(stop):.3f} ms by CUDA events, {wall:.3f} s "
        f"wall, of which the compaction rebuild (host inspector) "
        f"{engine.inspector_seconds - built_s:.3f} s; compaction kept "
        f"{engine.phi.n_coeffs} of {problem.phi.n_coeffs} coefficients; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    ls = losses.cpu().numpy()
    log("main", f"loss {ls[0]:.6e} -> {ls[-1]:.6e} "
        f"(first 10 mean {ls[:10].mean():.6e}, last 10 mean "
        f"{ls[-10:].mean():.6e})")
    if not np.all(np.isfinite(ls)):
        raise AssertionError("non-finite loss")
    if not (ls[-10:].mean() < ls[:10].mean() and ls[-1] < ls[0]):
        raise AssertionError("losses did not decrease over the window")
    if tuple(w.shape) != (problem.phi.n_fibers,) or not torch.isfinite(w).all():
        raise AssertionError("weights are not finite of shape (Nf,)")

    # steady-state iteration time on the compacted operator, and where it
    # goes on the device
    state = engine.init_state(w)
    state, _ = engine.step(state, 2)
    start.record()
    engine.step(state, 20)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / 20
    log("main", f"steady-state step: {step_ms:.4f} ms per iteration (CUDA "
        "events over 20 iterations, compacted Phi)")
    profile_step(engine, state, step_ms)

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
    return launches


def profile_step(engine, state, step_ms: float, k: int = 10) -> None:
    """Device time per iteration by kernel (torch.profiler over ``k``
    iterations) and the device's busy share of the iteration measured
    without the profiler."""
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
            for short in ("dsc_coo_kernel", "wc_coo_kernel"):
                if short in name:
                    name = short
            rows.append((us / k / 1e3, evt.count / k, name[:60]))
    if not rows:
        log("main", "profiler saw no device time: breakdown not measured")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log("main", f"device time per iteration {busy:.4f} ms = "
        f"{busy / step_ms:.1%} of the {step_ms:.4f} ms step (torch.profiler "
        f"over {k} iterations); by kernel:")
    for ms, calls, name in rows[:10]:
        log("main", f"  {ms:.4f} ms  {ms / busy:6.1%}  {calls:4.1f} calls  "
            f"{name}")


# ----------------------------------------------------------------------------
# 5. timing
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
    nc, n_theta = phi.n_coeffs, d.shape[1]
    w = torch.rand(phi.n_fibers, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(5))
    y = (run_dsc(t_dsc, d, w)[:phi.n_voxels] - problem.b).contiguous()
    d_bytes = d.numel() * d.element_size()
    coeff_bytes = nc * (4 + 4 + 4 + 4)             # atom, other, value, row
    tile_bytes = lambda t: 4 * (t.tile_ptr.numel() + t.tile_len.numel())
    entries = []
    for name, tiles, run, x, in_bytes, out_bytes in (
            ("dsc_coo", t_dsc, run_dsc, w, phi.n_fibers * 4,
             t_dsc.n_row_blocks * t_dsc.row_tile * n_theta * 4),
            ("wc_coo", t_wc, run_wc, y, phi.n_voxels * n_theta * 4,
             t_wc.n_row_blocks * t_wc.row_tile * 4)):
        ms = time_ms(lambda: run(tiles, d, x))
        plain_ms = time_ms(lambda: run(tiles, d, x, plain=True))
        m = csr_operator(phi, d, transpose=(name == "wc_coo"))
        xv = x.reshape(-1, 1)
        lib_out = torch.sparse.mm(m, xv).reshape(-1)
        mine = run(tiles, d, x)[:tiles.n_rows].reshape(-1)
        torch.testing.assert_close(mine, lib_out, **FP32_TOL)
        library_ms = time_ms(lambda: torch.sparse.mm(m, xv))
        del m
        torch.cuda.empty_cache()
        flops = 2.0 * nc * n_theta + nc
        bound_ms, bound_by = bound(
            coeff_bytes + tile_bytes(tiles) + d_bytes + in_bytes + out_bytes,
            flops)
        entry = dict(name=name, route="cuda", **KERNELS[name],
                     launches=launches[name], max_abs_err=errors[name],
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms)
        log("timing", f"{name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it); plain {plain_ms:.4f} ms; "
            f"torch.sparse.mm CSR {library_ms:.4f} ms; Nc {nc}, tiles "
            f"{tiles.atoms_p.shape[0]} x {tiles.atoms_p.shape[1]}")
        entries.append(entry)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
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
    launches = phase_main(problem)
    entries = phase_timing(problem, launches, errors)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
