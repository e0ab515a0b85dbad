"""Time kernel B4's design variants in turns on one card.

Usage, from the repository root on a machine with a CUDA card:

    python -m repro_torch.tune.probe_wc_sell [--parent DIR] [--rounds N]

Builds, each with its own ``nvcc`` into ``build/probe_wc_sell/``, variants
of ``kernels/csrc/wc_sell.cu`` made by text substitution: other launch
shapes (threads per block, blocks per SM in ``__launch_bounds__``) and a
walk whose batches stop at each row's end instead of packing rows
(``SellWalk::next`` replaced).  ``--parent DIR`` adds a build of the
``wc_sell.cu`` and ``common.cuh`` found in DIR, for example another
commit's.  On the full-width smoke problem (the problem of
``chip_smoke.py``'s main path) every variant is held to B4's plain version
(fp32, rtol 2e-4 / atol 2e-5) and timed with CUDA events over 20 launches,
variants in turns and in reversed order on odd rounds; prints each one's
median and range, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ops, wc

#: chip_smoke.py's main problem
PROBLEM = dict(n_fibers=50_000, n_theta=96, n_atoms=96, grid=(64, 64, 64),
               algorithm="PROB", seed=0)
OUT = _build.BUILD_DIR.parent / "probe_wc_sell"
#: name -> (threads per block, blocks per SM in __launch_bounds__)
SHAPES = {"t384": (384, 1), "t256": (256, 1), "t256x2": (256, 2),
          "t512x2": (512, 2)}
#: SellWalk::next with batches that stop at each row's end (no packing)
PER_ROW_NEXT = r'''  __device__ SellBatch next() {
    SellBatch b{0, -1, 0};
    while (pos_ == total_) {
      if (base_ + 32 >= r_end_) return b;
      window(base_ + 32);
    }
    int k = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFull, end_, k + step - 1) <= pos_) k += step;
    }
    const int row_end = __shfl_sync(kFull, end_, k);
    const int start = __shfl_sync(kFull, end_ - nnz_, k);
    b.m = min(32, row_end - pos_);
    if (lane_ < b.m) {
      b.row = base_ + k;
      b.slot = static_cast<size_t>(b.row) * width_ + (pos_ + lane_ - start);
    }
    pos_ += b.m;
    return b;
  }

'''


def variants(parent: Path = None) -> dict:
    """name -> (wc_sell.cu text, common.cuh text)."""
    cu = (_build.CSRC / "wc_sell.cu").read_text()
    cuh = (_build.CSRC / "common.cuh").read_text()
    out = {}
    for name, (threads, blocks) in SHAPES.items():
        v = cu.replace("constexpr int kThreads = 512;",
                       f"constexpr int kThreads = {threads};")
        v = v.replace("__launch_bounds__(kThreads, 1)",
                      f"__launch_bounds__(kThreads, {blocks})")
        if v == cu:
            raise RuntimeError(f"variant {name}: wc_sell.cu did not change")
        out[name] = (v, cuh)
    per_row = re.sub(r"  __device__ SellBatch next\(\) \{.*?\n private:",
                     lambda m: PER_ROW_NEXT + " private:", cuh, count=1,
                     flags=re.S)
    if per_row == cuh:
        raise RuntimeError("variant per_row: SellWalk::next not found")
    out["per_row"] = (cu, per_row)
    if parent is not None:
        out["parent"] = ((parent / "wc_sell.cu").read_text(),
                         (parent / "common.cuh").read_text())
    return out


def build(sources: dict) -> dict:
    """Compile every variant at once; name -> loaded library."""
    sig = {n: wc._SELL_SIGNATURE for n in wc._SELL_ENTRY.values()}
    procs = {}
    for name, (cu, cuh) in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "wc_sell.cu").write_text(cu)
        (d / "common.cuh").write_text(cuh)
        lib = d / "libwc_sell.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(d / "wc_sell.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        (OUT / name / "nvcc.log").write_text(text)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{text}")
        libs[name] = ctypes.CDLL(str(lib))
        for fn in sig:
            getattr(libs[name], fn).argtypes = sig[fn]
            getattr(libs[name], fn).restype = ctypes.c_int
    libs["new"] = _build.load("wc_sell", sig)
    return libs


def time_ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def main(argv=None) -> int:
    from repro_torch.data.dmri import synth_connectome
    from repro_torch.formats.sell import SellPhi
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(variants(args.parent))
    problem = synth_connectome(**PROBLEM, device="cuda")
    o = ops.sell_operands(SellPhi.encode(problem.phi, op="wc"), "cuda")
    d = problem.dictionary
    g = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randn(problem.phi.n_voxels, d.shape[1], generator=g,
                    device="cuda")
    args_ = (o.atoms, o.others, o.values, o.row_nnz, d, y)
    plain = wc.wc_sell_plain(*args_)
    names = ["new"] + sorted(n for n in libs if n != "new")
    times = {n: [] for n in names}
    try:
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                _build._LIBS["wc_sell"] = libs[name]
                torch.testing.assert_close(wc.wc_sell(*args_), plain,
                                           rtol=2e-4, atol=2e-5)
                times[name].append(time_ms(lambda: wc.wc_sell(*args_)))
    finally:
        _build._LIBS["wc_sell"] = libs["new"]
    print(f"wc_sell at Nc {problem.phi.n_coeffs}, {o.atoms.shape[0]} x "
          f"{o.atoms.shape[1]} fiber rows, Ntheta {d.shape[1]} (fp32; "
          f"median [min-max] of {args.rounds} rounds of 20 launches):")
    for name, t in times.items():
        print(f"  {name:8s} {np.median(t):.4f} ms [{min(t):.4f}-"
              f"{max(t):.4f}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
