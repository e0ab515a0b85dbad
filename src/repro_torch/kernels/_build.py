"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` compiles it in seconds into
``build/repro_torch/lib<name>-<digest>.so`` at the repository root (a
directory git ignores).  ``digest`` hashes the source and the flags, so an
edited kernel is rebuilt and an unchanged one is not.  Building happens at
first use, never at import: the CPU tests import every module on a machine
without ``nvcc``.  :func:`build` starts one ``nvcc`` per source, all at
once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> tuple:
    """Every kernel source in ``csrc/`` by name (``dsc``, ``wc``, ...)."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and "
                           "nvcc is not on PATH); the kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def log_path(name: str) -> Path:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    return library_path(name).with_suffix(".log")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet.

    Returns the seconds each compile took (0.0 for one already built).

    Raises:
        RuntimeError: nvcc failed; the message holds its output.
    """
    names = kernel_names() if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        log_path(name).write_text(out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be.

    ``signatures`` maps each C entry point to its ``argtypes`` (pointers
    and the stream as ``c_void_p``, sizes as ``c_int``); every entry point
    returns a ``cudaError_t`` as ``int``."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_operand(t, name: str, *, device, dtypes: tuple,
                  shape: Optional[tuple] = None) -> None:
    """Raise unless ``t`` lies on ``device`` with one of ``dtypes``, the
    given ``shape`` (``None`` entries match any size), and is contiguous:
    a kernel reads raw pointers and would read whatever lies there."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and (
            t.dim() != len(shape)
            or any(s is not None and s != n for s, n in zip(shape, t.shape))):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_coo_tiles(tile_ptr, tile_len, atoms_p, others_p, values_p,
                    local_row_p, dictionary, *, device) -> None:
    """The checks of :func:`check_operand` over the tile operands shared by
    the COO kernels (layout in ``kernels/ops.py:CooTiles``)."""
    import torch
    n_tiles, c_tile = atoms_p.shape
    i32 = (torch.int32,)
    check_operand(tile_ptr, "tile_ptr", device=device, dtypes=i32,
                  shape=(None,))
    check_operand(tile_len, "tile_len", device=device, dtypes=i32,
                  shape=(n_tiles,))
    for name, t in (("atoms_p", atoms_p), ("others_p", others_p),
                    ("local_row_p", local_row_p)):
        check_operand(t, name, device=device, dtypes=i32,
                      shape=(n_tiles, c_tile))
    check_operand(dictionary, "dictionary", device=device,
                  dtypes=(torch.float32, torch.bfloat16), shape=(None, None))
    check_operand(values_p, "values_p", device=device,
                  dtypes=(dictionary.dtype,), shape=(n_tiles, c_tile))


def launch(lib: ctypes.CDLL, fn_name: str, kernel: str, device,
           tensors: list, ints: list) -> None:
    """Call one C entry point on PyTorch's current stream of ``device``.

    Raises:
        RuntimeError: the launch was refused (non-zero cudaError_t).
    """
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*[ctypes.c_void_p(t.data_ptr())
                                      for t in tensors],
                                    *ints, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")
