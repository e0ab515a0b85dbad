"""B7: the grouped matmul of the MoE expert FFN, with its wrapper and plain
version.

``csrc/moe_gmm.cu`` replaces the Pallas TPU kernel
``repro/kernels/moe_gmm.py:moe_gmm``; its note says what bounds it on the
card and what its design does about that.  Tokens arrive sorted by expert
and cut into tiles that never cross an expert boundary, and each tile is
multiplied by its expert's weights:

    out[t] = x[t] @ W[expert_of_tile[t]]

Operands:

  expert_of_tile  int32[n_tiles]               expert of each token tile
  x_p             float32 | bfloat16 [n_tiles * t_tile, d_model]
  w_experts       [E, d_model, d_ff], the same dtype as ``x_p``

Result: ``[n_tiles * t_tile, d_ff]`` in ``x_p``'s dtype, summed in float32.
The wrapper launches the kernel on CUDA tensors (counted in
:data:`repro_torch.kernels._build.LAUNCHES` under ``"moe_gmm"``), runs the
plain version (:func:`repro_torch.kernels.ref.moe_gmm_ref`) on CPU
tensors, and raises on anything else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dsc import _device_of
from repro_torch.kernels.ref import moe_gmm_ref

DEFAULT_T_TILE = 128
DEFAULT_F_TILE = 128

_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ENTRY = {torch.float32: "moe_gmm_f32", torch.bfloat16: "moe_gmm_bf16"}


def moe_gmm(expert_of_tile: torch.Tensor, x_p: torch.Tensor,
            w_experts: torch.Tensor, *, t_tile: int = DEFAULT_T_TILE,
            f_tile: int = DEFAULT_F_TILE) -> torch.Tensor:
    """Run B7 on CUDA tensors; on CPU tensors, the plain version.

    ``t_tile`` is the rows of a token tile.  ``f_tile`` only bounds the
    shapes accepted, as in the reference (``d_ff`` a multiple of it); the
    kernel picks its own column blocks.

    Raises:
        ValueError: the reference's shape errors; an operand on another
            device, of another shape, or not contiguous; on the card, a
            width that is not a multiple of 16 bytes or an operand not
            aligned to 16 bytes.
        TypeError: an operand of another dtype.
        RuntimeError: the CUDA launch was refused.
    """
    n_rows, d_model = x_p.shape
    n_exp, _, d_ff = w_experts.shape
    if n_rows % t_tile:
        raise ValueError("token rows must be a multiple of t_tile")
    n_tiles = n_rows // t_tile
    if expert_of_tile.shape[0] != n_tiles:
        raise ValueError("expert_of_tile must have one entry per token tile")
    f_tile = min(f_tile, d_ff)
    if d_ff % f_tile:
        raise ValueError("d_ff must be a multiple of f_tile")
    dev = _device_of(x_p, "moe_gmm")
    _build.check_operand(x_p, "x_p", device=dev,
                         dtypes=(torch.float32, torch.bfloat16),
                         shape=(None, None))
    _build.check_operand(w_experts, "w_experts", device=dev,
                         dtypes=(x_p.dtype,), shape=(None, d_model, None))
    _build.check_operand(expert_of_tile, "expert_of_tile", device=dev,
                         dtypes=(torch.int32,), shape=(n_tiles,))
    if dev.type == "cpu":
        return moe_gmm_ref(x_p.view(n_tiles, t_tile, d_model), w_experts,
                           expert_of_tile).view(n_rows, d_ff)
    vec = 16 // x_p.element_size()
    if d_model % vec or d_ff % vec:
        raise ValueError(f"d_model ({d_model}) and d_ff ({d_ff}) must be "
                         f"multiples of {vec} {x_p.dtype} elements (16 bytes)")
    for name, t in (("x_p", x_p), ("w_experts", w_experts)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be aligned to 16 bytes")
    out = torch.empty((n_rows, d_ff), dtype=x_p.dtype, device=dev)
    if n_rows == 0 or d_ff == 0:
        return out
    if d_model == 0:
        return out.zero_()
    lib = _build.load("moe_gmm",
                      {name: _SIGNATURE for name in _ENTRY.values()})
    _build.launch(lib, _ENTRY[x_p.dtype], "moe_gmm", dev,
                  [expert_of_tile, x_p, w_experts, out],
                  [n_tiles, t_tile, n_exp, d_model, d_ff])
    return out
