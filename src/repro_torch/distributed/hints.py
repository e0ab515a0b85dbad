"""Sharding hints for model code, set by the launcher (torch counterpart of
``repro/distributed/hints.py``).

Model functions are mesh-agnostic: the launcher calls :func:`activate`
with a mesh, and the model reads the mesh through these functions.
Activating a :class:`~repro_torch.launch.mesh.ShapeMesh` on one process
changes what the mesh changes in the reference's math, and runs no
collective: the MoE's dispatch groups (``G = |batch axes|``) and the
attention branch (KV heads expanded to H).  Tests use it to build
single-process counterparts of a mesh run.

The reference's :func:`constrain`, :func:`residual`, :func:`gathered` and
:func:`attn_heads` are sharding constraints for GSPMD.  The port holds
plain local tensors, so they return their argument: on a live
:class:`~repro_torch.launch.mesh.HostMesh` each rank holds its data
shard's rows, and the residual stream is whole over ``model`` (no
sequence parallelism).  What the constraints make GSPMD do over
``model`` the port does with explicit regions: :func:`over_model` runs a
function on this rank's slice of a tensor that every ``model`` rank holds
whole and gathers its result (an all-gather, whose backward slices; the
slice's backward all-gathers the gradient), which is how the attention
core runs over heads and the MoE's experts over ``model`` (EP).
:func:`batch_total` sums a count over the batch axes (a loss's
normalisation).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

_ACTIVE: dict = {"axis_names": (), "axis_sizes": {}, "mesh": None}


def activate(mesh) -> None:
    """Make ``mesh`` (a shape-only or a host mesh) the model's mesh."""
    _ACTIVE["axis_names"] = tuple(mesh.axis_names)
    _ACTIVE["axis_sizes"] = {a: int(mesh.shape[a]) for a in mesh.axis_names}
    _ACTIVE["mesh"] = mesh if getattr(mesh, "live", False) else None


def deactivate() -> None:
    _ACTIVE["axis_names"] = ()
    _ACTIVE["axis_sizes"] = {}
    _ACTIVE["mesh"] = None


def batch_axes() -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _ACTIVE["axis_names"])


def axis_size(axes) -> int:
    if not axes:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= _ACTIVE["axis_sizes"].get(a, 1)
    return n


def active() -> bool:
    return bool(_ACTIVE["axis_names"])


def live_mesh():
    """The active mesh when it spans processes (a live host mesh), else
    None."""
    return _ACTIVE["mesh"]


def batch_shards() -> int:
    """How many ranks split the batch: the batch axes' size on a live
    mesh, 1 otherwise (a shape-only mesh holds the whole batch)."""
    return axis_size(batch_axes()) if live_mesh() is not None else 1


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's sharding constraint; a plain local tensor is left
    as it is (see the module docstring)."""
    return x


def residual(x: torch.Tensor) -> torch.Tensor:
    """The reference's sequence-parallel residual layout
    ``P(batch, model, None)``; the port's residual stream stays whole over
    ``model``."""
    if not active() or x.dim() != 3:
        return x
    return constrain(x, batch_axes(), "model", None)


def gathered(x: torch.Tensor) -> torch.Tensor:
    """The reference's layer-entry layout ``P(batch, None, None)``."""
    if not active() or x.dim() != 3:
        return x
    return constrain(x, batch_axes(), None, None)


def attn_heads(t: torch.Tensor) -> torch.Tensor:
    """The reference's TP layout for ``(B, S, H, hd)`` attention tensors:
    heads over ``model`` when divisible (see :func:`over_model`)."""
    if not active() or t.dim() != 4:
        return t
    if t.shape[2] % axis_size("model") == 0:
        return constrain(t, batch_axes(), None, "model", None)
    return constrain(t, batch_axes(), None, None, None)


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch axes of a live mesh (a copy; no
    gradient flows through the sum), ``x`` itself otherwise."""
    mesh = live_mesh()
    if mesh is None:
        return x
    return mesh.all_reduce(x.detach().clone(), batch_axes())


class _Slice(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor every ``model`` rank
    holds whole; the backward gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // mesh.shape["model"]
        return x.narrow(dim, mesh.coords["model"] * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), "model", ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Every ``model`` rank's slice along ``dim``, concatenated; the
    backward takes this rank's slice of the (whole) gradient."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, y.shape[dim]
        return mesh.all_gather(y.contiguous(), "model", dim)

    @staticmethod
    def backward(ctx, g):
        c = ctx.mesh.coords["model"]
        return g.narrow(ctx.dim, c * ctx.n, ctx.n).contiguous(), None, None


def over_model(fn: Callable, *xs: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(*xs)`` computed over ``model``: on a live mesh whose ``model``
    axis divides ``xs[0].shape[dim]``, each rank runs ``fn`` on its slice
    of every ``x`` (whole on every ``model`` rank) along ``dim`` and the
    results are gathered along ``dim``.  Otherwise ``fn(*xs)``."""
    mesh = live_mesh()
    n = mesh.shape["model"] if mesh is not None else 1
    if n == 1 or xs[0].shape[dim] % n:
        return fn(*xs)
    return _Gather.apply(fn(*(_Slice.apply(x, mesh, dim) for x in xs)),
                         mesh, dim)
