"""Mesh-axis sharding rules: parameters, optimizer state (ZeRO-1), batches,
caches (torch counterpart of ``repro/distributed/sharding.py``).

The rules are pure functions over paths, shapes and a mesh's axis names
and sizes (a :class:`~repro_torch.launch.mesh.ShapeMesh` or a live
:class:`~repro_torch.launch.mesh.HostMesh`), and give the reference's
PartitionSpecs entry for entry, as :class:`P` tuples: one entry per
tensor dim, ``None`` (replicated), an axis name, or a tuple of axis names
(major first).  Axis convention: ``model`` is the TP/EP axis, ``data``
(and ``pod``) the batch/FSDP/ZeRO axes.

  * TP on attention head / FFN feature dims when divisible by ``|model|``;
  * KV projections replicated when their width does not divide (MQA);
  * MoE experts over ``model`` (EP); configs above
    :data:`FSDP_PARAM_THRESHOLD` parameters also shard the experts'
    ``d_model`` dim over the batch axes;
  * ZeRO-1: each optimizer moment takes the batch axes on its first
    divisible dim and ``model`` on the next;
  * caches: batch over the batch axes when divisible, else sequence; KV
    heads over ``model`` when divisible, else sequence over ``model``.

PyTorch has no GSPMD to place collectives from these specs.
:func:`spec_placements` gives DTensor placements (``Shard(i)`` for a mesh
axis named on dim ``i``, ``Replicate()`` for the others), and the port
places tensors itself: :func:`local_shard` cuts this rank's block of a
whole tensor, :func:`gather_shard` rebuilds the whole tensor from the
blocks over a live mesh (``distributed/lm_shard.py`` uses both), and
:func:`compute_spec` names the layout each parameter is computed in.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, SHAPES

FSDP_PARAM_THRESHOLD = 100e9      # params above this FSDP-shard over `data`


class P(tuple):
    """A PartitionSpec: one entry per tensor dim (``None``, an axis name or
    a tuple of axis names, major first); missing trailing entries are
    ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def param_spec(cfg: ArchConfig, mesh, path: str, shape: Tuple[int, ...]) -> P:
    """The spec of one (unstacked) parameter at ``path``."""
    tp = "model" if "model" in mesh.axis_names else None
    tp_n = axis_size(mesh, tp)
    name = path.split("/")[-1]

    def div(dim):
        return tp is not None and shape[dim] % tp_n == 0

    if name in ("embed",):
        return P(tp if div(0) else None, None)
    if name == "lm_head":
        return P(None, tp if div(1) else None)
    if name == "heads":                    # (C, d, V) audio heads
        return P(None, None, tp if div(2) else None)
    if name == "pos_embed":
        return P(None, None)
    if name in ("scale", "bias", "a_log", "d_skip", "dt_bias", "norm_scale",
                "conv_bx", "conv_bb", "conv_bc"):
        return P(*([None] * len(shape)))
    if name == "router":
        return P(None, None)
    if is_expert_weight(path):
        # EP over `model`; the 1T config also FSDP-shards the d_model dim
        # over the batch axes (its parameters cannot fit TP alone)
        fsdp = cfg.param_count() > FSDP_PARAM_THRESHOLD
        baxes = batch_axes(mesh)
        dax: Any = None
        if fsdp and baxes and shape[1] % axis_size(mesh, baxes) == 0:
            dax = baxes if len(baxes) > 1 else baxes[0]
        return P(tp if shape[0] % tp_n == 0 else None, dax, None)
    if name in ("wq", "wk", "wv", "wi", "wi_gate", "wi_up",
                "wz", "wx", "wb", "wc", "wdt"):
        return P(None, tp if div(1) else None)
    if name in ("wo", "out_proj"):
        return P(tp if div(0) else None, None)
    if name in ("bq", "bk", "bv"):
        return P(tp if div(0) else None)
    if name in ("conv_wx", "conv_wb", "conv_wc"):   # (K, C)
        return P(None, tp if div(1) else None)
    return P(*([None] * len(shape)))


def is_expert_weight(path: str) -> bool:
    """A routed expert's weight (``(E, d_in, d_out)``), which shards over
    ``model`` by experts (EP) and is computed on where it lies."""
    return ("moe" in path and "shared" not in path
            and path.split("/")[-1] in ("wi_gate", "wi_up", "wo"))


def stack_dims(cfg: ArchConfig, path: str) -> int:
    """Leading stacked dims of the reference's leaf at ``path``: 1 for
    ``layers/`` and ``tail/``, 2 for the hybrid's ``layers/``."""
    if path.startswith("layers/") or path.startswith("tail/"):
        return 2 if cfg.family == "hybrid" and path.startswith(
            "layers/") else 1
    return 0


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def param_specs(cfg: ArchConfig, mesh, params_shape: Dict[str, Any]
                ) -> Dict[str, P]:
    """Spec per path of the reference's parameter tree on its stacked
    shapes: ``params_shape`` maps each path to a stacked shape or to
    anything with ``.shape`` (``Transformer.reference_leaves()``'s
    :class:`~repro_torch.models.leaves.Leaf` groups, tensors).  The rules
    apply to the dims after the stacked ones, which stay replicated."""
    out = {}
    for path, leaf in params_shape.items():
        shape = _shape(leaf)
        k = stack_dims(cfg, path)
        out[path] = P(*([None] * k),
                      *param_spec(cfg, mesh, path, shape[k:]))
    return out


def opt_state_specs(cfg: ArchConfig, mesh, opt_state_shape: Any) -> Any:
    """ZeRO-1: every moment leaf shards over the batch axes on its first
    divisible dim and over ``model`` on the next (the moment update is
    elementwise, so any dims work, the stacked layer dim included).
    ``opt_state_shape`` is the optimizer state's tree (dicts of tensors
    or shapes); a 0-d leaf (the step) is replicated."""
    baxes = batch_axes(mesh)
    bsize = axis_size(mesh, baxes)
    tp = "model" if "model" in mesh.axis_names else None
    tp_n = axis_size(mesh, tp)

    def widen(leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        parts: list = [None] * len(shape)
        want = [baxes if len(baxes) > 1 else baxes[0]] + ([tp] if tp else [])
        sizes = [bsize] + ([tp_n] if tp else [])
        j = 0
        for i, dim in enumerate(shape):
            if j >= len(want):
                break
            if dim % sizes[j] == 0 and dim >= max(sizes[j], 2):
                parts[i] = want[j]
                j += 1
        return P(*parts)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return widen(tree)

    return walk(opt_state_shape)


# ----------------------------------------------------------------------------
# Batch / cache shardings
# ----------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, mesh, shape_name: str) -> Dict[str, Any]:
    """Specs of a :data:`~repro_torch.configs.base.SHAPES` batch: the
    inputs of ``configs.base.input_specs`` for train and prefill (a vlm's
    ``positions`` (3, B, S) by its dim 1), one token and the cache for
    decode."""
    seq, batch, kind = SHAPES[shape_name]
    return batch_layout(cfg, mesh, kind, batch)


def batch_layout(cfg: ArchConfig, mesh, kind: str, batch: int
                 ) -> Dict[str, Any]:
    """:func:`batch_specs` of a ``kind`` (train, prefill or decode) batch
    of ``batch`` rows: the rows go over the batch axes when they divide,
    else stay whole."""
    baxes = batch_axes(mesh)
    bsize = axis_size(mesh, baxes)
    b_ax = baxes if batch % bsize == 0 else None
    tp = "model" if "model" in mesh.axis_names else None
    tp_n = axis_size(mesh, tp)

    if kind in ("train", "prefill"):
        specs: Dict[str, Any] = {}
        if cfg.family == "audio":
            specs["frame_embeds"] = P(b_ax, None, None)
            if kind == "train":
                specs["codes"] = P(b_ax, None, None)
            return specs
        specs["tokens"] = P(b_ax, None)
        if cfg.family == "vlm":
            specs["image_embeds"] = P(b_ax, None, None)
            specs["positions"] = P(None, b_ax, None)
        if kind == "train":
            specs["labels"] = P(b_ax, None)
        return specs

    # decode: one token + cache
    specs = {"cache_index": P()}
    if cfg.family == "audio":
        specs["frame_embeds"] = P(b_ax, None, None)
    else:
        specs["tokens"] = P(b_ax, None)
    if cfg.family == "vlm":
        specs["positions"] = P(None, b_ax, None)
    cache: Dict[str, Any] = {}
    if cfg.family in ("dense", "moe", "audio", "vlm", "hybrid"):
        kv_div = cfg.n_kv_heads % tp_n == 0 if tp else False
        if b_ax is not None:
            s_ax = None if kv_div else tp
            kv_ax = tp if kv_div else None
            cache["k"] = P(None, b_ax, s_ax, kv_ax, None)
        else:
            # B too small: the sequence takes the batch axes (and model
            # where the KV heads do not divide)
            s_ax = baxes + ((tp,) if (tp and not kv_div) else ())
            kv_ax = tp if kv_div else None
            cache["k"] = P(None, None, s_ax, kv_ax, None)
        cache["v"] = cache["k"]
    if cfg.family in ("ssm", "hybrid"):
        h_div = cfg.ssm_heads % tp_n == 0 if tp else False
        c_tot = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        cache["ssm"] = P(None, b_ax, tp if h_div else None, None, None)
        cache["conv"] = P(None, b_ax, None,
                          tp if c_tot % tp_n == 0 else None)
    specs["cache"] = cache
    return specs


# ----------------------------------------------------------------------------
# Placements
# ----------------------------------------------------------------------------

def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh axis: a
    mesh axis named on tensor dim ``i`` is ``Shard(i)``, any other
    ``Replicate()``.  Where two mesh axes shard one dim, the one earlier
    in ``mesh.axis_names`` (``pod`` before ``data``) is the major one, as
    DTensor orders nested shards."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for i, entry in enumerate(spec):
        for a in _axes_of(entry):
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one "
                                 f"of the mesh's {mesh.axis_names}")
            dim_of[a] = i
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.axis_names)


class MeshSharding(NamedTuple):
    """A spec on a mesh and its DTensor placements (the port's
    NamedSharding)."""
    mesh: Any
    spec: P
    placements: tuple


def logical_to_shardings(mesh, spec_tree: Any) -> Any:
    """Each :class:`P` of ``spec_tree`` as a :class:`MeshSharding`."""
    if isinstance(spec_tree, P):
        return MeshSharding(mesh, spec_tree, spec_placements(spec_tree, mesh))
    if isinstance(spec_tree, dict):
        return {k: logical_to_shardings(mesh, v) for k, v in spec_tree.items()}
    raise TypeError(f"not a spec tree: {type(spec_tree).__name__}")


def _ordered(spec_entry, mesh) -> Tuple[str, ...]:
    """The entry's axes in mesh order (major first)."""
    axes = _axes_of(spec_entry)
    return tuple(a for a in mesh.axis_names if a in axes)


def shard_bounds(shape: Sequence[int], spec: P, mesh,
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` that the rank at ``coords``
    holds under ``spec``: one slice per dim.

    Raises:
        ValueError: a sharded dim does not divide by its axes' size.
    """
    out = []
    for i, n in enumerate(shape):
        axes = _ordered(spec[i] if i < len(spec) else None, mesh)
        if not axes:
            out.append(slice(0, n))
            continue
        parts = axis_size(mesh, axes)
        if n % parts:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {axes} ({parts})")
        idx = 0
        for a in axes:                              # major first
            idx = idx * mesh.shape[a] + coords[a]
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shard(t: torch.Tensor, spec: P, mesh,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a
    view)."""
    coords = mesh.coords if coords is None else coords
    return t[shard_bounds(t.shape, spec, mesh, coords)]


def gather_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole tensor from each rank's block ``t`` under ``spec`` over a
    live mesh: an all-gather per sharded mesh axis, minor axes first."""
    for i in range(len(spec)):
        for a in reversed(_ordered(spec[i], mesh)):
            t = mesh.all_gather(t, a, i)
    return t


def sharded_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The mesh axes ``spec`` shards over, in mesh order."""
    named = {a for entry in spec for a in _axes_of(entry)}
    return tuple(a for a in mesh.axis_names if a in named)


def compute_spec(spec: P) -> P:
    """The layout a parameter is computed in on a live mesh: its block
    over ``model`` (the tensor-parallel layout: column- and row-parallel
    projections, the Mamba2 mixer's column blocks, its convolutions'
    channel blocks and its row-parallel ``out_proj``, vocabulary-parallel
    ``embed``, ``lm_head`` and ``heads``, the QKV biases, the routed
    experts over ``model``).  The batch axes are gathered wherever the
    rules put FSDP (the 1 T MoE's expert ``d_model`` dim);
    ``distributed/lm_shard.py`` gathers them."""
    return P(*((tuple(a for a in _axes_of(entry) if a == "model") or None)
               for entry in spec))
