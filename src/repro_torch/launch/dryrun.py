"""The production dry run: one record per (arch x shape x mesh) cell,
with nothing allocated (torch counterpart of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod \\
      --arch deepseek-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all     # full sweep

Per cell it writes ``results/dryrun/<mesh>/<arch>__<shape>.json`` (or under
``--out``).  The mesh is ``launch/mesh.py:make_production_mesh()``, a
shape-only (16, 16) ``(data, model)`` mesh ("pod") or (2, 16, 16) with
``pod`` ("multipod"); the state is ``launch.steps.abstract_state`` on the
``meta`` device.

The reference lowers and compiles each cell for 512 placeholder devices
and reads XLA's memory and cost analysis, its FLOPs, bytes and
collectives through ``roofline/hlo_cost.py``.  PyTorch compiles nothing;
the port traces the step instead (:func:`trace_step`,
``roofline/trace_cost.py``): the step the cell names
(``steps.make_train_step(cfg, opt_for(cfg))``, ``make_prefill`` or
``make_serve_step``) runs on rank 0's blocks of a model placed on a
:class:`RecordingMesh` of the cell's shape, its batch ``input_specs``'
shapes, all as ``meta`` tensors, the layer stacks, flash attention's
chunk pairs and the SSD's chunks counted by their trip counts:

  * ``memory.argument_size_in_bytes`` is exact: the bytes of one device's
    blocks (``sharding.shard_bounds`` under the sharding rules' specs) of
    the parameters, the optimizer state (train; ``opt_for`` picks it as
    the reference does), the batch and the cache.  Every device holds
    equal blocks: the rules shard only dims that divide.
    ``temp_size_in_bytes`` is the trace's peak (the most bytes alive at
    once among the tensors the step made), and ``total_bytes_per_device``
    temp plus arguments, as the reference's ``_mem_dict``;
  * ``flops.traced`` are the products' FLOPs the trace counts (and B7's),
    beside ``flops.model`` (``roofline.analysis.model_flops``; a train
    cell with remat adds the recomputed forward, 2 N D);
  * ``bytes.traced``: every op's inputs and outputs, beside the
    compulsory bytes (every argument read once, every output written
    once: train, the parameters and optimizer state; prefill, the cache
    and the last logits; decode, the logits and the cache entries the
    step writes);
  * ``collectives`` are the records the mesh took, through
    ``roofline.analysis.collective_bytes`` (``optimizer_collective_bytes``:
    the optimizer step's share); ``loop_multipliers`` the trip counts.
    A batch that does not divide over the batch axes is held whole by
    every data rank (only long_500k's batch of 1 is one; its cache's
    positions split over them and the decode writes rank 0's block);
  * the roofline takes the traced FLOPs, bytes and collectives;
    ``mfu_upper_bound`` keeps ``flops.model`` as its numerator;
  * the 1 T MoE trains with Adafactor (``opt_for``), as the reference's
    does: its train cells count the factors' regions as ``memory``'s
    ``opt`` and Adafactor's step as their collectives.

life-stn96 records trace the SBBNNLS iteration of the 2-D (voxel x
fiber) partition at Table-9 scale (``life-stn96-1d``: the 1-D one),
:func:`trace_life`: the port's ``make_sharded_step`` (or
``make_sharded_step_1d``) runs on rank 0's cell of the operands
``distributed/life_shard.py:life_input_specs`` gives as ``meta`` tensors
(``rank0_operands``), over a :class:`RecordingCellMesh` of the cell's
shape, once as an odd iteration (``it`` 1) and once as an even one (2):

  * ``memory.temp_size_in_bytes`` is the larger of the two traces' peaks
    and ``total_bytes_per_device`` temp plus arguments (rank 0's blocks
    of the cell arrays, ``d``, ``b`` and ``w``);
  * ``flops.traced`` and ``bytes.traced`` are the two traces' mean,
    beside ``flops.model`` (3.5 SpMVs of ``2 nnz Ntheta``) and
    ``bytes.compulsory`` (2 DSC + 1.5 WC each reading its op's cell
    arrays, and ``d``, ``b`` and ``w`` read once);
  * ``collectives`` are the two traces' records, halved (per iteration),
    and the roofline takes the traced FLOPs, bytes and collectives.

Full-attention archs skip ``long_500k``, as the reference's do.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig,
                                      cache_specs, get_config, input_specs,
                                      meta_spec)
from repro_torch.distributed import lm_shard
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import _Mesh
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig, apply_updates_zero1
from repro_torch.roofline import analysis as RL
from repro_torch.roofline import trace_cost as TC

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")

Record = Tuple[str, int, int]


def opt_for(cfg: ArchConfig) -> OptConfig:
    """The reference's choice: the 1 T MoE trains with factored moments."""
    kind = ("adafactor" if cfg.param_count() > SH.FSDP_PARAM_THRESHOLD
            else "adamw")
    return OptConfig(kind=kind)


class RecordingMesh(ShapeMesh):
    """A shape-only mesh that stands in for a live one at the coordinates
    of rank 0: its collectives move nothing (an all-gather returns a
    ``meta`` tensor of the gathered shape) and are recorded as a
    :class:`~repro_torch.launch.mesh.HostMesh` records them, ``(kind,
    bytes of this rank's operand, group size)`` (an all-gather's and a
    reduce-scatter's bytes are their result's), and, under a trace over
    this mesh, counted with the iterations their loop stands for
    (``trace_cost.record_collective``)."""

    live = True

    def __init__(self, shape, axis_names):
        super().__init__(shape, axis_names)
        self.coords = {a: 0 for a in self.axis_names}
        self.device = torch.device("meta")
        self.rank = 0
        self.collectives: List[Record] = []

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        n = self.axes_size(axes)
        if n > 1:
            TC.record_collective(
                self, ("all-reduce", t.numel() * t.element_size(), n), t)
        return t

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        n = self.shape[axis]
        if n == 1:
            return t
        shape = list(t.shape)
        shape[dim] //= n
        TC.record_collective(self, ("reduce-scatter", math.prod(shape)
                                    * t.element_size(), n), t)
        return t.new_empty(shape)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        n = self.shape[axis]
        if n == 1:
            return t
        TC.record_collective(
            self, ("all-gather", t.numel() * t.element_size() * n, n), t)
        shape = list(t.shape)
        shape[dim] *= n
        return t.new_empty(shape)

    def barrier(self) -> None:
        pass


class RecordingCellMesh(_Mesh):
    """The LiFE steps' cell mesh (``distributed/mesh.py``'s interface) at
    rank 0 of a mesh of ``mesh``'s shape: R rows, its row axes' sizes
    multiplied (``pod`` x ``data``, the steps' ``"data"``), C columns
    (``model``).  It holds cell ``(0, 0)`` alone, on ``meta``; a ``psum``
    over a group of more than one is recorded as ``("all-reduce", bytes of
    the part, group size)`` (``trace_cost.record_collective``) and
    returns the part, as a collective's output."""

    def __init__(self, mesh):
        from repro_torch.distributed.life_shard import _row_axes
        super().__init__(math.prod(mesh.shape[a] for a in _row_axes(mesh)),
                         mesh.shape["model"])
        self.cells = ((0, 0),)
        self.device = torch.device("meta")

    def device_of(self, r: int, c: int) -> torch.device:
        return self.device

    def psum(self, parts: Dict[Tuple[int, int], torch.Tensor], axis) -> Dict:
        n = self.group_size(axis)
        x = parts[(0, 0)]
        if n > 1:
            TC.record_collective(
                self, ("all-reduce", x.numel() * x.element_size(), n), x)
        return {self._key((0, 0), axis): x}


# ----------------------------------------------------------------------------
# bytes per device
# ----------------------------------------------------------------------------

def _zero(mesh) -> Dict[str, int]:
    return {a: 0 for a in mesh.axis_names}


def block_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of one device's block of ``t`` under ``spec``."""
    b = SH.shard_bounds(tuple(t.shape), spec, mesh, _zero(mesh))
    return math.prod(s.stop - s.start for s in b) * t.element_size()


def tree_bytes(tree: Any, specs: Any, mesh) -> int:
    """:func:`block_bytes` summed over a tree of tensors and its specs."""
    if isinstance(tree, dict):
        return sum(tree_bytes(tree[k], specs[k], mesh) for k in tree)
    return block_bytes(tree, specs, mesh)


def param_tree(params: T.Transformer) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree as ``meta`` tensors (stacked)."""
    return {k: meta_spec(leaf.shape, leaf.members[0].dtype)
            for k, leaf in params.reference_leaves().items()}


# ----------------------------------------------------------------------------
# the LM mesh step's collectives
# ----------------------------------------------------------------------------

def _batch_rows(mesh, batch: int) -> Tuple[int, int]:
    """(the batch axes' size R, the rows a data rank holds)."""
    R = SH.axis_size(mesh, SH.batch_axes(mesh))
    return R, batch // R if batch % R == 0 else batch


def _placed(cfg: ArchConfig, rec: "RecordingMesh"):
    """Rank 0's model on ``rec`` (``meta``), placed as
    ``steps.init_placed`` places it."""
    meta = T.Transformer(cfg, "meta")
    specs = lm_shard.member_specs(cfg, rec, meta)
    model = T.Transformer(cfg, "meta", place=lambda n, t: SH.local_shard(
        t, specs[n][1], rec).clone())
    return model, lm_shard.shard(cfg, rec, model, meta)


def step_batch(cfg: ArchConfig, rec, kind: str, seq: int, batch: int
               ) -> Dict[str, Any]:
    """A ``kind`` step's batch of ``batch`` rows and ``seq`` positions as
    ``meta`` tensors: the whole batch for train (the step takes its rows)
    and off a mesh (``rec`` None), else rank 0's block
    (``sharding.batch_layout``; the cache's block of ``cache_specs``); the
    decode's ``cache_index`` is the cache's last position (its block's,
    where the positions split over the batch axes)."""
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    b = input_specs(cfg, shape, {"seq_len": seq, "global_batch": batch})
    if kind == "decode":
        b["cache_index"] = seq - 1
    if kind == "train" or rec is None:
        return b
    specs = SH.batch_layout(cfg, rec, kind, batch)

    def local(t, spec):
        if isinstance(t, dict):
            return {k: local(v, spec[k]) for k, v in t.items()}
        return SH.local_shard(t, spec, rec) if isinstance(
            t, torch.Tensor) else t

    out = {k: local(v, specs[k]) if k in specs else v for k, v in b.items()}
    if kind == "decode" and "k" in out["cache"] and any(
            a in SH.batch_axes(rec) for a in _axes(specs["cache"]["k"][2])):
        # a batch that does not divide: the cache's positions split over
        # the batch axes, the new one in this rank's block
        out["cache_index"] = out["cache"]["k"].shape[2] - 1
    return out


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def trace_step(cfg: ArchConfig, kind: str, seq: int, batch: int,
               mesh=None, opt: Optional[OptConfig] = None, *,
               cut: bool = True) -> TC.TraceCost:
    """The traced cost (``roofline/trace_cost.py``) of one ``kind`` step
    (train with ``opt``, ``opt_for``'s by default; prefill; decode) of
    ``batch`` rows of ``seq`` positions: on rank 0 of a mesh of ``mesh``'s
    shape (over a :class:`RecordingMesh`), or on one device, unplaced,
    without ``mesh``.  ``cut=False``: every iteration traced
    (``trace_cost.analyze``)."""
    from repro_torch.distributed import hints
    opt = opt or opt_for(cfg)
    rec = None if mesh is None else RecordingMesh(
        tuple(mesh.shape.values()), mesh.axis_names)
    saved = dict(hints._ACTIVE)
    if rec is not None:
        hints.activate(rec)
    try:
        if rec is None:
            model, state = ST.abstract_state(cfg, opt)
        else:
            model, sharded = _placed(cfg, rec)
            state = sharded.init_opt_state(opt) if kind == "train" else None
        b = step_batch(cfg, rec, kind, seq, batch)
        if kind == "train":
            for p in model.parameters():
                p.requires_grad_(True)
            fn = lambda: ST.make_train_step(cfg, opt)(model, state, b)
        elif kind == "prefill":
            fn = lambda: ST.make_prefill(cfg)(model, b)
        else:
            fn = lambda: ST.make_serve_step(cfg)(model, b)
        return TC.analyze(fn, n_chips=1 if rec is None else rec.size,
                          mesh=rec, cut=cut)
    finally:
        hints._ACTIVE.update(saved)


def step_collectives(cfg: ArchConfig, mesh, kind: str, seq: int,
                     batch: int, opt: OptConfig) -> List[Record]:
    """Every collective one device issues in a ``kind`` step (train,
    prefill or decode) of ``batch`` sequences of ``seq`` positions on the
    port's LM mesh of ``mesh``'s shape: ``(kind, bytes, group size)``, as
    ``HostMesh.collectives`` records them (a train step's optimizer
    ``opt``: AdamW or Adafactor), from a trace of the step
    (:func:`trace_step`)."""
    return trace_step(cfg, kind, seq, batch, mesh, opt).records


def optimizer_collectives(cfg: ArchConfig, mesh, opt: OptConfig
                          ) -> List[Record]:
    """The collectives of the optimizer's step alone (ZeRO-1's AdamW or
    Adafactor on rank 0 of ``mesh``'s shape), traced."""
    rec = RecordingMesh(tuple(mesh.shape.values()), mesh.axis_names)
    model, sharded = _placed(cfg, rec)
    state = sharded.init_opt_state(opt)
    grads = {k: [torch.empty_like(m) for m in leaf.members]
             for k, leaf in model.reference_leaves().items()}
    return TC.analyze(apply_updates_zero1, opt, sharded, grads, state,
                      mesh=rec).records


def _step_parts(cfg: ArchConfig, mesh, kind: str, seq: int, batch: int,
                opt: OptConfig) -> Tuple[List[Record], List[Record]]:
    """:func:`step_collectives` in two parts: the model's (forward and
    backward, the loss and the metrics) and the optimizer's (train; else
    none)."""
    model = step_collectives(cfg, mesh, kind, seq, batch, opt)
    if kind != "train":
        return model, []
    optimizer = optimizer_collectives(cfg, mesh, opt)
    n = len(optimizer)
    for i in range(len(model) - n, -1, -1):   # the step runs it once
        if model[i:i + n] == optimizer:
            return model[:i] + model[i + n:], optimizer
    raise ValueError("the optimizer's collectives are not a run of the "
                     "step's")


# ----------------------------------------------------------------------------
# cells
# ----------------------------------------------------------------------------

def _lm_memory(cfg: ArchConfig, mesh, shape: str, kind: str, opt):
    """(arguments by part, outputs) in bytes per device."""
    seq, batch, _ = SHAPES[shape]
    params, opt_state = ST.abstract_state(cfg, opt)
    ptree = param_tree(params)
    parts = {"params": tree_bytes(ptree, SH.param_specs(cfg, mesh, ptree),
                                  mesh)}
    if kind == "train":
        parts["opt"] = tree_bytes(opt_state, SH.opt_state_specs(
            cfg, mesh, opt_state), mesh)
    bspecs = SH.batch_specs(cfg, mesh, shape)
    bmeta = input_specs(cfg, shape)
    cache = bmeta.pop("cache", None)
    cspecs = bspecs.pop("cache", None)
    parts["batch"] = tree_bytes(bmeta, bspecs, mesh)
    if cache is not None:
        parts["cache"] = tree_bytes(cache, cspecs, mesh)
    _, rows = _batch_rows(mesh, batch)
    es = cfg.torch_dtype.itemsize
    logits = rows * max(cfg.n_codebooks, 1) * cfg.vocab_size * es
    if kind == "train":
        out = parts["params"] + parts["opt"]
    elif kind == "prefill":
        kv = cache_specs(cfg, batch, seq, meta_spec, cfg.torch_dtype)
        out = logits + tree_bytes(kv, SH.batch_layout(
            cfg, mesh, "decode", batch)["cache"], mesh)
    else:
        out = logits
        for k, t in cache.items():
            b = block_bytes(t, cspecs[k], mesh)
            if k in ("k", "v"):       # one position of the block's
                local = SH.shard_bounds(tuple(t.shape), cspecs[k], mesh,
                                        _zero(mesh))[2]
                b //= local.stop - local.start
            out += b
    return parts, out


def lower_cell(arch: str, shape: str, mesh, *,
               variant: str = "base") -> Dict[str, Any]:
    """One cell's record (see the module docstring)."""
    if arch.startswith("life-stn96"):
        return _lower_life(mesh, shape,
                           variant="1d" if arch.endswith("-1d") else "2d")
    cfg = get_config(arch)
    if not cfg.supports(shape):
        return {"status": "skipped",
                "reason": "full-attention arch at 500k context "
                          "(DESIGN.md §4)"}
    seq, batch, kind = SHAPES[shape]
    opt = opt_for(cfg)
    n_chips = mesh.size
    t0 = time.time()
    head = {"arch": arch, "shape": shape, "variant": variant,
            "mesh": dict(shape=dict(mesh.shape), n_chips=int(n_chips)),
            "kind": kind}
    cost = trace_step(cfg, kind, seq, batch, mesh, opt)
    opt_records = (optimizer_collectives(cfg, mesh, opt) if kind == "train"
                   else [])
    parts, out_bytes = _lm_memory(cfg, mesh, shape, kind, opt)
    args = sum(parts.values())
    n_active = cfg.active_param_count()
    mf = RL.model_flops(cfg, shape, seq, batch, kind)
    recompute = (2.0 * n_active * seq * batch
                 if kind == "train" and cfg.remat else 0.0)
    coll = RL.collective_bytes(cost.records)
    r = RL.roofline(cost.flops, cost.bytes_accessed, coll["total"], n_chips,
                    mf)
    _, rows = _batch_rows(mesh, batch)
    return {
        "status": "ok", **head,
        "optimizer": opt.kind if kind == "train" else None,
        "seconds": round(time.time() - t0, 2),
        "trace_seconds": round(cost.seconds, 2),
        "memory": {
            "argument_size_in_bytes": float(args),
            "temp_size_in_bytes": cost.peak_temp_bytes,
            "output_size_in_bytes": float(out_bytes),
            "arguments_by_part": {k: float(v) for k, v in parts.items()},
            "total_bytes_per_device": cost.peak_temp_bytes + float(args),
        },
        "flops": {"model": mf, "remat_recompute": recompute,
                  "total": mf + recompute, "traced": cost.flops},
        "bytes": {"compulsory": float(args + out_bytes),
                  "traced": cost.bytes_accessed},
        "loop_multipliers": cost.loops,
        "collectives": coll,
        "optimizer_collective_bytes": (
            RL.collective_bytes(opt_records)["total"] if kind == "train"
            else None),
        "roofline": r.as_dict(),
        "mfu_upper_bound": RL.mfu_fraction(r, n_chips, kind),
        "params": cfg.param_count(),
        "active_params": n_active,
        "rows_per_data_rank": rows,
    }


#: the connectome per shape (the reference's Table-9 scales)
LIFE_SCALES = {
    "train_4k": dict(n_fibers=500_000, nnz=400_000_000),   # iFOD1 500k
    "prefill_32k": dict(n_fibers=250_000, nnz=190_000_000),
    "decode_32k": dict(n_fibers=100_000, nnz=100_000_000),
    "long_500k": dict(n_fibers=50_000, nnz=50_000_000),
}


def trace_life(mesh, variant: str, operands: dict, it: int
               ) -> TC.TraceCost:
    """The traced cost (``roofline/trace_cost.py``) of SBBNNLS iteration
    ``it`` (odd: one WC, even: two) of the port's ``make_sharded_step``
    (``variant`` "2d") or ``make_sharded_step_1d`` ("1d") on rank 0 of a
    mesh of ``mesh``'s shape (a :class:`RecordingCellMesh`), over
    ``operands``: rank 0's, as ``life_shard.rank0_operands`` or
    ``sharded_state`` give them (the 1-D step's cells under ``cells``),
    each tensor replaced by a ``meta`` one (``life_shard.without_data``)."""
    from repro_torch.distributed import life_shard as LS
    rec = RecordingCellMesh(mesh)
    ops = LS.without_data(operands)
    if variant == "1d":
        step = LS.make_sharded_step_1d(rec, {})
        args = (ops["cells"], ops["b"], ops["w"])
    else:
        step = LS.make_sharded_step(rec, {})
        args = (ops["dsc"], ops["wc"], ops["b"], ops["w"])
    return TC.analyze(step, *args, it, n_chips=mesh.size, mesh=rec)


def _lower_life(mesh, shape: str, variant: str = "2d") -> Dict[str, Any]:
    """The paper's own workload: the distributed SBBNNLS iteration at
    Table-9 scale, 2-D (voxel x fiber) or the 1-D coefficient partition
    (the MPI-LiFE analogue), traced (the module docstring)."""
    from repro_torch.distributed import life_shard as LS
    from repro_torch.distributed.sharding import P
    sc = LIFE_SCALES[shape]
    n_chips = mesh.size
    t0 = time.time()
    rows = LS._row_axes(mesh)
    if variant == "1d":
        specs = LS.life_input_specs_1d(mesh, **sc)
        all_axes = rows + ("model",)
        cell = P(all_axes, None)
        layout = {"a": cell, "v": cell, "fi": cell, "vals": cell,
                  "d": P(None, None), "b": P(None, None), "w": P(None),
                  "it": P()}
        per_op = {"dsc": ("a", "v", "fi", "vals"),
                  "wc": ("a", "v", "fi", "vals")}
    else:
        specs = LS.life_input_specs(mesh, **sc)
        cell = P(rows, "model", None)
        layout = {k: cell for k in ("da", "dv", "df", "dw", "wa", "wv",
                                    "wf", "ww")}
        layout.update(d=P(None, None), b=P(rows, None), w=P("model"),
                      it=P())
        per_op = {"dsc": ("da", "dv", "df", "dw"),
                  "wc": ("wa", "wv", "wf", "ww")}
    operands = LS.rank0_operands(specs, variant)
    meta = specs.pop("meta")
    held = {k: block_bytes(t, layout[k], mesh) for k, t in specs.items()}
    odd, even = (trace_life(mesh, variant, operands, it) for it in (1, 2))
    coll = RL.collective_bytes(odd.records + even.records)
    coll = {k: (v / 2 if k != "counts" else {kk: vv / 2 for kk, vv in
                                             v.items()})
            for k, v in coll.items()}
    mf = 3.5 * 2.0 * sc["nnz"] * meta["n_theta"]
    op_bytes = {op: sum(held[k] for k in ks) for op, ks in per_op.items()}
    moved = (2 * op_bytes["dsc"] + 1.5 * op_bytes["wc"]
             + held["d"] + held["b"] + held["w"])
    flops = (odd.flops + even.flops) / 2
    traced = (odd.bytes_accessed + even.bytes_accessed) / 2
    temp = max(odd.peak_temp_bytes, even.peak_temp_bytes)
    args = float(sum(held.values()))
    r = RL.roofline(flops, traced, coll["total"], n_chips, mf)
    return {
        "status": "ok",
        "arch": "life-stn96" + ("-1d" if variant == "1d" else ""),
        "shape": shape, "variant": variant,
        "mesh": dict(shape=dict(mesh.shape), n_chips=int(n_chips)),
        "kind": "sbbnnls", "seconds": round(time.time() - t0, 2),
        "trace_seconds": round(odd.seconds + even.seconds, 2),
        "memory": {
            "argument_size_in_bytes": args,
            "temp_size_in_bytes": temp,
            "total_bytes_per_device": temp + args,
        },
        "flops": {"model": mf, "traced": flops},
        "bytes": {"compulsory": float(moved), "traced": traced},
        "collectives": coll,
        "roofline": r.as_dict(),
        "scale": sc,
    }


def run_cell(arch: str, shape: str, mesh_kind: str,
             out_dir: Optional[str] = None) -> Dict[str, Any]:
    """Record one cell into ``<out_dir>/<mesh_kind>/<arch>__<shape>.json``
    (an exception is recorded, and the sweep goes on)."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    try:
        rec = lower_cell(arch, shape, mesh)
    except Exception as e:  # noqa: BLE001 — recorded, sweep continues
        rec = {"status": "error", "arch": arch, "shape": shape,
               "error": repr(e), "traceback": traceback.format_exc()}
    rec.setdefault("arch", arch)
    rec.setdefault("shape", shape)
    rec["mesh_kind"] = mesh_kind
    rec["package"] = "repro_torch"
    d = os.path.join(out_dir or RESULTS_DIR, mesh_kind)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{arch}__{shape}.json"), "w") as f:
        json.dump(rec, f, indent=2, default=float)
    return rec


def main(argv=None) -> int:
    """Run the cells; returns 1 if a cell failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or args.shape is None) else (
        args.shape,)
    meshes = ("pod", "multipod") if args.all else (args.mesh,)
    failures = 0
    for mk in meshes:
        for a in archs:
            for s in shapes:
                t0 = time.time()
                rec = run_cell(a, s, mk, args.out)
                dt = time.time() - t0
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    mem = rec["memory"]["total_bytes_per_device"] / 1e9
                    coll = rec["collectives"]["total"] / 1e9
                    extra = (f" dominant={r['dominant']}"
                             f" bound={r['bound_s']:.4f}s mem={mem:.2f}GB"
                             f" coll={coll:.3f}GB")
                elif status == "error":
                    failures += 1
                    extra = " " + rec["error"][:120]
                print(f"[{mk}] {a:24s} {s:12s} {status:7s} {dt:6.1f}s{extra}",
                      flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
