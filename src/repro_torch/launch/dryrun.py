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
and reads XLA's memory and cost analysis.  PyTorch has no such compile, so
a record here is computed from the port's own layouts and schedule
(ROADMAP §C2):

  * ``memory.argument_size_in_bytes`` is exact: the bytes of one device's
    blocks (``sharding.shard_bounds`` under the sharding rules' specs) of
    the parameters, the optimizer state (train; ``opt_for`` picks it as
    the reference does), the batch and the cache.  Every device holds
    equal blocks: the rules shard only dims that divide.
    ``temp_size_in_bytes`` is null: no compiler plans the activations.
  * ``flops`` are ``roofline.analysis.model_flops``; a train cell with
    remat adds the recomputed forward (2 N D), which the reference's
    compiled count holds as well.
  * the memory term's bytes are the compulsory ones: every argument read
    once, every output written once (train: parameters and optimizer
    state; prefill: the cache and the last logits; decode: the logits and
    the cache entries the step writes).
  * ``collectives`` are the bytes one device moves in a step of the
    port's LM mesh (``distributed/lm_shard.py``) in the tensor-parallel
    layout, through ``roofline.analysis.collective_bytes``: the gathers
    of the parameters FSDP splits (the 1 T MoE's experts), the gradient
    sums over the batch axes, ZeRO-1's gathers and region sums and the
    gradient norm's sums, or Adafactor's factor sums and gathers and its
    RMS sums (run by the port's own code on ``meta`` tensors over a
    :class:`RecordingMesh`), and, reckoned from the shapes
    (:func:`_model_collectives`), the Megatron-SP gathers and
    reduce-scatters of every attention, MLP and Mamba2 mixer, the
    mixer's gathered ``b`` and ``c``, norm sums and conv exchange, the
    MoE's gathers, the vocabulary-parallel embedding and loss, the
    decode's log-sum-exp over a sequence-split cache (forward, the remat
    recompute, backward), the loss's count and the metrics' sums (a train
    record's ``optimizer_collective_bytes``: the optimizer step's share).  A batch that does not divide over the batch axes is
    held whole by every data rank (the port refuses such a batch on a
    live mesh; only long_500k's batch of 1 is one, and its decode issues
    no batch-sized collective).
  * the 1 T MoE trains with Adafactor (``opt_for``), as the reference's
    does: its train cells count the factors' regions as ``memory``'s
    ``opt`` and Adafactor's step as their collectives.

life-stn96 records the SBBNNLS iteration of the 2-D (voxel x fiber)
partition at Table-9 scale (``distributed/life_shard.py:
life_input_specs``; ``life-stn96-1d`` the 1-D one), its collectives those
of ``make_sharded_step`` (or ``make_sharded_step_1d``), per iteration the
mean of an odd and an even one.  Full-attention archs skip ``long_500k``, as the
reference's do.
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
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig, apply_updates_zero1
from repro_torch.roofline import analysis as RL

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")
TEMP_REASON = ("PyTorch compiles no step: the activations' memory is not "
               "planned ahead, so there is no temp size to read")

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
    reduce-scatter's bytes are their result's)."""

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
            self.collectives.append(("all-reduce",
                                     t.numel() * t.element_size(), n))
        return t

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        n = self.shape[axis]
        if n == 1:
            return t
        shape = list(t.shape)
        shape[dim] //= n
        out = t.new_empty(shape, device="meta")
        self.collectives.append(("reduce-scatter",
                                 out.numel() * out.element_size(), n))
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        n = self.shape[axis]
        if n == 1:
            return t
        self.collectives.append(("all-gather",
                                 t.numel() * t.element_size() * n, n))
        shape = list(t.shape)
        shape[dim] *= n
        return t.new_empty(shape, device="meta")

    def barrier(self) -> None:
        pass


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


def _model_collectives(cfg: ArchConfig, mesh, kind: str, seq: int,
                       batch: int) -> List[Record]:
    """The collectives the model code runs in the tensor-parallel layout
    (``distributed/hints.py``, ``models/layers.py``, ``models/mamba2.py``,
    ``models/transformer.py``), reckoned from the shapes as the code
    runs them: per attention, MLP or Mamba2 mixer the Megatron-SP pair
    (an all-gather of the sequence in, a reduce-scatter of the
    row-parallel partial sums out; on a whole stream Megatron's ``f`` /
    ``g``), the gathered q, k, v columns where heads do not divide, the
    mixer's gathered ``b`` and ``c`` (and ``z`` and ``x`` where its heads
    do not divide), its gated norm's sums of squares, its small leaves'
    gradient sum and its conv state's exchange (prefill, decode), the
    hybrid's gathers at each super-layer's entry and before its tail,
    the MoE's gathers (its input whole, its experts' outputs over
    ``model``), the vocabulary-parallel embedding and cross entropy, the
    norms' parameter sums on a split stream, the decode's log-sum-exp over
    a sequence-split cache, the loss's count and the metrics' sums.  In
    training each layer under remat runs its forward collectives again in
    the backward pass up to its last saved tensor
    (``torch.utils.checkpoint``'s early stop: a block's final
    reduce-scatter or all-reduce is not recomputed)."""
    R, rows = _batch_rows(mesh, batch)
    C = mesh.shape.get("model", 1)
    es = torch.empty((), dtype=cfg.torch_dtype).element_size()
    train = kind == "train"
    S = 1 if kind == "decode" else seq
    out: List[Record] = []

    def ag(n):
        return ("all-gather", int(n), C)

    def rs(n):
        return ("reduce-scatter", int(n), C)

    def ar(n):
        return ("all-reduce", int(n), C)

    tail = []
    if train and R > 1:
        tail.append(("all-reduce", 8, R))           # the loss's int64 count
        tail += [("all-reduce", 4, R)] * 3          # loss, aux, total_loss
    if C == 1:
        return out + tail
    d, V = cfg.d_model, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    split = S % C == 0                               # the stream's
    act = rows * S * d * es
    n_norm = 1 if cfg.norm == "rms" else 2

    def norm_sums(sp):
        """A norm's parameter sums on a split stream, in float32."""
        return [ar(d * 4)] * n_norm if sp else []

    def enter(sp):
        """(forward, backward) of ``hints.column_products``: the input
        all-gathered, its gradient reduce-scattered (or all-reduced)."""
        return ([ag(act)], [rs(act // C)]) if sp else ([], [ar(act)])

    def leave(sp):
        """(forward, backward) of ``hints.residual``."""
        return ([rs(act // C)], [ag(act)]) if sp else ([ar(act)], [])

    def attention(sp):
        ef, eb = enter(sp)
        lf, lb = leave(sp)
        fwd, bwd = list(ef), norm_sums(sp) + eb
        if H % C:
            fwd.append(ag(rows * S * H * hd * es))
            bwd.append(rs(rows * S * H * hd // C * es))
        if KV % C:
            fwd += [ag(rows * S * KV * hd * es)] * 2
            bwd += [rs(rows * S * KV * hd // C * es)] * 2
        if kind == "decode" and KV % C:
            if H % C == 0:
                fwd.append(ag(rows * H * hd * es))
            fwd += [ar(rows * H * 4)] * 2 + [rs(rows * H * hd // C * 4)]
        return fwd + lf, bwd + lb, 0

    def ffn(moe_layer: bool, sp: bool):
        """(forward, backward, forward collectives at its end that a
        remat recompute skips)."""
        if not moe_layer and cfg.d_ff % C == 0:
            ef, eb = enter(sp)
            lf, lb = leave(sp)
            return ef + lf, norm_sums(sp) + eb + lb, len(lf)
        fwd = [ag(act)] if sp else []
        bwd = [ag(act)] if sp else []
        skipped = 0
        if moe_layer:
            if cfg.n_experts % C == 0:
                capacity = MOE.capacity_of(rows * S, cfg.top_k,
                                           cfg.n_experts,
                                           cfg.capacity_factor)
                g = ag(cfg.n_experts * capacity * d * es)
                fwd.append(g)
                bwd.append(g)
            if cfg.n_shared_experts and (cfg.moe_d_ff
                                         * cfg.n_shared_experts) % C == 0:
                fwd.append(ar(act))             # g
                bwd.append(ar(act))             # f
                skipped = 1
        return fwd, bwd, skipped

    def shared_block(sp: bool):
        """The hybrid's shared block on a whole stream: its attention
        between ``f`` and ``g``, its MLP's partial sums reduce-scattered
        onto the split stream (``sp``; ``g`` on a whole one), the stream
        cut to this rank's positions (backward: all-gather)."""
        af, ab, _ = attention(False)
        cut = [ag(act)] if sp else []
        if cfg.d_ff % C:
            return af, ab + cut, 0
        ef, eb = enter(False)
        lf, lb = leave(sp)
        return af + ef + lf, ab + eb + lb + cut, len(lf)

    def mamba(sp: bool):
        """(forward, backward, skipped) of a Mamba2 block on a split
        (``sp``) or whole stream."""
        di, gn, Hs = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, \
            cfg.ssm_heads
        heads = Hs % C == 0
        ef, eb = enter(sp)
        lf, lb = leave(sp)
        cols = rows * S * (2 * gn + (0 if heads else 2 * di)) * es
        fwd, bwd = ef + [ag(cols)], norm_sums(sp) + eb + [rs(cols // C)]
        if heads:                         # the gated norm's sums of squares
            fwd.append(ar(rows * S * 4))
            bwd.append(ar(rows * S * 4))
        # a_log d_skip dt_bias norm_scale conv_b* (and a whole wdt)
        bwd.append(ar((3 * Hs + 2 * di + 2 * gn
                       + (0 if heads else d * Hs)) * 4))
        c_tot = di + 2 * gn
        if kind == "decode":              # the conv window's exchange
            fwd.append(ag(rows * cfg.ssm_conv * c_tot * es))
        elif kind == "prefill":           # the conv state's block
            fwd.append(ag(rows * (cfg.ssm_conv - 1) * c_tot * es))
        return fwd + lf, bwd + lb, len(lf)

    def run(part, remat: bool) -> List[Record]:
        """A layer's forward, and in training its recompute and
        backward."""
        fwd, bwd, skipped = part
        if not train:
            return fwd
        again = fwd[:len(fwd) - skipped] if remat else []
        return fwd + again + bwd

    def block(moe_layer: bool, remat: bool) -> List[Record]:
        af, ab, _ = attention(split)
        ff, fb, skipped = ffn(moe_layer, split)
        return run((af + ff, ab + fb, skipped), remat)

    # the embedding: vocabulary-parallel partial sums, or a whole table
    if cfg.family != "audio":
        if V % C == 0:
            out.append(rs(act // C) if split else ar(act))
            if train and split:
                out.append(ag(act))
        elif train and split:
            out.append(ag(act))
    if train and split and cfg.rope == "learned":
        out.append(ag(act))
    # the layers
    last = split                          # the stream's layout at the head
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        kd = cfg.first_k_dense if cfg.family == "moe" else 0
        for _ in range(kd):
            out += block(False, False)
        for _ in range(cfg.n_layers - kd):
            out += block(cfg.family == "moe", cfg.remat)
    elif cfg.family == "ssm":
        for _ in range(cfg.n_layers):
            out += run(mamba(split), cfg.remat)
    elif cfg.family == "hybrid":
        n_super, n_tail = divmod(cfg.n_layers, cfg.attn_every)
        for _ in range(n_super):
            fwd, bwd = ([ag(act)] if split else []), []
            for _ in range(cfg.attn_every):
                f, b, _ = mamba(False)
                fwd, bwd = fwd + f, bwd + b
            f, b, skipped = shared_block(split)
            out += run((fwd + f, bwd + b, skipped), cfg.remat)
        if n_tail:
            out += [ag(act)] if split else []
            for _ in range(n_tail):
                out += run(mamba(False), False)
            last = False
    # the head and the loss
    vdim = V % C == 0
    if kind == "prefill" and last:
        out.append(ag(rows * C * d * es))           # the last position
    if train:
        cb = max(cfg.n_codebooks, 1)
        if vdim:
            ef, eb = enter(last)
            out += ef + [ar(rows * S * cb * 4)] * 3 + norm_sums(last) + eb
        elif last:
            out.append(ag(act))
    return out + tail


def step_collectives(cfg: ArchConfig, mesh, kind: str, seq: int,
                     batch: int, opt: OptConfig) -> List[Record]:
    """Every collective one device issues in a ``kind`` step (train,
    prefill or decode) of ``batch`` sequences of ``seq`` positions on the
    port's LM mesh of ``mesh``'s shape: ``(kind, bytes, group size)``, as
    ``HostMesh.collectives`` records them (a train step's optimizer
    ``opt``: AdamW or Adafactor)."""
    model, optimizer = _step_parts(cfg, mesh, kind, seq, batch, opt)
    return model + optimizer


def _step_parts(cfg: ArchConfig, mesh, kind: str, seq: int, batch: int,
                opt: OptConfig) -> Tuple[List[Record], List[Record]]:
    """:func:`step_collectives` in two parts: the model's (forward and
    backward) and the optimizer's (train; else none)."""
    rec = RecordingMesh(tuple(mesh.shape.values()), mesh.axis_names)
    meta = T.Transformer(cfg, "meta")
    specs = lm_shard.member_specs(cfg, rec, meta)
    model = T.Transformer(cfg, "meta", place=lambda n, t: SH.local_shard(
        t, specs[n][1], rec).clone())
    sharded = lm_shard.ShardedLM(cfg, rec, model, meta)
    train = kind == "train"
    if train:
        state = sharded.init_opt_state(opt)
    # ShardedLM.call: each parameter gathered into its compute layout (in
    # training every one passes the gather, whose backward sums its
    # gradient over the batch axes)
    for name, p in model.named_parameters():
        gather = sharded.gathers[name]
        if train or any(e is not None for e in gather):
            full = SH.gather_shard(p, gather, rec)
            if train:
                rec.all_reduce(full, SH.batch_axes(rec))
    rec.collectives += _model_collectives(cfg, rec, kind, seq, batch)
    n_model = len(rec.collectives)
    if train:
        grads = {k: [torch.empty_like(m) for m in leaf.members]
                 for k, leaf in model.reference_leaves().items()}
        apply_updates_zero1(opt, sharded, grads, state)
    return rec.collectives[:n_model], rec.collectives[n_model:]


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
    model_records, opt_records = _step_parts(cfg, mesh, kind, seq, batch,
                                             opt)
    records = model_records + opt_records
    parts, out_bytes = _lm_memory(cfg, mesh, shape, kind, opt)
    args = sum(parts.values())
    n_active = cfg.active_param_count()
    mf = RL.model_flops(cfg, shape, seq, batch, kind)
    recompute = (2.0 * n_active * seq * batch
                 if kind == "train" and cfg.remat else 0.0)
    coll = RL.collective_bytes(records)
    r = RL.roofline((mf + recompute) / n_chips, args + out_bytes,
                    coll["total"], n_chips, mf)
    _, rows = _batch_rows(mesh, batch)
    return {
        "status": "ok", **head,
        "optimizer": opt.kind if kind == "train" else None,
        "seconds": round(time.time() - t0, 2),
        "memory": {
            "argument_size_in_bytes": float(args),
            "temp_size_in_bytes": None,
            "temp_size_reason": TEMP_REASON,
            "output_size_in_bytes": float(out_bytes),
            "arguments_by_part": {k: float(v) for k, v in parts.items()},
            "total_bytes_per_device": float(args),
        },
        "flops": {"model": mf, "remat_recompute": recompute,
                  "total": mf + recompute},
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


def life_collectives(mesh, variant: str, meta: Dict[str, int],
                     n_y: int, n_w: int) -> List[Record]:
    """The ``psum``s of an odd and an even SBBNNLS iteration of the port's
    ``make_sharded_step`` (2-D: partial Y over ``model``, partial w over
    the rows, every dot over its operand's axis) or
    ``make_sharded_step_1d`` (1-D: the whole Y and w over the mesh; its
    dots are local), as a mesh records them (float32).  ``n_y`` and
    ``n_w``: the rows of the 1-D step's whole ``b`` and ``w``."""
    from repro_torch.distributed.life_shard import _row_axes
    R = math.prod(mesh.shape[a] for a in _row_axes(mesh))
    C = mesh.shape["model"]
    n_theta = meta["n_theta"]
    if variant == "1d":
        y, w = ("all-reduce", n_y * n_theta * 4, R * C), (
            "all-reduce", n_w * 4, R * C)
        return [y, w, y] + [y, w, y, w]
    y = ("all-reduce", meta["nv_local"] * n_theta * 4, C)
    w = ("all-reduce", meta["nf_local"] * 4, R)
    dot_y, dot_w = ("all-reduce", 4, R), ("all-reduce", 4, C)
    odd = [y, w, y, dot_w, dot_y, dot_y]
    even = [y, w, y, w, dot_y, dot_w, dot_y]
    return [r for r in odd + even if r[2] > 1]


def _lower_life(mesh, shape: str, variant: str = "2d") -> Dict[str, Any]:
    """The paper's own workload: the distributed SBBNNLS iteration at
    Table-9 scale, 2-D (voxel x fiber) or the 1-D coefficient partition
    (the MPI-LiFE analogue)."""
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
    meta = specs.pop("meta")
    held = {k: block_bytes(t, layout[k], mesh) for k, t in specs.items()}
    records = life_collectives(mesh, variant, meta, specs["b"].shape[0],
                               specs["w"].shape[0])
    coll = RL.collective_bytes(records)
    coll = {k: (v / 2 if k != "counts" else {kk: vv / 2 for kk, vv in
                                             v.items()})
            for k, v in coll.items()}
    n_theta = meta["n_theta"]
    mf = 3.5 * 2.0 * sc["nnz"] * n_theta
    # compulsory bytes of an iteration: 2 DSC + 1.5 WC each reading its
    # op's cell arrays, and the dictionary, b and w read once
    op_bytes = {op: sum(held[k] for k in ks) for op, ks in per_op.items()}
    moved = (2 * op_bytes["dsc"] + 1.5 * op_bytes["wc"]
             + held["d"] + held["b"] + held["w"])
    r = RL.roofline(mf / n_chips, moved, coll["total"], n_chips, mf)
    return {
        "status": "ok",
        "arch": "life-stn96" + ("-1d" if variant == "1d" else ""),
        "shape": shape, "variant": variant,
        "mesh": dict(shape=dict(mesh.shape), n_chips=int(n_chips)),
        "kind": "sbbnnls", "seconds": round(time.time() - t0, 2),
        "memory": {
            "argument_size_in_bytes": float(sum(held.values())),
            "temp_size_in_bytes": None,
            "temp_size_reason": TEMP_REASON,
            "total_bytes_per_device": float(sum(held.values())),
        },
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
