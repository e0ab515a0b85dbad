"""The LM on a live ``(data, model)`` mesh: its parameters and optimizer
state placed by the sharding rules, its forward in the tensor-parallel
layout, and the ZeRO-1 update (the LM half of the reference's
``repro/distributed``, which GSPMD partitions from the same rules).

PyTorch has no GSPMD, so the port holds plain local tensors and runs the
collectives the reference's compiler would place:

  * **parameters** are held as this rank's block under ``param_specs``,
    each cut as soon as its layer is drawn (``launch.steps.init_placed``),
    so no rank holds the whole model;
  * **the forward** (:meth:`ShardedLM.call`) runs the model code on each
    parameter in its compute layout
    (:func:`~repro_torch.distributed.sharding.compute_spec`): its block
    over ``model``, which the model computes on in the tensor-parallel
    layout (``distributed/hints.py``; the Mamba2 mixer's too), gathered
    only over the batch axes where the rules put FSDP.  In training every
    parameter passes
    :class:`_GatherParam`, whose backward sums the gradient over the
    batch axes (the data-parallel reduction) and cuts this rank's block,
    so gradients come out in the parameters' placements;
  * **the batch** is split over the batch axes (each data rank its rows,
    each input cut along its batch dim by ``sharding.batch_layout``: a
    vlm's ``positions`` (3, B, S) by dim 1;
    :meth:`ShardedLM.shard_batch`), and every ``model`` rank of a data
    row holds the same rows;
  * **ZeRO-1** (:meth:`ShardedLM.apply_updates`): each leaf of the
    optimizer state is held as this rank's region under
    ``opt_state_specs`` (for a stacked leaf the batch axes usually take
    the layer dim, so a data rank owns whole layers' moments).  AdamW:
    per parameter, the rank gathers the gradient and weight, updates its
    moments' region and the weight's region, and the regions are summed
    over the mesh into the new weight (each element written by one rank,
    zeros elsewhere), of which each rank keeps its block.  Adafactor: its
    factors' row and column sums, and its RMS, span a whole unit, so the
    rank sums them from its gradient block over the ranks that split
    them, gathers the factors (``d + ff`` floats a layer, not the
    weight's ``d * ff``), and updates its own block
    (:meth:`ShardedLM._adafactor_leaf`).

:meth:`ShardedLM.state_tree` gathers a state into the reference's tree of
whole tensors (what checkpoints hold); a restore reads each array and
keeps only this rank's part (:meth:`ShardedLM.cut`), whatever mesh shape
wrote it (the elastic restart), and :meth:`ShardedLM.load_state` copies
the parts in.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.optim.adamw import OptConfig, _chunked, init_opt_state
from repro_torch.roofline import trace_cost as TC


class _GatherParam(torch.autograd.Function):
    """A parameter block gathered over the axes ``spec`` names (into its
    compute layout; none for most); the backward sums the gradient over
    the batch axes and cuts this rank's block again."""

    @staticmethod
    def forward(ctx, local, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return SH.gather_shard(local, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = mesh.all_reduce(g.clone(memory_format=torch.contiguous_format),
                            SH.batch_axes(mesh))
        return SH.local_shard(g, ctx.spec, mesh).contiguous(), None, None


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module call, so ``functional_call`` can
    swap the model's parameters for their gathered forms."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


def _without(spec: P, keep: P) -> P:
    """The axes of ``spec`` that ``keep`` does not hold, per dim."""
    return P(*((tuple(a for a in SH._axes_of(e)
                      if a not in SH._axes_of(keep[i] if i < len(keep)
                                              else None)) or None)
               for i, e in enumerate(spec)))


def member_specs(cfg, mesh, model: nn.Module) -> Dict[str, Tuple[str, P]]:
    """Each parameter's reference path and spec (the stack dims left out)
    by its name in ``model`` (whole shapes: a model on the ``meta`` device
    will do)."""
    leaves = model.reference_leaves()
    specs = SH.param_specs(cfg, mesh, leaves)
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: (path, P(*specs[path][len(leaf.lead):]))
            for path, leaf in leaves.items() for p in leaf.members}


class ShardedLM:
    """A ``Transformer`` whose parameters are replaced by their blocks on
    ``mesh`` (a live :class:`~repro_torch.launch.mesh.HostMesh`).

    ``model`` was drawn already cut (``Transformer``'s ``place`` with
    :func:`member_specs`; ``launch.steps.init_placed``), and ``meta``, the
    same model on the ``meta`` device, gives the whole shapes.

    Raises:
        ValueError: a parameter dim does not divide by its axes (the
            rules only shard divisible dims), or a parameter is not its
            block's shape.
    """

    def __init__(self, cfg, mesh, model: nn.Module, meta: nn.Module):
        self.cfg, self.mesh, self.model = cfg, mesh, model
        self._bound = _Bound(model)
        leaves = meta.reference_leaves()
        self.meta_leaves = leaves
        self._key_specs: Optional[Dict[str, P]] = None
        self.full_shapes = {k: leaf.shape for k, leaf in leaves.items()}
        self.leads = {k: leaf.lead for k, leaf in leaves.items()}
        self.specs = SH.param_specs(cfg, mesh, leaves)
        specs = member_specs(cfg, mesh, meta)
        # parameter name -> the axes it is gathered over to compute
        self.gathers: Dict[str, P] = {
            n: _without(spec, SH.compute_spec(spec))
            for n, (_, spec) in specs.items()}
        shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
        for name, p in model.named_parameters():
            block = tuple(b.stop - b.start for b in SH.shard_bounds(
                shapes[name], specs[name][1], mesh, mesh.coords))
            if tuple(p.shape) != block:
                raise ValueError(f"{name}: placed as {tuple(p.shape)}, its "
                                 f"block is {block}")
        self.flat = [p for leaf in model.reference_leaves().values()
                     for p in leaf.members]

    # -- forward ---------------------------------------------------------
    def call(self, fn: Callable, *args):
        """``fn(model, *args)`` with every parameter in its compute
        layout."""
        full = {}
        for name, p in self.model.named_parameters():
            gather = self.gathers[name]
            full["model." + name] = (_GatherParam.apply(p, gather, self.mesh)
                                     if any(e is not None for e in gather)
                                     or torch.is_grad_enabled() else p)
        return torch.func.functional_call(self._bound, full, (fn, *args))

    def shard_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a whole batch: each input cut along its
        batch dim under ``sharding.batch_layout``'s train specs (dim 0,
        but dim 1 of a vlm's ``positions`` (3, B, S)); a key they do not
        name is cut along dim 0.

        Raises:
            ValueError: the batch does not divide over the batch axes.
        """
        axes = SH.batch_axes(self.mesh)
        n = SH.axis_size(self.mesh, axes)
        # the specs of a batch that divides: each names its batch dim
        specs = SH.batch_layout(self.cfg, self.mesh, "train", n)
        out = {}
        for k, v in batch.items():
            if not isinstance(v, torch.Tensor) or v.dim() == 0:
                out[k] = v
                continue
            spec = specs.get(k, P(axes))
            dim = next(i for i, e in enumerate(spec) if e is not None)
            if v.shape[dim] % n:
                raise ValueError(f"batch {k!r} of {v.shape[dim]} rows does "
                                 f"not divide over {n} data ranks")
            out[k] = SH.local_shard(v, spec, self.mesh)
        return out

    # -- optimizer state -------------------------------------------------
    def opt_shapes(self, opt) -> Dict:
        """The whole state of optimizer ``opt``, in its tree, as ``meta``
        tensors (``optim.adamw.init_opt_state`` on the reference
        leaves)."""
        return init_opt_state(opt, self.meta_leaves)

    def opt_specs(self, opt) -> Dict:
        """``opt_state_specs`` of the whole state of optimizer ``opt``."""
        return SH.opt_state_specs(self.cfg, self.mesh, self.opt_shapes(opt))

    def init_opt_state(self, opt) -> Dict:
        """Zero state of optimizer ``opt`` held as this rank's regions
        under :meth:`opt_specs` (ZeRO-1): AdamW's moments, or
        Adafactor's factors."""
        dev = self.mesh.device

        def zeros(x, spec):
            if isinstance(x, dict):
                return {k: zeros(v, spec[k]) for k, v in x.items()}
            b = SH.shard_bounds(tuple(x.shape), spec, self.mesh,
                                self.mesh.coords)
            return torch.zeros([s.stop - s.start for s in b],
                               dtype=x.dtype, device=dev)

        return zeros(self.opt_shapes(opt), self.opt_specs(opt))

    def _owner_axes(self, spec: P) -> Tuple[str, ...]:
        """Mesh axes ``spec`` does not shard over: ranks that differ only
        along them hold the same region, and the one at coordinate 0
        writes it."""
        used = SH.sharded_axes(spec, self.mesh)
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def grad_norm(self, grads: Dict[str, List[torch.Tensor]]) -> torch.Tensor:
        """The float32 2-norm of the whole gradient from the blocks: each
        leaf's squares summed over the ranks holding distinct blocks."""
        dev = self.mesh.device
        buckets: Dict[Tuple[str, ...], torch.Tensor] = {}
        for path in sorted(grads):
            spec = self.specs[path]
            axes = SH.sharded_axes(spec, self.mesh)
            sq = sum(torch.sum(torch.square(g.float()))
                     for g in _members(grads[path]))
            buckets[axes] = buckets.get(axes, torch.zeros(
                (), dtype=torch.float32, device=dev)) + sq
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for axes in sorted(buckets):
            total = total + self.mesh.all_reduce(buckets[axes], axes)
        return torch.sqrt(total)

    def _all_coords(self):
        coords = [{}]
        for a in self.mesh.axis_names:
            coords = [dict(c, **{a: i}) for c in coords
                      for i in range(self.mesh.shape[a])]
        return coords

    def _aligned(self, full: Tuple[int, ...], k: int, spec: P,
                 ospec: P) -> bool:
        """Whether every rank's moment region of a member lies inside its
        own block of the parameter (then the update needs no gather)."""
        mshape = full[k:]
        for c in self._all_coords():
            region = SH.shard_bounds(full, ospec, self.mesh, c)[k:]
            block = SH.shard_bounds(mshape, spec, self.mesh, c)
            if not all(b.start <= r.start and r.stop <= b.stop
                       for r, b in zip(region, block)):
                return False
        return True

    @torch.no_grad()
    def apply_updates(self, opt, grads: Dict[str, List[torch.Tensor]],
                      state: Dict, update) -> torch.Tensor:
        """ZeRO-1 step: clips ``grads`` (blocks, per path) by the global
        norm, then updates every parameter's block and this rank's state
        regions.  Returns the norm before clipping.

        AdamW (``update(p32, g32, mu, nu, decay) -> new p32``) runs on
        this rank's moment region and rebuilds the weight from every
        rank's region.  Where each rank's region lies in its own block of
        the weight (the experts: both shard the experts over ``model``)
        the gradient and weight are cut locally and the new block is
        summed over the ranks that hold the same block; else the whole
        gradient and weight are gathered and the new weight summed over
        the mesh.

        Adafactor (``update``: an ``optim.adamw.Adafactor``) runs on each
        rank's gradient block (:meth:`_adafactor_leaf`), gathering only
        the factors."""
        gnorm = self.grad_norm(grads)
        scale = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        for gs in grads.values():
            for g in _members(gs):
                g.copy_((g.float() * scale).to(g.dtype))
        mesh = self.mesh
        leaves = self.model.reference_leaves()
        if opt.kind == "adafactor":
            ospecs = self.opt_specs(opt)["fac"]
            for path, leaf in leaves.items():
                self._adafactor_leaf(update, path, leaf, grads[path],
                                     state["fac"][path], ospecs[path])
            return gnorm
        ospecs = self.opt_specs(opt)["mu"]
        for path, leaf in leaves.items():
            k = len(leaf.lead)
            full = self.full_shapes[path]
            spec = P(*self.specs[path][k:])
            ospec = ospecs[path]
            bounds = SH.shard_bounds(full, ospec, mesh, mesh.coords)
            region = bounds[k:]
            writer = all(mesh.coords[a] == 0 for a in self._owner_axes(ospec))
            decay = len(full) >= 2
            aligned = self._aligned(full, k, spec, ospec)
            if aligned:
                block = SH.shard_bounds(full[k:], spec, mesh, mesh.coords)
                rel = tuple(slice(r.start - b.start, r.stop - b.start)
                            for r, b in zip(region, block))
                replicas = tuple(a for a in mesh.axis_names
                                 if a not in SH.sharded_axes(spec, mesh))
            mu_l, nu_l = state["mu"][path], state["nu"][path]

            def owned(i, lead=leaf.lead, bounds=bounds):
                return all(b.start <= j < b.stop
                           for j, b in zip(_unravel(i, lead), bounds))

            for i in TC.classes("zero1.members", range(len(leaf.members)),
                                key=owned):
                p, g = leaf.members[i], grads[path][i]
                idx = _unravel(i, leaf.lead)
                owns = owned(i)
                loc = tuple(j - b.start for j, b in zip(idx, bounds))
                if aligned:
                    new = torch.zeros_like(p)
                    if owns:
                        _update_region(update, p[rel], g[rel], mu_l[loc],
                                       nu_l[loc], decay,
                                       new[rel] if writer else None)
                    mesh.all_reduce(new, replicas)
                    p.copy_(new)
                    continue
                g_full = SH.gather_shard(g, spec, mesh)
                p_full = SH.gather_shard(p.detach(), spec, mesh)
                new = torch.zeros_like(p_full)
                if owns:
                    _update_region(update, p_full[region], g_full[region],
                                   mu_l[loc], nu_l[loc], decay,
                                   new[region] if writer else None)
                mesh.all_reduce(new, mesh.axis_names)
                p.copy_(SH.local_shard(new, spec, mesh))
        return gnorm

    def _adafactor_leaf(self, af, path: str, leaf, grads, fac: Dict,
                        ospecs: Dict) -> None:
        """Adafactor on one reference leaf from this rank's gradient
        blocks, in three passes over them (each in slices of
        :data:`_UPDATE_CHUNK` elements, so no float32 copy of a whole unit
        is kept):

          1. the row and column sums of ``g² + d2`` over the block, summed
             over the axes that shard the summed dim and gathered whole
             over the others; with the old factors gathered whole from
             their regions, every rank computes the new factors whole and
             keeps its regions;
          2. the update ``d`` from the new factors on the block, its
             squares summed per unit (the whole leaf, or one leading slice
             of a chunked one) over the axes that shard the block;
          3. ``d`` again, clipped by its unit's RMS, into the block.

        Ranks holding the same block compute it from the same sums, so
        the replicas stay equal.  A 1-D leaf keeps ``v`` (its update is
        elementwise) and the same RMS."""
        mesh = self.mesh
        full = self.full_shapes[path]
        k = len(leaf.lead)
        sspec = self.specs[path]              # stacked: lead dims whole
        spec = P(*sspec[k:])
        mb = SH.shard_bounds(full[k:], spec, mesh, mesh.coords)
        m = len(mb)
        chunked = _chunked(self.meta_leaves[path])
        n_units = full[0] if chunked else 1
        unit_numel = math.prod(full) // n_units
        decay = len(full) - (1 if chunked else 0) >= 2
        sharded = SH.sharded_axes(spec, mesh)
        if len(full) < 2:                     # v: elementwise
            p, g32 = leaf.members[0], grads[0].float()
            v = af.moment(SH.gather_shard(fac["v"], ospecs["v"], mesh)[mb],
                          af.square(g32))
            d = af.direction(g32, v)
            sq = mesh.all_reduce(torch.sum(torch.square(d)), sharded)
            p.copy_(af.step(p.float(), d, af.rms(sq / unit_numel),
                            decay).to(p.dtype))
            fac["v"].copy_(SH.local_shard(SH.gather_shard(v, spec, mesh),
                                          ospecs["v"], mesh))
            return
        sb = tuple(slice(0, n) for n in leaf.lead) + mb
        bshape = tuple(s.stop - s.start for s in sb)
        dev = mesh.device

        def pieces(t):
            """Slices of ``t``'s dim 0 near :data:`_UPDATE_CHUNK`
            elements (a vector whole)."""
            if t.dim() < 2:
                return [slice(None)]
            step = max(1, _UPDATE_CHUNK // max(1, t[0].numel()))
            return [slice(s, s + step) for s in range(0, t.shape[0], step)]

        def walk(*members):
            """``(idx, g, sl, *members)`` over every member's pieces, in
            order; under a trace two of each size
            (``roofline.trace_cost.classes``: they cost the same)."""
            items = [(idx, g, sl, *rest)
                     for idx, g, *rest in zip(idxs, grads, *members)
                     for sl in pieces(g)]
            return TC.classes("adafactor.pieces", items, key=lambda it: len(
                range(*it[2].indices(it[1].shape[0]))) if it[1].dim() else 0)

        rows = torch.zeros(bshape[:-1], dtype=torch.float32, device=dev)
        cols = torch.zeros(bshape[:-2] + bshape[-1:], dtype=torch.float32,
                           device=dev)
        idxs = [_unravel(i, leaf.lead) for i in range(len(grads))]
        for idx, g, sl in walk():
            g2 = af.square(g[sl].float())
            if m == 1:
                rows[idx] = g2.sum()
                cols[idx[:-1]] += g2
                continue
            rows[idx][sl] = g2.sum(dim=-1)
            if m >= 3:
                cols[idx][sl] = g2.sum(dim=-2)
            else:
                cols[idx] += g2.sum(dim=-2)
        mesh.all_reduce(rows, SH.sharded_axes(P(sspec[-1]), mesh))
        mesh.all_reduce(cols, SH.sharded_axes(P(sspec[-2]), mesh))
        rows = SH.gather_shard(rows, P(*sspec[:-1]), mesh)
        cols = SH.gather_shard(cols, P(*sspec[:-2], sspec[-1]), mesh)
        new = {}
        for key, sums, n in (("vr", rows, full[-1]), ("vc", cols, full[-2])):
            new[key] = af.moment(SH.gather_shard(fac[key], ospecs[key], mesh),
                                 sums / n)
            fac[key].copy_(SH.local_shard(new[key], ospecs[key], mesh))
        del rows, cols
        rfac = af.row_factor(new["vr"])[sb[:-1]]
        vc = new["vc"][sb[:-2] + sb[-1:]]

        def direction(idx, g, sl):
            if m == 1:
                second = rfac[idx] * vc[idx[:-1]]
            else:
                c = vc[idx][sl] if m >= 3 else vc[idx]
                second = rfac[idx][sl][..., None] * c[..., None, :]
            return af.direction(g[sl].float(), second)

        def units(idx, sl, n):
            """The units of a piece: its leading slice's, or (a chunked
            leaf that is not stacked) its rows' over dim 0."""
            if not chunked:
                return slice(0, 1)
            if k:
                return slice(idx[0], idx[0] + 1)
            start = mb[0].start + (sl.start or 0)
            return slice(start, start + n)

        sq = torch.zeros(n_units, dtype=torch.float32, device=dev)
        for idx, g, sl in walk():
            d2 = torch.square(direction(idx, g, sl))
            u = units(idx, sl, d2.shape[0] if d2.dim() else 1)
            if chunked and not k:
                sq[u] += d2.reshape(d2.shape[0], -1).sum(dim=1)
            else:
                sq[u] += d2.sum()
        rms = af.rms(mesh.all_reduce(sq, sharded) / unit_numel)
        for idx, g, sl, p in walk(leaf.members):
            d = direction(idx, g, sl)
            r = rms[units(idx, sl, d.shape[0])]
            r = r.reshape((-1,) + (1,) * (d.dim() - 1)) if (
                chunked and not k) else r[0]
            p[sl] = af.step(p[sl].float(), d, r, decay).to(p.dtype)

    # -- whole trees -------------------------------------------------------
    @torch.no_grad()
    def gather_leaf(self, path: str, leaf=None) -> torch.Tensor:
        """The reference leaf ``path`` as one whole CPU tensor, gathered
        from every rank's blocks (a collective: every rank calls it)."""
        if leaf is None:
            leaf = self.model.reference_leaves()[path]
        spec = P(*self.specs[path][len(leaf.lead):])
        whole = [SH.gather_shard(m.detach(), spec, self.mesh).cpu()
                 for m in leaf.members]
        return (torch.stack(whole).reshape(self.full_shapes[path])
                if leaf.lead else whole[0])

    @torch.no_grad()
    def state_tree(self, opt_state: Dict) -> Dict:
        """``{"params", "opt"}`` as whole CPU tensors in the reference's
        tree (``launch.steps.state_tree``'s), gathered from every rank's
        blocks and regions (a collective: every rank calls it)."""
        mesh = self.mesh
        params = {path: self.gather_leaf(path, leaf) for path, leaf in
                  self.model.reference_leaves().items()}
        ospecs = self.opt_specs(_opt_of(opt_state))

        def walk(x, s):
            if isinstance(x, dict):
                return {k: walk(x[k], s[k]) for k in x}
            return SH.gather_shard(x, s, mesh).cpu()

        return {"params": params, "opt": walk(opt_state, ospecs)}

    def cut(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of the checkpoint array ``key``
        (``params/<path>``, or an optimizer state's ``opt/...``: AdamW's
        ``opt/mu/<path>``, Adafactor's ``opt/fac/<path>/vr``, ``opt/step``):
        a stacked parameter's blocks, stacked, or a state region.  A
        restore keeps only it (``checkpoint.manager.restore``'s ``part``),
        so no rank holds a whole state."""
        if key.startswith("params/"):
            path = key[len("params/"):]
            k = len(self.leads[path])
            spec = P(*((None,) * k + tuple(self.specs[path][k:])))
        else:
            spec = self._state_key_specs()[key]
        return SH.local_shard(whole, spec, self.mesh).clone()

    def _state_key_specs(self) -> Dict[str, P]:
        """The spec of every optimizer state array by its checkpoint key
        (both optimizers' trees flattened as checkpoints key them: a path
        inside such a key holds ``/`` too)."""
        if self._key_specs is None:
            out: Dict[str, P] = {}

            def walk(x, key):
                if isinstance(x, dict):
                    for k, v in x.items():
                        walk(v, f"{key}/{k}")
                else:
                    out[key] = x

            for kind in ("adamw", "adafactor"):
                walk(self.opt_specs(OptConfig(kind=kind)), "opt")
            self._key_specs = out
        return self._key_specs

    def part_template(self, opt_state: Dict) -> Dict:
        """The state tree of :meth:`cut`'s parts as ``meta`` tensors (what
        ``checkpoint.manager.unflatten_like`` rebuilds a restore on)."""
        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        def tree(x):
            return ({k: tree(v) for k, v in x.items()}
                    if isinstance(x, dict) else meta(x.shape, x.dtype))

        params = {}
        for path, leaf in self.model.reference_leaves().items():
            m = leaf.members[0]
            params[path] = meta(tuple(leaf.lead) + tuple(m.shape), m.dtype)
        return {"params": params, "opt": tree(opt_state)}

    @torch.no_grad()
    def load_state(self, tree: Dict, opt_state: Dict) -> None:
        """Copy a tree of this rank's parts (:meth:`part_template`'s, on
        any device) into the parameters' blocks and the moments' regions.

        Raises:
            KeyError: the tree lacks an entry.
            ValueError: an entry has another shape.
        """
        for path, leaf in self.model.reference_leaves().items():
            src = tree["params"][path]
            part = tuple(leaf.lead) + tuple(leaf.members[0].shape)
            if tuple(src.shape) != part:
                raise ValueError(f"params/{path}: {tuple(src.shape)} is not "
                                 f"this rank's {part}")
            for m, x in zip(leaf.members, list(src.reshape(
                    (-1,) + src.shape[len(leaf.lead):]))):
                m.copy_(x)

        def copy(dst, src, path):
            if isinstance(dst, dict):
                for k in dst:
                    copy(dst[k], src[k], f"{path}/{k}")
                return
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{path}: {tuple(src.shape)} is not this "
                                 f"rank's {tuple(dst.shape)}")
            dst.copy_(src)

        copy(opt_state, tree["opt"], "opt")


def _members(items):
    """A leaf's members (or their gradients) in order; under a trace two
    of them, the second standing for the rest
    (``roofline.trace_cost.classes``: they cost the same)."""
    return TC.classes("optimizer.members", items, key=lambda t: None)


#: elements the update takes at a time (its float32 temporaries)
_UPDATE_CHUNK = 1 << 24


def _update_region(update: Callable, p: torch.Tensor, g: torch.Tensor,
                   mu: torch.Tensor, nu: torch.Tensor, decay: bool,
                   out: Optional[torch.Tensor]) -> None:
    """``update`` over a region in slices of its first dim (so its float32
    temporaries stay near :data:`_UPDATE_CHUNK` elements), the new weight
    written into ``out`` unless it is None (the moments update anyway)."""
    if p.dim() == 0:
        new = update(p.float(), g.float(), mu, nu, decay)
        if out is not None:
            out.copy_(new.to(out.dtype))
        return
    step = max(1, _UPDATE_CHUNK // max(1, p[0].numel()))
    for s in range(0, p.shape[0], step):
        sl = slice(s, s + step)
        new = update(p[sl].float(), g[sl].float(), mu[sl], nu[sl], decay)
        if out is not None:
            out[sl] = new.to(out.dtype)


def _unravel(i: int, lead: Tuple[int, ...]) -> Tuple[int, ...]:
    """Member ``i``'s index in a leaf stacked as ``lead`` (row-major)."""
    out = []
    for n in reversed(lead):
        i, r = divmod(i, n)
        out.append(r)
    return tuple(reversed(out))


def _opt_of(state: Dict) -> OptConfig:
    """The optimizer whose state tree ``state`` is."""
    return OptConfig(kind="adafactor" if "fac" in state else "adamw")


def shard(cfg, mesh, model: nn.Module, meta: nn.Module) -> ShardedLM:
    """The :class:`ShardedLM` of ``model``, drawn already cut on ``mesh``
    (``meta``: the same model on the ``meta`` device), which the model
    remembers (:func:`sharded`)."""
    lm = ShardedLM(cfg, mesh, model, meta)
    model.mesh_state = lm
    return lm


def sharded(model: nn.Module) -> Optional[ShardedLM]:
    """The :class:`ShardedLM` a model was placed with, else None."""
    return getattr(model, "mesh_state", None)
