"""Train, eval and serve step functions (torch counterpart of
``repro/launch/steps.py``).

``make_train_step(cfg, opt)`` returns the fused step
``(params, opt_state, batch) -> (params, opt_state, metrics)``: the loss
and its gradient (autograd over :func:`repro_torch.models.transformer.loss_fn`)
and the optimizer update, which runs in place (``optim/adamw.py``).
``make_eval_step(cfg)`` returns the loss's metrics without a gradient,
``make_prefill(cfg)`` the prefill and ``make_serve_step(cfg)`` the
one-token decode step.  On a tensor-parallel mesh the serving steps'
logits are this rank's block of the vocabulary and their cache
``cache_specs``' block (``models/transformer.py``).

A training state crosses to checkpoints (and to the reference) as the
reference's tree: :func:`state_tree` stacks every layer-stacked parameter
on the host under the reference's path (``params/layers/attn/wq``; the
hybrid's Mamba layers as ``(n_super, attn_every, ...)``), the
optimizer state is already kept in that shape, and :func:`load_state`
copies such a tree back into a model and its optimizer state.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.checkpoint import manager as CK
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import lm_shard
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (OptConfig, apply_updates,
                                     apply_updates_zero1, init_opt_state)
from repro_torch.roofline import trace_cost as TC


def make_train_step(cfg: ArchConfig, opt: OptConfig) -> Callable:
    """The fused step.  A model placed on a live mesh
    (:func:`repro_torch.distributed.lm_shard.shard`) steps on this rank's
    rows of the whole ``batch`` with gradients in the parameters'
    placements and the ZeRO-1 update; its metrics are the whole batch's
    (summed over the batch axes)."""
    def train_step(params: T.Transformer, opt_state: Dict, batch: Dict):
        sharded = lm_shard.sharded(params)
        if sharded is not None:
            return _mesh_train_step(cfg, opt, sharded, opt_state, batch)
        leaves = params.reference_leaves()
        flat = [p for leaf in leaves.values() for p in leaf.members]
        total, metrics = T.loss_fn(cfg, params, batch)
        grads = _filled(leaves, flat, torch.autograd.grad(
            total, flat, allow_unused=True))
        by_leaf = {k: [next(grads) for _ in leaf.members]
                   for k, leaf in leaves.items()}
        _, opt_state, opt_metrics = apply_updates(opt, leaves, by_leaf,
                                                  opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics,
                                   "total_loss": total.detach()}
    return train_step


def _mesh_train_step(cfg: ArchConfig, opt: OptConfig, sharded, opt_state,
                     batch: Dict):
    params = sharded.model

    def loss_and_grads(p, b):
        # the backward runs while the model holds its gathered weights:
        # remat recomputes its layers from them
        total, metrics = T.loss_fn(cfg, p, b)
        return total, metrics, torch.autograd.grad(total, sharded.flat,
                                                   allow_unused=True)

    total, metrics, grads = sharded.call(loss_and_grads,
                                         sharded.shard_batch(batch))
    grads = _filled(params.reference_leaves(), sharded.flat, grads)
    by_leaf = {k: [next(grads) for _ in leaf.members]
               for k, leaf in params.reference_leaves().items()}
    opt_state, opt_metrics = apply_updates_zero1(opt, sharded, by_leaf,
                                                 opt_state)
    axes = SH.batch_axes(sharded.mesh)
    metrics = {k: sharded.mesh.all_reduce(v.detach().clone(), axes)
               for k, v in {**metrics, "total_loss": total}.items()}
    return params, opt_state, {**metrics, **opt_metrics}


def _filled(leaves, flat, grads):
    """The gradients in ``flat``'s order, zeros where autograd gave none
    (``roofline.trace_cost.missing_grad``: a trace's skipped layers)."""
    owners = [(k, i) for k, leaf in leaves.items()
              for i in range(len(leaf.members))]
    return iter(TC.missing_grad(p, *o) if g is None else g
                for p, o, g in zip(flat, owners, grads))


def make_eval_step(cfg: ArchConfig) -> Callable:
    @torch.no_grad()
    def eval_step(params: T.Transformer, batch: Dict) -> Dict:
        _, metrics = T.loss_fn(cfg, params, batch)
        return metrics
    return eval_step


def _on_mesh(fn: Callable) -> Callable:
    """``fn(params, batch, **kw)``, on a model placed on a live mesh
    through its compute layout (the batch is this rank's rows)."""
    def step(params, batch, **kw):
        sharded = lm_shard.sharded(params)
        if sharded is None:
            return fn(params, batch, **kw)
        with torch.no_grad():
            return sharded.call(lambda m, b: fn(m, b, **kw), batch)
    return step


def make_prefill(cfg: ArchConfig) -> Callable:
    """``prefill(params, batch, s_max=None)``: the cache holds ``s_max``
    positions (``models.transformer.prefill``)."""
    return _on_mesh(lambda params, batch, s_max=None: T.prefill(
        cfg, params, batch, s_max))


def make_serve_step(cfg: ArchConfig) -> Callable:
    return _on_mesh(lambda params, batch: T.decode_step(cfg, params, batch))


def init_all(cfg: ArchConfig, opt: OptConfig, generator: torch.Generator,
             device=None) -> Tuple[T.Transformer, Dict]:
    """A model with random weights from ``generator`` and its zero
    optimizer state, on ``device`` (the generator's by default)."""
    params = T.init_params(cfg, generator, device)
    return params, init_opt_state(opt, params.reference_leaves())


def init_placed(cfg: ArchConfig, mesh, generator: torch.Generator,
                device) -> T.Transformer:
    """:func:`repro_torch.models.transformer.init_params`'s model on a live
    ``mesh``, each parameter cut to this rank's block as soon as its table
    or layer is drawn (the rank never holds the whole model; the weights
    are an unplaced model's blocks)."""
    meta = T.Transformer(cfg, "meta")
    specs = lm_shard.member_specs(cfg, mesh, meta)
    params = T.init_params(cfg, generator, device, place=lambda n, t: (
        SH.local_shard(t, specs[n][1], mesh).clone()))
    lm_shard.shard(cfg, mesh, params, meta)
    return params


def abstract_state(cfg: ArchConfig, opt: OptConfig) -> Tuple[T.Transformer,
                                                              Dict]:
    """(params, opt_state) on the ``meta`` device: shapes and dtypes, no
    allocation."""
    params = T.Transformer(cfg, "meta")
    return params, init_opt_state(opt, params.reference_leaves())


def _host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def state_tree(params: T.Transformer, opt_state: Dict) -> Dict:
    """``{"params", "opt"}`` as CPU tensors in the reference's tree: each
    parameter under its reference path, stacked layers stacked (on the
    host), and the optimizer state as it is kept.  A model placed on a
    live mesh gathers whole tensors (every rank must call it)."""
    sharded = lm_shard.sharded(params)
    if sharded is not None:
        return sharded.state_tree(opt_state)
    flat = {}
    for path, leaf in params.reference_leaves().items():
        flat[path] = leaf.stack([m.detach().cpu() for m in leaf.members])
    return {"params": flat, "opt": _host(opt_state)}


def restore_state(ckpt_dir: str, params: T.Transformer,
                  opt_state: Dict) -> int:
    """Load the latest checkpoint under ``ckpt_dir`` into ``params`` and
    ``opt_state`` in place; returns its step.  A model placed on a live
    mesh reads only its parts of each array
    (:meth:`~repro_torch.distributed.lm_shard.ShardedLM.cut`), whatever
    mesh shape wrote them."""
    sharded = lm_shard.sharded(params)
    start, flat, _ = CK.restore(
        ckpt_dir, part=None if sharded is None else sharded.cut)
    load_state(params, opt_state,
               CK.unflatten_like(state_template(params, opt_state), flat))
    return start


def state_template(params: T.Transformer, opt_state: Dict) -> Dict:
    """:func:`state_tree`'s shapes as ``meta`` tensors, the template
    ``checkpoint.manager.unflatten_like`` rebuilds a restored tree on (a
    model placed on a live mesh: its parts' shapes,
    :meth:`~repro_torch.distributed.lm_shard.ShardedLM.part_template`)."""
    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def tree(x):
        return {k: tree(v) for k, v in x.items()} if isinstance(
            x, dict) else meta(x)

    leaves = params.reference_leaves()
    sharded = lm_shard.sharded(params)
    if sharded is not None:
        return sharded.part_template(opt_state)
    return {"params": {k: torch.empty(v.shape, dtype=v.members[0].dtype,
                                      device="meta")
                       for k, v in leaves.items()},
            "opt": tree(opt_state)}


@torch.no_grad()
def load_state(params: T.Transformer, opt_state: Dict, tree: Dict) -> None:
    """Copy a :func:`state_template`-shaped ``tree`` (any device; for an
    unplaced model, :func:`state_tree`'s shape) into ``params`` and
    ``opt_state`` in place.

    Raises:
        KeyError: the tree lacks a parameter or state entry.
        ValueError: an entry has another shape.
    """
    sharded = lm_shard.sharded(params)
    if sharded is not None:
        sharded.load_state(tree, opt_state)
        return
    for path, leaf in params.reference_leaves().items():
        src = tree["params"][path]
        if tuple(src.shape) != leaf.shape:
            raise ValueError(f"params/{path}: {tuple(src.shape)} != "
                             f"{leaf.shape}")
        for m, x in zip(leaf.members, leaf.unstack(src)):
            m.copy_(x)

    def copy(dst, src, path):
        if isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k], f"{path}/{k}")
        elif tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        else:
            dst.copy_(src)

    copy(opt_state, tree["opt"], "opt")
