"""Numpy bridge between the reference package and the port.

The reference's problems, weights and solver states cross into the port as
numpy arrays (``np.asarray`` of the reference's arrays), never by importing
the reference: the port runs where JAX is not installed.  Solver states
cross both ways (:func:`state_from_reference`, :func:`state_to_reference`),
single-subject and stacked.  A test that
holds the two packages against each other builds its problem once, with
the reference, and hands the same arrays to both; the LM side's
parameters and optimizer states cross the same way, both ways
(:func:`lm_params_from_reference`, :func:`lm_params_to_reference`,
:func:`opt_state_from_reference`, :func:`opt_state_to_reference`), in the
reference's stacked tree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sbbnnls import SbbnnlsState
from repro_torch.core.std import PhiTensor
from repro_torch.data.dmri import LifeProblem, problem_stats
from repro_torch.device import DeviceLike, resolve_device


def from_reference(atoms, voxels, fibers, values, n_atoms: int,
                   n_voxels: int, n_fibers: int, dictionary, b, w_true, *,
                   device: DeviceLike = None,
                   grid: Optional[Tuple[int, int, int]] = None) -> LifeProblem:
    """The port's LifeProblem from the numpy arrays of a reference one.

    Index arrays become int32 and the float arrays keep their dtype
    (float32 in the reference's problems)."""
    dev = resolve_device(device)

    def idx(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def flt(a):
        return torch.tensor(np.asarray(a), device=dev)

    phi = PhiTensor(atoms=idx(atoms), voxels=idx(voxels), fibers=idx(fibers),
                    values=flt(values), n_atoms=int(n_atoms),
                    n_voxels=int(n_voxels), n_fibers=int(n_fibers))
    phi.validate()
    return LifeProblem(
        phi=phi, dictionary=flt(dictionary), b=flt(b), w_true=flt(w_true),
        stats=problem_stats(np.asarray(atoms), np.asarray(voxels),
                            int(n_fibers)),
        grid=grid)


def weights_from_reference(w, *, device: DeviceLike = None) -> torch.Tensor:
    """Solver weights (or any float array) of the reference as a tensor."""
    return torch.tensor(np.asarray(w), device=resolve_device(device))


def state_from_reference(w, it, loss, *,
                         device: DeviceLike = None) -> SbbnnlsState:
    """The port's solver state from the arrays of a reference
    ``SbbnnlsState``.

    A single subject's 0-d ``it`` becomes a host int; a stacked (cohort)
    state's ``(S,)`` ``it`` stays a host int32 array, as the port's
    batched solver keeps it.  ``w`` and ``loss`` go to ``device``."""
    dev = resolve_device(device)
    it = np.asarray(it)
    return SbbnnlsState(
        w=torch.tensor(np.asarray(w), device=dev),
        it=int(it) if it.ndim == 0 else it.astype(np.int32),
        loss=torch.tensor(np.asarray(loss), device=dev))


def state_to_reference(state: SbbnnlsState
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(w, it, loss)`` of a port solver state as numpy arrays in the
    reference's dtypes (``it`` int32: 0-d single, ``(S,)`` stacked), to
    build the reference's ``SbbnnlsState`` from."""
    return (to_numpy(state.w), np.asarray(state.it, np.int32),
            to_numpy(state.loss))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bf16 widened to float32, which numpy
    lacks)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _tensor_of(a) -> torch.Tensor:
    """A reference array (numpy; bf16 as ``ml_dtypes.bfloat16``) as a CPU
    tensor of the same dtype, bf16 through its 16-bit pattern."""
    a = np.array(a)                          # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _lookup(tree, path: str):
    """The node of a nested reference tree at ``path`` (``a/b``, ``#i`` a
    list index)."""
    node = tree
    for key in path.split("/"):
        node = node[int(key[1:])] if key.startswith("#") else node[key]
    return node


def _nest(flat: dict) -> dict:
    """A flat ``{path: x}`` as the reference's nested tree: dicts, and a
    list where the keys are ``#i``."""
    out: dict = {}
    for path, x in flat.items():
        node, keys = out, path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = x

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [lists(node[f"#{i}"]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(out)


def lm_params_from_reference(params, cfg, *, device: DeviceLike = None):
    """The port's model (:class:`repro_torch.models.transformer.Transformer`)
    holding the reference's LM parameters.

    ``params`` is the reference's parameter pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): dictionaries keyed as the
    port's modules are, the stacked layers along a leading axis under
    ``"layers"`` (the hybrid's Mamba layers along two, ``(n_super,
    attn_every)``, its remainder under ``"tail"`` and its shared block
    under ``"shared"``), an MoE model's dense prefix a list under
    ``"prefix"``.

    Raises:
        ValueError: a parameter is missing or has another shape or dtype.
    """
    from repro_torch.models.transformer import Transformer
    model = Transformer(cfg, resolve_device(device))
    for path, leaf in model.reference_leaves().items():
        try:
            node = _tensor_of(_lookup(params, path))
        except (KeyError, IndexError) as e:
            raise ValueError(f"the reference has no parameter {path}") from e
        if tuple(node.shape) != leaf.shape or node.dtype != leaf.members[0].dtype:
            raise ValueError(f"{path}: reference {tuple(node.shape)} "
                             f"{node.dtype}, port {leaf.shape} "
                             f"{leaf.members[0].dtype}")
        with torch.no_grad():
            for m, x in zip(leaf.members, leaf.unstack(node)):
                m.copy_(x)
    return model


def lm_params_to_reference(model) -> dict:
    """The model's parameters as the reference's nested tree of numpy
    arrays (stacked layers stacked; bf16 widened to float32)."""
    from repro_torch.launch.steps import state_tree
    return _nest({k: to_numpy(v) for k, v in
                  state_tree(model, {})["params"].items()})


def opt_state_from_reference(opt_state, model, opt_cfg) -> dict:
    """The port's optimizer state (``optim/adamw.py``) for ``model`` from
    the reference's ``opt_state`` with numpy leaves: ``mu``, ``nu`` and
    ``step`` (AdamW) or ``fac`` and ``step`` (Adafactor), on the model's
    device.

    Raises:
        ValueError: an entry is missing or has another shape.
    """
    from repro_torch.optim.adamw import init_opt_state
    state = init_opt_state(opt_cfg, model.reference_leaves())

    def fill(dst, src, path):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], _lookup(src, k), f"{path}/{k}")
            return
        t = _tensor_of(src)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: reference {tuple(t.shape)}, port "
                             f"{tuple(dst.shape)}")
        dst.copy_(t)

    try:
        fill(state, opt_state, "opt")
    except (KeyError, IndexError) as e:
        raise ValueError(f"the reference's state has no entry {e}") from e
    return state


def opt_state_to_reference(opt_state) -> dict:
    """The port's optimizer state as the reference's nested tree of numpy
    arrays (``step`` int32, 0-d)."""
    def conv(x):
        if isinstance(x, dict):
            return _nest({k: conv(v) for k, v in x.items()})
        return to_numpy(x)
    return conv(opt_state)
