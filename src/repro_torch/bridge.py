"""Numpy bridge between the reference package and the port.

The reference's problems, weights and solver states cross into the port as
numpy arrays (``np.asarray`` of the reference's arrays), never by importing
the reference: the port runs where JAX is not installed.  Solver states
cross both ways (:func:`state_from_reference`, :func:`state_to_reference`),
single-subject and stacked.  A test that
holds the two packages against each other builds its problem once, with
the reference, and hands the same arrays to both; the LM side's
parameters cross the same way (:func:`lm_params_from_reference`).
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


def lm_params_from_reference(params, cfg, *, device: DeviceLike = None):
    """The port's model (:class:`repro_torch.models.transformer.MoETransformer`)
    holding the reference's LM parameters.

    ``params`` is the reference's parameter pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): dictionaries keyed as the
    port's modules are, the MoE layers stacked along a leading axis under
    ``"layers"``, the dense prefix a list under ``"prefix"``.

    Raises:
        ValueError: a parameter is missing or has another shape or dtype.
    """
    from repro_torch.models.transformer import MoETransformer
    model = MoETransformer(cfg, resolve_device(device))
    for name, param in model.named_parameters():
        parts = name.split(".")
        try:
            if parts[0] in ("layers", "prefix"):
                node, index = params[parts[0]], int(parts[1])
                if parts[0] == "prefix":
                    node = node[index]
                for key in parts[2:]:
                    node = node[key]
                if parts[0] == "layers":
                    node = np.asarray(node)[index]
            else:
                node = params
                for key in parts:
                    node = node[key]
        except (KeyError, IndexError) as e:
            raise ValueError(f"the reference has no parameter {name}") from e
        t = _tensor_of(node)
        if t.shape != param.shape or t.dtype != param.dtype:
            raise ValueError(f"{name}: reference {tuple(t.shape)} {t.dtype}, "
                             f"port {tuple(param.shape)} {param.dtype}")
        param.data.copy_(t)
    return model
