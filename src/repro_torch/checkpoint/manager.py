"""Checkpoint manager: atomic save, restore, retention.

Torch counterpart of ``repro/checkpoint/manager.py``, with its on-disk
layout: ``<dir>/step_<N:010d>/arrays.npz`` + ``manifest.json``, written to
a ``.tmp`` sibling and renamed into place, so a crash mid-save never
corrupts the latest checkpoint.  Either package restores what the other
wrote.

A tree is walked as the reference's ``jax.tree_util`` walks it, and its
leaves are keyed by the same path text: a dict key is its text, a list or
tuple item ``#<i>``, a NamedTuple field ``.<name>``, joined by ``/``
(``job0/.w``, ``stacked/#1/.loss``).  ``None`` has no leaves.  A tensor is
written as a numpy array; a host ``int`` (the port solver's iteration
counter) as a 0-d int32 array, as the reference writes its counter.
bfloat16 and float8 leaves, which ``.npz`` cannot hold, are written as
``uint16`` / ``uint8`` bit views with their dtype name in the manifest.

Restore returns torch CPU tensors (the reference returns numpy arrays),
viewing those leaves back as ``torch.bfloat16`` and the like;
:func:`place` moves a restored tree to a device, or reshards it under a
mesh: each rank takes its blocks of the whole tensors.  A sharded state
is saved whole (``distributed/lm_shard.py`` gathers it), so files cross
between mesh shapes and between the packages.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

SEP = "/"

#: dtype name -> (torch dtype, the unsigned integer type of its bit view);
#: numpy has no such dtypes, so .npz holds the bit views
_EXTENDED_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}
_EXTENDED_NAMES = {t: name for name, (t, _) in _EXTENDED_DTYPES.items()}
#: bit-view type -> the integer types of that width torch and numpy share
_SHARED_INT = {np.uint16: (torch.int16, np.int16),
               np.uint8: (torch.uint8, np.uint8)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's flattening order: dict keys
    sorted, sequences and NamedTuple fields in order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, path + (f"#{i}",))
    else:
        yield SEP.join(path), tree


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the array .npz holds and the dtype name the manifest
    records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _EXTENDED_NAMES.get(t.dtype)
        if name is not None:
            bits = _EXTENDED_DTYPES[name][1]
            shared = _SHARED_INT[bits][0]
            return t.contiguous().view(shared).numpy().view(bits), name
        arr = t.numpy()
    elif isinstance(leaf, (bool, np.bool_)):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        flat[key], dtypes[key] = _to_numpy(leaf)
    return flat, dtypes


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A restored array as a CPU tensor, bit views back in their dtype."""
    if dtype_name in _EXTENDED_DTYPES:
        target, bits = _EXTENDED_DTYPES[dtype_name]
        shared = _SHARED_INT[bits][1]
        return torch.from_numpy(np.array(arr.view(shared))).view(target)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree: Any,
         meta: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
    """Atomic checkpoint write; prunes to the most recent ``keep`` steps.

    Saving a step that already exists replaces it without destroying the
    old snapshot before the new one is in place: the existing directory is
    renamed aside to ``.old``, the new one renamed in, then the old
    removed.  A crash anywhere in that window leaves a complete snapshot
    on disk (``.old`` and ``.tmp`` are not steps to :func:`all_steps` and
    :func:`restore`)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, dtypes = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"step": step, "n_arrays": len(flat),
                "bytes": int(sum(a.nbytes for a in flat.values())),
                "dtypes": dtypes,
                **(meta or {})}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    shutil.rmtree(old, ignore_errors=True)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    """Completed checkpoint steps only: in-flight ``.tmp`` and replaced
    ``.old`` directories are not steps."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        suffix = name[len("step_"):]
        if name.startswith("step_") and suffix.isdigit():
            out.append(int(suffix))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, *, part=None
            ) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, Any]]:
    """Returns (step, flat CPU tensors keyed by path, manifest).
    ``part(key, tensor) -> tensor`` keeps only part of each array as it
    is read (a mesh rank's block: one whole array is held at a time)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {}
        for k in z.files:
            flat[k] = _to_tensor(z[k], dtypes.get(k, ""))
            if part is not None:
                flat[k] = part(k, flat[k])
    return step, flat, manifest


def load_latest(ckpt_dir: str
                ) -> Optional[Tuple[int, Dict[str, torch.Tensor],
                                    Dict[str, Any]]]:
    """:func:`restore` of the latest step, or None when no checkpoint
    exists (a cold start is not an error)."""
    if latest_step(ckpt_dir) is None:
        return None
    return restore(ckpt_dir)


def restore_job(ckpt_dir: str, job_id: str, step: Optional[int] = None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """One job's solver arrays and manifest meta from a service snapshot.

    Reads a checkpoint whose arrays are keyed ``<job_id>/<leaf>`` with
    per-job metadata under the manifest's ``jobs`` map (the reference's
    ``LifeService`` layout) and extracts one job.

    Returns:
        ``(arrays, meta)``: arrays keyed by leaf name (``w``, ``it``,
        ``loss``, optionally ``losses``), meta the job's manifest entry.

    Raises:
        KeyError: when the job is not in the snapshot.
        FileNotFoundError: when no checkpoint exists.
    """
    _, flat, manifest = restore(ckpt_dir, step)
    meta = manifest.get("jobs", {}).get(job_id)
    if meta is None:
        known = sorted(manifest.get("jobs", {}))
        raise KeyError(f"job {job_id!r} not in checkpoint (has {known})")
    prefix = job_id + SEP
    arrays = {k[len(prefix):]: v for k, v in flat.items()
              if k.startswith(prefix)}
    return arrays, meta


def _shape(leaf: Any) -> tuple:
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
        return tuple(leaf.shape)
    return ()                      # a host scalar


def _rebuild(template: Any, flat: Dict[str, torch.Tensor],
             path: Tuple[str, ...]) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, path + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            _rebuild(getattr(template, n), flat, path + (f".{n}",))
            for n in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(x, flat, path + (f"#{i}",))
                              for i, x in enumerate(template))
    key = SEP.join(path)
    if key not in flat:
        raise KeyError(f"checkpoint missing array {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != _shape(template):
        raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                         f"expected {_shape(template)}")
    if isinstance(template, np.ndarray):
        return arr.numpy().astype(template.dtype, copy=True)
    if isinstance(template, (bool, int, float)):
        return type(template)(arr.item())
    return arr


def unflatten_like(template: Any, flat: Dict[str, torch.Tensor]) -> Any:
    """Rebuild a tree shaped like ``template`` from restored arrays.

    A tensor leaf of the template comes back as the restored CPU tensor, a
    numpy leaf as a numpy array of the template's dtype (the batched
    solver's host counters), a host scalar as a scalar of its type.

    Raises:
        KeyError: an array the template needs is missing.
        ValueError: an array's shape differs from the template's.
    """
    return _rebuild(template, flat, ())


def place(tree: Any, shardings) -> Any:
    """``tree`` placed on a device or under a mesh (the reshard-on-load
    path of an elastic restart).

    ``shardings`` is a device (every tensor leaf moves there), or a tree
    of the same structure whose leaves are
    :class:`~repro_torch.distributed.sharding.MeshSharding` (from
    ``logical_to_shardings``): each tensor leaf becomes this rank's block
    under its spec, on the mesh's device.  A whole tree written under one
    mesh shape thus places under any other.  Host scalars and numpy
    leaves stay on the host.

    Raises:
        ValueError: a sharded dim does not divide over its mesh axes.
    """
    if isinstance(shardings, (str, torch.device)):
        return _to_device(tree, shardings)
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(place(x, s) for x, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(x, s) for x, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        from repro_torch.distributed.sharding import local_shard
        mesh = shardings.mesh
        return local_shard(tree, shardings.spec, mesh).to(
            mesh.device, copy=True).contiguous()
    return tree


def _to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_to_device(x, device) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(x, device) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
