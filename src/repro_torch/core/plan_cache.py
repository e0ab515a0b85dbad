"""Persistent, content-addressed inspector-plan cache.

Torch counterpart of ``repro/core/plan_cache.py``.  A ``TilePlan`` (kernel
tile geometry), an ``SpmvPlan`` (the ``auto`` executor's measured sort
choice), a ``FormatPlan`` (the format selector's choice), a ``TunePlan``
(the kernel autotuner's winner) or a ``ShardPlan`` (the mesh partition's
cuts) is keyed by a content hash of the index arrays, the geometry and the
backend, and
serialized to disk, so re-constructing an engine on the same dataset
replaces the host inspector and its measurements with one ``np.load``.
Every key carries the backend (``cpu`` / ``cuda``): a choice measured on
one never replays on the other.

Layout: ``<cache_dir>/<digest>.npz`` holding the plan arrays and a
``geometry`` vector, the reference's layout.  The directory is
``$REPRO_PLAN_CACHE`` or ``~/.cache/repro-life/plans``;
``LifeConfig.plan_cache_dir`` overrides it per engine and ``""`` disables
caching.  Entries are written atomically (temporary file + rename).

A TunePlan's and a ShardPlan's key also carry the device count (1 on the
CPU, ``torch.cuda.device_count()`` on the card).  A ShardPlan's payload is
the reference's (``geometry``, ``voxel_cuts``, ``fiber_cuts``), so either
package's ``get_shard_plan`` parses the other's entry.

:class:`CacheStats` counts every lookup; while observability is on each
lookup also counts in ``plan_cache.lookups{kind, outcome}`` (kinds
``tile``, ``spmv``, ``tune``, ``format``, ``shard``, as in the reference),
and each key's digest is a ``plan_cache.key`` span of the same kind.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.inspector import ShardPlan, TilePlan
from repro_torch.core.restructure import SpmvPlan
from repro_torch.formats.base import FORMAT_VERSION as _PHI_FORMAT_VERSION
from repro_torch.formats.base import FormatPlan

_ENV_VAR = "REPRO_PLAN_CACHE"
_MAX_BYTES_ENV_VAR = "REPRO_PLAN_CACHE_MAX_BYTES"
_FORMAT_VERSION = 2      # the reference's serialization version


def default_cache_dir() -> str:
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-life",
                        "plans")


def default_max_bytes() -> Optional[int]:
    """Size cap from ``$REPRO_PLAN_CACHE_MAX_BYTES``; None = unbounded."""
    env = os.environ.get(_MAX_BYTES_ENV_VAR)
    if not env:
        return None
    try:
        return int(env)
    except ValueError:
        return None


def _digest(kind: str, header, arrays) -> str:
    """SHA-256 of the ``header`` byte strings, then of each index array as
    contiguous int64, inside a ``plan_cache.key`` span (``kind``, bytes
    hashed)."""
    with obs.span("plan_cache.key", {"kind": kind}) as sp:
        h = hashlib.sha256()
        n = 0
        for part in header:
            h.update(part)
            n += len(part)
        for arr in arrays:
            h.update(np.ascontiguousarray(arr, np.int64).tobytes())
            n += 8 * np.size(arr)
        sp.set_attr("bytes", n)
        return h.hexdigest()


def tile_plan_key(sorted_ids: np.ndarray, n_rows: int, *, c_tile: int,
                  row_tile: int, backend: str) -> str:
    """Digest of the exact inspector inputs: sorted output-index content,
    row count, tile geometry and the backend (``cpu`` / ``cuda``)."""
    return _digest("tile", [
        b"tile-plan-v%d:" % _FORMAT_VERSION + backend.encode(),
        np.int64([n_rows, c_tile, row_tile]).tobytes()], [sorted_ids])


def spmv_plan_key(op: str, atoms: np.ndarray, voxels: np.ndarray,
                  fibers: np.ndarray, *, backend: str) -> str:
    """Digest for an autotuned SpmvPlan: the op, the backend and the full
    index content (the measured outcome depends on all three vectors)."""
    return _digest("spmv", [
        b"spmv-plan-v%d:" % _FORMAT_VERSION + op.encode() + b":"
        + backend.encode()], [atoms, voxels, fibers])


def format_plan_key(atoms: np.ndarray, voxels: np.ndarray, fibers: np.ndarray,
                    *, sizes, row_tile: int, slot_tile: int, allowed,
                    backend: str, coo_executor: str, sell_accept: float = 0.0,
                    sell_reject: float = 0.0) -> str:
    """Digest for a FormatPlan: the full index content, mode sizes, layout
    geometry, the candidate set and thresholds the selector decided under,
    the backend its measured rung timed on and the executor it timed the
    coo candidate on (the reference's key has no executor: its measured
    rung times jnp code for every candidate).  Versioned by
    ``formats.base.FORMAT_VERSION``."""
    return _digest("format", [
        b"format-plan-v%d.%d:" % (_FORMAT_VERSION, _PHI_FORMAT_VERSION)
        + backend.encode() + b":" + coo_executor.encode() + b":",
        ",".join(sorted(allowed)).encode(),
        np.float64([sell_accept, sell_reject]).tobytes(),
        np.int64(list(sizes) + [row_tile, slot_tile]).tobytes()],
        [atoms, voxels, fibers])


def tune_plan_key(atoms: np.ndarray, voxels: np.ndarray, fibers: np.ndarray,
                  *, sizes, n_theta: int, executor: str, fmt: str,
                  backend: str, n_devices: int, compute_dtype: str,
                  budget: int = 0, mesh=(1, 1)) -> str:
    """Digest for a TunePlan: the full index content, the problem geometry,
    the executor/format pair the search bound, the platform (backend,
    device count and ``(R, C)`` mesh shape), the requested compute-dtype
    mode and the search budget.

    A plan tuned on one backend misses cleanly on another instead of
    replaying layouts measured on other silicon.  The *requested* dtype is
    in the key, not the resolved winner, so ``compute_dtype="auto"`` and
    an explicit "fp32" never share an entry.
    """
    return _digest("tune", [
        b"tune-plan-v%d:" % _FORMAT_VERSION,
        ("%s|%s|%s|%s" % (executor, fmt, backend, compute_dtype)).encode(),
        np.int64(list(sizes) + [n_theta, n_devices, budget]
                 + list(mesh)).tobytes()], [atoms, voxels, fibers])


def shard_plan_key(atoms: np.ndarray, voxels: np.ndarray, fibers: np.ndarray,
                   *, sizes, R: int, C: int, cell_format: str, backend: str,
                   n_devices: int) -> str:
    """Digest for a ShardPlan: the full index content, mode sizes, the mesh
    geometry (R x C), the per-cell layout the partition is materialized
    in, the backend and the device count the mesh is built over.  A plan
    written for one topology misses cleanly on another."""
    return _digest("shard", [
        b"shard-plan-v%d.%d:" % (_FORMAT_VERSION, _PHI_FORMAT_VERSION)
        + backend.encode() + b":",
        cell_format.encode(),
        np.int64(list(sizes) + [R, C, n_devices]).tobytes()],
        [atoms, voxels, fibers])


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0

    def record(self, hit: bool, kind: str = "plan") -> None:
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        # the lookup, labeled by plan kind, in the obs registry; the fields
        # above stay authoritative (they count lookups made while
        # observability was off too)
        if obs.SWITCH.on:
            obs.counter("plan_cache.lookups", kind=kind,
                        outcome="hit" if hit else "miss").inc()

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        """hits / lookups; 0.0 before the first lookup."""
        n = self.lookups
        return self.hits / n if n else 0.0


class PlanCache:
    """On-disk plan store.  ``directory=None`` -> default location;
    ``directory=""`` -> disabled (every lookup misses, nothing is written).

    ``max_bytes`` caps the directory's total ``.npz`` footprint: after each
    write the oldest entries (by mtime; a hit refreshes it) are pruned until
    the cache fits.  ``None`` defers to ``$REPRO_PLAN_CACHE_MAX_BYTES``;
    unset means unbounded.
    """

    def __init__(self, directory: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        self.directory = default_cache_dir() if directory is None else directory
        self.max_bytes = default_max_bytes() if max_bytes is None else max_bytes
        self.stats = CacheStats()

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".npz")

    def _write(self, key: str, payload: dict) -> None:
        if not self.enabled:
            return
        tmp = None
        try:
            os.makedirs(self.directory, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, self._path(key))
            self._prune(keep=self._path(key))
        except OSError:
            # fail-open: an unwritable cache must never take down the
            # engine — the plan is simply not persisted
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)

    def _prune(self, keep: str) -> None:
        """Evict oldest entries until the directory fits ``max_bytes``;
        ``keep`` (the entry just written) is never evicted."""
        if self.max_bytes is None:
            return
        entries = []
        try:
            with os.scandir(self.directory) as it:
                for e in it:
                    if e.name.endswith(".npz") and e.path != keep:
                        st = e.stat()
                        entries.append((st.st_mtime, st.st_size, e.path))
            total = sum(size for _, size, _ in entries) \
                + os.stat(keep).st_size
        except OSError:
            return
        for _, size, path in sorted(entries):          # oldest first
            if total <= self.max_bytes:
                break
            try:
                os.unlink(path)
                total -= size
            except OSError:
                pass                                   # raced with another engine

    def _read(self, key: str) -> Optional[dict]:
        if not self.enabled:
            return None
        path = self._path(key)
        try:
            with np.load(path, allow_pickle=False) as z:
                raw = {k: z[k] for k in z.files}
            os.utime(path)                 # a hit refreshes the entry's age
            return raw
        except (OSError, ValueError, KeyError):
            return None     # missing, corrupt or foreign entries are a miss

    def get_tile_plan(self, key: str) -> Optional[TilePlan]:
        raw = self._read(key)
        self.stats.record(raw is not None, "tile")
        if raw is None:
            return None
        try:
            geom = raw["geometry"]
            return TilePlan(
                sel=raw["sel"].astype(np.int32),
                row_block=raw["row_block"].astype(np.int32),
                local_row=raw["local_row"].astype(np.int32),
                n_tiles=int(geom[0]), c_tile=int(geom[1]),
                row_tile=int(geom[2]), n_rows_padded=int(geom[3]),
                n_coeffs=int(geom[4]))
        except (KeyError, IndexError, ValueError):
            return None

    def put_tile_plan(self, key: str, plan: TilePlan) -> None:
        self._write(key, dict(
            sel=plan.sel, row_block=plan.row_block, local_row=plan.local_row,
            geometry=np.int64([plan.n_tiles, plan.c_tile, plan.row_tile,
                               plan.n_rows_padded, plan.n_coeffs])))

    def get_spmv_plan(self, key: str) -> Optional[SpmvPlan]:
        raw = self._read(key)
        self.stats.record(raw is not None, "spmv")
        if raw is None:
            return None
        try:
            return SpmvPlan(
                op=str(raw["op"]), restructure=str(raw["restructure"]),
                partition=str(raw["partition"]),
                order=raw["order"] if "order" in raw else None)
        except (KeyError, ValueError):
            return None

    def put_spmv_plan(self, key: str, plan: SpmvPlan) -> None:
        payload = dict(op=np.str_(plan.op),
                       restructure=np.str_(plan.restructure),
                       partition=np.str_(plan.partition))
        if plan.order is not None:
            payload["order"] = np.asarray(plan.order, np.int64)
        self._write(key, payload)

    def get_shard_plan(self, key: str) -> Optional[ShardPlan]:
        raw = self._read(key)
        self.stats.record(raw is not None, "shard")
        if raw is None:
            return None
        try:
            geom = raw["geometry"]
            return ShardPlan(R=int(geom[0]), C=int(geom[1]),
                             voxel_cuts=raw["voxel_cuts"].astype(np.int64),
                             fiber_cuts=raw["fiber_cuts"].astype(np.int64))
        except (KeyError, IndexError, ValueError):
            return None

    def put_shard_plan(self, key: str, plan: ShardPlan) -> None:
        self._write(key, dict(
            geometry=np.int64([plan.R, plan.C]),
            voxel_cuts=np.asarray(plan.voxel_cuts, np.int64),
            fiber_cuts=np.asarray(plan.fiber_cuts, np.int64)))

    def get_tune_plan(self, key: str):
        raw = self._read(key)
        self.stats.record(raw is not None, "tune")
        if raw is None:
            return None
        return _parse_tune_plan(raw)

    def put_tune_plan(self, key: str, plan) -> None:
        pk = sorted(plan.params)
        mk = sorted(plan.measurements)
        sk = sorted(plan.stats)
        self._write(key, dict(
            executor=np.str_(plan.executor), backend=np.str_(plan.backend),
            n_devices=np.int64(plan.n_devices),
            compute_dtype=np.str_(plan.compute_dtype),
            reason=np.str_(plan.reason),
            params_keys=np.asarray(pk, np.str_),
            params_vals=np.asarray([plan.params[k] for k in pk], np.int64),
            meas_keys=np.asarray(mk, np.str_),
            meas_vals=np.asarray([plan.measurements[k] for k in mk],
                                 np.float64),
            stats_keys=np.asarray(sk, np.str_),
            stats_vals=np.asarray([plan.stats[k] for k in sk], np.float64)))

    def get_format_plan(self, key: str) -> Optional[FormatPlan]:
        raw = self._read(key)
        self.stats.record(raw is not None, "format")
        if raw is None:
            return None
        return _parse_format_plan(raw)

    def put_format_plan(self, key: str, plan: FormatPlan) -> None:
        pk = sorted(plan.params)
        sk = sorted(plan.stats)
        self._write(key, dict(
            format=np.str_(plan.format), reason=np.str_(plan.reason),
            params_keys=np.asarray(pk, np.str_),
            params_vals=np.asarray([plan.params[k] for k in pk], np.int64),
            stats_keys=np.asarray(sk, np.str_),
            stats_vals=np.asarray([plan.stats[k] for k in sk], np.float64)))


    # -- harvest iteration ---------------------------------------------------
    def iter_plans(self):
        """Yield every decodable (kind, plan) in the cache directory, kind
        in {"format", "tune"}: the learn subsystem's harvest source.

        Classification is structural, as in the reference (digests are
        opaque): a FormatPlan payload carries a ``format`` entry, a
        TunePlan payload an ``executor`` entry.  Other plan kinds and
        corrupt or foreign files are skipped.  No lookup is counted: a
        training sweep is not a cache workload."""
        if not self.enabled:
            return
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return
        for name in names:
            if not name.endswith(".npz"):
                continue
            try:
                with np.load(os.path.join(self.directory, name),
                             allow_pickle=False) as z:
                    raw = {k: z[k] for k in z.files}
            except (OSError, ValueError, KeyError):
                continue
            if "format" in raw:
                plan = _parse_format_plan(raw)
                if plan is not None:
                    yield "format", plan
            elif "executor" in raw:
                plan = _parse_tune_plan(raw)
                if plan is not None:
                    yield "tune", plan


def _parse_format_plan(raw: dict) -> Optional[FormatPlan]:
    """Raw npz dict -> FormatPlan, or None on a malformed payload."""
    try:
        params = {str(k): int(v) for k, v in
                  zip(raw["params_keys"], raw["params_vals"])}
        stats = {str(k): float(v) for k, v in
                 zip(raw["stats_keys"], raw["stats_vals"])}
        return FormatPlan(format=str(raw["format"]),
                          reason=str(raw["reason"]),
                          params=params, stats=stats)
    except (KeyError, ValueError):
        return None


def _parse_tune_plan(raw: dict):
    """Raw npz dict -> TunePlan, or None on a malformed payload.  ``stats``
    may be absent, as in the reference's plans written before it had
    them."""
    from repro_torch.tune.plan import TunePlan
    try:
        params = {str(k): int(v) for k, v in
                  zip(raw["params_keys"], raw["params_vals"])}
        meas = {str(k): float(v) for k, v in
                zip(raw["meas_keys"], raw["meas_vals"])}
        stats = {str(k): float(v) for k, v in
                 zip(raw.get("stats_keys", ()), raw.get("stats_vals", ()))}
        return TunePlan(
            executor=str(raw["executor"]), backend=str(raw["backend"]),
            n_devices=int(raw["n_devices"]), params=params,
            compute_dtype=str(raw["compute_dtype"]),
            reason=str(raw["reason"]), measurements=meas, stats=stats)
    except (KeyError, ValueError):
        return None
