"""Persistent, content-addressed tile-plan cache.

Torch counterpart of the tile-plan part of ``repro/core/plan_cache.py``.  A
``TilePlan`` is keyed by a content hash of the sorted index array, the tile
geometry and the backend, and serialized to disk, so re-constructing an
engine on the same dataset replaces the O(Nc) host tiling loop with one
``np.load``.  The key carries the backend (``cpu`` / ``cuda``) so that plans
never cross between the two.

Layout: ``<cache_dir>/<digest>.npz`` holding the plan arrays and a
``geometry`` vector, the reference's layout.  The directory is
``$REPRO_PLAN_CACHE`` or ``~/.cache/repro-life/plans``;
``LifeConfig.plan_cache_dir`` overrides it per engine and ``""`` disables
caching.  Entries are written atomically (temporary file + rename).

The format, tune and shard plan kinds arrive with their slices.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from typing import Optional

import numpy as np

from repro_torch.core.inspector import TilePlan

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


def tile_plan_key(sorted_ids: np.ndarray, n_rows: int, *, c_tile: int,
                  row_tile: int, backend: str) -> str:
    """Digest of the exact inspector inputs: sorted output-index content,
    row count, tile geometry and the backend (``cpu`` / ``cuda``)."""
    h = hashlib.sha256()
    h.update(b"tile-plan-v%d:" % _FORMAT_VERSION + backend.encode())
    h.update(np.int64([n_rows, c_tile, row_tile]).tobytes())
    h.update(np.ascontiguousarray(sorted_ids, np.int64).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0

    def record(self, hit: bool) -> None:
        if hit:
            self.hits += 1
        else:
            self.misses += 1

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
        self.stats.record(raw is not None)
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
