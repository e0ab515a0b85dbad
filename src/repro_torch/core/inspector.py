"""Inspector layer: host-side tile planning (paper §4.1.3 + §4.2.1.2).

A copy of the numpy-only parts of ``repro/core/inspector.py`` that the
port runs: the tile planner (``TilePlan``, ``auto_tile``, ``plan_tiles``),
the format-selection statistics (``run_lengths``, ``sell_geometry``,
``phi_stats``) and the mesh partition's helpers (``ShardPlan``,
``shard_boundaries``, ``pad_shards_equal``).  The port imports nothing of
the reference, so it keeps its own.

``TilePlan`` cuts *sorted* coefficients into tiles of at most ``c_tile``
entries such that every tile touches output rows in exactly **one**
row-block of ``row_tile`` rows.  Consecutive tiles that share a row-block
form one contiguous tile range; the CUDA kernels give each row-block's range
to one thread block, which owns those output rows alone — the
synchronization-free thread mapping of the paper.

Inspector cost is O(Nc) on the host and is amortized across the several
hundred SBBNNLS iterations (and across runs via the plan cache).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Executor plan for one SpMV op over sorted coefficients.

    sel:        int32[n_tiles * c_tile]  gather map into the padded coefficient
                arrays; padding entries point at index Nc (a zero dummy).
    row_block:  int32[n_tiles]           output row-block index per tile.
    local_row:  int32[n_tiles * c_tile]  output row within the row-block.
    n_tiles, c_tile, row_tile, n_rows_padded: static geometry.
    n_coeffs:   the real (unpadded) coefficient count Nc — also the dummy
                index that padding slots in ``sel`` point at.
    """

    sel: np.ndarray
    row_block: np.ndarray
    local_row: np.ndarray
    n_tiles: int
    c_tile: int
    row_tile: int
    n_rows_padded: int
    n_coeffs: int

    @property
    def n_padded(self) -> int:
        return self.n_tiles * self.c_tile

    def occupancy(self) -> float:
        """Fraction of tile slots holding real coefficients (waste metric)."""
        return float((self.sel < self.n_coeffs).mean()) if self.sel.size else 1.0


def auto_tile(sorted_ids: np.ndarray, n_rows: int, *, row_tile: int = 8,
              min_c: int = 32, max_c: int = 512) -> Tuple[int, int]:
    """Pick (c_tile, row_tile) from the data's density so tile slots stay
    occupied: c_tile ~ row_tile x mean nnz-per-touched-row, rounded to a
    power of two."""
    sorted_ids = np.asarray(sorted_ids)
    touched = max(1, np.unique(sorted_ids).size)
    per_row = sorted_ids.size / touched
    target = row_tile * per_row
    c = min_c
    while c < target and c < max_c:
        c *= 2
    return int(c), int(row_tile)


def plan_tiles(sorted_ids: np.ndarray, n_rows: int, *, c_tile: int,
               row_tile: int) -> TilePlan:
    """Cut sorted coefficients into (<=c_tile, single row-block) tiles."""
    sorted_ids = np.asarray(sorted_ids, np.int64)
    nc = sorted_ids.size
    if nc and (sorted_ids.min() < 0 or sorted_ids.max() >= n_rows):
        raise ValueError("row id out of range")
    if np.any(np.diff(sorted_ids) < 0):
        raise ValueError("ids must be sorted (run the restructuring first)")

    blocks = sorted_ids // row_tile
    # tile boundaries: every c_tile coefficients, plus every row-block change
    starts = [0]
    i = 0
    while i < nc:
        b = blocks[i]
        # end of this row-block run
        j = int(np.searchsorted(blocks, b, side="right"))
        # cut the run into c_tile chunks
        while i + c_tile < j:
            i += c_tile
            starts.append(i)
        i = j
        if i < nc:
            starts.append(i)
    starts_arr = np.asarray(starts, np.int64) if nc else np.zeros(0, np.int64)
    ends = np.append(starts_arr[1:], nc) if nc else starts_arr
    n_tiles = max(1, starts_arr.size)

    sel = np.full(n_tiles * c_tile, nc, np.int32)          # default: dummy pad
    local_row = np.zeros(n_tiles * c_tile, np.int32)
    row_block = np.zeros(n_tiles, np.int32)
    for t in range(starts_arr.size):
        s, e = int(starts_arr[t]), int(ends[t])
        row_block[t] = blocks[s]
        sel[t * c_tile: t * c_tile + (e - s)] = np.arange(s, e, dtype=np.int32)
        local_row[t * c_tile: t * c_tile + (e - s)] = (
            sorted_ids[s:e] - blocks[s] * row_tile)
    n_rows_padded = -(-n_rows // row_tile) * row_tile
    return TilePlan(sel=sel, row_block=row_block, local_row=local_row,
                    n_tiles=n_tiles, c_tile=c_tile, row_tile=row_tile,
                    n_rows_padded=n_rows_padded, n_coeffs=int(nc))


def run_lengths(ids: np.ndarray) -> np.ndarray:
    """Length of each run of equal output index once sorted — the
    nnz-per-touched-row distribution (sub-vector lengths, paper §4.1.2),
    in ascending row-id order."""
    ids = np.asarray(ids, np.int64)
    if ids.size == 0:
        return np.zeros(0, np.int64)
    return np.unique(ids, return_counts=True)[1]


def sell_geometry(max_nnz: int, n_rows: int, *, row_tile: int,
                  slot_tile: int) -> Tuple[int, int]:
    """(width, n_rows_padded) a SELL layout allocates for this shape.

    Shared by the layout itself (``formats/sell.py:SellPhi.encode``) and
    the selector's overhead prediction in :func:`phi_stats`: the
    accept/reject heuristic is sound only if the predicted slots equal the
    allocated slots."""
    width = max(slot_tile, -(-max_nnz // slot_tile) * slot_tile)
    n_rows_padded = -(-n_rows // row_tile) * row_tile
    return width, n_rows_padded


def phi_stats(phi, *, row_tile: int = 8, slot_tile: int = 32) -> dict:
    """Format-selection statistics (consumed by ``formats/select.py``).

    Per op (dsc: voxel rows, wc: fiber rows): run-length moments of the
    output dimension plus the padding overhead a SELL layout with this
    (row_tile, slot_tile) geometry would pay, from counts alone, without
    building the layout.  Global Nc/Nv/Nf ratios ride along.
    """
    out = dict(
        n_coeffs=float(phi.n_coeffs),
        nc_per_voxel=phi.n_coeffs / max(1, phi.n_voxels),
        nc_per_fiber=phi.n_coeffs / max(1, phi.n_fibers),
        nc_per_atom=phi.n_coeffs / max(1, phi.n_atoms),
    )
    for op, ids, n_rows in (("dsc", phi.voxels, phi.n_voxels),
                            ("wc", phi.fibers, phi.n_fibers)):
        touched = run_lengths(ids.cpu().numpy())
        max_nnz = int(touched.max()) if touched.size else 0
        width, n_rows_padded = sell_geometry(max_nnz, n_rows,
                                             row_tile=row_tile,
                                             slot_tile=slot_tile)
        slots = n_rows_padded * width
        out[f"{op}.rows_touched"] = float(touched.size) / max(1, n_rows)
        out[f"{op}.run_mean"] = float(touched.mean()) if touched.size else 0.0
        out[f"{op}.run_p99"] = (float(np.percentile(touched, 99))
                                if touched.size else 0.0)
        out[f"{op}.run_max"] = float(max_nnz)
        out[f"{op}.sell_width"] = float(width)
        out[f"{op}.sell_overhead"] = slots / max(1, phi.n_coeffs) - 1.0
    return out


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """2-D mesh partition plan: equal-nnz (voxel-range x fiber-range) cells.

    ``voxel_cuts``/``fiber_cuts`` are *id-space* boundaries (int64[R+1] /
    int64[C+1]): mesh row ``r`` owns voxels ``[voxel_cuts[r],
    voxel_cuts[r+1])`` and mesh column ``c`` owns fibers ``[fiber_cuts[c],
    fiber_cuts[c+1])``.  Produced by
    :func:`repro_torch.formats.shard.partition_cuts` from
    :func:`shard_boundaries` per dimension, and serialized through the
    persistent plan cache under a key that includes the mesh shape, the
    backend and the device count.
    """

    R: int
    C: int
    voxel_cuts: np.ndarray        # int64 (R+1,)
    fiber_cuts: np.ndarray        # int64 (C+1,)

    @property
    def nv_local(self) -> int:
        """Common per-row voxel count (max range length; rows pad up to it)."""
        return int(np.max(np.diff(self.voxel_cuts)))

    @property
    def nf_local(self) -> int:
        return int(np.max(np.diff(self.fiber_cuts)))


def shard_boundaries(sorted_ids: np.ndarray, n_shards: int) -> np.ndarray:
    """Equal-nnz shard cuts snapped to sub-vector boundaries.

    Returns int64[n_shards + 1] coefficient offsets.  Snapping direction is
    chosen per cut to minimize the induced imbalance (paper Figure 5b, case
    2: give the straddling sub-vector to whichever side adds less work).
    """
    sorted_ids = np.asarray(sorted_ids, np.int64)
    nc = sorted_ids.size
    cuts = [0]
    for s in range(1, n_shards):
        target = (nc * s) // n_shards
        if target <= cuts[-1]:
            cuts.append(cuts[-1])
            continue
        v = sorted_ids[min(target, nc - 1)]
        lo = int(np.searchsorted(sorted_ids, v, side="left"))
        hi = int(np.searchsorted(sorted_ids, v, side="right"))
        # snap to whichever sub-vector boundary is closer to the target
        snap = lo if (target - lo) <= (hi - target) else hi
        snap = max(snap, cuts[-1])
        cuts.append(snap)
    cuts.append(nc)
    return np.asarray(cuts, np.int64)


def pad_shards_equal(cuts: np.ndarray,
                     pad_to: int | None = None) -> Tuple[np.ndarray, int]:
    """Per-shard (start, length) padded to a common length for stacking."""
    lens = np.diff(cuts)
    width = int(lens.max()) if pad_to is None else pad_to
    return np.stack([cuts[:-1], lens], axis=1), width
