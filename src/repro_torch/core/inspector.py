"""Inspector layer: host-side tile planning (paper §4.1.3 + §4.2.1.2).

A copy of the numpy-only tile planner of ``repro/core/inspector.py``
(``TilePlan``, ``auto_tile``, ``plan_tiles``, ``run_lengths``): the port
imports nothing of the reference, so it keeps its own.  The shard and SELL
helpers of that module arrive with their slices.

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
