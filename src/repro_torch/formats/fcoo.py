"""F-COO: one sorted, segment-flagged Phi linearization serving both ops.

Torch counterpart of ``repro/formats/fcoo.py`` (Liu et al.,
arXiv:1705.09905).  SELL keeps a voxel-row copy for DSC and a fiber-row
copy for WC; F-COO keeps *one* flat coefficient stream and moves the per-op
irregularity into segment metadata:

  * coefficients are lexsorted once, voxel-major ``(voxel, fiber, atom)``
    (the DSC order), and padded to a ``c_tile`` multiple with inert slots
    (value 0, indices repeating the last real coefficient);
  * the WC (fiber-major) view is a stable permutation ``wc_perm`` over the
    same stream, not a second copy;
  * for each op the stream is cut into ``c_tile`` chunks; within a chunk,
    runs of equal output ids form *segments*, stored as per-slot segment
    ranks (``dsc_ranks`` / ``wc_ranks``), and a ``(n_chunks, K)`` map
    (``seg_rows_*``) names each segment's output row (padding segments
    point at a dummy row one past the end).

Kernels B5 and B6 (``kernels/fcoo.py``) write ``y`` and ``w`` directly and
fold runs that cross chunks themselves, finding segments from the voxels
and from the fiber-major view's fibers.  The ranks and ``seg_rows_*`` maps
serve the partials-based yardsticks only and stay on the host.

``nbytes`` counts every array of the encoding, as the reference does;
``kernels/ops.py:FcooOperands.nbytes`` counts what the card holds.  The port
defines the padding overhead of an empty Phi as 0.0; the reference's
``0 / max(1, 0) - 1`` gives -1.0 there.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.bridge import to_numpy
from repro_torch.core.std import PhiTensor
from repro_torch.formats.base import register_format

DEFAULT_C_TILE = 256          # coefficients per chunk
DEFAULT_SEG_TILE = 16         # K (segments per chunk) rounds up to this


def chunk_segment_map(ids: np.ndarray, c_tile: int, seg_tile: int,
                      dummy_row: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Segment metadata for one op over a padded id stream.

    ``ids``: int array, ``ids.size % c_tile == 0``, the output ids of the
    linearized stream.  Returns ``(seg_rows, ranks, k)``:

      * ``ranks`` (int32, like ``ids``): chunk-local segment index of every
        slot, the prefix sum of ``ids[i] != ids[i-1]`` with the flag reset
        at each chunk boundary;
      * ``seg_rows`` (int32 ``(n_chunks, k)``): segment -> output row;
        entries past a chunk's last segment hold ``dummy_row``;
      * ``k``: max segments in any chunk, rounded up to ``seg_tile``.
    """
    if ids.size % c_tile:
        raise ValueError(f"ids.size={ids.size} not a c_tile={c_tile} multiple")
    n_chunks = ids.size // c_tile
    if n_chunks == 0:
        return (np.zeros((0, seg_tile), np.int32),
                np.zeros((0,), np.int32), seg_tile)
    ids2 = np.asarray(ids).reshape(n_chunks, c_tile)
    flags = np.zeros((n_chunks, c_tile), np.int32)
    flags[:, 1:] = ids2[:, 1:] != ids2[:, :-1]
    ranks = np.cumsum(flags, axis=1, dtype=np.int32)
    max_segs = int(ranks[:, -1].max()) + 1
    k = -(-max_segs // seg_tile) * seg_tile
    seg_rows = np.full((n_chunks, k), dummy_row, np.int32)
    seg_rows[np.repeat(np.arange(n_chunks), c_tile),
             ranks.reshape(-1)] = ids2.reshape(-1)
    return seg_rows, ranks.reshape(-1), k


@register_format
@dataclasses.dataclass
class FcooPhi:
    """One resident F-COO linearization serving DSC and WC.

    ``atoms``/``voxels``/``fibers``/``values``: the padded stream in DSC
    (voxel-major) order.  ``wc_perm`` re-reads the same stream fiber-major.
    ``dsc_ranks``/``wc_ranks`` are the per-slot chunk-local segment ranks,
    ``seg_rows_dsc``/``seg_rows_wc`` the segment -> output-row maps (dummy
    rows ``n_voxels`` / ``n_fibers`` absorb padding segments).
    """

    name: ClassVar[str] = "fcoo"

    atoms: np.ndarray                    # int32 (Ncp,)
    voxels: np.ndarray                   # int32 (Ncp,)
    fibers: np.ndarray                   # int32 (Ncp,)
    values: np.ndarray                   # fp    (Ncp,)
    wc_perm: np.ndarray                  # int32 (Ncp,) fiber-major view
    dsc_ranks: np.ndarray                # int32 (Ncp,)
    wc_ranks: np.ndarray                 # int32 (Ncp,)
    seg_rows_dsc: np.ndarray             # int32 (n_chunks, k_dsc)
    seg_rows_wc: np.ndarray              # int32 (n_chunks, k_wc)
    c_tile: int
    seg_tile: int
    n_coeffs: int                        # real (unpadded) coefficient count
    n_atoms: int
    n_voxels: int
    n_fibers: int
    device: str = "cpu"

    # -- encode / decode ------------------------------------------------------
    @classmethod
    def encode(cls, phi: PhiTensor, *, op: str = "dsc",
               c_tile: int = DEFAULT_C_TILE,
               seg_tile: int = DEFAULT_SEG_TILE, **_params) -> "FcooPhi":
        """Linearize once; ``op`` is ignored: one encode serves both ops.

        A ``build.encode`` span; inside it, the ``lexsort`` and the
        ``wc_perm`` argsort (each with the take that applies it) are
        ``build.sort`` spans and the two segment maps ``build.plan``
        spans."""
        with obs.span("build.encode", {"format": cls.name,
                                       "n_coeffs": phi.n_coeffs}):
            a = to_numpy(phi.atoms).astype(np.int64)
            v = to_numpy(phi.voxels).astype(np.int64)
            f = to_numpy(phi.fibers).astype(np.int64)
            vals = to_numpy(phi.values)
            nc = a.size
            ncp = -(-nc // c_tile) * c_tile
            with obs.span("build.sort", {"dim": "voxel", "n_coeffs": nc}):
                # total order up to identical triples: any input
                # permutation of the coefficients linearizes to the same
                # layout
                order = np.lexsort((a, f, v))

                def lay(x, fill):
                    out = np.empty(ncp, np.int32)
                    out[:nc] = x[order]
                    out[nc:] = fill
                    return out

                atoms = lay(a, a[order[-1]] if nc else 0)
                voxels = lay(v, v[order[-1]] if nc else 0)
                fibers = lay(f, f[order[-1]] if nc else 0)
                values = np.zeros(ncp, vals.dtype)
                if nc:
                    values[:nc] = vals[order]
            with obs.span("build.sort", {"dim": "fiber", "n_coeffs": nc}):
                # fiber-major view over the SAME stream (stable:
                # voxel-major within a fiber); padding slots repeat the
                # last real fiber id, so they merge into its final segment
                # and stay inert (value 0)
                wc_perm = np.argsort(fibers, kind="stable").astype(np.int32)
                wc_fibers = fibers[wc_perm]
            n_tiles = ncp // c_tile
            with obs.span("build.plan", {"op": "dsc", "n_tiles": n_tiles}):
                seg_rows_dsc, dsc_ranks, _ = chunk_segment_map(
                    voxels, c_tile, seg_tile, phi.n_voxels)
            with obs.span("build.plan", {"op": "wc", "n_tiles": n_tiles}):
                seg_rows_wc, wc_ranks, _ = chunk_segment_map(
                    wc_fibers, c_tile, seg_tile, phi.n_fibers)
            return cls(atoms=atoms, voxels=voxels, fibers=fibers,
                       values=values, wc_perm=wc_perm, dsc_ranks=dsc_ranks,
                       wc_ranks=wc_ranks, seg_rows_dsc=seg_rows_dsc,
                       seg_rows_wc=seg_rows_wc, c_tile=c_tile,
                       seg_tile=seg_tile, n_coeffs=nc, n_atoms=phi.n_atoms,
                       n_voxels=phi.n_voxels, n_fibers=phi.n_fibers,
                       device=str(phi.device))

    def decode(self) -> PhiTensor:
        nc = self.n_coeffs

        def t(a):
            return torch.as_tensor(a[:nc].copy(), device=self.device)

        return PhiTensor(atoms=t(self.atoms), voxels=t(self.voxels),
                         fibers=t(self.fibers), values=t(self.values),
                         n_atoms=self.n_atoms, n_voxels=self.n_voxels,
                         n_fibers=self.n_fibers)

    # -- geometry / accounting ------------------------------------------------
    @property
    def n_chunks(self) -> int:
        return self.atoms.size // self.c_tile if self.c_tile else 0

    @property
    def k_dsc(self) -> int:
        return self.seg_rows_dsc.shape[1]

    @property
    def k_wc(self) -> int:
        return self.seg_rows_wc.shape[1]

    @property
    def nbytes(self) -> int:
        """Every array of the encoding, as the reference counts it: stream,
        WC view permutation, both rank vectors, both segment maps.  The
        card holds the stream, ``wc_perm`` and ``fibers[wc_perm]`` instead
        (``kernels/ops.py:FcooOperands.nbytes``)."""
        return int(self.atoms.nbytes + self.voxels.nbytes
                   + self.fibers.nbytes + self.values.nbytes
                   + self.wc_perm.nbytes + self.dsc_ranks.nbytes
                   + self.wc_ranks.nbytes + self.seg_rows_dsc.nbytes
                   + self.seg_rows_wc.nbytes)

    @property
    def padding_overhead(self) -> float:
        """Padded slots / real coefficients - 1 (tail padding only); 0.0
        for an empty Phi."""
        if self.n_coeffs == 0:
            return 0.0
        return self.atoms.size / self.n_coeffs - 1.0


# ----------------------------------------------------------------------------
# Plain torch executors over the F-COO stream, the reference's jnp ones
# (padding slots carry value 0) on the dictionary's device: oracles of the
# layout's semantics.  The executor runs kernels B5/B6 instead.
# ----------------------------------------------------------------------------

def dsc_reference(fc: FcooPhi, dictionary: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """y = M w over the linearized stream."""
    dev = dictionary.device
    y = torch.zeros((fc.n_voxels, dictionary.shape[1]),
                    dtype=torch.promote_types(dictionary.dtype, w.dtype),
                    device=dev)
    if fc.atoms.size == 0:
        return y
    atoms = torch.as_tensor(fc.atoms, device=dev).long()
    fibers = torch.as_tensor(fc.fibers, device=dev).long()
    scaled = w[fibers] * torch.as_tensor(fc.values, device=dev)
    contrib = dictionary[atoms] * scaled[:, None]
    return y.index_add_(0, torch.as_tensor(fc.voxels, device=dev).long(),
                        contrib.to(y.dtype))


def wc_reference(fc: FcooPhi, dictionary: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """w = M^T y over the same resident stream."""
    dev = dictionary.device
    w = torch.zeros((fc.n_fibers,),
                    dtype=torch.promote_types(dictionary.dtype, y.dtype),
                    device=dev)
    if fc.atoms.size == 0:
        return w
    atoms = torch.as_tensor(fc.atoms, device=dev).long()
    voxels = torch.as_tensor(fc.voxels, device=dev).long()
    dots = (dictionary[atoms] * y[voxels]).sum(-1) \
        * torch.as_tensor(fc.values, device=dev)
    return w.index_add_(0, torch.as_tensor(fc.fibers, device=dev).long(),
                        dots.to(w.dtype))
