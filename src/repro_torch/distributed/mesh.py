"""Cell meshes of the 2-D partition: the port's ``make_mesh`` + ``psum``.

An ``(R, C)`` mesh with the reference's axis names: ``data`` indexes the
mesh rows (voxel ranges), ``model`` the columns (fiber ranges).  Cell
``(r, c)`` has the flat index ``r * C + c`` (:meth:`cell`).  Two
implementations share one interface:

  :class:`LocalMesh`         one process holds every cell; cell ``(r, c)``
                             lives on its own device.  ``psum`` is an
                             ordered sum of the cells' parts: columns
                             ``0..C-1`` for a reduction over ``model``,
                             rows ``0..R-1`` over ``data``.  The registry's
                             ``shard`` / ``shard-sell`` executors run on
                             it, because there the solver runs in one
                             process, as under the reference's single
                             controller.
  :class:`ProcessGroupMesh`  SPMD under ``torch.distributed``: world size
                             ``R * C``, rank ``r * C + c`` holds cell
                             ``(r, c)``, one group per mesh row and one per
                             mesh column; ``psum`` is an ``all_reduce``
                             over the row or column group.

``psum(parts, axis)`` takes this process's partial results keyed by cell
``(r, c)`` and returns the reduced ones keyed by what survives the
reduction: ``r`` over ``model``, ``c`` over ``data``, ``()`` over both
axes (:data:`AXES`).  Every call records ``(kind, bytes, group size)`` in
``collectives``, the bytes of one cell's part: what
:func:`repro_torch.roofline.analysis.collective_bytes` turns into bytes
moved per device.

On the card a local mesh needs ``R * C`` cards (one H100 admits only
``(1, 1)``).  On the CPU its cells share the CPU, up to :data:`CPU_CELLS`
of them, the counterpart of the reference tests'
``--xla_force_host_platform_device_count=8``.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Tuple, Union

import torch

#: the mesh's axis names, rows then columns (the reference's)
AXES = ("data", "model")
#: cells a local mesh on the CPU admits
CPU_CELLS = 8

Axis = Union[str, Tuple[str, ...]]


def max_cells(device) -> int:
    """Cells a local mesh rooted at ``device`` admits: the visible cards
    from ``device``'s index on for cuda, :data:`CPU_CELLS` on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device_count() - (device.index or 0)
    return CPU_CELLS


class _Mesh:
    """What both meshes share: the shape, cell numbering and the record of
    collectives."""

    def __init__(self, R: int, C: int):
        if R < 1 or C < 1:
            raise ValueError(f"mesh shape must be positive, got ({R}, {C})")
        self.R, self.C = R, C
        self.collectives: List[Tuple[str, int, int]] = []

    @property
    def shape(self) -> Tuple[int, int]:
        return self.R, self.C

    def cell(self, r: int, c: int) -> int:
        """Flat index (the rank under a process group) of cell ``(r, c)``."""
        if not (0 <= r < self.R and 0 <= c < self.C):
            raise ValueError(f"cell ({r}, {c}) is outside the "
                             f"{self.R} x {self.C} mesh")
        return r * self.C + c

    def group_size(self, axis: Axis) -> int:
        if axis == "model":
            return self.C
        if axis == "data":
            return self.R
        if tuple(axis) == AXES:
            return self.R * self.C
        raise ValueError(f"axis must be 'data', 'model' or {AXES}, "
                         f"got {axis!r}")

    @staticmethod
    def _key(rc: Tuple[int, int], axis: Axis):
        if axis == "model":
            return rc[0]
        if axis == "data":
            return rc[1]
        return ()

    def _record(self, part: torch.Tensor, axis: Axis) -> None:
        self.collectives.append(("all-reduce",
                                 part.numel() * part.element_size(),
                                 self.group_size(axis)))


class LocalMesh(_Mesh):
    """Every cell in this process, cell ``(r, c)`` on its own device.

    Raises:
        ValueError: a non-positive shape, or more cells than
            :func:`max_cells` admits on ``device``.
    """

    def __init__(self, R: int, C: int, device, *, name: str = "mesh"):
        super().__init__(R, C)
        self.device = torch.device(device)
        have = max_cells(self.device)
        if R * C > have:
            raise ValueError(f"{name} executor needs {R * C} devices, "
                             f"have {have}")
        self.cells: Tuple[Tuple[int, int], ...] = tuple(
            (r, c) for r in range(R) for c in range(C))

    def device_of(self, r: int, c: int) -> torch.device:
        if self.device.type != "cuda":
            return self.device
        return torch.device("cuda", (self.device.index or 0)
                            + self.cell(r, c))

    def psum(self, parts: Dict[Tuple[int, int], torch.Tensor],
             axis: Axis) -> Dict:
        """Ordered sums of the parts, each on the device of its first
        cell: over ``model`` in column order, over ``data`` in row order,
        over both in cell order.  ``parts`` may hold some of the cells
        (one mesh row's, say): the sums are over those given."""
        given = [rc for rc in self.cells if rc in parts]
        self._record(parts[given[0]], axis)
        out: Dict = {}
        for rc in given:                      # row-major: the fixed order
            k = self._key(rc, axis)
            out[k] = (out[k] + parts[rc].to(out[k].device) if k in out
                      else parts[rc])
        return out


class ProcessGroupMesh(_Mesh):
    """Cell ``(rank // C, rank % C)`` of an SPMD run under
    ``torch.distributed``, whose default group must have world size
    ``R * C``.  Creates one group per mesh row and one per mesh column
    (every rank creates all of them, in the same order).

    Under gloo a CUDA tensor is reduced in place.  If this build's gloo
    refuses CUDA tensors, the mesh stages each one through a host tensor
    from then on, says so on stderr, and sets ``staged``.  The LM's mesh
    (``launch/mesh.py``) runs its collectives through :meth:`all_reduce`,
    :meth:`all_gather` and :meth:`reduce_scatter`.
    """

    def __init__(self, R: int, C: int, *, device):
        super().__init__(R, C)
        import torch.distributed as dist
        self._dist = dist
        world = dist.get_world_size()
        if world != R * C:
            raise ValueError(f"a {R} x {C} mesh needs world size {R * C}, "
                             f"the process group has {world}")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = torch.device(device)
        self.r, self.c = divmod(self.rank, C)
        self.cells = ((self.r, self.c),)
        self.staged = False
        self.rs_emulated: set = set()
        self._rows = [dist.new_group([r * C + c for c in range(C)])
                      for r in range(R)]
        self._cols = [dist.new_group([r * C + c for r in range(R)])
                      for c in range(C)]

    def device_of(self, r: int, c: int) -> torch.device:
        if (r, c) != (self.r, self.c):
            raise ValueError(f"rank {self.rank} holds cell "
                             f"({self.r}, {self.c}), not ({r}, {c})")
        return self.device

    def psum(self, parts: Dict[Tuple[int, int], torch.Tensor],
             axis: Axis) -> Dict:
        """``all_reduce`` (sum) of this rank's part over its row group
        (``model``), column group (``data``) or the world (both); the
        part is reduced in place."""
        self.group_size(axis)
        x = parts[(self.r, self.c)]
        self._record(x, axis)
        self.all_reduce(x, axis)
        return {self._key((self.r, self.c), axis): x}

    def group_of(self, axis: Axis):
        """The process group of this rank's row (``model``), column
        (``data``) or the world (both axes: None)."""
        self.group_size(axis)
        return (self._rows[self.r] if axis == "model" else
                self._cols[self.c] if axis == "data" else None)

    def all_reduce(self, x: torch.Tensor, axis: Axis, op: str = "sum"
                   ) -> None:
        """Sum ``x`` (``op="max"``: its maximum) in place over this rank's
        row (``model``), column (``data``) or the world (both), staged
        once gloo has refused a CUDA tensor."""
        group = self.group_of(axis)
        rop = {"sum": self._dist.ReduceOp.SUM,
               "max": self._dist.ReduceOp.MAX}[op]

        def staged():
            h = x.cpu()
            self._dist.all_reduce(h, op=rop, group=group)
            x.copy_(h)
        self._try(x, "all_reduce",
                  lambda: self._dist.all_reduce(x, op=rop, group=group),
                  staged)

    def reduce_scatter(self, x: torch.Tensor, axis: Axis, dim: int
                       ) -> torch.Tensor:
        """This rank's block along ``dim`` of ``x`` summed over its row
        (``model``) or column (``data``): the ``i``-th of ``n`` equal
        blocks goes to the rank at coordinate ``i``.  Where the backend
        implements no reduce-scatter for the tensor's device type (which
        it then adds to ``rs_emulated``), an all-reduce and a ``narrow`` do
        it, moving the whole ``x`` twice."""
        group = self.group_of(axis)
        n = self.group_size(axis)
        i = self.c if axis == "model" else self.r
        m = x.shape[dim] // n
        xt = x.movedim(dim, 0).contiguous()

        def native(t):
            out = torch.empty((m,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            self._dist.reduce_scatter_tensor(out, t, group=group)
            return out

        def run(t):
            kind = t.device.type
            if kind not in self.rs_emulated:
                try:
                    return native(t)
                except (RuntimeError, NotImplementedError, ValueError):
                    self.rs_emulated.add(kind)
            t = t.clone()
            self._dist.all_reduce(t, group=group)
            return t.narrow(0, i * m, m).contiguous()

        out = self._try(x, "reduce_scatter", lambda: run(xt),
                        lambda: run(xt.cpu()).to(x.device))
        return out.movedim(0, dim).contiguous()

    def all_gather(self, x: torch.Tensor, axis: Axis, dim: int
                   ) -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` (in coordinate order),
        concatenated along ``dim``, staged as :meth:`all_reduce` is."""
        x = x.contiguous()
        group = self.group_of(axis)
        n = self.group_size(axis)

        def on_device():
            parts = [torch.empty_like(x) for _ in range(n)]
            self._dist.all_gather(parts, x, group=group)
            return torch.cat(parts, dim=dim)

        def staged():
            parts = [torch.empty_like(x, device="cpu") for _ in range(n)]
            self._dist.all_gather(parts, x.cpu(), group=group)
            return torch.cat(parts, dim=dim).to(x.device)
        return self._try(x, "all_gather", on_device, staged)

    def _try(self, x: torch.Tensor, what: str, on_device, staged):
        """``on_device()``; once gloo has refused a CUDA tensor,
        ``staged()`` (through host memory) from then on."""
        if not self.staged:
            try:
                return on_device()
            except RuntimeError as exc:
                if not (x.is_cuda and self.backend == "gloo"):
                    raise
                print(f"[mesh] rank {self.rank}: gloo refused a CUDA tensor "
                      f"in {what} ({exc}); staging every collective through "
                      "host memory from now on", file=sys.stderr, flush=True)
                self.staged = True
        return staged()
