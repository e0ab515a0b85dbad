"""A traced cost model of a step (torch counterpart of
``repro/roofline/hlo_cost.py``).

The reference compiles a step and reads its cost from the HLO text, each
``while`` body counted by its trip count.  PyTorch compiles nothing, so
:func:`analyze` runs the step itself on tensors without data and counts
what the card would do, op by op, in a ``TorchDispatchMode``:

  * **FLOPs** of the products, with ``torch.utils.flop_counter``'s
    formulas (mm, bmm, addmm, baddbmm, convolution, attention) and 2 N
    for a dot of two N-vectors (``aten.dot``, which the registry lacks:
    the SBBNNLS step sizes and loss), as the reference counts its dots; a
    kernel wrapper reports its own (:func:`record_kernel`: B1–B6 in
    ``kernels/dsc.py:traced``, B7's ``moe_gmm``);
  * **bytes** as each op's inputs plus its outputs.  Views, allocations and
    metadata count nothing.  The port runs its ops unfused, so this is what
    the card reads and writes;
  * **peak_temp_bytes**, the most bytes alive at once among the storages
    the step made: each storage lives from the op that made it until its
    last reference goes (views share their storage; autograd's saved
    tensors and ``torch.utils.checkpoint``'s live as long as they do on
    the card);
  * **collectives**, the records a recording mesh takes
    (:func:`record_collective`; ``launch/dryrun.py:RecordingMesh``),
    through ``roofline.analysis.collective_bytes``.

The tensors are ``meta`` tensors: shapes, dtypes and storages, no data.
The LM and LiFE paths' device branches are the kernel wrappers, whose
path for a tensor without data (:func:`without_data`) records the kernel's
op and launches nothing, and ``core/spmv.py:scatter_add``, which takes the
card's ops on one.  (``FakeTensorMode``'s fake ``cuda`` tensors would
take those branches literally, but on a CPU-only PyTorch autograd aborts
the process on them, and its fake ``meta`` tensors cost four times the
trace time of plain ones for the same counts.)

**Trip counts.**  A trace of every layer and chunk is too slow at full
size, so the loops that run identical iterations ask this module for
their items: :func:`trips` for a stack (the model's layers, the SSD's
chunks) and :func:`classes` for a loop whose iterations fall into a few
kinds that leave the live set as they found it (flash attention's chunk
pairs).  Outside a trace both give every item.  Under a trace a stack
runs its first, one middle and its last item (or last two), the middle
one standing for the rest; a class loop runs each class twice, the
second standing for the rest of the class.  Each op is weighted by the iterations its frame
stands for, in the backward pass too: a backward node takes the frame of
the forward iteration that made it (by its sequence number), or, made
outside every loop (a gathered weight's backward), the frame of the
gradient it is given.  FLOPs, bytes and collectives are linear in the
count.  The peak is composed from the iterations' events: the middle
iteration's events are replayed as often as it stands for, each storage freed in
the copy of the iteration that frees it in the stack (a layer's output,
saved by the next layer, is freed in the next layer's backward), so the
tensors saved per iteration add up and the transient working set does
not.  :attr:`TraceCost.loops` holds the trip counts.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
import weakref
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import collective_bytes

Record = Tuple[str, int, int]

#: ops that move no data: allocations and metadata
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_unsafe_view", "view", "_reshape_alias",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "set_", "resize_",
})


@dataclasses.dataclass(frozen=True)
class _Frame:
    """One iteration that runs under a trace: loop instance ``uid``, its
    position (0 the first, 1 the middle, 2 the last item of a stack; -1 a
    class), the direction its events run in (``f`` forward, ``b`` the
    backward pass of a forward iteration, ``r`` a remat recompute), the
    trip count, the iterations it stands for and how many of the stack's
    last iterations run as themselves (position 2 is the first of them)."""
    uid: int
    name: str
    pos: int
    dir: str
    n: int
    weight: int
    tail: int = 1

    def real(self, pos: int) -> int:
        """The real index of position ``pos`` (not the middle)."""
        return 0 if pos == 0 else self.n - self.tail + pos - 2

    def position(self, r: int) -> int:
        """The position that runs real index ``r``."""
        if r <= 0:
            return 0
        return 2 + r - (self.n - self.tail) if r >= self.n - self.tail else 1

    @property
    def stacked(self) -> bool:
        return self.pos >= 0

    def turned(self, d: str) -> "_Frame":
        return dataclasses.replace(self, dir=d)


def _weight(ctx: Tuple[_Frame, ...]) -> int:
    return math.prod(f.weight for f in ctx)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class TraceCost:
    flops: float                    # per chip, trip-count corrected
    bytes_accessed: float           # per chip: every op's inputs + outputs
    collective: Dict[str, float]    # per chip bytes moved, by kind
    collective_total: float
    loops: Dict[str, int]           # trip count per loop name
    peak_temp_bytes: float          # most bytes alive at once
    by_op: Dict[str, Dict[str, float]]   # flops, bytes, calls per op
    records: List[Record]           # the collectives, in order
    seconds: float                  # the trace's own time
    n_chips: int = 1


def _dot_flops(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.numel()


#: FLOPs by op: ``flop_counter``'s formulas and the dot's
_FLOPS = {**flop_registry, torch.ops.aten.dot: _dot_flops}


class _Tracer(TorchDispatchMode):
    def __init__(self, mesh=None, cut: bool = True):
        super().__init__()
        self.mesh = mesh
        self.cut = cut
        self.frames: List[_Frame] = []
        self.ranges: List[Tuple[int, int, Tuple[_Frame, ...]]] = []
        self.node_ctx: Dict[int, Tuple[_Frame, ...]] = {}
        self.live: Dict[int, int] = {}          # id(storage) -> sid
        self.outside: Dict[int, Any] = {}       # storages made before
        self.sids: List[tuple] = []             # bytes, ctx, op
        self.events: List[tuple] = []
        self.by_op: Dict[str, List[float]] = {}
        self.loops: Dict[str, int] = {}
        self.skipped: Dict[str, set] = {}
        self.instances: Dict[tuple, int] = {}
        self.ordinals: Dict[tuple, int] = {}
        self.last_ctx: Tuple[_Frame, ...] = ()
        self.uids = itertools.count()
        self.ghost = 0
        self.open = True

    # -- where an event belongs ------------------------------------------
    def ctx(self, tensors: Sequence[torch.Tensor] = ()) -> Tuple[_Frame, ...]:
        node = torch._C._current_autograd_node()
        if node is None:
            if torch._C._current_graph_task_id() != -1:
                return self.last_ctx     # the engine, between two nodes
            return tuple(self.frames)
        seq = node._sequence_nr()
        base = self.node_ctx.get(seq)
        if base is None:
            base = self._range_ctx(seq)
            if base is None:
                base = self._flow_ctx(tensors)
            self.node_ctx[seq] = base
        return base + tuple(self.frames)

    def _range_ctx(self, seq: int) -> Optional[Tuple[_Frame, ...]]:
        best = None
        for lo, hi, ctx in self.ranges:
            if lo <= seq < hi and (best is None or len(ctx) > len(best)):
                best = ctx
        return best

    def _flow_ctx(self, tensors) -> Tuple[_Frame, ...]:
        """A node made outside every loop: the frame of the innermost
        iteration that made one of its inputs (its gradient)."""
        best: Tuple[_Frame, ...] = ()
        for t in tensors:
            sid = self.live.get(id(t.untyped_storage()))
            if sid is not None and len(self.sids[sid][1]) > len(best):
                best = self.sids[sid][1]
        return tuple(f.turned("b") for f in best)

    # -- the dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.ghost or func.namespace != "aten":
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in ins:
            st = t.untyped_storage()
            if id(st) not in self.live:
                self.outside.setdefault(id(st), st)
        ctx = self.ctx(ins)
        self.last_ctx = ctx
        name = func._overloadpacket.__name__
        fl = _FLOPS.get(func._overloadpacket)
        flops = fl(*args, **kwargs, out_val=out) if fl is not None else 0
        if name in _NO_TRAFFIC or func.is_view:
            moved = 0
        else:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._count(name, flops, moved, _weight(ctx))
        for t in outs:
            self._made(t.untyped_storage(), ctx, name)
        return out

    def _count(self, name: str, flops: float, moved: float, w: int) -> None:
        row = self.by_op.setdefault(name, [0.0, 0.0, 0])
        row[0] += w * flops
        row[1] += w * moved
        row[2] += w

    def _made(self, st, ctx, op: str) -> None:
        key = id(st)
        if key in self.live or key in self.outside:
            return
        self.live[key] = len(self.sids)
        self.sids.append((st.nbytes(), ctx, op))
        self.events.append(("a", self.live[key], ctx))
        weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        sid = self.live.pop(key, None)
        if sid is not None and self.open:
            self.events.append(("f", sid, self.ctx()))

    # -- loops -----------------------------------------------------------------
    def frame(self, name: str, pos: int, n: int, weight: int,
              instance: int, tail: int = 1) -> _Frame:
        in_bwd = torch._C._current_autograd_node() is not None
        return _Frame(instance, name, pos, "r" if in_bwd else "f", n, weight,
                      tail)

    def instance(self, name: str) -> int:
        """A loop instance's id; a remat recompute's loop takes the id of
        the forward loop it repeats (same enclosing iteration, name and
        ordinal), so that its storages pair with that loop's backward."""
        node = torch._C._current_autograd_node()
        outer = self.ctx() if node is not None else tuple(self.frames)
        sig = tuple((f.uid, f.pos) for f in outer)
        phase = "r" if node is not None else "f"
        k = (sig, name, phase)
        ordinal = self.ordinals.get(k, 0)
        self.ordinals[k] = ordinal + 1
        if phase == "r" and (sig, name, ordinal) in self.instances:
            return self.instances[(sig, name, ordinal)]
        uid = next(self.uids)
        if phase == "f":
            self.instances[(sig, name, ordinal)] = uid
        return uid

    def enter(self, f: _Frame) -> int:
        self.frames.append(f)
        return torch._C._autograd._get_sequence_nr()

    def leave(self, f: _Frame, lo: int) -> None:
        self.frames.pop()
        if f.dir == "f":
            hi = torch._C._autograd._get_sequence_nr()
            if hi > lo:
                self.ranges.append(
                    (lo, hi, tuple(x.turned("b") for x in self.frames)
                     + (f.turned("b"),)))

    # -- the composed cost -------------------------------------------------------
    def result(self, seconds: float, n_chips: int) -> TraceCost:
        peak, records = _replay(self.events, self.sids)
        coll = collective_bytes(records)
        total = coll.pop("total")
        coll.pop("counts")
        flops = sum(r[0] for r in self.by_op.values())
        moved = sum(r[1] for r in self.by_op.values())
        return TraceCost(
            flops=flops, bytes_accessed=moved, collective=coll,
            collective_total=total, loops=dict(self.loops),
            peak_temp_bytes=float(peak),
            by_op={k: {"flops": v[0], "bytes": v[1], "calls": v[2]}
                   for k, v in sorted(self.by_op.items())},
            records=records, seconds=seconds, n_chips=n_chips)


_ACTIVE: Optional[_Tracer] = None


def without_data(t: torch.Tensor) -> bool:
    """A tensor a trace runs on (``meta``): a kernel wrapper records its
    op (:func:`record_kernel`) and launches nothing."""
    return t.is_meta


# ----------------------------------------------------------------------------
# the API the model code calls
# ----------------------------------------------------------------------------

class Trips:
    """The items of a stack loop of ``n`` identical iterations
    (:func:`trips`)."""

    def __init__(self, name: str, n: int, owner: Optional[str], per: int,
                 tail: int):
        self.name, self.n, self.owner, self.per = name, n, owner, per
        self.tail = tail
        self.cut = _ACTIVE is not None and _ACTIVE.cut and n > tail + 2
        if self.cut:
            self.positions = ((0, 0, 1), (1, 1, n - 1 - tail)) + tuple(
                (2 + j, n - tail + j, 1) for j in range(tail))
        else:
            f = _Frame(0, name, 0, "f", n, 1, tail)
            self.positions = tuple((f.position(i), i, 1) for i in range(n))

    def __iter__(self) -> Iterator[int]:
        tr = _ACTIVE
        if tr is None or not tr.cut:
            yield from range(self.n)
            return
        tr.loops[self.name] = self.n
        if self.owner is not None:
            tr.skipped.setdefault(self.owner, set()).update(
                range(2 * self.per, (self.n - self.tail) * self.per))
        uid = tr.instance(self.name)
        for pos, item, w in self.positions:
            f = tr.frame(self.name, pos, self.n, w, uid, self.tail)
            lo = tr.enter(f)
            try:
                yield item
            finally:
                tr.leave(f, lo)

    def full(self, items: List[Any]) -> List[Any]:
        """A list the loop appended the same number of entries to in every
        iteration, as the whole stack gives it: under a trace, the middle
        iteration's entries stand for every middle iteration's."""
        if not self.cut:
            return items
        k = len(items) // (2 + self.tail)
        mid = items[k:2 * k]
        return (items[:k] + mid + _detached(mid) * (self.n - 2 - self.tail)
                + items[2 * k:])


def _detached(items: List[Any]) -> List[Any]:
    """The middle iteration's entries again, detached and uncounted: the
    copies that stand for the other middle iterations' entries carry no
    gradient back (each middle iteration's entry gets its own once)."""
    tr = _ACTIVE
    tr.ghost += 1
    try:
        return [tuple(t.detach() for t in x) if isinstance(x, tuple)
                else x.detach() for x in items]
    finally:
        tr.ghost -= 1


def trips(name: str, n: int, *, owner: Optional[str] = None,
          per: int = 1, tail: int = 1) -> Trips:
    """``range(n)`` for a loop of ``n`` identical iterations; under a trace
    the first, one middle and the last ``tail`` indices (module docstring;
    ``tail=2`` where the last iteration's output takes no gradient, so
    that the next to last runs its backward as the first one of the middle
    iterations' does not).
    ``owner``: the model's ``ModuleList`` (by name, as
    ``Transformer.reference_leaves`` names it) whose entries
    ``[i * per, (i + 1) * per)`` iteration ``i`` runs, so that the
    gradients of the entries a trace skips are known to stand in the
    middle iteration's (:func:`missing_grad`)."""
    return Trips(name, n, owner, per, tail)


def classes(name: str, items: Iterable[Any],
            key: Callable[[Any], Any]) -> Iterator[Any]:
    """``items``; under a trace the items in order until each class
    ``key(item)`` has run twice (or all of its items), the last of them
    standing for the rest of its class.  For a loop whose iterations of one
    class cost the same and leave the live set as they found it (flash
    attention's chunk pairs: each replaces its row's accumulators by new
    ones of the same size); running each class twice also runs each
    class after each other one, as the previous iteration's tensors are
    still held then."""
    tr = _ACTIVE
    if tr is None or not tr.cut:
        yield from items
        return
    items = list(items)
    counts: Dict[Any, int] = {}
    for it in items:
        counts[key(it)] = counts.get(key(it), 0) + 1
    run: List[Any] = []
    seen: Dict[Any, int] = {}
    for it in items:
        if all(seen.get(k, 0) >= min(2, c) for k, c in counts.items()):
            break
        run.append(it)
        seen[key(it)] = seen.get(key(it), 0) + 1
    if len(run) == len(items):
        yield from items
        return
    tr.loops[name] = len(items)
    uid = tr.instance(name)
    last = {key(it): i for i, it in enumerate(run)}
    for i, it in enumerate(run):
        k = key(it)
        w = counts[k] - seen[k] + 1 if last[k] == i else 1
        f = tr.frame(name, -1, len(items), w, uid)
        lo = tr.enter(f)
        try:
            yield it
        finally:
            tr.leave(f, lo)


def missing_grad(p: torch.Tensor, path: str, index: int) -> torch.Tensor:
    """The gradient of a parameter autograd gave none: zeros like ``p``.
    Under a trace, a member ``index`` of a leaf under ``path`` whose
    iteration the trace skipped (:func:`trips`' ``owner``) has a gradient
    on the card, which the middle iteration's copies stand for: its zeros
    are made without being counted."""
    tr = _ACTIVE
    skipped = tr is not None and index in tr.skipped.get(
        path.split("/")[0], ())
    if not skipped:
        return torch.zeros_like(p)
    tr.ghost += 1
    try:
        return torch.zeros_like(p)
    finally:
        tr.ghost -= 1


def record_kernel(name: str, flops: float, moved: float) -> None:
    """A hand-written kernel's launch on tensors without data: one op
    ``name`` with its FLOPs and bytes (no-op outside a trace)."""
    tr = _ACTIVE
    if tr is not None and not tr.ghost:
        tr._count(name, flops, moved, _weight(tr.ctx()))


def record_collective(mesh, record: Record,
                      t: Optional[torch.Tensor] = None) -> None:
    """A collective a recording mesh issues (``(kind, bytes, group
    size)``): appended to ``mesh.collectives``, and under a trace over
    this mesh also to the trace's events (``t``: its operand, whose maker
    places a backward node made outside every loop)."""
    mesh.collectives.append(record)
    tr = _ACTIVE
    if tr is not None and tr.mesh is mesh and not tr.ghost:
        tr.events.append(("c", record, tr.ctx(() if t is None else (t,))))


def analyze(fn: Callable, *args, n_chips: int = 1, mesh=None,
            cut: bool = True, **kwargs) -> TraceCost:
    """Run ``fn(*args, **kwargs)`` on its tensors without data (``meta``)
    and return its :class:`TraceCost`; ``mesh``: the recording mesh whose
    collectives to count (``launch.dryrun.RecordingMesh``).  ``n_chips``
    is kept on the result: the counts are one chip's.  ``cut=False``
    traces every iteration of every loop (what the trip counts stand
    for)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("analyze does not nest")
    tr = _Tracer(mesh, cut)
    t0 = time.perf_counter()
    _ACTIVE = tr
    try:
        with tr:
            fn(*args, **kwargs)
    finally:
        _ACTIVE = None
        tr.open = False
    return tr.result(time.perf_counter() - t0, n_chips)


# ----------------------------------------------------------------------------
# replaying the events with every iteration of the stacks
# ----------------------------------------------------------------------------

def _stacked(ctx: Tuple[_Frame, ...]) -> Tuple[_Frame, ...]:
    return tuple(f for f in ctx if f.stacked)


class _Replay:
    """The live bytes and collectives of the whole program, from a trace
    whose stacks ran a few iterations: each middle iteration's run of
    events (forward, backward or recompute) played as often as it stands
    for, its storages told apart by the real iteration index of each stack
    they were made in (a key ``(sid, indices)``)."""

    def __init__(self, events, sids):
        self.events = events
        self.sids = sids
        self.ectx = [_stacked(c) for _, _, c in events]
        self.alloc_ctx = [_stacked(c) for _, c, _ in sids]
        # each iteration's storages by their role: the op that made them,
        # their size and how many such the iteration made before
        self.slots: Dict[tuple, Dict[tuple, int]] = {}
        self.role: Dict[tuple, tuple] = {}
        seen: Dict[tuple, int] = {}
        for sid, c in enumerate(self.alloc_ctx):
            for f in c:
                it = (f.uid, f.dir, f.pos)
                kind = it + (sids[sid][2], sids[sid][0])
                role = kind[3:] + (seen.get(kind, 0),)
                seen[kind] = role[-1] + 1
                self.slots.setdefault(it, {})[role] = sid
                self.role[it + (sid,)] = role
        self.live: Dict[tuple, int] = {}
        self.bytes = 0
        self.peak = 0
        self.records: List[Record] = []
        self.rep = [_weight(tuple(f for f in c if not f.stacked))
                    for _, _, c in events]

    def run(self) -> Tuple[int, List[Record]]:
        self._play(0, len(self.events), 0, {})
        return self.peak, self.records

    def _play(self, lo: int, hi: int, depth: int, env: Dict[int, int]):
        i = lo
        while i < hi:
            c = self.ectx[i]
            if len(c) <= depth:
                self._emit(i, env)
                i += 1
                continue
            f = c[depth]
            j = i + 1
            while j < hi and len(self.ectx[j]) > depth and \
                    self.ectx[j][depth] == f:
                j += 1
            if f.pos == 1:
                w = f.weight
                order = range(w, 0, -1) if f.dir == "b" else range(1, w + 1)
            else:
                order = (f.real(f.pos),)
            for r in order:
                self._play(i, j, depth + 1, {**env, f.uid: r})
            i = j

    def _emit(self, i: int, env: Dict[int, int]) -> None:
        kind, x, c = self.events[i]
        if kind == "c":
            self.records.extend([x] * self.rep[i])
        elif kind == "a":
            key = (x, tuple(env[f.uid] for f in self.alloc_ctx[x]))
            self.live[key] = self.sids[x][0]
            self.bytes += self.sids[x][0]
            self.peak = max(self.peak, self.bytes)
        else:
            keys, moved = self._keys(x, self.ectx[i], env)
            hit = [k for k in keys if k in self.live]
            if not hit and moved:
                hit = self._alike(keys[0])
            for key in hit:
                self.bytes -= self.live.pop(key)

    def _keys(self, sid: int, at: Tuple[_Frame, ...], env: Dict[int, int]
              ) -> Tuple[List[tuple], bool]:
        """The keys of the copies of storage ``sid`` that a free at frames
        ``at`` (real indices ``env``) frees, and whether the storage was
        taken from another iteration's slot."""
        here = {f.uid: f for f in at}
        choices: List[List[int]] = []
        moved = False
        level = 0
        while level < len(self.alloc_ctx[sid]):
            f = self.alloc_ctx[sid][level]
            g = here.get(f.uid)
            if g is None:                   # freed outside the loop: all
                choices.append(list(range(1, f.weight + 1)) if f.pos == 1
                               else [f.real(f.pos)])
                level += 1
                continue
            r = min(max(env[f.uid] - (g.pos - f.pos), 0), f.n - 1)
            pos = f.position(r)
            if pos != f.pos:
                sid = self._moved(sid, f, pos)
                moved = True
            choices.append([r])
            level += 1
        return [(sid, rs) for rs in itertools.product(*choices)], moved

    def _moved(self, sid: int, f: _Frame, pos: int) -> int:
        """The storage of position ``pos``'s iteration in the role ``sid``
        has in its own iteration's (the iterations are identical)."""
        role = self.role[(f.uid, f.dir, f.pos, sid)]
        return self.slots.get((f.uid, f.dir, pos), {}).get(role, sid)

    def _alike(self, key: tuple) -> List[tuple]:
        """A live storage of the same iteration and size as ``key``, the
        latest made: where the iterations' roles differ (a gradient summed
        over every iteration is a new sum in all but the first one run),
        the one the free meant."""
        sid, rs = key
        ctx = self.alloc_ctx[sid]
        size = self.sids[sid][0]
        best = None
        for k in self.live:
            c = self.alloc_ctx[k[0]]
            if k[1] == rs and self.sids[k[0]][0] == size and len(c) == len(
                    ctx) and (c[0].uid, c[0].dir) == (ctx[0].uid, ctx[0].dir) \
                    and (best is None or k[0] > best[0]):
                best = k
        return [] if best is None else [best]


def _replay(events, sids) -> Tuple[int, List[Record]]:
    return _Replay(events, sids).run()


# ----------------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------------

def main(argv=None) -> int:
    """Trace one step of an architecture (one device, or rank 0 of a
    production mesh) and print its cost as one JSON line."""
    import argparse
    import json

    from repro_torch.configs.base import SHAPES, get_config, reduced
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "pod", "multipod"],
                    help="trace rank 0 of this production mesh (default: "
                         "one device)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    seq, batch, kind = SHAPES[args.shape]
    seq, batch = args.seq or seq, args.batch or batch
    mesh = None if args.mesh == "none" else make_production_mesh(
        multi_pod=args.mesh == "multipod")
    cost = D.trace_step(cfg, kind, seq, batch, mesh)
    print(json.dumps({"arch": cfg.name, "kind": kind, "seq": seq,
                      "batch": batch, "flops": cost.flops,
                      "bytes": cost.bytes_accessed,
                      "peak_temp_bytes": cost.peak_temp_bytes,
                      "collective_bytes": cost.collective_total,
                      "loops": cost.loops, "seconds": cost.seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
