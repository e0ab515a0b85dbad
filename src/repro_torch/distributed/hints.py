"""Sharding hints for model code, set by the launcher (torch counterpart of
``repro/distributed/hints.py``).

Model functions are mesh-agnostic: the launcher calls :func:`activate`
with a mesh, and the model reads the mesh through these functions.
Activating a :class:`~repro_torch.launch.mesh.ShapeMesh` on one process
changes what the mesh changes in the reference's math, and runs no
collective: the MoE's dispatch groups (``G = |batch axes|``), the
attention branch (KV heads expanded to H) and the tensor-parallel
layout's arithmetic, block by block (:func:`shape_blocks`).  Tests and
``chip_smoke.py`` use it to build single-process counterparts of a mesh
run.

On a live :class:`~repro_torch.launch.mesh.HostMesh` whose ``model`` axis
has ``C > 1`` ranks the model computes in the reference's
tensor-parallel layout (``distributed/sharding.py``: column-parallel
``wq wk wv``, FFN inputs and Mamba2 mixer inputs, row-parallel ``wo``
and ``out_proj``, vocabulary-parallel embeddings and heads), and these
functions are the collectives GSPMD places from the reference's
``residual`` / ``gathered`` hints, the Megatron-SP schedule, as autograd
functions:

  * :func:`column_products` enters a tensor-parallel region (attention,
    an MLP, a vocabulary-parallel head) with its column-parallel
    products: the reference's ``gathered``, fused with them.  On a stream
    split over ``model`` along the sequence (:func:`split_seq`) it
    all-gathers the sequence, and its backward reduce-scatters the input's
    gradient (each rank's products' shares summed in float32 and rounded
    once); on a whole stream it is Megatron's ``f`` (identity; backward
    all-reduce).
  * :func:`residual` leaves one: the row-parallel partial sums are
    reduce-scattered along the sequence (backward: all-gather), or on a
    whole stream all-reduced (Megatron's ``g``; backward identity).  The
    reference applies ``residual`` to the whole stream; the port applies
    it where the partial sums meet the stream.
  * :func:`whole` / :func:`part` enter and leave a region that every
    ``model`` rank computes whole (the MoE, with its experts over
    ``model`` through :func:`over_model`): all-gather (backward: this
    rank's slice) and slice (backward: all-gather).
  * :func:`shared` passes a parameter that every ``model`` rank holds
    whole (a norm's scale) into the computation on its own positions of
    a split stream: identity, its gradient summed over ``model``;
    :func:`replicated` does so for several at once (the Mamba2 mixer's
    small leaves, of which each rank uses its heads' or channels' slice),
    in one float32 all-reduce.
  * :func:`model_sum` sums a tensor over ``model`` both ways (the Mamba2
    gated norm's sums of squares over its channel blocks).

Where the sequence does not divide over ``model`` (decode's ``S = 1``) the
stream stays whole on every ``model`` rank, as the reference's
:func:`constrain` drops an axis that does not divide.  On a live mesh
with ``C = 1`` every one of them returns its argument, and on a
shape-only mesh every collective does (one process computes the ranks'
blocks in turn, :func:`shape_blocks`; :func:`fan` sums the gradients of
a tensor every block uses in rank order, as a collective's backward
sums them over the ranks).  :func:`constrain` and :func:`attn_heads`
are layout constraints of the reference that the port's explicit blocks
make hold; they return their argument.  :func:`batch_total` sums a
count over the batch axes (a loss's normalisation); :func:`vocab_nll`
and :func:`vocab_argmax` are the vocabulary-parallel cross entropy and
greedy pick.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

_ACTIVE: dict = {"axis_names": (), "axis_sizes": {}, "mesh": None}


def activate(mesh) -> None:
    """Make ``mesh`` (a shape-only or a host mesh) the model's mesh."""
    _ACTIVE["axis_names"] = tuple(mesh.axis_names)
    _ACTIVE["axis_sizes"] = {a: int(mesh.shape[a]) for a in mesh.axis_names}
    _ACTIVE["mesh"] = mesh if getattr(mesh, "live", False) else None


def deactivate() -> None:
    _ACTIVE["axis_names"] = ()
    _ACTIVE["axis_sizes"] = {}
    _ACTIVE["mesh"] = None


def batch_axes() -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _ACTIVE["axis_names"])


def axis_size(axes) -> int:
    if not axes:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= _ACTIVE["axis_sizes"].get(a, 1)
    return n


def active() -> bool:
    return bool(_ACTIVE["axis_names"])


def live_mesh():
    """The active mesh when it spans processes (a live host mesh), else
    None."""
    return _ACTIVE["mesh"]


def batch_shards() -> int:
    """How many ranks split the batch: the batch axes' size on a live
    mesh, 1 otherwise (a shape-only mesh holds the whole batch)."""
    return axis_size(batch_axes()) if live_mesh() is not None else 1


def tp_mesh():
    """The live mesh when its ``model`` axis has more than one rank (the
    model then computes in the tensor-parallel layout), else None."""
    mesh = live_mesh()
    return mesh if mesh is not None and mesh.shape["model"] > 1 else None


def model_coords() -> Tuple[int, int]:
    """``(C, c)``: the ``model`` axis' size and this rank's coordinate on
    it (``(1, 0)`` off a tensor-parallel mesh)."""
    mesh = tp_mesh()
    return (1, 0) if mesh is None else (mesh.shape["model"],
                                        mesh.coords["model"])


def shape_blocks() -> int:
    """The ``model`` axis' size ``C`` of an active shape-only mesh (1 on a
    live mesh, off a mesh, or at ``C = 1``).  One process under a
    shape-only mesh runs the tensor-parallel layout's arithmetic block by
    block: each rank's column, row, head and vocabulary blocks, their
    sums in rank order and in the mesh's dtypes (``column_products``,
    ``layers.row_parallel``, ``vocab_nll``), so it is a mesh run's
    counterpart to the last bit but for the data-parallel sums."""
    if live_mesh() is not None or not active():
        return 1
    return axis_size("model")


def split_seq(n: int) -> bool:
    """Whether a stream of ``n`` positions is split over ``model`` along
    the sequence: where the active mesh's ``model`` axis (live, or
    shape-only: one process then normalises block by block) divides
    ``n``."""
    C = axis_size("model") if active() else 1
    return C > 1 and n % C == 0


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's sharding constraint; a plain local tensor is left
    as it is (see the module docstring)."""
    return x


def attn_heads(t: torch.Tensor) -> torch.Tensor:
    """The reference's TP layout for ``(B, S, H, hd)`` attention tensors
    (heads over ``model`` when divisible), which ``models/layers.py``'s
    column blocks hold; the tensor is left as it is."""
    return t


class _Copy(torch.autograd.Function):
    """Megatron's ``f`` over one or more tensors: identity; the backward
    sums their gradients over ``model`` in one float32 all-reduce, each
    rounded once to its dtype."""

    @staticmethod
    def forward(ctx, mesh, *ps):
        ctx.mesh = mesh
        return tuple(p.view_as(p) for p in ps)

    @staticmethod
    def backward(ctx, *gs):
        flat = ctx.mesh.all_reduce(torch.cat(
            [g.reshape(-1).float() for g in gs]), ("model",))
        out, i = [], 0
        for g in gs:
            out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
            i += g.numel()
        return (None, *out)


class _Columns(torch.autograd.Function):
    """A tensor-parallel region's input gathered whole (``dim``: the
    sequence of a split stream; None: the stream is whole) and its
    products with this rank's column blocks ``ws``.  The backward sums
    the products' input gradients (this rank's share of the input's) in
    float32, rounds the sum once to the input's dtype and reduce-scatters
    it over ``model`` (or all-reduces it, Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, *ws):
        h = x if dim is None else mesh.all_gather(x.contiguous(), "model",
                                                  dim)
        ctx.mesh, ctx.dim = mesh, dim
        ctx.save_for_backward(h, *ws)
        return tuple(h @ w for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        h, *ws = ctx.saved_tensors
        dx, dws = _input_and_weight_grads(h, gs, ws)
        if ctx.dim is None:
            dx = ctx.mesh.all_reduce(dx, ("model",))
        else:
            dx = ctx.mesh.reduce_scatter(dx, "model", ctx.dim)
        return (dx, None, None, *dws)


def _input_and_weight_grads(h, gs, ws):
    """A region's products' gradients: the input's, their float32 sum
    rounded once to ``h``'s dtype, and each weight's."""
    flat = h.reshape(-1, h.shape[-1])
    dx, dws = None, []
    for g, w in zip(gs, ws):
        if g is None:
            dws.append(None)
            continue
        q = g.float() @ w.float().T
        dx = q if dx is None else dx + q
        dws.append(flat.T @ g.reshape(-1, g.shape[-1]).to(flat.dtype))
    return dx.to(h.dtype), dws


class _Reduce(torch.autograd.Function):
    """Megatron's ``g``: the sum over ``model``; the backward passes the
    gradient on."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSum(torch.autograd.Function):
    """Every ``model`` rank's block along ``dim``, concatenated; each rank
    then computes its own share from the whole, so the backward sums the
    ranks' gradients and keeps this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(y.contiguous(), "model", dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g.contiguous(), "model",
                                       ctx.dim), None, None


class _ScatterSum(torch.autograd.Function):
    """This rank's block along ``dim`` of the partial sums summed over
    ``model`` (a reduce-scatter); the backward all-gathers the
    gradient."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.reduce_scatter(y.contiguous(), "model", dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), "model",
                                   ctx.dim), None, None


class _Slice(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor every ``model`` rank
    holds whole; the backward gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // mesh.shape["model"]
        return x.narrow(dim, mesh.coords["model"] * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), "model", ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Every ``model`` rank's slice along ``dim``, concatenated; the
    backward takes this rank's slice of the (whole) gradient."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, y.shape[dim]
        return mesh.all_gather(y.contiguous(), "model", dim)

    @staticmethod
    def backward(ctx, g):
        c = ctx.mesh.coords["model"]
        return g.narrow(ctx.dim, c * ctx.n, ctx.n).contiguous(), None, None


def _split_of(x: torch.Tensor, split: Optional[bool]) -> bool:
    return split_seq(x.shape[1]) if split is None else split


class _BlockColumns(torch.autograd.Function):
    """:class:`_Columns` on one process under a shape-only mesh of ``n``
    blocks: each product computed per column block (a rank's; a width
    that does not divide stays whole, as on the mesh), each block's input
    gradient summed over the products in float32 and rounded, and the
    blocks' summed in rank order, as the mesh's reduction sums them."""

    @staticmethod
    def forward(ctx, x, n, *ws):
        ctx.n = n
        ctx.save_for_backward(x, *ws)
        return tuple(x @ w if w.shape[1] % n else torch.cat(
            [x @ b for b in _col_blocks(w, n)], dim=-1) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        n = ctx.n
        blocks: list = [[] for _ in ws]       # each weight's gradient blocks
        dx = None
        for c in range(n):
            bg, bw, owner = [], [], []
            for i, (g, w) in enumerate(zip(gs, ws)):
                if g is None:
                    continue
                if w.shape[1] % n == 0:
                    k = w.shape[1] // n
                    bg.append(g[..., c * k:(c + 1) * k].contiguous())
                    bw.append(w[:, c * k:(c + 1) * k].contiguous())
                elif c == 0:                      # a whole product: once
                    bg.append(g)
                    bw.append(w)
                else:
                    continue
                owner.append(i)
            part, grads = _input_and_weight_grads(x, bg, bw)
            dx = part if dx is None else dx + part
            for i, wg in zip(owner, grads):
                blocks[i].append(wg)
        dws = [None if not b else b[0] if len(b) == 1 else torch.cat(b, 1)
               for b in blocks]
        return (dx, None, *dws)


def _col_blocks(w: torch.Tensor, n: int) -> list:
    """``w``'s ``n`` column blocks, each contiguous (a rank's block)."""
    k = w.shape[1] // n
    return [w[:, c * k:(c + 1) * k].contiguous() for c in range(n)]


def column_products(x: torch.Tensor, ws, split: bool) -> tuple:
    """``x @ w`` for each column-parallel block ``w`` of a tensor-parallel
    region whose input is the stream ``x`` (``split``: this rank's
    positions): on a tensor-parallel mesh the input gathered whole with
    the products (:class:`_Columns`), on one process under a shape-only
    mesh the same arithmetic block by block (:class:`_BlockColumns`),
    else the plain products."""
    mesh = tp_mesh()
    if mesh is not None:
        return _Columns.apply(x, mesh, 1 if split else None, *ws)
    n = shape_blocks()
    if n > 1:
        return _BlockColumns.apply(x, n, *ws)
    return tuple(x @ w for w in ws)


def residual(y: torch.Tensor, split: Optional[bool] = None) -> torch.Tensor:
    """A tensor-parallel region's row-parallel partial sums ``y`` (B, S,
    d) summed over ``model`` into the stream's layout: reduce-scattered
    along the sequence onto a split stream (backward: all-gather), or
    all-reduced onto a whole one (Megatron's ``g``).  ``split`` defaults
    to :func:`split_seq` of ``y``'s dim 1."""
    mesh = tp_mesh()
    if mesh is None or y.dim() != 3:
        return y
    if _split_of(y, split):
        return _ScatterSum.apply(y, mesh, 1)
    return _Reduce.apply(y, mesh)


def whole(x: torch.Tensor, split: bool) -> torch.Tensor:
    """A split stream ``x`` gathered along the sequence for a region every
    ``model`` rank computes whole (backward: this rank's slice); a whole
    stream as it is."""
    mesh = tp_mesh()
    return _Gather.apply(x, mesh, 1) if mesh is not None and split else x


def part(y: torch.Tensor, split: bool) -> torch.Tensor:
    """A whole region's output ``y`` cut to this rank's positions of a
    split stream (backward: all-gather); on a whole stream as it is."""
    mesh = tp_mesh()
    return _Slice.apply(y, mesh, 1) if mesh is not None and split else y


def shared(p: torch.Tensor, split: bool) -> torch.Tensor:
    """A parameter every ``model`` rank holds whole, used on this rank's
    positions of a split stream: its gradient summed over ``model``."""
    mesh = tp_mesh()
    return _Copy.apply(mesh, p)[0] if mesh is not None and split else p


def replicated(*ps: torch.Tensor) -> tuple:
    """Parameters every ``model`` rank holds whole, of which each uses its
    own part (its heads', its channels'): on a tensor-parallel mesh their
    gradients summed over ``model`` (one all-reduce); else as they are."""
    mesh = tp_mesh()
    return ps if mesh is None else _Copy.apply(mesh, *ps)


class _SumBoth(torch.autograd.Function):
    """The sum over ``model`` of a quantity each rank's share of the work
    adds to and uses (backward: the same sum of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               ("model",))

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(
            g.clone(memory_format=torch.contiguous_format), ("model",)), None


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``model`` on a tensor-parallel mesh, its gradient
    too (an all-reduce each way); else ``x``."""
    mesh = tp_mesh()
    return x if mesh is None else _SumBoth.apply(x, mesh)


class _Fan(torch.autograd.Function):
    """``n`` uses of one tensor whose gradients are summed in the order of
    the uses (a shape-only process's counterpart of a collective's
    backward sum over the ranks, in rank order)."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        total = gs[0]
        for g in gs[1:]:
            total = total + g
        return total, None


def fan(x: torch.Tensor, n: int) -> tuple:
    """``n`` copies of ``x``, one for each rank's block that one process
    computes in turn; their gradients meet in rank order."""
    return _Fan.apply(x, n)


def reduce_from_model(y: torch.Tensor) -> torch.Tensor:
    """Megatron's ``g`` on a tensor-parallel mesh: row-parallel partial
    sums all-reduced over ``model`` (backward: identity)."""
    mesh = tp_mesh()
    return y if mesh is None else _Reduce.apply(y, mesh)


def gather_model(y: torch.Tensor, dim: int) -> torch.Tensor:
    """Every ``model`` rank's block of ``y`` along ``dim``, concatenated
    (a column-parallel product's columns); the backward reduce-scatters."""
    mesh = tp_mesh()
    return y if mesh is None else _GatherSum.apply(y, mesh, dim)


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch axes of a live mesh (a copy; no
    gradient flows through the sum), ``x`` itself otherwise."""
    mesh = live_mesh()
    if mesh is None:
        return x
    return mesh.all_reduce(x.detach().clone(), batch_axes())


def over_model(fn: Callable, *xs: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(*xs)`` computed over ``model``: on a live mesh whose ``model``
    axis divides ``xs[0].shape[dim]``, each rank runs ``fn`` on its slice
    of every ``x`` (whole on every ``model`` rank) along ``dim`` and the
    results are gathered along ``dim``.  Otherwise ``fn(*xs)``."""
    mesh = live_mesh()
    n = mesh.shape["model"] if mesh is not None else 1
    if n == 1 or xs[0].shape[dim] % n:
        return fn(*xs)
    return _Gather.apply(fn(*(_Slice.apply(x, mesh, dim) for x in xs)),
                         mesh, dim)


class _VocabNLL(torch.autograd.Function):
    """The cross entropy of vocabulary-parallel logits in float32: the
    maximum, the sum of exponentials and the target's logit each reduced
    over the vocabulary's blocks: over ``model`` on a mesh (``logits``
    this rank's block, ``n = 1``), or over the ``n`` blocks of whole
    logits in rank order on one process under a shape-only mesh
    (``mesh`` None)."""

    @staticmethod
    def forward(ctx, logits, target, mesh, n):
        lf = logits.float()
        vl = lf.shape[-1] // n
        blocks = ([lf] if n == 1 else
                  [lf[..., b * vl:(b + 1) * vl].contiguous()
                   for b in range(n)])
        m = blocks[0].amax(dim=-1)
        for b in blocks[1:]:
            m = torch.maximum(m, b.amax(dim=-1))
        if mesh is not None:
            m = mesh.all_reduce(m, ("model",), "max")
        es = [torch.exp(b - m[..., None]) for b in blocks]
        s = es[0].sum(dim=-1)
        for e_ in es[1:]:
            s = s + e_.sum(dim=-1)
        if mesh is not None:
            s = mesh.all_reduce(s, ("model",))
        c = mesh.coords["model"] if mesh is not None else 0
        local = target.long() - c * lf.shape[-1]
        inside = (local >= 0) & (local < lf.shape[-1])
        idx = local.clamp(0, lf.shape[-1] - 1)
        t = torch.where(inside, torch.gather(lf, -1, idx[..., None])[..., 0],
                        0.0)
        if mesh is not None:
            t = mesh.all_reduce(t, ("model",))
        e = es[0] if n == 1 else torch.cat(es, dim=-1)
        ctx.save_for_backward(e, s, idx, inside)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - t

    @staticmethod
    def backward(ctx, g):
        e, s, idx, inside = ctx.saved_tensors
        grad = e / s[..., None]
        grad.scatter_add_(-1, idx[..., None], -inside[..., None].float())
        return (grad * g[..., None]).to(ctx.dtype), None, None, None


def vocab_nll(logits: torch.Tensor, target: torch.Tensor,
              vocab: int = None) -> torch.Tensor:
    """``-log_softmax(logits)[target]`` in float32 over the last dim, which
    on a tensor-parallel mesh holds this rank's block of the vocabulary
    (the ``c``-th of ``C``; on one process under a shape-only mesh the
    blocks' reductions in rank order); ``target`` holds global ids.
    ``vocab``: the whole vocabulary's size; logits that hold all of it
    (a head whose vocabulary ``model`` does not divide stays whole) reduce
    nothing over the mesh."""
    mesh = tp_mesh()
    if mesh is not None and logits.shape[-1] != vocab:
        return _VocabNLL.apply(logits, target, mesh, 1)
    n = shape_blocks()
    if n > 1 and logits.shape[-1] % n == 0:
        return _VocabNLL.apply(logits, target, None, n)
    ls = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(ls, -1, target.long()[..., None])[..., 0]


@torch.no_grad()
def vocab_argmax(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The global id of the largest logit over the last dim, the lowest id
    winning a tie (``jnp.argmax``'s rule), where ``logits`` may hold this
    rank's block of a ``vocab`` split over ``model``: each rank's first
    maximum and its value are gathered, and the lowest rank holding the
    largest value wins."""
    mesh = tp_mesh()
    if mesh is None or logits.shape[-1] == vocab:
        return torch.argmax(logits, dim=-1)
    vl = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0].float()
    vals = mesh.all_gather(val[None].contiguous(), "model", 0)
    ids = mesh.all_gather((idx + mesh.coords["model"] * vl)[None].contiguous(),
                          "model", 0)
    best = vals.amax(dim=0)
    first = torch.argmax((vals == best).to(torch.int32), dim=0)
    return torch.gather(ids, 0, first[None])[0]
