"""The traced cost model of a step (``repro_torch/roofline/trace_cost.py``)
against the reference's HLO cost model (``repro/roofline/hlo_cost.py``,
``tests/test_hlo_cost.py``) and against itself without trip counts.

A loop's trip count multiplies its FLOPs (the reference's scanned loop);
the checkpointed six-layer gradient counts the reference's dots; a hand
built chain of ops has the peak and bytes worked out by hand; a recording
mesh's collectives in a loop are counted per iteration; B1–B7 on tensors
without data are one op each (B1–B6 with ``roofline/spmv_bytes.py``'s
FLOPs and bytes) and launch nothing; a dot counts 2 N; for each family at reduced
size and a depth of 6 the trip-count cost equals a trace of every
iteration (FLOPs, bytes, collectives, peak); flash attention's chunk pairs
too; and the reduced train, prefill and decode steps count the
reference's compiled FLOPs, the Mamba2 mixer's train step less a named
residual.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs import base as jbase
from repro.launch import steps as JST
from repro.optim.adamw import OptConfig as JOpt
from repro.roofline import hlo_cost
from repro_torch.configs import base
from repro_torch.kernels import _build
from repro_torch.kernels import dsc as KD
from repro_torch.kernels import fcoo as KF
from repro_torch.kernels import wc as KW
from repro_torch.kernels.moe_gmm import grouped_matmul, moe_gmm
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.models.flash import flash_attention
from repro_torch.optim.adamw import OptConfig
from repro_torch.roofline import spmv_bytes as SB
from repro_torch.roofline import trace_cost as TC

#: a reduced model of each family
FAMILIES = {"dense": "deepseek-7b", "moe": "phi3.5-moe-42b-a6.6b",
            "ssm": "mamba2-2.7b", "hybrid": "zamba2-1.2b",
            "audio": "musicgen-large", "vlm": "qwen2-vl-7b"}
#: FLOPs per Mamba2 block the reference's reduced train step (2 x 64)
#: counts and the port's does not: its autodiff of the three-operand SSD
#: einsums sums over a broadcast axis (the heads of a group, the head dim)
#: with dot_generals, which ``hlo_cost`` counts, where the port's autograd
#: of the same pairwise products multiplies and sums, which
#: ``flop_counter`` does not
MAMBA_TRAIN_RESIDUAL = 2 * 65_536 + 524_288 + 1_048_576


def _rms(x):
    v = torch.mean(torch.square(x.float()), -1, keepdim=True)
    return (x.float() * torch.rsqrt(v + 1e-6)).to(x.dtype)


def _body(x, w):
    return x + _rms(x) @ w


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_scan_flops_corrected():
    """An 8-iteration loop counts its body 8 times, with trip count 8, and
    equals a trace of every iteration."""
    def loop(x, ws):
        for i in TC.trips("loop", ws.shape[0]):
            x = _body(x, ws[i])
        return x

    x, ws = _meta(128, 128), _meta(8, 128, 128)
    cut, full = TC.analyze(loop, x, ws), TC.analyze(loop, x, ws, cut=False)
    assert cut.flops == 8 * 2 * 128 ** 3
    assert cut.loops == {"loop": 8} and full.loops == {}
    assert (cut.flops, cut.bytes_accessed, cut.peak_temp_bytes) == (
        full.flops, full.bytes_accessed, full.peak_temp_bytes)


def test_checkpointed_gradient_matches_reference():
    """The checkpointed six-layer gradient of ``test_hlo_cost.py`` counts
    the reference's dots exactly, with or without trip counts."""
    def loss(x, ws):
        return jnp.sum(jax.lax.scan(jax.checkpoint(
            lambda x, w: (x + _jrms(x) @ w, None)), x, ws,
            unroll=6)[0].astype(jnp.float32) ** 2)

    def _jrms(x):
        v = jnp.mean(jnp.square(x.astype(jnp.float32)), -1, keepdims=True)
        return (x.astype(jnp.float32) * jax.lax.rsqrt(v + 1e-6)).astype(
            x.dtype)

    c = jax.jit(jax.grad(loss, argnums=(0, 1))).lower(
        jax.ShapeDtypeStruct((64, 256), jnp.bfloat16),
        jax.ShapeDtypeStruct((6, 256, 256), jnp.bfloat16)).compile()
    want = hlo_cost.analyze(c.as_text(), 1).flops

    def grad(x, ws):
        x, ws = x.requires_grad_(), ws.requires_grad_()
        h = x
        for i in TC.trips("layers", ws.shape[0]):
            h = checkpoint(_body, h, ws[i], use_reentrant=False)
        return torch.autograd.grad(torch.sum(h.float() ** 2), [x, ws])

    args = (_meta(64, 256, dtype=torch.bfloat16),
            _meta(6, 256, 256, dtype=torch.bfloat16))
    cut = TC.analyze(grad, *args)
    full = TC.analyze(grad, *args, cut=False)
    assert want == cut.flops == full.flops == 150_994_944
    assert cut.peak_temp_bytes == full.peak_temp_bytes
    assert cut.bytes_accessed == full.bytes_accessed


def test_peak_and_bytes_of_a_hand_built_chain():
    """Storages live from the op that makes them to their last reference;
    a view shares its storage; bytes are each op's inputs and outputs,
    views none."""
    def chain(x):                       # x: 64 x 64 float32, 16 KiB
        a = x + 1                       # 16384: a
        b = a[:32] * 2                  # 8192 (a view read): a + b = 24576
        del a                           # 8192
        c = torch.cat([b, b, b])        # 24576: b + c = 32768
        return c.sum()                  # 4: 32772

    cost = TC.analyze(chain, _meta(64, 64))
    assert cost.peak_temp_bytes == 32_772
    assert cost.bytes_accessed == ((16_384 + 16_384) + (8_192 + 8_192)
                                   + (3 * 8_192 + 24_576) + (24_576 + 4))
    assert cost.flops == 0
    assert cost.by_op["cat"] == {"flops": 0.0, "bytes": 49_152.0,
                                 "calls": 1}


def test_collectives_of_a_loop_are_counted_per_iteration():
    """An 8-step loop with an all-reduce over a recording mesh gives 8
    records, the ring model's bytes 8 times."""
    rec = D.RecordingMesh((1, 8), ("data", "model"))

    def f(x, ws):
        for i in TC.trips("steps", ws.shape[0]):
            x = rec.all_reduce(x @ ws[i], ("model",))
        return x

    cost = TC.analyze(f, _meta(16, 64), _meta(8, 64, 64), mesh=rec)
    assert cost.records == [("all-reduce", 16 * 64 * 4, 8)] * 8
    assert cost.collective["all-reduce"] == 8 * 2 * (16 * 64 * 4) * 7 / 8
    assert cost.collective_total == cost.collective["all-reduce"]


def test_b7_on_tensors_without_data_is_one_op():
    """B7 on ``meta`` tensors returns its output's shape and dtype, counts
    one ``moe_gmm`` op of 2 rows K N FLOPs (x, the experts' W and the tile
    ids read, out written) and launches nothing; its gradient on the
    segment layout runs B7 again on the transposed weights and a bmm."""
    E, cap, K, N, tile = 4, 32, 64, 128, 16
    before = dict(_build.LAUNCHES)
    ids = torch.zeros(E * cap // tile, dtype=torch.int32, device="meta")
    x, w = _meta(E * cap, K, dtype=torch.bfloat16), _meta(
        E, K, N, dtype=torch.bfloat16)
    out = []
    cost = TC.analyze(lambda: out.append(moe_gmm(ids, x, w, t_tile=tile)))
    assert out[0].shape == (E * cap, N) and out[0].dtype == torch.bfloat16
    assert out[0].is_meta
    assert cost.by_op["moe_gmm"] == {
        "flops": 2.0 * E * cap * K * N,
        "bytes": (E * cap * K + E * K * N + E * cap * N) * 2.0
        + ids.numel() * 4, "calls": 1}
    assert cost.flops == 2 * E * cap * K * N

    def train(x, w):
        x, w = x.requires_grad_(), w.requires_grad_()
        y = grouped_matmul(x, w, capacity=cap, t_tile=tile)
        return torch.autograd.grad(y.float().sum(), [x, w])

    cost = TC.analyze(train, x, w)
    assert cost.by_op["moe_gmm"]["calls"] == 2          # forward, dx
    assert cost.by_op["bmm"]["flops"] == 2.0 * E * cap * K * N   # dW
    assert dict(_build.LAUNCHES) == before


#: B1–B6 on ``meta`` operands: Ntheta, atoms, voxels and fibers, and
#: the layouts' sizes (COO: 7 tiles of 32 slots in 4 row blocks of 8;
#: SELL: 16 rows of 4 slots, 13 of them real; F-COO: 3 chunks of 32)
NT, NA, NV, NF = 8, 12, 100, 60
LIFE_KERNELS = ("dsc_coo", "wc_coo", "dsc_sell", "wc_sell", "dsc_fcoo",
                "wc_fcoo")


def _life_kernel_call(name: str, dt: torch.dtype):
    """(a call of wrapper ``name`` on ``meta`` operands, storage ``dt``;
    its output's shape; ``spmv_bytes``' work for them)."""
    i32 = torch.int32
    d = _meta(NA, NT, dtype=dt)
    w, y = _meta(NF), _meta(NV, NT)
    kw = dict(d_bytes=NA * NT * d.element_size(),
              value_bytes=d.element_size())
    if name in ("dsc_coo", "wc_coo"):
        tiles = (_meta(5, dtype=i32), _meta(7, dtype=i32),
                 _meta(7, 32, dtype=i32), _meta(7, 32, dtype=i32),
                 _meta(7, 32, dtype=dt), _meta(7, 32, dtype=i32), d)
        layout = dict(n_row_blocks=4, n_tiles=7, row_tile=8, **kw)
        if name == "dsc_coo":
            return (lambda: KD.dsc_coo(*tiles, w, row_tile=8), (32, NT),
                    SB.dsc_coo(7 * 32, NT, n_fibers=NF, **layout))
        return (lambda: KW.wc_coo(*tiles, y, row_tile=8), (32,),
                SB.wc_coo(7 * 32, NT, n_voxels=NV, **layout))
    if name in ("dsc_sell", "wc_sell"):
        sell = (_meta(16, 4, dtype=i32), _meta(16, 4, dtype=i32),
                _meta(16, 4, dtype=dt), _meta(13, dtype=i32), d)
        layout = dict(n_rows=13, rows_padded=16, **kw)
        if name == "dsc_sell":
            return (lambda: KD.dsc_sell(*sell, w, row_tile=8), (16, NT),
                    SB.dsc_sell(64, NT, n_fibers=NF, **layout))
        return (lambda: KW.wc_sell(*sell, y), (16,),
                SB.wc_sell(64, NT, n_voxels=NV, **layout))
    if name == "dsc_fcoo":
        return (lambda: KF.dsc_fcoo(
            _meta(3, 32, dtype=i32), _meta(3, 32, dtype=i32),
            _meta(3, 32, dtype=dt), _meta(3, 32, dtype=i32), d, w,
            n_voxels=NV), (NV, NT),
            SB.stream(96, NT, n_voxels=NV, n_fibers=NF, **kw))
    return (lambda: KF.wc_fcoo(
        _meta(3, 32, dtype=i32), _meta(3, 32, dtype=i32),
        _meta(96, dtype=i32), _meta(96, dtype=i32), _meta(96, dtype=dt), d,
        y, n_fibers=NF), (NF,),
        SB.wc_fcoo(96, NT, n_voxels=NV, n_fibers=NF, **kw))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", LIFE_KERNELS)
def test_b1_to_b6_on_tensors_without_data_are_one_op(name, dt):
    """Each LiFE wrapper on ``meta`` operands returns a float32 ``meta``
    output of its shape and counts exactly one op named after its kernel,
    whose FLOPs and bytes are ``roofline/spmv_bytes.py``'s for those
    operands (every slot counted), and nothing else moves a byte or
    counts a FLOP; nothing is launched."""
    call, shape, work = _life_kernel_call(name, dt)
    before = dict(_build.LAUNCHES)
    out = []
    cost = TC.analyze(lambda: out.append(call()))
    assert out[0].is_meta and out[0].shape == shape
    assert out[0].dtype == torch.float32
    assert cost.by_op[name] == {"flops": work.flops, "bytes": work.bytes,
                                "calls": 1}
    assert (cost.flops, cost.bytes_accessed) == (work.flops, work.bytes)
    assert set(cost.by_op) == {name, "empty"}
    assert dict(_build.LAUNCHES) == before


def test_a_dot_counts_two_n_flops():
    """``aten.dot`` (which ``flop_counter`` lacks) counts 2 N FLOPs, as
    ``hlo_cost`` counts a ``jnp.vdot``."""
    cost = TC.analyze(torch.dot, _meta(1000), _meta(1000))
    assert cost.flops == cost.by_op["dot"]["flops"] == 2000


def _mesh_step(arch: str, kind: str, seq: int, cut: bool):
    cfg = dataclasses.replace(base.reduced(base.get_config(arch)),
                              n_layers=6, remat=True)
    return D.trace_step(cfg, kind, seq, 4, ShapeMesh((2, 2), ("data",
                                                              "model")),
                        OptConfig(), cut=cut)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_trip_counts_equal_a_full_trace(family, kind):
    """At reduced size, a depth of 6, remat and a (2, 2) mesh, the cost
    with trip counts equals a trace of every iteration: FLOPs, bytes,
    collectives (record for record) and the peak.  The ssm and hybrid
    steps run 5 SSD chunks (seq 640).  No LM step runs a vector dot, so
    counting ``aten.dot`` (the SBBNNLS steps') leaves the LM cells' FLOPs
    as they were."""
    seq = 640 if family in ("ssm", "hybrid") else 64
    cut = _mesh_step(FAMILIES[family], kind, seq, True)
    full = _mesh_step(FAMILIES[family], kind, seq, False)
    assert "dot" not in cut.by_op
    assert cut.loops and not full.loops
    assert cut.flops == full.flops > 0
    assert cut.bytes_accessed == full.bytes_accessed
    assert sorted(cut.records) == sorted(full.records)
    assert cut.collective == full.collective
    assert cut.peak_temp_bytes == full.peak_temp_bytes > 0


def test_flash_pairs_equal_a_full_trace():
    """Flash attention's gradient over 4 chunks (10 pairs) with trip counts
    equals its trace of every pair."""
    def grad(q, k, v):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = flash_attention(q, k, v, 512)
        return torch.autograd.grad(out.float().sum(), [q, k, v])

    args = (_meta(1, 2048, 2, 2, 32, dtype=torch.bfloat16),
            _meta(1, 2048, 2, 32, dtype=torch.bfloat16),
            _meta(1, 2048, 2, 32, dtype=torch.bfloat16))
    cut, full = TC.analyze(grad, *args), TC.analyze(grad, *args, cut=False)
    assert cut.loops == {"flash.pairs": 10}
    assert (cut.flops, cut.bytes_accessed, cut.peak_temp_bytes) == (
        full.flops, full.bytes_accessed, full.peak_temp_bytes)


class _Replicas:
    """A live mesh of ``C`` model ranks that hold the same tensors: a sum
    over ``model`` is ``C`` times the tensor, a maximum the tensor."""

    live = True
    axis_names = ("data", "model")

    def __init__(self, C: int):
        self.shape = {"data": 1, "model": C}
        self.coords = {"data": 0, "model": 0}
        self.calls = []

    def all_reduce(self, t, axes, op="sum"):
        self.calls.append(op)
        return t if op == "max" else t.mul_(self.shape["model"])


def test_whole_vocabulary_logits_sum_nothing_over_the_mesh():
    """Where ``model`` does not divide the vocabulary the head stays whole
    on every rank, and its cross entropy reduces nothing over ``model``
    (it summed the ranks' equal sums of exponentials, a loss log C too
    high: the trace's collectives showed the three reductions on mamba2's
    train cells, which the reckoning did not have); a rank's block of a
    vocabulary that divides still reduces over ``model``."""
    from repro_torch.distributed import hints
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 5, 30, generator=g)
    target = torch.randint(0, 30, (2, 5), generator=g)
    want = -torch.log_softmax(logits, -1).gather(-1, target[..., None])[..., 0]
    mesh = _Replicas(4)
    hints.activate(mesh)
    try:
        whole = hints.vocab_nll(logits, target, 30)
        assert mesh.calls == []
        hints.vocab_nll(logits, target, 120)
        assert mesh.calls == ["max", "sum", "sum"]
    finally:
        hints.deactivate()
    torch.testing.assert_close(whole, want)


def _reference_flops(arch: str, kind: str) -> float:
    cfg = jbase.reduced(jbase.get_config(arch))
    p, o = JST.abstract_state(cfg, JOpt())
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    b = jbase.input_specs(cfg, shape, {"seq_len": 64, "global_batch": 2})
    if kind == "train":
        fn, args = JST.make_train_step(cfg, JOpt()), (p, o, b)
    elif kind == "prefill":
        fn, args = JST.make_prefill(cfg), (p, b)
    else:
        fn, args = JST.make_serve_step(cfg), (p, b)
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text(),
                            1).flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_traced_flops_equal_the_reference_hlo_cost(family, kind):
    """The reduced step's traced FLOPs on one device (2 x 64) equal the
    reference's compiled ``hlo_cost`` FLOPs (deepseek-7b's train step:
    119,537,664), but for the Mamba2 mixer's train step, which counts
    :data:`MAMBA_TRAIN_RESIDUAL` less per Mamba block."""
    arch = FAMILIES[family]
    cfg = base.reduced(base.get_config(arch))
    got = D.trace_step(cfg, kind, 64, 2, opt=OptConfig()).flops
    want = _reference_flops(arch, kind)
    residual = 0
    if kind == "train" and family in ("ssm", "hybrid"):
        residual = MAMBA_TRAIN_RESIDUAL * cfg.n_layers
    assert want - got == residual
    if (family, kind) == ("dense", "train"):
        assert got == 119_537_664
