"""The port's dry run (``repro_torch/launch/dryrun.py``) and its inputs.

``configs.base.input_specs`` / ``cache_specs`` against the reference's,
shape and dtype, for every architecture and shape; life-stn96's mesh
operands against ``repro.distributed.life_shard``'s; the records' bytes
per device against every rank's ``shard_bounds`` blocks; the collective
schedule against what the port's meshes record: a reduced train, prefill
and decode step on a (2, 2) mesh of four gloo CPU ranks
(``HostMesh.collectives``, kind, bytes and group size for each one; the
train step with AdamW and with Adafactor; the Mamba2 mixer's in mamba2,
in mamba2 with one head and in zamba2 with and without a tail), and an
odd and an even SBBNNLS iteration of the 2-D and 1-D steps on a (2, 2)
``LocalMesh`` against their trace (``dryrun.trace_life``) and the hand
reckoning of their ``psum``s; the traced life-stn96 records (collectives
record for record the reckoning's on the pod and multipod meshes, FLOPs
against the reference's compiled ``hlo_cost``, the peak against a hand
count of the live temporaries); the mesh
step's loss against one process's (the audio loss's count over every
data rank); the sweep over every cell of the pod mesh (each ``ok`` or
``skipped``; kimi-k2's train cell trains with Adafactor) through the
CLI; and ``roofline/report.py``'s tables over records of both packages
(a refused record among them) and their comparison of two sweeps.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.distributed import life_shard as JLS
from repro_torch.configs import base
from repro_torch.distributed import life_shard as LS
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as HM
from repro_torch.optim.adamw import OptConfig
from repro_torch.roofline import report

POD = HM.make_production_mesh()
MULTIPOD = HM.make_production_mesh(multi_pod=True)
RANK_ENV = {"OMP_NUM_THREADS": "1"}
#: the reduced step the gloo ranks record: (arch, seq, global batch)
RECORDED = (("phi3.5-moe-42b-a6.6b", 16, 4), ("qwen2-vl-7b", 24, 4),
            ("musicgen-large", 16, 4), ("zamba2-1.2b", 16, 4),
            ("granite-34b", 16, 4), ("kimi-k2-1t-a32b", 16, 4),
            ("mamba2-2.7b", 16, 4), ("zamba2-1.2b+tail", 16, 4),
            ("mamba2-2.7b+whole-heads", 16, 4))
#: reduced configs with a change: zamba2 with a Mamba tail after its
#: super-layer (the stream gathered whole for it), mamba2 with one head,
#: which a model axis of 2 does not divide (every rank runs it from the
#: gathered columns)
VARIANTS = {"zamba2-1.2b+tail": ("zamba2-1.2b", dict(n_layers=3)),
            "mamba2-2.7b+whole-heads": ("mamba2-2.7b",
                                        dict(ssm_head_dim=128))}


def _recorded_cfg(name: str):
    """RECORDED's reduced config ``name`` (a VARIANTS entry's change
    applied), remat on."""
    arch, change = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(base.reduced(base.get_config(arch)),
                               remat=True, **change)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), _dt(tree))


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_input_specs_equal_reference(arch):
    """Every shape's batch (the decode cache within it) and the overrides,
    as meta tensors of the reference's shapes and dtypes."""
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    for shape in base.SHAPES:
        got, want = base.input_specs(cfg, shape), jbase.input_specs(jcfg,
                                                                    shape)
        assert _shapes(got) == jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), want), shape
        assert all(t.device.type == "meta" for t in jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    kw = {"seq_len": 64, "global_batch": 3}
    assert _shapes(base.input_specs(cfg, "decode_32k", kw)) == jax.tree.map(
        lambda s: (tuple(s.shape), str(s.dtype)),
        jbase.input_specs(jcfg, "decode_32k", kw))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2-vl-7b",
                                  "musicgen-large", "mamba2-2.7b"])
def test_cache_specs_equal_reference(arch):
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    got = base.cache_specs(cfg, 2, 40, base.meta_spec, cfg.torch_dtype)
    want = jbase.cache_specs(jcfg, 2, 40, jax.ShapeDtypeStruct,
                             jcfg.jnp_dtype)
    assert _shapes(got) == {k: (tuple(v.shape), str(v.dtype))
                            for k, v in want.items()}


class _JMesh:
    """What the reference's life specs read of a mesh."""

    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.shape = dict(mesh.shape)
        self.devices = np.empty(tuple(mesh.shape.values()))


@pytest.mark.parametrize("mesh", [POD, MULTIPOD], ids=["pod", "multipod"])
@pytest.mark.parametrize("fn", ["life_input_specs", "life_input_specs_1d"])
def test_life_input_specs_equal_reference(mesh, fn):
    for sc in D.LIFE_SCALES.values():
        got = getattr(LS, fn)(mesh, **sc)
        want = getattr(JLS, fn)(_JMesh(mesh), **sc)
        assert got.pop("meta") == want.pop("meta")
        assert _shapes(got) == {k: (tuple(v.shape), str(v.dtype))
                                for k, v in want.items()}


def _every_rank_bytes(t, spec, mesh):
    """Bytes of every rank's block of ``t``, summed (each rank's coordinates
    walked, its block from ``shard_bounds``)."""
    total = 0
    for idx in np.ndindex(*mesh.shape.values()):
        coords = dict(zip(mesh.axis_names, idx))
        b = SH.shard_bounds(tuple(t.shape), spec, mesh, coords)
        total += math.prod(s.stop - s.start for s in b) * t.element_size()
    return total


def _tree_every_rank(tree, specs, mesh):
    if isinstance(tree, dict):
        return sum(_tree_every_rank(tree[k], specs[k], mesh) for k in tree)
    return _every_rank_bytes(tree, specs, mesh)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("deepseek-7b", "train_4k", POD), ("qwen2-vl-7b", "decode_32k", MULTIPOD),
    ("musicgen-large", "prefill_32k", POD), ("zamba2-1.2b", "long_500k", POD),
    ("phi3.5-moe-42b-a6.6b", "train_4k", MULTIPOD),
    ("kimi-k2-1t-a32b", "train_4k", POD),
    ("kimi-k2-1t-a32b", "train_4k", MULTIPOD)])
def test_argument_bytes_are_every_ranks_blocks(arch, shape, mesh):
    """``argument_size_in_bytes`` is one device's share of the blocks every
    rank holds (``shard_bounds`` at each coordinate) of the parameters,
    the optimizer state (train: AdamW's moments, or kimi-k2's Adafactor
    factors), the batch and the cache."""
    from repro_torch.launch import steps as ST
    cfg = base.get_config(arch)
    rec = D.lower_cell(arch, shape, mesh)
    assert rec["status"] == "ok"
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["total_bytes_per_device"] == (
        mem["temp_size_in_bytes"] + mem["argument_size_in_bytes"])
    params, opt = ST.abstract_state(cfg, D.opt_for(cfg))
    ptree = D.param_tree(params)
    want = {"params": _tree_every_rank(
        ptree, SH.param_specs(cfg, mesh, ptree), mesh)}
    if rec["kind"] == "train":
        want["opt"] = _tree_every_rank(
            opt, SH.opt_state_specs(cfg, mesh, opt), mesh)
    batch = base.input_specs(cfg, shape)
    specs = SH.batch_specs(cfg, mesh, shape)
    if "cache" in batch:
        want["cache"] = _tree_every_rank(batch.pop("cache"),
                                         specs.pop("cache"), mesh)
    want["batch"] = _tree_every_rank(batch, specs, mesh)
    got = rec["memory"]["arguments_by_part"]
    assert got == {k: v / mesh.size for k, v in want.items()}
    assert rec["memory"]["argument_size_in_bytes"] == sum(got.values())


RANK_STEPS = """
import dataclasses, json, sys
import torch
import torch.distributed as dist
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.tokens import DataConfig, synth_batch_for
from repro_torch.distributed import hints, lm_shard, spmd
from repro_torch.launch import mesh as HM
from repro_torch.launch import steps as ST
from repro_torch.optim.adamw import OptConfig
torch.set_num_threads(1)
spmd.join_process_group("gloo", torch.device("cpu"))
out = {}
jobs, variants = json.load(open(sys.argv[1]))
for arch, seq, batch in jobs:
    name, change = variants.get(arch, (arch, {}))
    cfg = dataclasses.replace(reduced(get_config(name)), remat=True,
                              **change)
    mesh = HM.make_host_mesh(2, "cpu")
    hints.activate(mesh)
    params = ST.init_placed(cfg, mesh, torch.Generator().manual_seed(0),
                            "cpu")
    sharded = lm_shard.sharded(params)
    opt = OptConfig()
    state = sharded.init_opt_state(opt)
    b = synth_batch_for(cfg, DataConfig(seq_len=seq, global_batch=batch), 0,
                        device="cpu")
    mesh.collectives.clear()
    _, _, metrics = ST.make_train_step(cfg, opt)(params, state, b)
    out[f"{arch}/train"] = list(mesh.collectives)
    out[f"{arch}/loss"] = float(metrics["loss"])
    adafactor = OptConfig(kind="adafactor")
    state = sharded.init_opt_state(adafactor)
    mesh.collectives.clear()
    ST.make_train_step(cfg, adafactor)(params, state, b)
    out[f"{arch}/train-adafactor"] = list(mesh.collectives)
    local = sharded.shard_batch({k: v for k, v in b.items()
                                 if k not in ("labels", "codes")})
    mesh.collectives.clear()
    _, cache = ST.make_prefill(cfg)(params, local, s_max=seq + 2)
    out[f"{arch}/prefill"] = list(mesh.collectives)
    if cfg.family == "audio":
        step = {"frame_embeds": local["frame_embeds"][:, -1:]}
    else:
        step = {"tokens": local["tokens"][:, -1:]}
    if cfg.family == "vlm":
        step["positions"] = local["positions"][:, :, -1:] + 1
    mesh.collectives.clear()
    ST.make_serve_step(cfg)(params, dict(step, cache=cache, cache_index=seq))
    out[f"{arch}/decode"] = list(mesh.collectives)
    hints.deactivate()
if dist.get_rank() == 0:
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
print("RANK DONE", flush=True)
"""


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Four gloo CPU ranks at (2, 2), each step of RECORDED's reduced
    configs (remat on) once, the train step with AdamW and then with
    Adafactor: rank 0's ``HostMesh.collectives`` per step."""
    root = tmp_path_factory.mktemp("dryrun_mesh")
    jobs, out = root / "jobs.json", root / "collectives.json"
    jobs.write_text(json.dumps([RECORDED, VARIANTS]))
    spmd.launch(["-c", RANK_STEPS, str(jobs), str(out)], 4,
                str(root / "ranks"), deadline_s=240.0, env=RANK_ENV)
    return json.loads(out.read_text())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,seq,batch", RECORDED,
                         ids=[a for a, _, _ in RECORDED])
def test_step_collectives_equal_what_a_gloo_mesh_records(recorded, arch, seq,
                                                          batch, kind):
    """The dry run's schedule of a reduced step on a (2, 2) mesh is, kind
    for kind and byte for byte, what four gloo ranks recorded running it
    (weight gathers, gradient sums, attention and expert gathers, ZeRO-1,
    the loss's count and the metrics)."""
    cfg = _recorded_cfg(arch)
    got = D.step_collectives(cfg, HM.ShapeMesh((2, 2), ("data", "model")),
                             kind, seq, batch, OptConfig())
    want = [tuple(r) for r in recorded[f"{arch}/{kind}"]]
    assert sorted(got) == sorted(want)
    assert want


@pytest.mark.parametrize("arch,seq,batch", RECORDED,
                         ids=[a for a, _, _ in RECORDED])
def test_adafactor_step_collectives_equal_what_a_gloo_mesh_records(
        recorded, arch, seq, batch):
    """The dry run's schedule of a reduced Adafactor train step on a (2, 2)
    mesh is, byte for byte, what four gloo ranks recorded running it
    (the model's as AdamW's; the optimizer's factor sums over the axes
    that split a block, the factors' gathers and the RMS sums), and
    differs from AdamW's only in the optimizer."""
    cfg = _recorded_cfg(arch)
    mesh = HM.ShapeMesh((2, 2), ("data", "model"))
    got = D.step_collectives(cfg, mesh, "train", seq, batch,
                             OptConfig(kind="adafactor"))
    want = [tuple(r) for r in recorded[f"{arch}/train-adafactor"]]
    assert sorted(got) == sorted(want)
    model, opt = D._step_parts(cfg, mesh, "train", seq, batch,
                               OptConfig(kind="adafactor"))
    adamw = D._step_parts(cfg, mesh, "train", seq, batch, OptConfig())
    assert model == adamw[0] and opt and opt != adamw[1]


@pytest.mark.parametrize("arch,seq,batch", RECORDED,
                         ids=[a for a, _, _ in RECORDED])
def test_mesh_loss_divides_by_the_whole_batch(recorded, arch, seq, batch):
    """The first step's loss of the (2, 2) gloo mesh (each data rank its
    rows, its sum divided by the count over both: B * S * C codes for the
    audio family, the labels >= 0 for the others) equals one process's
    loss of the whole batch under a shape-only (2, 2) mesh."""
    from repro_torch.data.tokens import DataConfig, synth_batch_for
    from repro_torch.distributed import hints
    from repro_torch.models import transformer as T
    cfg = _recorded_cfg(arch)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = synth_batch_for(cfg, DataConfig(seq_len=seq, global_batch=batch), 0,
                        device="cpu")
    hints.activate(HM.ShapeMesh((2, 2), ("data", "model")))
    try:
        with torch.no_grad():
            _, m = T.loss_fn(cfg, model, b)
    finally:
        hints.deactivate()
    np.testing.assert_allclose(recorded[f"{arch}/loss"], float(m["loss"]),
                               rtol=1e-5)


def _reckoned_life_collectives(mesh, variant: str, meta, n_y: int,
                               n_w: int):
    """The ``psum``s of an odd and an even SBBNNLS iteration of the port's
    ``make_sharded_step`` (2-D: partial Y over ``model``, partial w over
    the rows, every dot over its operand's axis) or
    ``make_sharded_step_1d`` (1-D: the whole Y and w over the mesh; its
    dots are local), reckoned by hand (float32): the dry run's schedule
    before it traced the step.  ``n_y`` and ``n_w``: the rows of the 1-D
    step's whole ``b`` and ``w``."""
    R = math.prod(mesh.shape[a] for a in LS._row_axes(mesh))
    C = mesh.shape["model"]
    n_theta = meta["n_theta"]
    if variant == "1d":
        y, w = ("all-reduce", n_y * n_theta * 4, R * C), (
            "all-reduce", n_w * 4, R * C)
        return [y, w, y] + [y, w, y, w]
    y = ("all-reduce", meta["nv_local"] * n_theta * 4, C)
    w = ("all-reduce", meta["nf_local"] * 4, R)
    dot_y, dot_w = ("all-reduce", 4, R), ("all-reduce", 4, C)
    odd = [y, w, y, dot_w, dot_y, dot_y]
    even = [y, w, y, w, dot_y, dot_w, dot_y]
    return [r for r in odd + even if r[2] > 1]


def _traced_life(mesh, variant: str, operands) -> list:
    """The trace's records of an odd and an even iteration (it 1, 2)."""
    return [r for it in (1, 2)
            for r in D.trace_life(mesh, variant, operands, it).records]


@pytest.mark.parametrize("variant", ["2d", "1d"])
def test_life_collectives_equal_a_local_mesh(variant):
    """An odd and an even SBBNNLS iteration of the port's 2-D / 1-D steps
    on a (2, 2) LocalMesh record what the hand reckoning gives, and the
    dry run's trace of the same iterations on rank 0's operands
    (``dryrun.trace_life``, a (2, 2) ``RecordingCellMesh``) records the
    same, record for record."""
    from repro_torch.data.dmri import synth_connectome
    from repro_torch.distributed.mesh import LocalMesh
    problem = synth_connectome(n_fibers=60, n_theta=8, n_atoms=12,
                               grid=(6, 6, 6), seed=3, device="cpu")
    mesh = LocalMesh(2, 2, "cpu")
    shape = HM.ShapeMesh((2, 2), ("data", "model"))
    phi, b = problem.phi, problem.b
    w = torch.ones(phi.n_fibers)
    if variant == "2d":
        shards = LS.build_life_shards(phi, 8, 2, 2)
        state = LS.sharded_state(mesh, shards, problem)
        step = LS.make_sharded_step(mesh, shards.meta)
        args = (state["dsc"], state["wc"], state["b"], state["w"])
        meta = shards.meta
        rank0 = dict(dsc={(0, 0): state["dsc"][(0, 0)]},
                     wc={(0, 0): state["wc"][(0, 0)]},
                     b={0: state["b"][0]}, w={0: state["w"][0]})
    else:
        blocks = LS.build_life_shards_1d(phi, 4)
        cells = LS.coo_cells(mesh, {(r, c): {k: v[r * 2 + c] for k, v in
                                             blocks.items()}
                                    for r in range(2) for c in range(2)},
                             "dsc", n_atoms=phi.n_atoms,
                             nv_local=phi.n_voxels, nf_local=phi.n_fibers,
                             dictionary=problem.dictionary)
        step = LS.make_sharded_step_1d(mesh, {})
        args = (cells, b, w)
        meta = {"n_theta": 8}
        rank0 = dict(cells={(0, 0): cells[(0, 0)]}, b=b, w=w)
    traced = _traced_life(shape, variant, rank0)
    for it in (1, 2):
        args = (*args[:-1], step(*args, it)[0])
    n_y = b.shape[0] if variant == "1d" else 0
    want = _reckoned_life_collectives(shape, variant, meta, n_y,
                                      phi.n_fibers)
    assert sorted(mesh.collectives) == sorted(want)
    assert sorted(traced) == sorted(want)


@pytest.mark.parametrize("shape", list(D.LIFE_SCALES))
@pytest.mark.parametrize("variant", ["2d", "1d"])
@pytest.mark.parametrize("mesh", [POD, MULTIPOD], ids=["pod", "multipod"])
def test_traced_life_records_equal_the_reckoning(mesh, variant, shape):
    """Each life-stn96 (2-D) and life-stn96-1d record of the pod and
    multipod meshes is traced: a temp size > 0 (no reason beside it),
    total = temp + arguments, the traced FLOPs and bytes beside the model
    FLOPs and the compulsory bytes; its trace's collectives equal the hand
    reckoning record for record (the multipod's rows span ``pod`` x
    ``data``, R = 32; the 1-D step's groups are the whole mesh), and the
    record's collective bytes are theirs per iteration."""
    from repro_torch.roofline import analysis as RL
    arch = "life-stn96" + ("-1d" if variant == "1d" else "")
    rec = D.lower_cell(arch, shape, mesh)
    mem = rec["memory"]
    assert rec["status"] == "ok" and "temp_size_reason" not in mem
    assert mem["temp_size_in_bytes"] > 0
    assert mem["total_bytes_per_device"] == (
        mem["temp_size_in_bytes"] + mem["argument_size_in_bytes"])
    assert rec["flops"]["traced"] > 0 and rec["flops"]["model"] > 0
    assert rec["bytes"]["traced"] > rec["bytes"]["compulsory"] > 0
    fn = LS.life_input_specs_1d if variant == "1d" else LS.life_input_specs
    specs = fn(mesh, **D.LIFE_SCALES[shape])
    traced = _traced_life(mesh, variant, LS.rank0_operands(specs, variant))
    want = _reckoned_life_collectives(mesh, variant, specs["meta"],
                                      specs["b"].shape[0],
                                      specs["w"].shape[0])
    assert sorted(traced) == sorted(want)
    assert rec["collectives"]["total"] == \
        RL.collective_bytes(want)["total"] / 2


def _reference_life_flops(variant: str, sizes: dict) -> float:
    """``hlo_cost.analyze`` FLOPs of the reference's ``make_sharded_step``
    (or ``_1d``) compiled on a one-device (1, 1) mesh."""
    from jax.sharding import Mesh

    from repro.roofline import hlo_cost
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    if variant == "1d":
        specs = JLS.life_input_specs_1d(mesh, **sizes)
        step = JLS.make_sharded_step_1d(mesh, specs.pop("meta"))
        keys = ("a", "v", "fi", "vals", "d", "b", "w", "it")
    else:
        specs = JLS.life_input_specs(mesh, **sizes)
        step = JLS.make_sharded_step(mesh, specs.pop("meta"))
        keys = ("da", "dv", "df", "dw", "wa", "wv", "wf", "ww", "d", "b",
                "w", "it")
    with mesh:
        c = jax.jit(step).lower(*(specs[k] for k in keys)).compile()
    return hlo_cost.analyze(c.as_text(), 1).flops


#: a small life step: Nv, Nf, Ntheta, Na and nnz
LIFE_SMALL = dict(n_voxels=100, n_fibers=60, n_theta=8, n_atoms=12,
                  nnz=1000)


def _small_life(variant: str):
    mesh = HM.ShapeMesh((1, 1), ("data", "model"))
    fn = LS.life_input_specs_1d if variant == "1d" else LS.life_input_specs
    ops = LS.rank0_operands(fn(mesh, **LIFE_SMALL), variant)
    return [D.trace_life(mesh, variant, ops, it) for it in (1, 2)]


@pytest.mark.parametrize("variant", ["2d", "1d"])
def test_traced_life_flops_relate_to_the_reference_hlo_cost(variant):
    """The reference's compiled step (a one-device (1, 1) mesh, Nv 100,
    Ntheta 8, nnz 1,000) counts both ``lax.cond`` branches once and each
    WC's ``einsum("ct,ct->c")``, which XLA keeps as a batched ``dot``, as
    2 nnz Ntheta: its FLOPs are the odd and the even trace's summed (each
    counts its branch's two dots and the loss's, 2 N a dot) less one
    loss dot, plus the two WCs' 2 nnz Ntheta each (the port's WC
    multiplies and sums, which ``flop_counter`` does not count).  The
    record keeps the mean of the two traces."""
    odd, even = _small_life(variant)
    nnz, nv, nt = (LIFE_SMALL[k] for k in ("nnz", "n_voxels", "n_theta"))
    loss = 2 * nv * nt
    want = _reference_life_flops(variant, LIFE_SMALL)
    assert want == odd.flops + even.flops - loss + 2 * (2 * nnz * nt)
    assert odd.flops == odd.by_op["dot"]["flops"] == even.flops == 3_320


@pytest.mark.parametrize("variant", ["2d", "1d"])
def test_traced_life_peak_is_its_live_temporaries(variant):
    """The traced peak of a small step is the WC's three live (nnz,
    Ntheta) float32 temporaries (``d[atoms]``, ``Y[voxels]`` and their
    product) beside the residual Y; in the even iteration's second WC
    also ``v``, ``g`` and the projected gradient."""
    odd, even = _small_life(variant)
    nnz, nv, nf, nt = (LIFE_SMALL[k] for k in ("nnz", "n_voxels",
                                               "n_fibers", "n_theta"))
    big, y, w = nnz * nt * 4, nv * nt * 4, nf * 4
    assert odd.peak_temp_bytes == 3 * big + y
    assert even.peak_temp_bytes == 3 * big + 2 * y + 2 * w


def test_every_pod_cell_is_ok_skipped_or_refused(tmp_path):
    """The sweep over every architecture and shape of the pod mesh through
    the CLI: every cell ``ok`` or ``skipped`` (full attention at
    long_500k), none refused; kimi-k2's train cell trains with Adafactor,
    its ``opt`` bytes the factors' regions; the exit code counts no
    failure."""
    from repro_torch.launch import steps as ST
    assert D.main(["--mesh", "pod", "--out", str(tmp_path)]) == 0
    recs = report.load(str(tmp_path))
    assert len(recs) == len(base.ARCH_IDS) * len(base.SHAPES)
    for r in recs:
        if r["status"] == "skipped":
            assert r["shape"] == "long_500k"
            assert not base.get_config(r["arch"]).sub_quadratic
            continue
        assert r["status"] == "ok", r
        mem = r["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] > 0
        assert mem["total_bytes_per_device"] == (
            mem["temp_size_in_bytes"] + mem["argument_size_in_bytes"])
        assert r["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
        if r["kind"] == "train" and not r["arch"].startswith("life"):
            assert r["flops"]["remat_recompute"] > 0
            assert r["collectives"]["all-gather"] > 0
            assert 0 < r["optimizer_collective_bytes"] < \
                r["collectives"]["total"]
    kimi = [r for r in recs if (r["arch"], r["shape"]) == (
        "kimi-k2-1t-a32b", "train_4k")][0]
    cfg = base.get_config("kimi-k2-1t-a32b")
    _, opt = ST.abstract_state(cfg, OptConfig(kind="adafactor"))
    assert kimi["optimizer"] == "adafactor" and "fac" in opt
    assert kimi["memory"]["temp_size_in_bytes"] > 0
    assert kimi["memory"]["arguments_by_part"]["opt"] == D.tree_bytes(
        opt, SH.opt_state_specs(cfg, POD, opt), POD)
    life = [r for r in recs if r["arch"] == "life-stn96"]
    assert {r["kind"] for r in life} == {"sbbnnls"}


def test_report_renders_both_packages_records(tmp_path):
    """A port record, a skip, a refused record (synthetic: the port
    refuses no cell now) and a record in the reference's layout (its
    compiled temp size) in one table."""
    for arch, shape in (("qwen2-vl-7b", "prefill_32k"),
                        ("deepseek-7b", "long_500k")):
        D.run_cell(arch, shape, "pod", str(tmp_path))
    refused = {"status": "error", "arch": "kimi-k2-1t-a32b",
               "shape": "train_4k", "kind": "train", "mesh_kind": "pod",
               "package": "repro_torch", "refused": True,
               "error": "ValueError('not ported')"}
    (tmp_path / "pod" / "kimi-k2-1t-a32b__train_4k.json").write_text(
        json.dumps(refused))
    ref = {"status": "ok", "arch": "stablelm-12b", "shape": "train_4k",
           "kind": "train", "mesh_kind": "pod",
           "memory": {"temp_size_in_bytes": 3e9,
                      "argument_size_in_bytes": 2e9,
                      "total_bytes_per_device": 5e9},
           "roofline": {"compute_s": 1.0, "memory_s": 0.5,
                        "collective_s": 0.25, "dominant": "compute",
                        "useful_ratio": 0.8},
           "mfu_upper_bound": 0.4}
    (tmp_path / "pod" / "stablelm-12b__train_4k.json").write_text(
        json.dumps(ref))
    recs = report.load(str(tmp_path))
    text = report.table(recs, "pod")
    rows = text.splitlines()[2:]
    assert len(rows) == 4
    assert any(r.startswith("| deepseek-7b | long_500k | — | SKIP")
               for r in rows)
    assert any(r.startswith("| kimi-k2-1t-a32b | train_4k | — | ERROR")
               for r in rows)
    assert "| stablelm-12b | train_4k | train | 1.0000 | 0.5000 | 0.2500 | " \
           "**compute** | 0.80 | 5.0 | 0.400 |" in rows
    vlm = [r for r in rows if r.startswith("| qwen2-vl-7b")][0]
    assert "| prefill |" in vlm
    s = report.summary(recs)
    assert "4 total, 2 ok, 1 documented skips, 1 errors (1 refused" in s
    report.main(["--dir", str(tmp_path)])


def test_report_summary_names_records_without_a_temp_size():
    """The summary names the ok records of either package that carry no
    temp size (their memory is their arguments alone), and says nothing
    when every record has one."""
    def rec(arch, temp, package=None):
        r = {"status": "ok", "arch": arch, "shape": "train_4k",
             "memory": {"temp_size_in_bytes": temp},
             "roofline": {"dominant": "memory"}}
        if package:
            r["package"] = package
        return r

    traced = [rec("life-stn96", 1.8e9, "repro_torch"),
              rec("deepseek-7b", 3e9, "repro_torch")]
    assert "no temp size" not in report.summary(traced)
    s = report.summary(traced + [rec("stablelm-12b", None)])
    assert "- 1 records' memory per device is their arguments alone (no " \
           "temp size: stablelm-12b)" in s


def test_report_compare_names_each_dominant_term():
    """``report.compare`` sets each cell's collective GB before and after
    beside its dominant term's initial: c compute, m memory, x
    collective."""
    def rec(dominant, total):
        return {"status": "ok", "mesh_kind": "pod", "arch": "mamba2-2.7b",
                "shape": "prefill_32k", "collectives": {"total": total},
                "roofline": {"dominant": dominant}}

    text = report.compare([rec("compute", 4.824e9)],
                          [rec("collective", 42.31e9)])
    assert "| pod | mamba2-2.7b | 4.82 c → 42.31 x |" in text
    text = report.compare([rec("collective", 4.824e9)],
                          [rec("memory", 2.6e7)])
    assert "| pod | mamba2-2.7b | 4.82 x → 0.03 m |" in text
