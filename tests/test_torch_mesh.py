"""Port vs reference: the mesh partition (``repro_torch.distributed``), the
``shard`` / ``shard-sell`` executors, the mesh rules of the selector and
the registry, mesh jobs in the service and ``collective_bytes``.

- *Executors at (1, 1)*: port vs reference (its Pallas in interpret mode)
  on ``tiny_problem``: matvec and rmatvec within rtol 2e-4 / atol 1e-5,
  10-iteration weights within rtol 2e-2 / atol 2e-3; ``shard-sell`` bit
  for bit ``kernel-sell`` and ``shard`` bit for bit ``opt`` (the cell is
  the whole Phi).
- *Local mesh at (2, 2) and (4, 2)* on the CPU (cells share it, as the
  reference's tests share 8 forced host devices): against the reference's
  ``dsc_reference`` / ``wc_reference`` and the dense oracle with the
  conformance test's tolerances (matvec rtol 2e-4 / atol 1e-5, rmatvec
  rtol 2e-4 / atol 1e-4); and against the reference's own ``shard`` /
  ``shard-sell`` at (2, 2), run in a subprocess that forces 4 host devices
  (matvec, rmatvec as above, 10-iteration weights within rtol 2e-2 /
  atol 2e-3).
- *SPMD on gloo*: ranks in fresh interpreters over one partition built
  here: ``make_sharded_step`` at (2, 2) and (4, 2) and
  ``make_sharded_step_1d`` on 4 ranks within rtol 1e-3 / atol 1e-4 of the
  reference's ``LifeEngine(opt)`` (tests/test_distributed.py's problem and
  tolerance), ``make_sharded_sell_ops`` within 1e-6 relative of the local
  mesh; a failing rank and a missed deadline raise.
- *Rules*: ``executor_for``, the mesh-aware "auto" candidates, the
  engine's routing and ``create_for_format``'s refusal equal the
  reference's for every format x mesh.
- *Service*: tests/test_serve.py's mesh tests (solo buckets, intake
  refusals, kill-and-resume bit for bit at (1, 1)).
- *Roofline*: ``collective_bytes`` on recorded collectives equals the
  reference's on HLO lines of each kind and group size.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.life import LifeConfig as JConfig
from repro.core.life import LifeEngine as JEngine
from repro.core.registry import REGISTRY as JREGISTRY
from repro.core.registry import create_for_format as j_create_for_format
from repro.data.dmri import synth_connectome as j_synth_connectome
from repro.formats import select as jselect
from repro.formats import shard as jshard
from repro.roofline import analysis as janalysis
from repro_torch.bridge import from_reference, to_numpy
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.registry import REGISTRY, create_for_format
from repro_torch.distributed import life_shard as LS
from repro_torch.distributed import spmd
from repro_torch.distributed.mesh import CPU_CELLS, LocalMesh
from repro_torch.formats import select as fsel
from repro_torch.formats import shard
from repro_torch.roofline.analysis import COLLECTIVE_KINDS, collective_bytes
from repro_torch.serve import LifeService, Scheduler
from repro_torch.serve.scheduler import Job

ROOT = os.path.join(os.path.dirname(__file__), "..")
SHARD_EXECUTORS = ("shard", "shard-sell")
#: tests/test_conformance.py:178-186
MATVEC_TOL = dict(rtol=2e-4, atol=1e-5)
RMATVEC_TOL = dict(rtol=2e-4, atol=1e-4)
#: the conformance trajectory bound
TRAJ_TOL = dict(rtol=2e-2, atol=2e-3)
#: tests/test_distributed.py:58
SPMD_TOL = dict(rtol=1e-3, atol=1e-4)
CFG = dict(c_tile=64, row_tile=8, slot_tile=16, plan_cache_dir="")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(p):
    ph = p.phi
    return from_reference(ph.atoms, ph.voxels, ph.fibers, ph.values,
                          ph.n_atoms, ph.n_voxels, ph.n_fibers, p.dictionary,
                          p.b, p.w_true, device="cpu")


def _executor(name, p, R=1, C=1):
    fmt = REGISTRY.consumes(name)
    cfg = LifeConfig(executor=name, format=fmt, shard_rows=R, shard_cols=C,
                     **CFG)
    if fmt == "coo":
        return REGISTRY.create(name, p.phi, p, cfg, PlanCache(""))
    return create_for_format(p.phi, p, cfg, PlanCache(""))


def _probes(p, seed=0):
    r = np.random.default_rng(seed)
    w = r.uniform(0, 1, p.phi.n_fibers).astype(np.float32)
    y = r.normal(size=(p.phi.n_voxels,
                       p.dictionary.shape[1])).astype(np.float32)
    return w, y


# ----------------------------------------------------------------------------
# the executors
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", SHARD_EXECUTORS)
def test_executor_at_1x1_matches_reference(name, tiny_problem):
    p = tiny_problem
    fmt = JREGISTRY.consumes(name)
    jcfg = JConfig(executor=name, format=fmt, **CFG)
    jex = j_create_for_format(p.phi, p, jcfg)
    ex = _executor(name, _port(p))
    assert ex.name == jex.name == name
    w, y = _probes(p)
    np.testing.assert_allclose(to_numpy(ex.matvec(torch.tensor(w))),
                               np.asarray(jex.matvec(jnp.asarray(w))),
                               **MATVEC_TOL)
    np.testing.assert_allclose(to_numpy(ex.rmatvec(torch.tensor(y))),
                               np.asarray(jex.rmatvec(jnp.asarray(y))),
                               **MATVEC_TOL)
    w_ref, _ = JEngine(p, dataclasses.replace(jcfg, n_iters=10)).run()
    w_got, _ = LifeEngine(_port(p), LifeConfig(
        executor=name, format=fmt, n_iters=10, **CFG), device="cpu").run()
    np.testing.assert_allclose(to_numpy(w_got), np.asarray(w_ref),
                               **TRAJ_TOL)


@pytest.mark.parametrize("name,single", [("shard", "opt"),
                                         ("shard-sell", "kernel-sell")])
def test_one_cell_is_the_single_device_path_bit_for_bit(name, single,
                                                        tiny_problem):
    """At (1, 1) the cell is the whole Phi: shard-sell runs kernel-sell's
    layout and shard opt's segment sums, so a solve is bit-identical."""
    fmt = REGISTRY.consumes(name)
    runs = [LifeEngine(_port(tiny_problem), LifeConfig(
        executor=ex, format=fmt, n_iters=10, **CFG), device="cpu").run()
        for ex in (name, single)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("R,C", [(2, 2), (4, 2)])
@pytest.mark.parametrize("name", SHARD_EXECUTORS)
def test_local_mesh_matches_reference_oracles(name, R, C, tiny_problem,
                                              tiny_dense):
    """The local mesh's cells share the CPU: DSC and WC against the
    reference's numpy oracles over its own ShardPhi and the dense one."""
    p = tiny_problem
    ex = _executor(name, _port(p), R, C)
    assert ex.name == name and ex.plans["mesh"].shape == (R, C)
    w, y = _probes(p)
    got_y = to_numpy(ex.matvec(torch.tensor(w))).astype(np.float64)
    got_w = to_numpy(ex.rmatvec(torch.tensor(y))).astype(np.float64)
    cell = "coo" if name == "shard" else "sell"
    jd, jw = jshard.encode_pair(p.phi, cell_format=cell, R=R, C=C,
                                row_tile=8, slot_tile=16)
    d = np.asarray(p.dictionary)
    np.testing.assert_allclose(got_y, jshard.dsc_reference(jd, d, w),
                               **MATVEC_TOL)
    np.testing.assert_allclose(got_w, jshard.wc_reference(jw, d, y),
                               **RMATVEC_TOL)
    m = np.asarray(tiny_dense, np.float64)
    np.testing.assert_allclose(got_y.reshape(-1), m @ w, **MATVEC_TOL)
    np.testing.assert_allclose(got_w, m.T @ y.reshape(-1), **RMATVEC_TOL)


_FORCED_DEVICES = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
assert len(jax.devices()) == 4
from repro.core.life import LifeConfig, LifeEngine
from repro.core.plan_cache import PlanCache
from repro.core.registry import REGISTRY, create_for_format
from repro.data.dmri import synth_connectome
p = synth_connectome(n_fibers=64, n_theta=16, n_atoms=24, grid=(10, 10, 10),
                     seed=1)
r = np.random.default_rng(0)
w = r.uniform(0, 1, p.phi.n_fibers).astype(np.float32)
y = r.normal(size=(p.phi.n_voxels, 16)).astype(np.float32)
out = {}
for name in ("shard", "shard-sell"):
    fmt = REGISTRY.consumes(name)
    cfg = LifeConfig(executor=name, format=fmt, shard_rows=2, shard_cols=2,
                     c_tile=64, row_tile=8, slot_tile=16, plan_cache_dir="")
    ex = create_for_format(p.phi, p, cfg, PlanCache(""))
    out[name + "/matvec"] = np.asarray(ex.matvec(jnp.asarray(w)))
    out[name + "/rmatvec"] = np.asarray(ex.rmatvec(jnp.asarray(y)))
    out[name + "/w"] = np.asarray(
        LifeEngine(p, dataclasses.replace(cfg, n_iters=10)).run()[0])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_on_4_devices(tmp_path_factory):
    """The reference's shard / shard-sell at (2, 2) in a subprocess with 4
    forced host devices (the parent keeps its single device)."""
    path = str(tmp_path_factory.mktemp("ref4") / "ref.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    code = "import dataclasses\n" + textwrap.dedent(_FORCED_DEVICES)
    proc = subprocess.run([sys.executable, "-c", code, path], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", SHARD_EXECUTORS)
def test_local_mesh_matches_reference_executor_on_4_devices(
        name, reference_on_4_devices, tiny_problem):
    ref = reference_on_4_devices
    ex = _executor(name, _port(tiny_problem), 2, 2)
    w, y = _probes(tiny_problem)
    np.testing.assert_allclose(to_numpy(ex.matvec(torch.tensor(w))),
                               ref[name + "/matvec"], **MATVEC_TOL)
    np.testing.assert_allclose(to_numpy(ex.rmatvec(torch.tensor(y))),
                               ref[name + "/rmatvec"], **RMATVEC_TOL)
    fmt = REGISTRY.consumes(name)
    w_got, _ = LifeEngine(_port(tiny_problem), LifeConfig(
        executor=name, format=fmt, shard_rows=2, shard_cols=2, n_iters=10,
        **CFG), device="cpu").run()
    np.testing.assert_allclose(to_numpy(w_got), ref[name + "/w"], **TRAJ_TOL)


def test_local_mesh_admission_and_psum_order():
    with pytest.raises(ValueError, match="positive"):
        LocalMesh(0, 2, "cpu")
    with pytest.raises(ValueError, match=f"needs 9 devices, have "
                                         f"{CPU_CELLS}"):
        LocalMesh(3, 3, "cpu")
    mesh = LocalMesh(2, 3, "cpu")
    parts = {(r, c): torch.tensor([float(10 * r + c)]) for r, c in mesh.cells}
    rows = mesh.psum(parts, "model")
    cols = mesh.psum(parts, "data")
    whole = mesh.psum(parts, ("data", "model"))
    assert {r: float(t) for r, t in rows.items()} == {0: 3.0, 1: 33.0}
    assert {c: float(t) for c, t in cols.items()} == {0: 10.0, 1: 12.0,
                                                      2: 14.0}
    assert float(whole[()]) == 36.0
    assert mesh.collectives == [("all-reduce", 4, 3), ("all-reduce", 4, 2),
                                ("all-reduce", 4, 6)]
    assert mesh.cell(1, 2) == 5
    with pytest.raises(ValueError, match="outside"):
        mesh.cell(2, 0)


# ----------------------------------------------------------------------------
# SPMD on gloo
# ----------------------------------------------------------------------------

def _spmd_problem():
    """tests/test_distributed.py's problem, in both packages."""
    jp = j_synth_connectome(n_fibers=96, n_theta=16, n_atoms=24,
                            grid=(10, 10, 10), seed=3)
    return jp, _port(jp)


@pytest.fixture(scope="module")
def spmd_runs(tmp_path_factory):
    """One partition per mesh built here, once; the ranks run as fresh
    interpreters under gloo, each with a deadline."""
    jp, p = _spmd_problem()
    out = {}
    for R, C, programs in ((2, 2, ("step2d", "step1d", "sell_ops")),
                           (4, 2, ("step2d",))):
        d = str(tmp_path_factory.mktemp(f"spmd{R}x{C}"))
        shards = LS.build_life_shards(p.phi, 16, R, C)
        sell = shard.encode_pair(p.phi, cell_format="sell", R=R, C=C,
                                 row_tile=8, slot_tile=16)
        sizes = spmd.write_inputs(
            d, p, shards, sell=sell,
            blocks_1d=LS.build_life_shards_1d(p.phi, R * C),
            probes=_probes(jp, seed=5))
        ranks = spmd.run(d, sizes, programs=programs,
                         iters=dict(step2d=10, step1d=10), backend="gloo",
                         devices=["cpu"] * (R * C), deadline_s=240)
        out[(R, C)] = (shards, sell, ranks, d, sizes)
    return jp, p, out


def _reference_opt(jp, n_iters=10):
    return np.asarray(JEngine(jp, JConfig(executor="opt", n_iters=n_iters,
                                          plan_cache_dir="")).run()[0])


@pytest.mark.parametrize("R,C", [(2, 2), (4, 2)])
def test_sharded_step_matches_reference_opt(R, C, spmd_runs):
    jp, _, runs = spmd_runs
    shards, _, ranks, _, _ = runs[(R, C)]
    w_pad = np.concatenate([ranks[c]["step2d_w"] for c in range(C)])
    np.testing.assert_allclose(LS.unshard_w(shards, w_pad),
                               _reference_opt(jp), **SPMD_TOL)
    # every rank of a column holds the same w block, bit for bit
    for r in range(R):
        for c in range(C):
            np.testing.assert_array_equal(ranks[r * C + c]["step2d_w"],
                                          ranks[c]["step2d_w"])


def test_sharded_step_1d_matches_reference_opt(spmd_runs):
    jp, _, runs = spmd_runs
    ranks = runs[(2, 2)][2]
    np.testing.assert_allclose(ranks[0]["step1d_w"], _reference_opt(jp),
                               **SPMD_TOL)


def test_sharded_sell_ops_match_local_mesh(spmd_runs):
    """B3/B4 per rank (their plain versions on the CPU), then all_reduce,
    against the local mesh's ordered sums, within 1e-6 relative."""
    jp, p, runs = spmd_runs
    shards, (sd, sw), ranks, _, _ = runs[(2, 2)]
    mesh = LocalMesh(2, 2, "cpu")
    kw = dict(row_tile=8, dictionary=p.dictionary)
    cd = LS.sell_cells(mesh, LS.cell_arrays(sd.arrays, mesh.cells), **kw)
    cw = LS.sell_cells(mesh, LS.cell_arrays(sw.arrays, mesh.cells), **kw)
    dsc_fn, wc_fn = LS.make_sharded_sell_ops(mesh, shards.meta)
    w, y = _probes(jp, seed=5)
    nv_l, nf_l = shards.nv_local, shards.nf_local
    w_pad, y_pad = LS.shard_w(shards, w), LS.shard_b(shards, y)
    ys = dsc_fn(cd, {c: torch.tensor(w_pad[c * nf_l:(c + 1) * nf_l])
                     for c in range(2)})
    ws = wc_fn(cw, {r: torch.tensor(y_pad[r * nv_l:(r + 1) * nv_l])
                    for r in range(2)})
    for r in range(2):
        for c in range(2):
            for got, want in ((ranks[r * 2 + c]["sell_ops_y"], ys[r]),
                              (ranks[r * 2 + c]["sell_ops_w"], ws[c])):
                want = want.numpy()
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # and the whole SpMV against the reference's numpy oracle
    jd = jshard.encode_pair(jp.phi, cell_format="sell", R=2, C=2,
                            row_tile=8, slot_tile=16)[0]
    y_full = np.concatenate([ys[r].numpy() for r in range(2)])
    pos = np.concatenate([np.arange(lo, hi) - lo + r * nv_l for r, (lo, hi)
                          in enumerate(zip(sd.voxel_cuts[:-1],
                                           sd.voxel_cuts[1:]))])
    np.testing.assert_allclose(
        y_full[pos], jshard.dsc_reference(jd, np.asarray(jp.dictionary), w),
        **MATVEC_TOL)


def test_collective_bytes_2d_below_1d(spmd_runs):
    """The paper's point (§7.1.3): per iteration the 2-D partition moves
    less than the 1-D one, which all-reduces the full Y and w."""
    _, p, runs = spmd_runs
    ranks = runs[(2, 2)][2]

    def per_iter(prog):
        recs = [("all-reduce", int(b), int(g)) for b, g in
                zip(ranks[0][f"{prog}_coll_bytes"],
                    ranks[0][f"{prog}_coll_groups"])]
        return collective_bytes(recs)["total"] / 10

    nv, n_theta = p.phi.n_voxels, 16
    one_d, two_d = per_iter("step1d"), per_iter("step2d")
    # 1-D: two full-Y psums an iteration over 4 ranks dominate
    assert one_d > 2 * (2 * nv * n_theta * 4 * 3 / 4)
    assert two_d < one_d


def test_spmd_failures_fail_the_caller(spmd_runs):
    _, _, runs = spmd_runs
    _, _, _, d, sizes = runs[(2, 2)]
    with pytest.raises(RuntimeError, match="unknown SPMD program"):
        spmd.run(d, sizes, programs=("nope",), iters={}, backend="gloo",
                 devices=["cpu"] * 4, deadline_s=120)
    with pytest.raises(TimeoutError):
        spmd.run(d, sizes, programs=("step2d",), iters=dict(step2d=10),
                 backend="gloo", devices=["cpu"] * 4, deadline_s=0.01)
    with pytest.raises(ValueError, match="4 ranks need 4 devices"):
        spmd.run(d, sizes, programs=("step2d",), iters={}, backend="gloo",
                 devices=["cpu"], deadline_s=1)


def test_sharded_state_step_matches_engine_at_1x1(tiny_problem):
    """make_sharded_step on a local (1, 1) mesh is LifeEngine(shard) bit
    for bit (the NCCL rank of the card smoke run is held to this)."""
    p = _port(tiny_problem)
    shards = LS.build_life_shards(p.phi, 16, 1, 1)
    mesh = LocalMesh(1, 1, "cpu")
    st = LS.sharded_state(mesh, shards, p)
    step = LS.make_sharded_step(mesh, shards.meta)
    w = st["w"]
    for it in range(6):
        w, _ = step(st["dsc"], st["wc"], st["b"], w, it)
    w_eng, _ = LifeEngine(p, LifeConfig(executor="shard", n_iters=6, **CFG),
                          device="cpu").run()
    assert torch.equal(w[0], w_eng)


# ----------------------------------------------------------------------------
# selector, registry and engine rules
# ----------------------------------------------------------------------------

MESH_SHAPES = [(1, 1), (2, 1), (2, 2)]


@pytest.mark.parametrize("R,C", MESH_SHAPES)
@pytest.mark.parametrize("fmt", ["coo", "sell", "alto", "fcoo"])
def test_executor_for_equals_reference(fmt, R, C):
    for executor in ("opt", "kernel", "kernel-sell", "alto", "shard",
                     "shard-sell", "kernel-fcoo"):
        got = fsel.executor_for(fmt, LifeConfig(executor=executor,
                                                shard_rows=R, shard_cols=C))
        want = jselect.executor_for(fmt, JConfig(executor=executor,
                                                 shard_rows=R, shard_cols=C))
        assert got == want, (fmt, executor, R, C)


@pytest.mark.parametrize("R,C", MESH_SHAPES)
def test_auto_candidates_equal_reference(R, C, tiny_problem, monkeypatch):
    """The candidate set "auto" hands choose_format under a mesh: alto
    (and fcoo: no mesh executor) dropped where R*C > 1, in both
    packages; mesh_aware=False keeps the full set."""
    seen = {}

    def spy(pkg):
        def choose(phi, dictionary, **kw):
            seen[pkg] = kw["allowed"]
            return None
        return choose

    monkeypatch.setattr(fsel, "choose_format", spy("port"))
    monkeypatch.setattr(jselect, "choose_format", spy("ref"))
    p = tiny_problem
    fsel.resolve_format(_port(p).phi, _port(p), LifeConfig(
        format="auto", shard_rows=R, shard_cols=C))
    jselect.resolve_format(p.phi, p, JConfig(format="auto", shard_rows=R,
                                             shard_cols=C))
    assert seen["port"] == seen["ref"]
    assert ("alto" in seen["port"]) == (R * C == 1)
    fsel.resolve_format(_port(p).phi, _port(p), LifeConfig(
        format="auto", shard_rows=R, shard_cols=C), mesh_aware=False)
    assert seen["port"] == fsel.DEFAULT_CANDIDATES
    with pytest.raises(ValueError, match="mesh executor"):
        fsel.resolve_format(_port(p).phi, _port(p), LifeConfig(
            format="auto", shard_rows=2), allowed=("alto", "fcoo"))


@pytest.mark.parametrize("fmt", ["coo", "sell", "alto", "fcoo"])
def test_engine_mesh_routing_equals_reference(fmt, tiny_problem):
    """A (2, 1) request runs the format's mesh executor, or both packages
    refuse it; a (1, 1) request with a single-device executor is no mesh
    request.  (The reference's single test device refuses the (2, 1)
    mesh, naming the executor it routed to.)"""
    p = tiny_problem
    cfg = dict(executor="opt", format=fmt, shard_rows=2, shard_cols=1, **CFG)
    if JREGISTRY.mesh_executor_for(fmt) is None:
        for make in (lambda: JEngine(p, JConfig(**cfg)),
                     lambda: LifeEngine(_port(p), LifeConfig(**cfg),
                                        device="cpu")):
            with pytest.raises(ValueError, match="no mesh executor"):
                make()
        return
    got = LifeEngine(_port(p), LifeConfig(**cfg), device="cpu")
    assert got.executor.name == REGISTRY.mesh_executor_for(fmt)
    with pytest.raises(ValueError, match=f"{got.executor.name} executor "
                                         f"needs 2 devices, have 1"):
        JEngine(p, JConfig(**cfg))
    one = dict(cfg, shard_rows=1)
    assert (LifeEngine(_port(p), LifeConfig(**one), device="cpu")
            .executor.name == JEngine(p, JConfig(**one)).executor.name)


# ----------------------------------------------------------------------------
# the service (tests/test_serve.py:403-500)
# ----------------------------------------------------------------------------

def _cfg(**kw):
    kw.setdefault("executor", "opt")
    kw.setdefault("n_iters", 12)
    kw.setdefault("plan_cache_dir", "")
    return LifeConfig(**kw)


def test_mesh_jobs_get_solo_buckets_and_match_shard_engine(tiny_problem):
    p = _port(tiny_problem)
    svc = LifeService(_cfg(), slice_iters=5, device="cpu")
    plain = svc.submit(p, n_iters=12, format="coo")
    meshed = svc.submit(p, n_iters=12, format="coo", mesh=(1, 1))
    wide = svc.submit(p, n_iters=12, format="sell", mesh=(2, 2))
    results = svc.run()
    w_ref, l_ref = LifeEngine(p, dataclasses.replace(
        _cfg(), executor="shard", shard_rows=1, shard_cols=1),
        device="cpu").run(12)
    assert torch.equal(results[meshed][0], w_ref)
    assert torch.equal(results[meshed][1], l_ref)
    np.testing.assert_allclose(to_numpy(results[plain][0]), to_numpy(w_ref),
                               rtol=1e-3, atol=1e-4)
    w22, l22 = LifeEngine(p, dataclasses.replace(
        _cfg(), executor="shard-sell", format="sell", shard_rows=2,
        shard_cols=2), device="cpu").run(12)
    assert torch.equal(results[wide][0], w22)
    assert torch.equal(results[wide][1], l22)


def test_mesh_job_validation(tiny_problem):
    p = _port(tiny_problem)
    sched = Scheduler(_cfg(), device="cpu")
    with pytest.raises(ValueError, match="no mesh executor"):
        sched.submit(Job(job_id="a", problem=p, n_iters=4, format="alto",
                         mesh=(1, 1)))
    with pytest.raises(ValueError, match="explicit cell format"):
        sched.submit(Job(job_id="a2", problem=p, n_iters=4, format="auto",
                         mesh=(1, 1)))
    with pytest.raises(ValueError, match="devices"):
        sched.submit(Job(job_id="b", problem=p, n_iters=4, format="coo",
                         mesh=(CPU_CELLS + 1, 2)))
    with pytest.raises(ValueError, match="positive"):
        sched.submit(Job(job_id="c", problem=p, n_iters=4, format="coo",
                         mesh=(0, 1)))
    assert not sched.active()


@pytest.mark.parametrize("fmt", ["coo", "sell"])
def test_shard_job_interrupted_then_resumed_bit_compatible(fmt, tiny_problem,
                                                           tmp_path):
    p = _port(tiny_problem)
    cfg = _cfg(n_iters=24, slot_tile=16)
    ref = LifeService(cfg, slice_iters=5, device="cpu")
    jid = ref.submit(p, job_id="tenant", n_iters=24, format=fmt, mesh=(1, 1))
    w_ref, l_ref = ref.run()[jid]

    ck = str(tmp_path / "svc")
    svc = LifeService(cfg, ckpt_dir=ck, checkpoint_every=1, slice_iters=5,
                      device="cpu")
    svc.submit(p, job_id="tenant", n_iters=24, format=fmt, mesh=(1, 1))
    svc.step()
    svc.step()
    assert svc.scheduler.job("tenant").done == 10
    del svc

    svc2 = LifeService(cfg, ckpt_dir=ck, checkpoint_every=1, slice_iters=5,
                       device="cpu")
    assert svc2.resumable_jobs == ("tenant",)
    with pytest.raises(ValueError, match="mesh"):
        svc2.submit(p, job_id="tenant", mesh=(2, 1))
    svc2.submit(p, job_id="tenant")
    job = svc2.scheduler.job("tenant")
    assert (job.done, job.mesh, job.format) == (10, (1, 1), fmt)
    w_res, l_res = svc2.run()["tenant"]
    assert torch.equal(w_res, w_ref) and torch.equal(l_res, l_ref)
    assert l_res.shape == (24,)


# ----------------------------------------------------------------------------
# roofline
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", COLLECTIVE_KINDS)
def test_collective_bytes_equals_reference_on_hlo_lines(kind, g):
    """One HLO line per kind and group size (an f32[16,8] result), parsed
    by the reference, against the port's record of the same collective."""
    groups = "{" + ",".join(str(i) for i in range(g)) + "}"
    line = (f"  %c = f32[16,8]{{1,0}} {kind}(f32[16,8]{{1,0}} %p), "
            f"replica_groups={{{groups}}}")
    want = janalysis.collective_bytes(line, 8)
    got = collective_bytes([(kind, 16 * 8 * 4, g)])
    assert got == want
    both = collective_bytes([(kind, 16 * 8 * 4, g)] * 3)
    assert both["total"] == pytest.approx(3 * want["total"])
    with pytest.raises(ValueError, match="kind"):
        collective_bytes([("broadcast", 4, 2)])
