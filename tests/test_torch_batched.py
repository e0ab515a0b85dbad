"""Port vs reference: ``synth_cohort`` and ``BatchedLifeEngine``.

The cohort generator array for array; the cohort solve against the
reference's ``BatchedLifeEngine`` on the same arrays (rtol 1e-5 / atol
1e-6, as tests/test_batched.py holds the reference to its per-subject
engines) for every recipe and ``format="alto"``; inert padding; each
refusal; the stepped API; mixed iteration parities; bf16 storage.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.batched import BatchedLifeEngine as JBatched
from repro.core.life import LifeConfig as JConfig
from repro.data.dmri import synth_cohort as j_synth_cohort
from repro_torch.bridge import from_reference, to_numpy
from repro_torch.core import spmv
from repro_torch.core.batched import (BatchedLifeEngine, _pad_sorted,
                                      _stack_phis)
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.core.restructure import sort_by_host
from repro_torch.core.sbbnnls import SbbnnlsState, sbbnnls_step
from repro_torch.data.dmri import synth_cohort
from repro_torch.tune import BF16_RTOL, COMPUTE_DTYPES

SMALL = dict(n_fibers=64, n_theta=16, n_atoms=24, grid=(10, 10, 10))
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jcohort():
    return j_synth_cohort(3, base_seed=10, **SMALL)


def _port(p):
    ph = p.phi
    return from_reference(ph.atoms, ph.voxels, ph.fibers, ph.values,
                          ph.n_atoms, ph.n_voxels, ph.n_fibers, p.dictionary,
                          p.b, p.w_true, device="cpu", grid=p.grid)


@pytest.fixture(scope="module")
def cohort(jcohort):
    return [_port(p) for p in jcohort]


def _cfg(**kw):
    return LifeConfig(**{**dict(n_iters=12, plan_cache_dir=""), **kw})


def test_synth_cohort_is_the_references(jcohort):
    ours = synth_cohort(3, base_seed=10, device="cpu", **SMALL)
    assert len(ours) == len(jcohort) == 3
    for p, q in zip(ours, jcohort):
        for name in ("atoms", "voxels", "fibers", "values"):
            np.testing.assert_array_equal(to_numpy(getattr(p.phi, name)),
                                          np.asarray(getattr(q.phi, name)))
        assert (p.phi.n_atoms, p.phi.n_voxels, p.phi.n_fibers) == (
            q.phi.n_atoms, q.phi.n_voxels, q.phi.n_fibers)
        np.testing.assert_array_equal(to_numpy(p.w_true),
                                      np.asarray(q.w_true))
        # the dictionary and b are the reference's to float32 rounding
        np.testing.assert_allclose(to_numpy(p.dictionary),
                                   np.asarray(q.dictionary), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(to_numpy(p.b), np.asarray(q.b),
                                   rtol=1e-6, atol=1e-6)
        assert p.grid == q.grid and p.stats == q.stats
    # subjects share the dictionary and differ in Nc
    assert all(torch.equal(p.dictionary, ours[0].dictionary) for p in ours)
    assert len({p.phi.n_coeffs for p in ours}) > 1


@pytest.mark.parametrize("executor,fmt", [
    ("naive", "coo"), ("opt", "coo"), ("opt-paper", "coo"), ("auto", "coo"),
    ("opt", "alto"), ("naive", "auto")])
def test_batched_matches_reference_batched(executor, fmt, jcohort, cohort):
    """format="auto" measures its choice between coo and alto (a timing),
    so the reference runs the format the port chose."""
    eng = BatchedLifeEngine(cohort, _cfg(executor=executor, format=fmt),
                            device="cpu")
    w, losses = eng.run()
    if fmt == "auto":
        assert eng.format_plan.format in ("coo", "alto")
        assert eng.format_plan.reason == "autotune"
        fmt = eng.format_plan.format
    jeng = JBatched(jcohort, JConfig(executor=executor, format=fmt,
                                     n_iters=12, predict="off",
                                     plan_cache_dir=""))
    jw, jl = jeng.run()
    assert tuple(w.shape) == (3, cohort[0].phi.n_fibers)
    assert tuple(losses.shape) == (3, 12)
    assert w.device.type == losses.device.type == "cpu"
    np.testing.assert_allclose(to_numpy(w), np.asarray(jw), **TOL)
    np.testing.assert_allclose(to_numpy(losses), np.asarray(jl), rtol=1e-5)
    assert eng.nc_padded == jeng.nc_padded
    if jeng.format_plan is not None:
        assert eng.format_plan.format == jeng.format_plan.format
    assert eng.prune_stats(w) == jeng.prune_stats(jnp.asarray(to_numpy(w)))


@pytest.mark.parametrize("executor", ["naive", "opt", "opt-paper"])
def test_batched_matches_port_single_subject(executor, cohort, rng):
    """The cohort's SpMVs give each subject's own executor's outputs bit
    for bit on the CPU (the offset stream sums each row in the subject's
    order; padding adds zeros); the trajectories agree to the rounding of
    the dots, which a cohort reduces in one batched product and a single
    solve by ``torch.dot``: over 16,000 fp32 terms two orders differ by
    ~1e-5 of the sum (weights rtol 1e-3 / atol 1e-4, the reference's bound
    between two executors' cohorts, tests/test_batched.py:43; losses
    rtol 1e-4)."""
    cfg = _cfg(executor=executor)
    eng = BatchedLifeEngine(cohort, cfg, device="cpu")
    nf, n_theta = cohort[0].phi.n_fibers, cohort[0].dictionary.shape[1]
    w = torch.tensor(rng.uniform(0, 1, (3, nf)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=(3, cohort[0].phi.n_voxels, n_theta)),
                     dtype=torch.float32)
    mv, rmv = eng._matvec(w), eng._rmatvec(y)
    w_all, losses = eng.run()
    for s, p in enumerate(cohort):
        single = LifeEngine(p, cfg, device="cpu")
        assert torch.equal(mv[s], single.matvec(w[s]))
        assert torch.equal(rmv[s], single.rmatvec(y[s]))
        w1, l1 = single.run()
        np.testing.assert_allclose(to_numpy(w_all[s]), to_numpy(w1),
                                   rtol=1e-3, atol=1e-4,
                                   err_msg=f"{executor} subject {s}")
        np.testing.assert_allclose(to_numpy(losses[s]), to_numpy(l1),
                                   rtol=1e-4)


def test_batched_auto_tunes_once_on_the_first_subject(cohort, tmp_path):
    eng = BatchedLifeEngine(cohort, _cfg(executor="auto", n_iters=10,
                                         plan_cache_dir=str(tmp_path)),
                            device="cpu")
    eng.run()
    assert eng.cache.stats.misses == 2          # one SpmvPlan per op


def test_padding_is_inert():
    [p] = synth_cohort(1, base_seed=3, n_fibers=32, n_theta=8, n_atoms=12,
                       grid=(8, 8, 8), device="cpu")
    phi_v, _ = sort_by_host(p.phi, "voxel")
    padded = _pad_sorted(phi_v, phi_v.n_coeffs + 37, "voxel", True)
    assert padded.n_coeffs == phi_v.n_coeffs + 37
    assert not np.any(np.diff(to_numpy(padded.voxels)) < 0)   # still sorted
    w = torch.tensor(np.random.default_rng(0).uniform(size=32),
                     dtype=torch.float32)
    torch.testing.assert_close(spmv.dsc(padded, p.dictionary, w),
                               spmv.dsc(phi_v, p.dictionary, w),
                               rtol=1e-6, atol=1e-7)
    y = torch.randn(p.phi.n_voxels, 8, generator=torch.Generator()
                    .manual_seed(1))
    phi_f, _ = sort_by_host(p.phi, "fiber")
    padded_f = _pad_sorted(phi_f, phi_f.n_coeffs + 5, "fiber", True)
    torch.testing.assert_close(spmv.wc(padded_f, p.dictionary, y),
                               spmv.wc(phi_f, p.dictionary, y),
                               rtol=1e-6, atol=1e-7)
    assert _pad_sorted(phi_v, phi_v.n_coeffs, "voxel", True) is phi_v


def test_offset_stream_stays_sorted(cohort):
    """Subject s's voxel v is row s*Nv + v: the padded per-subject blocks
    laid end to end keep the whole stream sorted where each block is."""
    eng = BatchedLifeEngine(cohort, _cfg(executor="opt"), device="cpu")
    s = len(cohort)
    nv, nf = cohort[0].phi.n_voxels, cohort[0].phi.n_fibers
    assert (eng.phi_dsc.n_voxels, eng.phi_dsc.n_fibers) == (s * nv, s * nf)
    assert eng.phi_dsc.n_coeffs == s * eng.nc_padded
    assert not np.any(np.diff(to_numpy(eng.phi_dsc.voxels)) < 0)
    assert not np.any(np.diff(to_numpy(eng.phi_wc.fibers)) < 0)
    blocks = to_numpy(eng.phi_dsc.voxels).reshape(s, -1) // nv
    np.testing.assert_array_equal(blocks, np.arange(s)[:, None]
                                  * np.ones_like(blocks))
    stacked = _stack_phis([c.phi for c in cohort])
    assert stacked.n_coeffs == sum(c.phi.n_coeffs for c in cohort)


@pytest.mark.parametrize("executor", ["kernel", "kernel-sell", "kernel-fcoo",
                                      "alto", "shard"])
def test_rejects_non_vmappable_executor(executor, cohort):
    with pytest.raises(ValueError, match="not vmappable"):
        BatchedLifeEngine(cohort, _cfg(executor=executor), device="cpu")


@pytest.mark.parametrize("fmt", ["sell", "fcoo"])
def test_rejects_layouts_that_do_not_stack(fmt, cohort):
    with pytest.raises(ValueError, match="not supported here"):
        BatchedLifeEngine(cohort, _cfg(format=fmt), device="cpu")


def test_rejections(cohort):
    with pytest.raises(ValueError, match="at least one subject"):
        BatchedLifeEngine([], _cfg(), device="cpu")
    with pytest.raises(ValueError, match="compaction"):
        BatchedLifeEngine(cohort, _cfg(compact_every=4), device="cpu")
    with pytest.raises(ValueError, match="batched mesh needs 9 devices"):
        BatchedLifeEngine(cohort, _cfg(shard_rows=3, shard_cols=3),
                          device="cpu")
    small = synth_cohort(1, base_seed=99, n_fibers=32, n_theta=16,
                         n_atoms=24, grid=(10, 10, 10), device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        BatchedLifeEngine(cohort + small, _cfg(), device="cpu")
    other = dataclasses.replace(cohort[1],
                                dictionary=cohort[1].dictionary * 2)
    with pytest.raises(ValueError, match="dictionary"):
        BatchedLifeEngine([cohort[0], other], _cfg(), device="cpu")
    with pytest.raises(ValueError, match="searched axis"):
        BatchedLifeEngine(cohort, _cfg(compute_dtype="auto"), device="cpu")


def test_engine_raises_without_a_card_when_no_device_given(monkeypatch,
                                                           cohort):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedLifeEngine(cohort, _cfg())


@pytest.mark.parametrize("executor", ["naive", "opt"])
def test_step_chained_equals_run(executor, cohort):
    eng = BatchedLifeEngine(cohort, _cfg(executor=executor), device="cpu")
    w_run, l_run = eng.run(10)
    st = eng.init_states()
    st, l1 = eng.step(st, 5)
    st, l2 = eng.step(st, 5)
    assert torch.equal(st.w, w_run)
    assert torch.equal(torch.cat([l1, l2], dim=1), l_run)
    np.testing.assert_array_equal(st.it, np.full(len(cohort), 10))
    assert st.it.dtype == np.int32


def test_mixed_parities_step_each_subject_as_its_own_solver(cohort):
    """Subjects on odd and even iterations in one step each take their own
    Barzilai-Borwein branch (the reference's lax.cond under vmap)."""
    eng = BatchedLifeEngine(cohort, _cfg(executor="opt"), device="cpu")
    rng = np.random.default_rng(4)
    w0 = torch.tensor(rng.uniform(0.2, 1.0, (3, cohort[0].phi.n_fibers)),
                      dtype=torch.float32)
    st = eng.init_states(w0)._replace(it=np.array([0, 1, 4], np.int32))
    st, _ = eng.step(st, 3)
    for s, p in enumerate(cohort):
        single = LifeEngine(p, _cfg(executor="opt"), device="cpu")
        one = SbbnnlsState(w=w0[s], it=int([0, 1, 4][s]),
                           loss=torch.zeros(()))
        for _ in range(3):
            one = sbbnnls_step(single.matvec, single.rmatvec, p.b, one)
        np.testing.assert_allclose(to_numpy(st.w[s]), to_numpy(one.w), **TOL)
        np.testing.assert_allclose(float(st.loss[s]), float(one.loss),
                                   rtol=1e-5)
    np.testing.assert_array_equal(st.it, [3, 4, 7])


def test_bf16_batched_within_contract(jcohort, cohort):
    """bf16 storage tracks fp32 within BF16_RTOL, and the reference's bf16
    cohort within the same bound."""
    _, l32 = BatchedLifeEngine(cohort, _cfg(executor="opt", n_iters=4),
                               device="cpu").run()
    eng16 = BatchedLifeEngine(cohort, _cfg(executor="opt", n_iters=4,
                                           compute_dtype="bf16"),
                              device="cpu")
    assert eng16.resolved_compute_dtype == "bf16"
    assert eng16.phi_dsc.values.dtype == torch.bfloat16
    _, l16 = eng16.run()
    np.testing.assert_allclose(to_numpy(l16), to_numpy(l32), rtol=BF16_RTOL)
    _, jl16 = JBatched(jcohort, JConfig(executor="opt", n_iters=4,
                                        compute_dtype="bf16",
                                        plan_cache_dir="")).run()
    np.testing.assert_allclose(to_numpy(l16), np.asarray(jl16),
                               rtol=BF16_RTOL)


def test_tuned_batched_engine_resolves_the_dtype(cohort, tmp_path):
    eng = BatchedLifeEngine(cohort, _cfg(executor="opt", tune="full",
                                         compute_dtype="auto",
                                         plan_cache_dir=str(tmp_path)),
                            device="cpu")
    assert eng.tune_plan is not None and eng.tune_plan.reason == "search"
    assert eng.resolved_compute_dtype == eng.tune_plan.compute_dtype
    assert eng.resolved_compute_dtype in COMPUTE_DTYPES
    again = BatchedLifeEngine(cohort, _cfg(executor="opt", tune="cached",
                                           compute_dtype="auto",
                                           plan_cache_dir=str(tmp_path)),
                              device="cpu")
    assert again.tune_plan == eng.tune_plan


# ----------------------------------------------------------------------------
# mesh placement: subjects over `data`, Phi slots over `model`
# ----------------------------------------------------------------------------

#: the reference's tolerance for a placed cohort (tests/test_batched.py)
MESH_TOL = dict(rtol=1e-4, atol=1e-5)
MESH_ITERS = 10
PLACED = ((2, 2), (4, 2))

REFERENCE_PLACED = """
import dataclasses, sys
import numpy as np
from repro.core.batched import BatchedLifeEngine
from repro.core.life import LifeConfig
from repro.data.dmri import synth_cohort
cohort = synth_cohort(4, base_seed=10, n_fibers=64, n_theta=16, n_atoms=24,
                      grid=(10, 10, 10))
base = LifeConfig(executor="opt", n_iters=%d, plan_cache_dir="")
out = {}
for R, C in %r:
    eng = BatchedLifeEngine(cohort, dataclasses.replace(
        base, shard_rows=R, shard_cols=C))
    assert eng.mesh is not None
    W, L = eng.run()
    out[f"W{R}{C}"], out[f"L{R}{C}"] = np.asarray(W), np.asarray(L)
np.savez(sys.argv[1], **out)
""" % (MESH_ITERS, PLACED)


#: one gloo rank of a placed solve: the cohort from its seeds, the engine
#: on the process group's (R, C) mesh; rank 0 writes the result
RANK_PLACED = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core.batched import BatchedLifeEngine
from repro_torch.core.life import LifeConfig
from repro_torch.data.dmri import synth_cohort
from repro_torch.distributed import spmd
torch.set_num_threads(1)
R, C, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spmd.join_process_group("gloo", torch.device("cpu"))
cohort = synth_cohort(4, base_seed=10, device="cpu", **%r)
eng = BatchedLifeEngine(cohort, LifeConfig(
    executor="opt", n_iters=%d, plan_cache_dir="", shard_rows=R,
    shard_cols=C), device="cpu")
W, L = eng.run()
if dist.get_rank() == 0:
    np.savez(out, W=W.numpy(), losses=L.numpy(), staged=eng.mesh.staged,
             coll_groups=[g for _, _, g in eng.mesh.collectives])
dist.destroy_process_group()
""" % (SMALL, MESH_ITERS)


@pytest.fixture(scope="module")
def cohort4():
    return synth_cohort(4, base_seed=10, device="cpu", **SMALL)


@pytest.fixture(scope="module")
def placed_runs(cohort4, tmp_path_factory):
    """The unplaced solve; the placed ones on a local mesh, on gloo ranks
    (:data:`RANK_PLACED` under ``spmd.launch``) and in the reference on 8
    host devices (a subprocess, overlapping the spawns)."""
    import os
    import subprocess
    import sys
    from repro_torch.distributed import spmd
    root = tmp_path_factory.mktemp("placed")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_out = str(root / "reference.npz")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_PLACED, ref_out],
                           env=env, stderr=subprocess.PIPE, text=True)
    cfg = _cfg(executor="opt", n_iters=MESH_ITERS)
    out = {"unplaced": BatchedLifeEngine(cohort4, cfg, device="cpu").run()}
    for R, C in PLACED:
        eng = BatchedLifeEngine(cohort4, dataclasses.replace(
            cfg, shard_rows=R, shard_cols=C), device="cpu")
        out["local", R, C] = eng.run() + (eng,)
        dst = str(root / f"gloo{R}{C}.npz")
        spmd.launch(["-c", RANK_PLACED, str(R), str(C), dst], R * C,
                    str(root / f"ranks{R}{C}"), deadline_s=240.0,
                    env={"OMP_NUM_THREADS": "1"})
        with np.load(dst) as z:
            out["gloo", R, C] = {k: z[k] for k in z.files}
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with np.load(ref_out) as z:
        out["reference"] = {k: z[k] for k in z.files}
    return out


def _placed(placed_runs, kind, R, C):
    got = placed_runs[kind, R, C]
    if kind == "local":
        return to_numpy(got[0]), to_numpy(got[1])
    return got["W"], got["losses"]


@pytest.mark.parametrize("kind", ["local", "gloo"])
@pytest.mark.parametrize("R,C", PLACED)
def test_placed_cohort_matches_unplaced(placed_runs, kind, R, C):
    W0, L0 = (to_numpy(x) for x in placed_runs["unplaced"])
    W1, L1 = _placed(placed_runs, kind, R, C)
    np.testing.assert_allclose(W1, W0, **MESH_TOL)
    np.testing.assert_allclose(L1, L0, rtol=MESH_TOL["rtol"])


@pytest.mark.parametrize("kind", ["local", "gloo"])
@pytest.mark.parametrize("R,C", PLACED)
def test_placed_cohort_matches_the_references_placed_run(placed_runs, kind,
                                                         R, C):
    W1, L1 = _placed(placed_runs, kind, R, C)
    ref = placed_runs["reference"]
    np.testing.assert_allclose(W1, ref[f"W{R}{C}"], **MESH_TOL)
    np.testing.assert_allclose(L1, ref[f"L{R}{C}"], rtol=MESH_TOL["rtol"])


@pytest.mark.parametrize("R,C", PLACED)
def test_placement_layout(placed_runs, cohort4, R, C):
    """Row r holds subjects [r S/R, (r+1) S/R), cell (r, c) the c-th of C
    contiguous slot ranges of each; the gloo ranks' psums ran over groups
    of C (model) and R (data)."""
    eng = placed_runs["local", R, C][2]
    assert eng.mesh.shape == (R, C)
    assert eng.subjects_sharded and eng.slots_sharded
    # a placed engine builds no whole stacked operands
    assert not hasattr(eng, "phi_dsc") and not hasattr(eng, "phi_wc")
    n_rows, n_slots = 4 // R, eng.nc_padded // C
    nv = cohort4[0].phi.n_voxels
    for (r, c), (mv, _) in eng._cells.items():
        w = torch.zeros((n_rows, cohort4[0].phi.n_fibers))
        assert mv(w).shape == (n_rows, nv, 16)
    groups = set(placed_runs["gloo", R, C]["coll_groups"].tolist())
    assert groups == {C, R}
    assert not bool(placed_runs["gloo", R, C]["staged"])


def test_an_axis_that_does_not_divide_stays_replicated(cohort4):
    cfg = _cfg(executor="opt", n_iters=6)
    W0, L0 = BatchedLifeEngine(cohort4, cfg, device="cpu").run()
    eng = BatchedLifeEngine(cohort4, dataclasses.replace(
        cfg, shard_rows=3, shard_cols=1), device="cpu")
    assert not eng.subjects_sharded
    W1, L1 = eng.run()
    # every row solves every subject on whole slots: the unplaced math
    assert torch.equal(W1, W0) and torch.equal(L1, L0)
    C = next(c for c in range(2, 9) if eng.nc_padded % c)
    eng = BatchedLifeEngine(cohort4, dataclasses.replace(
        cfg, shard_rows=1, shard_cols=C), device="cpu")
    assert not eng.slots_sharded
    W2, _ = eng.run()
    assert torch.equal(W2, W0)
