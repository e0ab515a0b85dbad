"""Port vs reference: the science workloads (``repro_torch.science``).

The reference's tests/test_science.py case by case on the port over the
CPU (its examples/ smoke waits for the port's examples, ROADMAP A14b):
pruning, k-fold cross-validation, virtual lesions with warm starts from a
live solve and from a service checkpoint, coarse-to-fine multires with
checkpoint resume, warm-started service jobs and a Phi-delta resubmission
through the front line.  Then the two packages on the same problem (the
reference's arrays, bridged): the numpy parts (``coarsen_problem``,
``fiber_bundles``, ``kfold_voxel_folds``, ``restrict_to_voxels``,
``lesion_problem``, ``prune_connectome``'s support) equal array for array;
``crossval_rmse``'s fold RMSEs and ``virtual_lesion``'s RMSEs within
rtol 1e-3, weights within rtol 2e-2 / atol 2e-3; ``solve_to_convergence``
stops after the same number of iterations (or one chunk apart with the
two best losses straddling the rtol rule); a multires checkpoint written
by either package resumes in the other.
"""
import os

import numpy as np
import pytest
import torch

from repro.core.life import LifeConfig as JConfig
from repro.core.life import LifeEngine as JEngine
from repro.data import dmri as jdmri
from repro import science as jsci
from repro_torch import obs
from repro_torch.bridge import from_reference
from repro_torch.core import spmv
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.data.dmri import coarsen_problem, fiber_bundles
from repro_torch.learn import clear_load_memo, refine
from repro_torch.science import (crossval_rmse, heldout_rmse,
                                 kfold_voxel_folds, lesion_problem,
                                 multires_solve, prune_connectome,
                                 restrict_to_voxels, resubmit_delta,
                                 solve_to_convergence, virtual_lesion,
                                 warm_start_weights, weight_summary)

TEST_SEED = int(os.environ.get("REPRO_TEST_SEED", "0"))
CFG = LifeConfig(executor="opt", plan_cache_dir="")
JCFG = JConfig(executor="opt", plan_cache_dir="")
#: the conformance trajectory bound (tests/test_conformance.py)
TRAJ_TOL = dict(rtol=2e-2, atol=2e-3)
#: fold and lesion RMSEs of the two packages
RMSE_RTOL = 1e-3
WAIT = 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_state_clean():
    """The port's observability, refine queue and predictor memo start
    empty for every test (tests/conftest.py resets only the
    reference's)."""
    obs.disable()
    obs.reset()
    refine.QUEUE.clear()
    clear_load_memo()
    yield
    obs.disable()
    obs.reset()
    refine.QUEUE.clear()
    clear_load_memo()


def _port(p):
    ph = p.phi
    return from_reference(ph.atoms, ph.voxels, ph.fibers, ph.values,
                          ph.n_atoms, ph.n_voxels, ph.n_fibers, p.dictionary,
                          p.b, p.w_true, device="cpu", grid=p.grid)


@pytest.fixture(scope="module")
def jproblem():
    return jdmri.synth_connectome(n_fibers=96, n_theta=16, n_atoms=24,
                                  grid=(10, 10, 10), seed=3 + TEST_SEED,
                                  noise=0.02)


@pytest.fixture(scope="module")
def problem(jproblem):
    return _port(jproblem)


@pytest.fixture(scope="module")
def converged(problem):
    return solve_to_convergence(LifeEngine(problem, CFG, device="cpu"),
                                rtol=1e-5, chunk=8, max_iters=300)


@pytest.fixture(scope="module")
def bundle(problem):
    return fiber_bundles(problem, bundle_size=6, n_bundles=1,
                         seed=TEST_SEED)[0]


def _np(t):
    return t.detach().cpu().numpy()


def _assert_problem_equal(got, want):
    """A port LifeProblem equals a reference one array for array."""
    for name in ("atoms", "voxels", "fibers", "values"):
        np.testing.assert_array_equal(_np(getattr(got.phi, name)),
                                      np.asarray(getattr(want.phi, name)))
    for name in ("n_atoms", "n_voxels", "n_fibers"):
        assert getattr(got.phi, name) == getattr(want.phi, name)
    np.testing.assert_array_equal(_np(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(_np(got.w_true), np.asarray(want.w_true))
    assert got.grid == want.grid
    for key in ("n_coeffs", "n_voxels_touched"):
        if key in want.stats:
            assert got.stats[key] == want.stats[key]


# -- pruning ---------------------------------------------------------------

def test_prune_support_and_compaction(problem, converged):
    pr = prune_connectome(problem, converged.w, threshold=1e-3)
    w = converged.w
    expect = np.intersect1d(np.nonzero(w > 1e-3)[0],
                            np.unique(_np(problem.phi.fibers)))
    assert np.array_equal(pr.support, expect)
    assert 0 < pr.n_kept < pr.n_fibers_total
    assert set(np.unique(_np(pr.phi.fibers))) <= set(pr.support)
    fib = _np(problem.phi.fibers)
    assert pr.phi.n_coeffs == int(np.isin(fib, pr.support).sum())
    assert pr.phi.n_fibers == problem.phi.n_fibers
    assert pr.weight_of(int(pr.support[0])) == pytest.approx(
        float(w[pr.support[0]]))
    off = np.setdiff1d(np.arange(problem.phi.n_fibers), pr.support)
    assert pr.weight_of(int(off[0])) == 0.0
    s = weight_summary(w, 1e-3)
    assert s["kept"] == float(pr.n_kept)
    assert s["w_min"] > 1e-3
    # a weight tensor prunes as its host array does
    again = prune_connectome(problem, converged.state.w, threshold=1e-3)
    assert np.array_equal(again.support, pr.support)
    with pytest.raises(ValueError, match="shape"):
        prune_connectome(problem, np.ones(3))


def test_prune_support_identical_across_formats(problem):
    """Same problem through coo/sell/fcoo (B1-B6's plain versions on the
    CPU) -> bit-identical pruned support."""
    supports = {}
    for fmt, executor in (("coo", "opt"), ("sell", "kernel-sell"),
                          ("fcoo", "kernel-fcoo")):
        cfg = LifeConfig(executor=executor, format=fmt, n_iters=40,
                         plan_cache_dir="")
        w, _ = LifeEngine(problem, cfg, device="cpu").run()
        supports[fmt] = prune_connectome(problem, w, 1e-3).support
    assert np.array_equal(supports["coo"], supports["sell"])
    assert np.array_equal(supports["coo"], supports["fcoo"])


# -- cross-validation ------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 7])
def test_kfold_disjoint_and_covering(k):
    n = 211
    folds = kfold_voxel_folds(n, k, seed=TEST_SEED)
    assert len(folds) == k
    cat = np.concatenate(folds)
    assert cat.size == n
    assert np.array_equal(np.sort(cat), np.arange(n))
    sizes = [f.size for f in folds]
    assert max(sizes) - min(sizes) <= 1
    for got, want in zip(folds, jsci.kfold_voxel_folds(n, k,
                                                       seed=TEST_SEED)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_kfold_validation():
    with pytest.raises(ValueError):
        kfold_voxel_folds(10, 1)
    with pytest.raises(ValueError):
        kfold_voxel_folds(10, 11)


def test_restrict_to_voxels_consistency(problem, jproblem):
    """Restricted prediction rows == the same rows of the full prediction;
    the restricted problem is the reference's array for array."""
    vox = np.arange(0, problem.phi.n_voxels, 7)
    sub = restrict_to_voxels(problem, vox)
    assert sub.phi.n_voxels == vox.size and sub.b.shape[0] == vox.size
    full = spmv.dsc_naive(problem.phi, problem.dictionary, problem.w_true)
    part = spmv.dsc_naive(sub.phi, sub.dictionary, sub.w_true)
    torch.testing.assert_close(part, full[torch.as_tensor(vox)], rtol=1e-5,
                               atol=1e-6)
    _assert_problem_equal(sub, jsci.restrict_to_voxels(jproblem, vox))
    with pytest.raises(ValueError):
        restrict_to_voxels(problem, [])
    with pytest.raises(ValueError):
        restrict_to_voxels(problem, [problem.phi.n_voxels])


def test_crossval_beats_null(problem):
    cv = crossval_rmse(problem, CFG, k=3, seed=TEST_SEED, n_iters=40,
                       device="cpu")
    assert len(cv.fold_rmse) == 3
    assert cv.mean_rmse < cv.null_rmse
    assert 0.0 < cv.relative_rmse < 1.0
    assert "crossval" in cv.describe()


@pytest.mark.parametrize("executor", ["opt", "kernel"])
def test_crossval_matches_reference(executor, problem, jproblem):
    """Fold RMSEs within rtol 1e-3 of the reference's (the port on its
    ``opt`` and on its ``kernel`` executor, B1/B2's plain versions here;
    the reference on its ``opt``)."""
    cfg = LifeConfig(executor=executor, c_tile=64, plan_cache_dir="")
    got = crossval_rmse(problem, cfg, k=4, seed=TEST_SEED, n_iters=40,
                        device="cpu")
    want = jsci.crossval_rmse(jproblem, JCFG, k=4, seed=TEST_SEED,
                              n_iters=40)
    np.testing.assert_allclose(got.fold_rmse, want.fold_rmse,
                               rtol=RMSE_RTOL)
    assert got.null_rmse == pytest.approx(want.null_rmse, rel=1e-6)
    assert (got.k, got.n_iters) == (want.k, want.n_iters)


def test_heldout_rmse_matches_reference(problem, jproblem, converged):
    got = heldout_rmse(problem, converged.w)
    want = jsci.heldout_rmse(jproblem, converged.w)
    assert got == pytest.approx(want, rel=1e-5)


# -- virtual lesions -------------------------------------------------------

def test_fiber_bundles_disjoint_structural(problem, jproblem):
    bundles = fiber_bundles(problem, bundle_size=5, n_bundles=3, seed=2)
    structural = set(np.unique(_np(problem.phi.fibers)).tolist())
    seen = set()
    for b in bundles:
        assert b.size == 5
        ids = set(b.tolist())
        assert ids <= structural
        assert not ids & seen
        seen |= ids
    for got, want in zip(bundles, jdmri.fiber_bundles(
            jproblem, bundle_size=5, n_bundles=3, seed=2)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="fibers with coefficients"):
        fiber_bundles(problem, bundle_size=problem.phi.n_fibers + 1)


def test_lesion_problem_keeps_fiber_space(problem, jproblem, bundle):
    les = lesion_problem(problem, bundle)
    assert les.phi.n_fibers == problem.phi.n_fibers
    assert not np.isin(_np(les.phi.fibers), bundle).any()
    assert np.all(_np(les.w_true)[bundle] == 0.0)
    _assert_problem_equal(les, jsci.lesion_problem(jproblem, bundle))
    with pytest.raises(ValueError):
        lesion_problem(problem, [])
    with pytest.raises(ValueError):
        lesion_problem(problem, [problem.phi.n_fibers])


def test_lesioned_fibers_exactly_zero_in_pruned(problem, bundle, converged):
    rep = virtual_lesion(problem, bundle, CFG, w_full=converged.w,
                         rtol=1e-5, chunk=8, max_iters=300, device="cpu")
    assert np.all(rep.w_lesioned[bundle] == 0.0)
    les = lesion_problem(problem, bundle)
    pr = prune_connectome(les, rep.w_lesioned, threshold=1e-3)
    assert not np.isin(bundle, pr.support).any()
    for f in bundle:
        assert pr.weight_of(int(f)) == 0.0
    assert "evidence" in rep.describe()


def test_warm_start_matches_cold_fixed_point(problem, bundle, converged):
    les = lesion_problem(problem, bundle)
    cold = solve_to_convergence(LifeEngine(les, CFG, device="cpu"),
                                rtol=1e-5, chunk=8, max_iters=300)
    warm = solve_to_convergence(
        LifeEngine(les, CFG, device="cpu"),
        w0=warm_start_weights(converged.w, bundle),
        rtol=1e-5, chunk=8, max_iters=300)
    assert warm.converged and cold.converged
    assert warm.iters <= cold.iters
    assert heldout_rmse(les, warm.w) == pytest.approx(
        heldout_rmse(les, cold.w), rel=1e-2)
    assert np.array_equal(prune_connectome(les, warm.w, 1e-2).support,
                          prune_connectome(les, cold.w, 1e-2).support)


def test_virtual_lesion_matches_reference(problem, jproblem, bundle,
                                          converged):
    """The same lesion through both packages from the same weights:
    footprint and bundle equal, RMSEs within rtol 1e-3, lesioned weights
    within the trajectory tolerance."""
    got = virtual_lesion(problem, bundle, CFG, w_full=converged.w,
                         rtol=1e-5, chunk=8, max_iters=300, device="cpu")
    want = jsci.virtual_lesion(jproblem, bundle, JCFG, w_full=converged.w,
                               rtol=1e-5, chunk=8, max_iters=300)
    np.testing.assert_array_equal(got.bundle, want.bundle)
    np.testing.assert_array_equal(got.footprint, want.footprint)
    assert got.rmse_full == pytest.approx(want.rmse_full, rel=RMSE_RTOL)
    assert got.rmse_lesioned == pytest.approx(want.rmse_lesioned,
                                              rel=RMSE_RTOL)
    np.testing.assert_allclose(got.w_lesioned, np.asarray(want.w_lesioned),
                               **TRAJ_TOL)


def test_virtual_lesion_from_checkpoint(problem, bundle, tmp_path):
    from repro_torch.serve.service import LifeService
    ck = str(tmp_path / "ck")
    svc = LifeService(CFG, ckpt_dir=ck, device="cpu")
    svc.submit(problem, job_id="subject", n_iters=48)
    w_svc, _ = svc.run()["subject"]
    rep = virtual_lesion(problem, bundle, CFG, ckpt_dir=ck,
                         job_id="subject", rtol=1e-4, chunk=8, max_iters=200,
                         device="cpu")
    assert rep.iters_full == 0
    assert rep.iters_warm > 0
    np.testing.assert_array_equal(rep.w_full, _np(w_svc))
    with pytest.raises(KeyError):
        virtual_lesion(problem, bundle, CFG, ckpt_dir=ck, job_id="nope",
                       device="cpu")
    with pytest.raises(ValueError, match="job_id"):
        virtual_lesion(problem, bundle, CFG, ckpt_dir=ck, device="cpu")


# -- convergence -----------------------------------------------------------

def _stop_ratio(losses, chunk, at):
    """Relative best-loss improvement of chunk ``at`` (1-based) over the
    chunks before it: what solve_to_convergence compares with rtol."""
    best = min(float(np.min(losses[i * chunk:(i + 1) * chunk]))
               for i in range(at - 1))
    cur = float(np.min(losses[(at - 1) * chunk:at * chunk]))
    return (best - cur) / max(abs(best), 1e-30)


@pytest.mark.parametrize("rtol", [1e-4, 1e-5])
def test_solve_to_convergence_iterations_match_reference(rtol, problem,
                                                         jproblem, bundle,
                                                         converged):
    """Cold and warm solves stop after the same number of iterations in
    both packages; where they differ by one chunk, the two runs' ratios at
    the earlier stop straddle the rtol rule."""
    les, jles = lesion_problem(problem, bundle), jsci.lesion_problem(
        jproblem, bundle)
    w0 = warm_start_weights(converged.w, bundle)
    for start in (None, w0):
        got = solve_to_convergence(LifeEngine(les, CFG, device="cpu"),
                                   w0=start, rtol=rtol, chunk=8,
                                   max_iters=300)
        want = jsci.solve_to_convergence(JEngine(jles, JCFG), w0=start,
                                         rtol=rtol, chunk=8, max_iters=300)
        assert got.losses.shape == (got.iters,)
        if got.iters != want.iters:
            assert abs(got.iters - want.iters) == 8
            at = min(got.iters, want.iters) // 8
            ratios = sorted([_stop_ratio(got.losses, 8, at),
                             _stop_ratio(np.asarray(want.losses), 8, at)])
            assert ratios[0] <= rtol < ratios[1]
        n = min(got.iters, want.iters)
        np.testing.assert_allclose(got.losses[:n],
                                   np.asarray(want.losses)[:n],
                                   rtol=TRAJ_TOL["rtol"])


# -- multi-resolution ------------------------------------------------------

def test_coarsen_problem_signal_sums(problem, jproblem):
    c = coarsen_problem(problem, 2)
    gx, gy, gz = problem.grid
    assert c.grid == (5, 5, 5)
    assert c.phi.n_voxels == 125
    assert c.phi.n_fibers == problem.phi.n_fibers
    b = _np(problem.b)
    got = _np(c.b)
    vox = np.arange(gx * gy * gz)
    x, rem = vox // (gy * gz), vox % (gy * gz)
    y, z = rem // gz, rem % gz
    cid = ((x // 2) * 5 + (y // 2)) * 5 + (z // 2)
    expect = np.zeros_like(got)
    np.add.at(expect, cid, b)
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    _assert_problem_equal(c, jdmri.coarsen_problem(jproblem, 2))
    assert coarsen_problem(problem, 1) is problem
    with pytest.raises(ValueError):
        coarsen_problem(problem, 0)
    sub = restrict_to_voxels(problem, [0, 1])      # grid=None
    with pytest.raises(ValueError):
        coarsen_problem(sub, 2)


def test_multires_resume_skips_completed_levels(problem, tmp_path):
    ck = str(tmp_path / "mr")
    mr = multires_solve(problem, CFG, factors=(2,), rtol=1e-4, chunk=8,
                        max_iters=200, ckpt_dir=ck, device="cpu")
    assert mr.resumed_at == 0
    assert len(mr.levels) == 2 and all(lv["iters"] > 0 for lv in mr.levels)
    again = multires_solve(problem, CFG, factors=(2,), rtol=1e-4, chunk=8,
                           max_iters=200, ckpt_dir=ck, device="cpu")
    assert again.resumed_at == 2
    assert again.total_iters == 0
    np.testing.assert_array_equal(again.final.w, mr.final.w)
    assert "(ckpt)" in again.describe()
    with pytest.raises(ValueError):
        multires_solve(problem, CFG, factors=(2, 4), device="cpu")
    with pytest.raises(ValueError):
        multires_solve(problem, CFG, factors=(1,), device="cpu")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_multires_resume_across_packages(writer, problem, jproblem,
                                         tmp_path):
    """A multires checkpoint written by either package resumes in the
    other: every level skipped, the stored fine weights replayed bit for
    bit."""
    ck = str(tmp_path / "mr")
    kw = dict(factors=(2,), rtol=1e-4, chunk=8, max_iters=200, ckpt_dir=ck)
    if writer == "reference":
        first = jsci.multires_solve(jproblem, JCFG, **kw)
        again = multires_solve(problem, CFG, device="cpu", **kw)
        w_first, w_again = np.asarray(first.final.w), again.final.w
    else:
        first = multires_solve(problem, CFG, device="cpu", **kw)
        again = jsci.multires_solve(jproblem, JCFG, **kw)
        w_first, w_again = first.final.w, np.asarray(again.final.w)
    assert first.resumed_at == 0 and again.resumed_at == 2
    assert again.total_iters == 0
    np.testing.assert_array_equal(w_again, w_first)


# -- served warm starts ----------------------------------------------------

def test_service_w0_warm_start(problem, converged):
    from repro_torch.serve.service import LifeService
    svc = LifeService(CFG, device="cpu")
    svc.submit(problem, job_id="cold", n_iters=16)
    svc.submit(problem, job_id="warm", n_iters=16, w0=converged.w)
    res = svc.run()
    _, cold_losses = res["cold"]
    _, warm_losses = res["warm"]
    assert warm_losses[0] < cold_losses[0]
    with pytest.raises(ValueError):
        svc.submit(problem, job_id="bad-shape", w0=np.ones(3))
    with pytest.raises(ValueError):
        svc.submit(problem, job_id="bad-sign",
                   w0=-np.ones(problem.phi.n_fibers))


def test_resubmit_delta_through_frontend(problem, bundle, converged):
    from repro_torch.serve.frontend import LifeFrontend
    les = lesion_problem(problem, bundle)
    with LifeFrontend(CFG, refine=False, device="cpu") as fe:
        h = resubmit_delta(fe, les, converged.w, lesioned=bundle, n_iters=16)
        w, losses = h.result(timeout=WAIT)
        assert np.all(_np(w)[bundle] == 0.0)
        cold = fe.submit_async(les, n_iters=16)
        _, cold_losses = cold.result(timeout=WAIT)
        # a tensor w_prev is accepted as the numpy one is
        same = resubmit_delta(fe, les, converged.state.w, lesioned=bundle,
                              n_iters=16)
        w2, _ = same.result(timeout=WAIT)
    assert losses[0] < cold_losses[0]
    assert torch.equal(w, w2)
    with pytest.raises(ValueError):
        resubmit_delta(fe, les, np.ones(3))


def test_resume_rejects_w0(problem, tmp_path):
    from repro_torch.serve.service import LifeService
    ck = str(tmp_path / "ck")
    svc = LifeService(CFG, ckpt_dir=ck, device="cpu")
    svc.submit(problem, job_id="s", n_iters=16)
    svc.run()
    svc2 = LifeService(CFG, ckpt_dir=ck, device="cpu")
    assert "s" in svc2.resumable_jobs
    with pytest.raises(ValueError, match="warm start"):
        svc2.submit(problem, job_id="s", w0=np.ones(problem.phi.n_fibers))


def test_entry_points_run_on_the_card_by_default(problem):
    """With no device given the science solves run on the CUDA card; with
    none visible they raise instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crossval_rmse(problem, CFG, k=2, n_iters=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multires_solve(problem, CFG, factors=(2,), max_iters=8)
