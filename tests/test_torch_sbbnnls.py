"""Port vs reference: the SBBNNLS solver.

Trajectories of the port's ``opt`` and ``kernel`` executors against the
reference's over 8 iterations from the same start (losses at rtol 2e-3,
weights at rtol 2e-2 / atol 2e-3, the conformance matrix's trajectory
bounds), and the stepped API's exact ``k x (n/k)`` composition.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sbbnnls as jsb
from repro.core.life import LifeConfig as JConfig
from repro.core.life import LifeEngine as JEngine
from repro_torch.bridge import from_reference, to_numpy, weights_from_reference
from repro_torch.core import sbbnnls as sb
from repro_torch.core.life import LifeConfig, LifeEngine

CFG = LifeConfig(c_tile=64, row_tile=8, plan_cache_dir="")
JCFG = JConfig(c_tile=64, row_tile=8, plan_cache_dir="")


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


@pytest.mark.parametrize("executor", ["opt", "kernel"])
def test_trajectory_matches_reference(executor, tiny_problem):
    p = tiny_problem
    w0 = np.random.default_rng(2).uniform(0.5, 1.5, p.phi.n_fibers).astype(
        np.float32)
    jeng = JEngine(p, dataclasses.replace(JCFG, executor=executor,
                                          n_iters=8))
    w_ref, l_ref = jeng.run(w0=jnp.asarray(w0))
    eng = LifeEngine(_port(p), dataclasses.replace(CFG, executor=executor,
                                                   n_iters=8), device="cpu")
    w, losses = eng.run(w0=weights_from_reference(w0, device="cpu"))
    np.testing.assert_allclose(to_numpy(losses), np.asarray(l_ref),
                               rtol=2e-3)
    np.testing.assert_allclose(to_numpy(w), np.asarray(w_ref), rtol=2e-2,
                               atol=2e-3)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_stepped_composition_is_exact(k, tiny_problem):
    """k x (8/k) calls of sbbnnls_steps equal one 8-iteration run bit for
    bit: the BB parity rides in state.it."""
    eng = LifeEngine(_port(tiny_problem), dataclasses.replace(
        CFG, executor="kernel"), device="cpu")
    one, l_one = eng.step(eng.init_state(), 8)
    state, parts = eng.init_state(), []
    for _ in range(8 // k):
        state, ls = eng.step(state, k)
        parts.append(ls)
    assert state.it == one.it == 8
    assert torch.equal(state.w, one.w)
    assert torch.equal(torch.cat(parts), l_one)
    assert torch.equal(state.loss, one.loss)


def test_step_matches_reference_step_for_step(tiny_problem):
    """One iteration at each parity (the odd step skips the second WC)
    against the reference's, from the same state."""
    p = tiny_problem
    tp = _port(p)
    eng = LifeEngine(tp, dataclasses.replace(CFG, executor="naive"),
                     device="cpu")
    jeng = JEngine(p, dataclasses.replace(JCFG, executor="naive"))
    w = np.random.default_rng(3).uniform(0, 1, p.phi.n_fibers)
    w[::3] = 0.0
    for it in (0, 1):
        calls = []

        def rmatvec(y):
            calls.append(1)
            return eng.rmatvec(y)

        got = sb.sbbnnls_step(eng.matvec, rmatvec, tp.b, sb.SbbnnlsState(
            w=torch.tensor(w, dtype=torch.float32), it=it,
            loss=torch.zeros(())))
        want = jsb.sbbnnls_step(jeng.matvec, jeng.rmatvec, p.b,
                                jsb.SbbnnlsState(
                                    w=jnp.asarray(w, jnp.float32),
                                    it=jnp.asarray(it, jnp.int32),
                                    loss=jnp.asarray(0.0)))
        assert len(calls) == (1 if it % 2 else 2)
        assert got.it == it + 1
        np.testing.assert_allclose(to_numpy(got.w), np.asarray(want.w),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(got.loss), float(want.loss),
                                   rtol=1e-5)
        assert float(got.w.min()) >= 0.0


def test_projection_safe_div_and_loss_match_reference(tiny_problem):
    r = np.random.default_rng(5)
    w = r.uniform(-1, 1, 50).astype(np.float32)
    w[::4] = 0.0
    g = r.normal(size=50).astype(np.float32)
    np.testing.assert_array_equal(
        to_numpy(sb.projected_gradient(torch.tensor(w), torch.tensor(g))),
        np.asarray(jsb.projected_gradient(jnp.asarray(w), jnp.asarray(g))))
    assert float(sb._safe_div(torch.tensor(3.0), torch.tensor(0.0))) == 0.0
    assert float(sb._safe_div(torch.tensor(3.0), torch.tensor(2.0))) == 1.5
    init = sb.sbbnnls_init(torch.ones(4))
    assert init.it == 0 and float(init.loss) == 0.0
    p = tiny_problem
    eng = LifeEngine(_port(p), dataclasses.replace(CFG, executor="opt"),
                     device="cpu")
    jeng = JEngine(p, dataclasses.replace(JCFG, executor="opt"))
    w = r.uniform(0, 1, p.phi.n_fibers).astype(np.float32)
    np.testing.assert_allclose(eng.loss(torch.tensor(w)),
                               jeng.loss(jnp.asarray(w)), rtol=1e-5)
    ones = torch.ones(p.phi.n_fibers)
    state, losses = sb.sbbnnls_steps(eng.matvec, eng.rmatvec, eng.problem.b,
                                     sb.sbbnnls_init(ones), 0)
    assert losses.shape == (0,) and state.it == 0
    ran, ran_losses = sb.sbbnnls_run(eng.matvec, eng.rmatvec, eng.problem.b,
                                     ones, 3)
    stepped, stepped_losses = sb.sbbnnls_steps(
        eng.matvec, eng.rmatvec, eng.problem.b, sb.sbbnnls_init(ones), 3)
    assert torch.equal(ran.w, stepped.w) and ran.it == 3
    assert torch.equal(ran_losses, stepped_losses)
