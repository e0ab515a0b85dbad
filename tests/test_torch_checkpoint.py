"""Port vs reference: the checkpoint manager and resumed solves.

The reference's tests of ``repro/checkpoint/manager.py`` on the port's
manager (round trip, retention, atomic replace, swap debris, shape and key
checks); checkpoints crossing between the two packages bit for bit in both
directions (a bf16 leaf, ``SbbnnlsState`` single and stacked, a service
snapshot read by ``restore_job``); and on the CPU a solve resumed after
``k`` iterations equal, bit for bit, to ``2k`` uninterrupted ones.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.checkpoint import manager as JCK
from repro.core.sbbnnls import SbbnnlsState as JState
from repro_torch.bridge import (from_reference, state_from_reference,
                                state_to_reference, to_numpy)
from repro_torch.checkpoint import manager as CK
from repro_torch.core.batched import BatchedLifeEngine
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.core.sbbnnls import SbbnnlsState


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng):
    return {"params": {"w": torch.tensor(rng.normal(size=(4, 8)),
                                         dtype=torch.float32),
                       "layers": {"scale": torch.ones(3,
                                                      dtype=torch.bfloat16)}},
            "step": 7}


def _port(p):
    ph = p.phi
    return from_reference(ph.atoms, ph.voxels, ph.fibers, ph.values,
                          ph.n_atoms, ph.n_voxels, ph.n_fibers, p.dictionary,
                          p.b, p.w_true, device="cpu")


def _bits(x) -> np.ndarray:
    """The raw bytes of an array or tensor, for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().reshape(-1)
        if x.element_size() == 1:
            x = x.view(torch.uint8)
        elif x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


# ----------------------------------------------------------------------------
# the reference's manager tests, on the port's manager
# ----------------------------------------------------------------------------

def test_roundtrip(tmp_path, rng):
    tree = _tree(rng)
    CK.save(str(tmp_path), 7, tree, meta={"arch": "test"})
    step, flat, manifest = CK.restore(str(tmp_path))
    assert step == 7 and manifest["arch"] == "test"
    assert sorted(flat) == ["params/layers/scale", "params/w", "step"]
    assert manifest["dtypes"] == {"params/layers/scale": "bfloat16",
                                  "params/w": "float32", "step": "int32"}
    rebuilt = CK.unflatten_like(tree, flat)
    assert torch.equal(rebuilt["params"]["w"], tree["params"]["w"])
    scale = rebuilt["params"]["layers"]["scale"]
    assert scale.dtype == torch.bfloat16 and torch.equal(
        scale, tree["params"]["layers"]["scale"])
    assert rebuilt["step"] == 7 and isinstance(rebuilt["step"], int)
    assert manifest["bytes"] == 4 * 8 * 4 + 3 * 2 + 4


def test_float8_and_scalar_leaves_roundtrip(tmp_path):
    tree = [torch.tensor([0.5, -2.0, 448.0]).to(torch.float8_e4m3fn),
            torch.tensor([1.0, -3.0]).to(torch.float8_e5m2),
            np.arange(3, dtype=np.int32), 2.5, None, (True,)]
    CK.save(str(tmp_path), 1, tree)
    _, flat, manifest = CK.restore(str(tmp_path))
    assert manifest["dtypes"]["#0"] == "float8_e4m3fn"
    assert manifest["dtypes"]["#1"] == "float8_e5m2"
    got = CK.unflatten_like(tree, flat)
    for a, b in zip(got[:2], tree[:2]):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(got[2], tree[2])
    assert got[3] == 2.5 and got[4] is None and got[5] == (True,)


def test_retention_and_latest(tmp_path, rng):
    tree = _tree(rng)
    for s in (1, 2, 3, 4, 5):
        CK.save(str(tmp_path), s, tree, keep=3)
    assert CK.all_steps(str(tmp_path)) == [3, 4, 5]
    assert CK.latest_step(str(tmp_path)) == 5
    assert CK.load_latest(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path / "none"))


def test_no_tmp_dirs_left(tmp_path, rng):
    CK.save(str(tmp_path), 1, _tree(rng))
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_same_step_save_replaces_atomically(tmp_path, rng):
    tree = _tree(rng)
    CK.save(str(tmp_path), 3, tree, meta={"gen": 1})
    CK.save(str(tmp_path), 3, tree, meta={"gen": 2})
    step, _, manifest = CK.restore(str(tmp_path))
    assert (step, manifest["gen"]) == (3, 2)
    assert CK.all_steps(str(tmp_path)) == [3]
    assert not [d for d in os.listdir(tmp_path)
                if d.endswith((".tmp", ".old"))]


def test_all_steps_ignores_swap_debris(tmp_path, rng):
    CK.save(str(tmp_path), 2, _tree(rng))
    os.makedirs(tmp_path / "step_0000000002.old")
    os.makedirs(tmp_path / "step_0000000002.tmp")
    assert CK.all_steps(str(tmp_path)) == [2]
    assert CK.latest_step(str(tmp_path)) == 2
    CK.save(str(tmp_path), 2, _tree(rng))
    assert not [d for d in os.listdir(tmp_path)
                if d.endswith((".tmp", ".old"))]


def test_shape_mismatch_detected(tmp_path, rng):
    CK.save(str(tmp_path), 1, _tree(rng))
    _, flat, _ = CK.restore(str(tmp_path))
    bad = _tree(rng)
    bad["params"]["w"] = torch.zeros(5, 8)
    with pytest.raises(ValueError, match="shape"):
        CK.unflatten_like(bad, flat)


def test_missing_key_detected(tmp_path, rng):
    CK.save(str(tmp_path), 1, _tree(rng))
    _, flat, _ = CK.restore(str(tmp_path))
    with pytest.raises(KeyError):
        CK.unflatten_like({"params": {"extra": torch.zeros(1)}}, flat)


def test_place_moves_tensors_only(tmp_path, rng):
    tree = _tree(rng)
    CK.save(str(tmp_path), 2, tree)
    _, flat, _ = CK.restore(str(tmp_path))
    placed = CK.place(CK.unflatten_like(tree, flat), "cpu")
    assert torch.equal(placed["params"]["w"], flat["params/w"])
    assert placed["step"] == 7
    state = SbbnnlsState(w=torch.ones(3), it=np.zeros(2, np.int32),
                         loss=torch.zeros(()))
    moved = CK.place({"s": [state]}, torch.device("cpu"))
    assert isinstance(moved["s"][0], SbbnnlsState)
    assert moved["s"][0].it is state.it


def test_place_under_a_mesh_reshards_bit_for_bit(tmp_path, rng):
    """A whole tree placed under (2, 2) shardings: each cell gets the block
    of its coordinates; the blocks put back together are the tree bit for
    bit, saved they read back so in the reference's restore and
    unflatten_like, and the reference's save of them places so again."""
    import jax
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as HM
    tree = {"wq": torch.tensor(rng.normal(size=(2, 8, 12)),
                               dtype=torch.float32),
            "experts": torch.tensor(rng.normal(size=(4, 6, 2)),
                                    dtype=torch.bfloat16),
            "scale": torch.ones(6, dtype=torch.bfloat16)}
    specs = {"wq": SH.P(None, None, "model"),
             "experts": SH.P("model", "data", None), "scale": SH.P(None)}
    whole = {k: torch.zeros_like(v) for k, v in tree.items()}
    for r in range(2):
        for c in range(2):
            cell = HM.ShapeMesh((2, 2), ("data", "model"))
            cell.coords, cell.device = {"data": r, "model": c}, "cpu"
            placed = CK.place(tree, SH.logical_to_shardings(cell, specs))
            for k, v in placed.items():
                b = SH.shard_bounds(tree[k].shape, specs[k], cell,
                                    cell.coords)
                assert np.array_equal(_bits(v), _bits(tree[k][b])), k
                whole[k][b] = v
    for k in tree:
        assert np.array_equal(_bits(whole[k]), _bits(tree[k])), k
    CK.save(str(tmp_path / "port"), 1, whole)
    _, flat, _ = JCK.restore(str(tmp_path / "port"))
    template = jax.eval_shape(lambda: {
        "wq": jnp.zeros((2, 8, 12)), "experts": jnp.zeros((4, 6, 2),
                                                          jnp.bfloat16),
        "scale": jnp.zeros(6, jnp.bfloat16)})
    got = JCK.unflatten_like(template, flat)
    for k in tree:
        assert np.array_equal(_bits(got[k]), _bits(tree[k])), k
    JCK.save(str(tmp_path / "ref"), 1, got)
    _, back, _ = CK.restore(str(tmp_path / "ref"))
    cell = HM.ShapeMesh((2, 2), ("data", "model"))
    cell.coords, cell.device = {"data": 1, "model": 1}, "cpu"
    placed = CK.place(back, SH.logical_to_shardings(cell, specs))
    assert np.array_equal(_bits(placed["experts"]),
                          _bits(tree["experts"][2:, 3:]))


# ----------------------------------------------------------------------------
# across the packages, bit for bit, both ways
# ----------------------------------------------------------------------------

def _reference_tree(rng):
    nf = 40
    return {
        "job0": JState(w=jnp.asarray(rng.uniform(size=nf), jnp.float32),
                       it=jnp.asarray(7, jnp.int32),
                       loss=jnp.asarray(rng.uniform(), jnp.float32)),
        "stacked": [JState(w=jnp.asarray(rng.uniform(size=(3, nf)),
                                         jnp.float32),
                           it=jnp.asarray([4, 5, 6], jnp.int32),
                           loss=jnp.asarray(rng.uniform(size=3),
                                            jnp.float32))],
        "scale": jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16),
    }


def _port_tree(rng):
    nf = 40
    return {
        "job0": SbbnnlsState(w=torch.tensor(rng.uniform(size=nf),
                                            dtype=torch.float32),
                             it=7, loss=torch.tensor(rng.uniform(),
                                                     dtype=torch.float32)),
        "stacked": [SbbnnlsState(
            w=torch.tensor(rng.uniform(size=(3, nf)), dtype=torch.float32),
            it=np.asarray([4, 5, 6], np.int32),
            loss=torch.tensor(rng.uniform(size=3), dtype=torch.float32))],
        "scale": torch.tensor(rng.normal(size=(5,))).to(torch.bfloat16),
    }


KEYS = ["job0/.it", "job0/.loss", "job0/.w", "scale", "stacked/#0/.it",
        "stacked/#0/.loss", "stacked/#0/.w"]


def test_reference_checkpoint_restores_in_the_port(tmp_path, rng):
    tree = _reference_tree(rng)
    JCK.save(str(tmp_path), 12, tree, meta={"by": "reference"})
    step, flat, manifest = CK.restore(str(tmp_path))
    assert (step, manifest["by"]) == (12, "reference")
    assert sorted(flat) == KEYS
    _, want, _ = JCK.restore(str(tmp_path))
    for key in KEYS:
        assert str(want[key].dtype) == manifest["dtypes"][key]
        assert tuple(flat[key].shape) == want[key].shape
        assert np.array_equal(_bits(flat[key]), _bits(want[key])), key
    assert flat["scale"].dtype == torch.bfloat16
    assert flat["job0/.it"].dtype == torch.int32
    # into the port's solver states, through the bridge and the template
    template = {"job0": SbbnnlsState(w=torch.zeros(40), it=0,
                                     loss=torch.zeros(())),
                "stacked": [SbbnnlsState(w=torch.zeros(3, 40),
                                         it=np.zeros(3, np.int32),
                                         loss=torch.zeros(3))],
                "scale": torch.zeros(5, dtype=torch.bfloat16)}
    got = CK.unflatten_like(template, flat)
    assert got["job0"].it == 7 and isinstance(got["job0"].it, int)
    np.testing.assert_array_equal(got["stacked"][0].it, [4, 5, 6])
    assert got["stacked"][0].it.dtype == np.int32
    single = state_from_reference(*tree["job0"], device="cpu")
    assert single.it == 7
    assert torch.equal(single.w, got["job0"].w)
    stacked = state_from_reference(*tree["stacked"][0], device="cpu")
    np.testing.assert_array_equal(stacked.it, got["stacked"][0].it)


def test_port_checkpoint_restores_in_the_reference(tmp_path, rng):
    tree = _port_tree(rng)
    CK.save(str(tmp_path), 3, tree, meta={"by": "port"})
    step, flat, manifest = JCK.restore(str(tmp_path))
    assert (step, manifest["by"]) == (3, "port")
    assert sorted(flat) == KEYS
    _, ours, _ = CK.restore(str(tmp_path))
    for key in KEYS:
        assert np.array_equal(_bits(flat[key]), _bits(ours[key])), key
    assert str(flat["scale"].dtype) == "bfloat16"
    assert flat["job0/.it"].dtype == np.int32 and flat["job0/.it"].shape == ()
    assert flat["stacked/#0/.it"].dtype == np.int32
    # into the reference's states
    import jax
    template = {"job0": JState(w=jnp.zeros(40), it=jnp.zeros((), jnp.int32),
                               loss=jnp.zeros(())),
                "stacked": [JState(w=jnp.zeros((3, 40)),
                                   it=jnp.zeros(3, jnp.int32),
                                   loss=jnp.zeros(3))],
                "scale": jnp.zeros(5, jnp.bfloat16)}
    got = JCK.unflatten_like(jax.eval_shape(lambda: template), flat)
    assert int(got["job0"].it) == 7
    w, it, loss = state_to_reference(tree["stacked"][0])
    np.testing.assert_array_equal(got["stacked"][0].w, w)
    np.testing.assert_array_equal(got["stacked"][0].it, it)
    np.testing.assert_array_equal(got["stacked"][0].loss, loss)


def test_restore_job_reads_a_reference_service_snapshot(tmp_path,
                                                        tiny_problem):
    from repro.core.life import LifeConfig as JConfig
    from repro.serve import LifeService
    svc = LifeService(JConfig(executor="opt", n_iters=8, plan_cache_dir=""),
                      ckpt_dir=str(tmp_path / "svc"), checkpoint_every=1,
                      slice_iters=4)
    svc.submit(tiny_problem, job_id="t", n_iters=8, format="coo")
    svc.run()
    arrays, meta = CK.restore_job(str(tmp_path / "svc"), "t")
    jarrays, jmeta = JCK.restore_job(str(tmp_path / "svc"), "t")
    assert meta == jmeta
    assert sorted(arrays) == sorted(jarrays)
    for key in arrays:
        assert np.array_equal(_bits(arrays[key]), _bits(jarrays[key])), key
    with pytest.raises(KeyError, match="not in checkpoint"):
        CK.restore_job(str(tmp_path / "svc"), "nope")


# ----------------------------------------------------------------------------
# resume: k + k iterations equal 2k uninterrupted, bit for bit
# ----------------------------------------------------------------------------

def test_engine_resume_is_bit_identical(tmp_path, tiny_problem):
    """The kernel executor (plain versions on the CPU), no compaction."""
    p = _port(tiny_problem)
    cfg = LifeConfig(executor="kernel", c_tile=64, plan_cache_dir="")
    whole = LifeEngine(p, cfg, device="cpu")
    st_whole, l_whole = whole.step(whole.init_state(), 10)

    first = LifeEngine(p, cfg, device="cpu")
    st, l1 = first.step(first.init_state(), 5)
    CK.save(str(tmp_path), 5, {"state": st, "losses": l1})
    del first, st

    fresh = LifeEngine(p, cfg, device="cpu")
    step, flat, _ = CK.restore(str(tmp_path))
    template = {"state": fresh.init_state(), "losses": torch.zeros(5)}
    restored = CK.place(CK.unflatten_like(template, flat), fresh.device)
    assert step == 5 and restored["state"].it == 5
    st2, l2 = fresh.step(restored["state"], 5)
    assert torch.equal(st2.w, st_whole.w)
    assert torch.equal(st2.loss, st_whole.loss) and st2.it == st_whole.it
    assert torch.equal(torch.cat([restored["losses"], l2]), l_whole)


def test_cohort_resume_is_bit_identical(tmp_path, tiny_cohort):
    cohort = [_port(p) for p in tiny_cohort]
    cfg = LifeConfig(executor="opt", plan_cache_dir="")
    whole = BatchedLifeEngine(cohort, cfg, device="cpu")
    st_whole, l_whole = whole.step(whole.init_states(), 10)

    first = BatchedLifeEngine(cohort, cfg, device="cpu")
    st, l1 = first.step(first.init_states(), 5)
    CK.save(str(tmp_path), 5, {"stacked": st, "losses": l1})

    fresh = BatchedLifeEngine(cohort, cfg, device="cpu")
    _, flat, manifest = CK.restore(str(tmp_path))
    assert manifest["dtypes"]["stacked/.it"] == "int32"
    template = {"stacked": fresh.init_states(), "losses": torch.zeros(3, 5)}
    restored = CK.place(CK.unflatten_like(template, flat), fresh.device)
    np.testing.assert_array_equal(restored["stacked"].it, [5, 5, 5])
    st2, l2 = fresh.step(restored["stacked"], 5)
    assert torch.equal(st2.w, st_whole.w)
    assert torch.equal(torch.cat([restored["losses"], l2], dim=1), l_whole)
    np.testing.assert_array_equal(st2.it, st_whole.it)
    assert to_numpy(st2.w).shape == (3, cohort[0].phi.n_fibers)
