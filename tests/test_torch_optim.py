"""Port vs reference: AdamW and Adafactor on the reference's stacked leaves.

The reference updates one leaf of its tree at a time, and its layers are
stacked along a leading axis; the port holds a parameter per layer and
groups them into ``Leaf``s that the reference stacks.  Given the same
gradients, 3 steps of ``apply_updates`` must give the reference's
parameters, moments, grad_norm and lr within rtol 1e-6 / atol 1e-7.  The
tree holds the leaves whose rules read the stacked shape: a stacked norm
scale (decays in the reference), a stacked vector under Adafactor
(factored across layers) and Adafactor's RMS clip over a whole stack; a
check that decides per layer fails here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro_torch.bridge import to_numpy
from repro_torch.optim import adamw as A

TOL = dict(rtol=1e-6, atol=1e-7)
L, D, H, E, F = 3, 8, 12, 4, 6


def _reference_tree(rng) -> dict:
    """A parameter tree in the reference's layout: top-level leaves, a
    prefix list and a layer stack of L layers."""
    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"embed": n(16, D), "final_norm": {"scale": 1 + 0.1 * n(D)},
            "prefix": [{"mlp": {"wo": n(F, D)}}],
            "layers": {"ln1": {"scale": 1 + 0.1 * n(L, D)},
                       "attn": {"wq": n(L, D, H), "bk": n(L, H)},
                       "moe": {"wi_gate": n(L, E, D, F)}}}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _paths(x, f"{prefix}#{i}/")
    else:
        yield prefix[:-1], tree


def _leaves(tree) -> A.Leaves:
    """The port's groups: a tensor per layer under ``layers/``."""
    out = {}
    for path, a in _paths(tree):
        if path.startswith("layers/"):
            out[path] = A.Leaf([torch.tensor(x) for x in a], stacked=True)
        else:
            out[path] = A.Leaf([torch.tensor(a)], stacked=False)
    return out


def _stacked(leaf: A.Leaf) -> np.ndarray:
    ts = [to_numpy(m) for m in leaf.members]
    return np.stack(ts) if leaf.stacked else ts[0]


def _grads(tree, rng, scale=1.0):
    return jax.tree.map(lambda a: (scale * rng.normal(size=a.shape)).astype(
        np.float32), tree)


def _port_grads(gtree, leaves):
    out = {}
    for path, g in _paths(gtree):
        leaf = leaves[path]
        out[path] = ([torch.tensor(x) for x in g] if leaf.stacked
                     else [torch.tensor(g)])
    return out


def _flat(tree, prefix=""):
    return dict(_paths(tree, prefix))


def _run_both(kind, tree, grads_per_step, **opt_kw):
    cfg = A.OptConfig(kind=kind, **opt_kw)
    jcfg = JA.OptConfig(kind=kind, **opt_kw)
    leaves = _leaves(tree)
    state = A.init_opt_state(cfg, leaves)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = JA.init_opt_state(jcfg, jparams)
    for g in grads_per_step:
        leaves, state, m = A.apply_updates(cfg, leaves,
                                           _port_grads(g, leaves), state)
        jparams, jstate, jm = JA.apply_updates(
            jcfg, jparams, jax.tree.map(jnp.asarray, g), jstate)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                       err_msg=k)
    return leaves, state, jparams, jstate


def _check_params(leaves, jparams):
    want = _flat(jax.tree.map(np.asarray, jparams))
    assert set(want) == set(leaves)
    for path, leaf in leaves.items():
        np.testing.assert_allclose(_stacked(leaf), want[path], **TOL,
                                   err_msg=path)


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_adamw_three_steps_match_reference(scale):
    """scale 1e-3 keeps the global norm under the clip."""
    rng = np.random.default_rng(0)
    tree = _reference_tree(rng)
    grads = [_grads(tree, rng, scale) for _ in range(3)]
    leaves, state, jparams, jstate = _run_both(
        "adamw", tree, grads, lr=1e-2, warmup_steps=2, decay_steps=10)
    _check_params(leaves, jparams)
    for name in ("mu", "nu"):
        want = _flat(jax.tree.map(np.asarray, jstate[name]))
        for path, got in state[name].items():
            np.testing.assert_allclose(to_numpy(got), want[path], **TOL,
                                       err_msg=f"{name}/{path}")
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert state["step"].dtype == torch.int32


def test_adafactor_three_steps_match_reference():
    rng = np.random.default_rng(1)
    tree = _reference_tree(rng)
    grads = [_grads(tree, rng) for _ in range(3)]
    leaves, state, jparams, jstate = _run_both(
        "adafactor", tree, grads, lr=1e-2, warmup_steps=2, decay_steps=10)
    _check_params(leaves, jparams)
    want = _flat(jax.tree.map(np.asarray, jstate["fac"]))
    got = {f"{p}/{k}": v for p, fac in state["fac"].items()
           for k, v in fac.items()}
    assert set(got) == set(want)
    for key, v in got.items():
        np.testing.assert_allclose(to_numpy(v), want[key], **TOL, err_msg=key)
    # the stacked vector is factored: vc averages over the layers
    assert tuple(state["fac"]["layers/ln1/scale"]["vc"].shape) == (D,)
    assert tuple(state["fac"]["final_norm/scale"]["v"].shape) == (D,)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_rules_read_the_stacked_shape(kind):
    """Deciding per layer (each layer's tensor its own leaf) moves the
    stacked norm scale and bias otherwise than the reference does."""
    rng = np.random.default_rng(2)
    tree = _reference_tree(rng)
    grads = [_grads(tree, rng) for _ in range(2)]
    cfg = A.OptConfig(kind=kind, lr=1e-2, warmup_steps=1, decay_steps=10)
    per_layer = {}
    for path, leaf in _leaves(tree).items():
        if leaf.stacked:
            for i, m in enumerate(leaf.members):
                per_layer[f"{path}@{i}"] = A.Leaf([m], stacked=False)
        else:
            per_layer[path] = leaf
    state = A.init_opt_state(cfg, per_layer)
    for g in grads:
        pg = {}
        for path, gs in _port_grads(g, _leaves(tree)).items():
            if f"{path}@0" in per_layer:
                pg.update({f"{path}@{i}": [x] for i, x in enumerate(gs)})
            else:
                pg[path] = gs
        per_layer, state, _ = A.apply_updates(cfg, per_layer, pg, state)
    _, _, jparams, _ = _run_both(kind, tree, grads, lr=1e-2, warmup_steps=1,
                                 decay_steps=10)
    want = _flat(jax.tree.map(np.asarray, jparams))
    for path in ("layers/ln1/scale", "layers/attn/bk"):
        got = np.stack([to_numpy(per_layer[f"{path}@{i}"].members[0])
                        for i in range(L)])
        assert not np.allclose(got, want[path], **TOL), path


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_leaves_over_the_chunk_threshold(kind, monkeypatch):
    """With the threshold scaled down on both sides, the 4-D expert stack
    is updated slice by slice (Adafactor's statistics per slice)."""
    threshold = L * E * D * F
    monkeypatch.setattr(A, "_CHUNK_THRESHOLD", threshold)
    monkeypatch.setattr(JA, "_CHUNK_THRESHOLD", threshold)
    rng = np.random.default_rng(3)
    tree = _reference_tree(rng)
    tree["embed3d"] = rng.normal(size=(2, E, threshold // (2 * E))).astype(
        np.float32)
    grads = [_grads(tree, rng) for _ in range(3)]
    leaves, state, jparams, jstate = _run_both(
        kind, tree, grads, lr=1e-2, warmup_steps=2, decay_steps=10)
    assert A._chunked(leaves["layers/moe/wi_gate"])
    assert A._chunked(leaves["embed3d"])
    assert not A._chunked(leaves["layers/attn/wq"])
    _check_params(leaves, jparams)
    if kind == "adafactor":
        want = _flat(jax.tree.map(np.asarray, jstate["fac"]))
        for k in ("vr", "vc"):
            np.testing.assert_allclose(
                to_numpy(state["fac"]["layers/moe/wi_gate"][k]),
                want[f"layers/moe/wi_gate/{k}"], **TOL)


@pytest.mark.parametrize("step", [0, 1, 3, 50, 99, 100, 250])
def test_schedule_matches_reference(step):
    cfg = A.OptConfig(lr=3e-3, warmup_steps=4, decay_steps=100)
    jcfg = JA.OptConfig(lr=3e-3, warmup_steps=4, decay_steps=100)
    got = A.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = JA.schedule(jcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e9])
def test_clip_by_global_norm_with_bf16_grads(max_norm):
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "layers": {"b": rng.normal(size=(3, 4)).astype(np.float32)}}
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    jclipped, jnorm = JA.clip_by_global_norm(jtree, max_norm)
    grads = {"a": [torch.tensor(tree["a"]).bfloat16()],
             "layers/b": [torch.tensor(x).bfloat16()
                          for x in tree["layers"]["b"]]}
    norm = A.clip_by_global_norm(grads, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), **TOL)
    assert all(g.dtype == torch.bfloat16 for gs in grads.values()
               for g in gs)
    np.testing.assert_array_equal(
        to_numpy(grads["a"][0]),
        np.asarray(jclipped["a"]).astype(np.float32))
    np.testing.assert_array_equal(
        np.stack([to_numpy(g) for g in grads["layers/b"]]),
        np.asarray(jclipped["layers"]["b"]).astype(np.float32))


def test_leaf_shapes_and_unknown_kind():
    leaf = A.Leaf([torch.zeros(4, 5), torch.zeros(4, 5)], stacked=True)
    assert leaf.shape == (2, 4, 5) and leaf.numel == 40
    with pytest.raises(ValueError, match="one tensor"):
        A.Leaf([torch.zeros(2), torch.zeros(2)], stacked=False)
    with pytest.raises(ValueError, match="lion"):
        A.init_opt_state(dataclasses.replace(A.OptConfig(), kind="lion"),
                         {"a": leaf})
