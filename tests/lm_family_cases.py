"""Shared cases of the port's ssm, hybrid, audio and vlm model tests.

``tests/test_torch_ssm.py`` (mamba2) and ``tests/test_torch_hybrid.py``
(zamba2) each import the test functions below and define the two fixtures
they take: ``arch`` (the architecture) and ``run`` (``make_run(arch)``,
once per module).  ``tests/test_torch_audio.py`` (musicgen) and
``tests/test_torch_vlm.py`` (qwen2-vl) import the cases that do not feed
token prompts, on :func:`_batch`'s batches of their families.  One
architecture per file keeps each file's reference compilations within a
minute.

The reference's parameters (``jax.random``) cross into the port through
``repro_torch.bridge`` (the hybrid's Mamba layers stacked as ``(n_super,
attn_every, ...)``, its ``tail`` and ``shared`` block); batches are made
with numpy.  On the reference's ``reduced()`` configs at 5 layers (the
hybrid: 2 super-layers of 2 Mamba blocks and the shared block, and a tail
of 1), float32: ``forward_train``'s logits within 1e-5, ``loss_fn`` within
1e-5, every gradient within rtol 1e-4 / atol 1e-6 of ``jax.grad`` (a 1%
fault planted in any leaf is rejected), 3 ``make_train_step`` steps with
AdamW and with Adafactor within rtol 1e-4 / atol 1e-6 in parameters,
optimizer state and metrics, and prefill + 4 greedy decode steps within
1e-4 with the same tokens.  Checkpoints cross both ways with either
optimizer (as ``tests/test_torch_train.py``'s for the dense and MoE
configs), reusing the fixture's compiled reference steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JCK
from repro.configs import base as jbase
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.bridge import lm_params_from_reference, to_numpy
from repro_torch.checkpoint import manager as CK
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A

ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
LAYERS = 5
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
#: the reference's train-step test's optimizer (as tests/test_torch_train.py)
OPT = dict(lr=1e-3)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, **kw):
    kw = {"n_layers": LAYERS, **kw}
    return (dataclasses.replace(jbase.reduced(jbase.get_config(arch)), **kw),
            dataclasses.replace(base.reduced(base.get_config(arch)), **kw))


def grid_positions(b: int, vt: int, n_text: int, width: int = 4
                   ) -> np.ndarray:
    """Qwen2-VL's (3, b, vt + n_text) positions for ``vt`` image patches
    on a grid ``width`` wide, then text: the image at t = 0, h its row, w
    its column; each text position continues on all three axes from the
    largest image position + 1."""
    pos = np.zeros((3, b, vt + n_text), np.int32)
    i = np.arange(vt)
    pos[1, :, :vt] = i // width
    pos[2, :, :vt] = i % width
    start = int(pos[:, :, :vt].max()) + 1 if vt else 0
    pos[:, :, vt:] = start + np.arange(n_text)
    return pos


def _np_batch(cfg, seed=0, b=2, s=16):
    """A training batch of ``cfg``'s family as numpy arrays: tokens and
    labels (some -1); audio: normal frame embeddings and codes; vlm:
    ``s // 2`` normal image embeddings before ``s - s // 2`` tokens, on
    :func:`grid_positions`, labels -1 over the image."""
    r = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frame_embeds": r.normal(size=(b, s, cfg.d_model)).astype(
                    np.float32),
                "codes": r.integers(0, cfg.vocab_size,
                                    (b, s, cfg.n_codebooks)).astype(np.int32)}
    vt = s // 2 if cfg.family == "vlm" else 0
    tok = r.integers(0, cfg.vocab_size, (b, s - vt)).astype(np.int32)
    lab = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab[0, vt:vt + 3] = -1
    out = {"tokens": tok, "labels": lab}
    if vt:
        lab[:, :vt] = -1
        out["image_embeds"] = r.normal(size=(b, vt, cfg.d_model)).astype(
            np.float32)
        out["positions"] = grid_positions(b, vt, s - vt)
    return out


def _batch(cfg, seed=0, b=2, s=16):
    """:func:`_np_batch` for both packages: (jnp arrays, torch tensors)."""
    nb = _np_batch(cfg, seed, b, s)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.tensor(v) for k, v in nb.items()})


def _grad_tree(model, total):
    leaves = model.reference_leaves()
    flat = [p for leaf in leaves.values() for p in leaf.members]
    grads = iter(torch.autograd.grad(total, flat))
    return bridge._nest({
        k: to_numpy(leaf.stack([next(grads) for _ in leaf.members]))
        for k, leaf in leaves.items()})


def _assert_tree_close(got, want, tol, what):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(paths), what
    for (path, w), g in zip(paths, got_leaves):
        np.testing.assert_allclose(
            np.asarray(g, np.float32), np.asarray(w, np.float32), **tol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _grad_faults(got, want):
    """Leaves whose gradient is off by more than rtol 1e-4 / atol
    max(1e-6, 8 float32 ulps of the leaf's largest gradient)."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    got = jax.tree.leaves(got)
    assert len(got) == len(paths)
    faults = []
    for (path, w), g in zip(paths, got):
        atol = max(STEP_TOL["atol"],
                   8 * np.finfo(np.float32).eps * float(np.abs(w).max()))
        if not np.all(np.abs(g - w) <= atol + STEP_TOL["rtol"] * np.abs(w)):
            faults.append(jax.tree_util.keystr(path))
    return faults


def make_run(arch: str, **kw) -> dict:
    """Both packages on one reduced config (``kw`` replaces its fields in
    both) from the same parameters and batch: the forward, the gradient,
    an eval step, and 3 train steps with each optimizer."""
    jcfg, cfg = _configs(arch, **kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jb, tb = _batch(cfg)
    out = {"arch": arch, "cfg": cfg, "jparams": jparams}
    model = lm_params_from_reference(_np_tree(jparams), cfg, device="cpu")
    out["jfwd"] = jax.jit(lambda p, b: JT.forward_train(jcfg, p, b))(jparams,
                                                                     jb)
    with torch.no_grad():
        out["fwd"] = T.forward_train(cfg, model, tb)
    (jtotal, jm), jgrad = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb), has_aux=True))(jparams)
    out["jloss"], out["jgrad"] = (jtotal, jm), jgrad
    total, m = T.loss_fn(cfg, model, tb)
    out["loss"] = (total.detach(), {k: v.detach() for k, v in m.items()})
    out["grad"] = _grad_tree(model, total)
    out["jeval"] = jax.jit(JST.make_eval_step(jcfg))(jparams, jb)
    out["eval"] = ST.make_eval_step(cfg)(model, tb)
    out.update(jcfg=jcfg, batch=(jb, tb), jsteps={})
    for kind in ("adamw", "adafactor"):
        opt, jopt = A.OptConfig(kind=kind, **OPT), JA.OptConfig(kind=kind,
                                                                **OPT)
        jstep = out["jsteps"][kind] = jax.jit(JST.make_train_step(jcfg,
                                                                  jopt))
        jp, jstate = jparams, JA.init_opt_state(jopt, jparams)
        model = lm_params_from_reference(_np_tree(jparams), cfg,
                                         device="cpu")
        state = A.init_opt_state(opt, model.reference_leaves())
        step = ST.make_train_step(cfg, opt)
        metrics = []
        for _ in range(3):
            jp, jstate, jmet = jstep(jp, jstate, jb)
            model, state, met = step(model, state, tb)
            metrics.append((met, jmet))
        out[kind] = (metrics, model, state, jp, jstate)
    return out


def test_leaves_are_the_reference_tree(run):
    """The reference's tree, leaf for leaf and shape for shape: the
    hybrid's Mamba layers as (n_super, attn_every, ...) and its tail."""
    cfg = run["cfg"]
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = model.reference_leaves()
    want = jax.tree_util.tree_flatten_with_path(run["jparams"])[0]
    assert sorted(leaves) == sorted(
        "/".join(str(k.key) for k in path) for path, _ in want)
    for path, w in want:
        key = "/".join(str(k.key) for k in path)
        assert leaves[key].shape == w.shape, key
    if cfg.family == "hybrid":
        assert leaves["layers/mamba/wz"].lead == (2, 2)
        assert leaves["tail/mamba/wz"].lead == (1,)
        assert leaves["shared/attn/wq"].lead == ()
        assert leaves["layers/mamba/a_log"].members[0].dtype == torch.float32
    else:
        assert leaves["layers/mamba/wz"].lead == (LAYERS,)


def test_forward_train_matches_reference(run):
    (logits, aux), (jlogits, jaux) = run["fwd"], run["jfwd"]
    assert logits.shape == jlogits.shape
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    assert float(aux) == float(jaux) == 0.0


def test_loss_fn_matches_reference(run):
    (total, m), (jtotal, jm) = run["loss"], run["jloss"]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5,
                               atol=1e-5)


def test_gradients_match_jax_grad(run):
    assert _grad_faults(run["grad"], _np_tree(run["jgrad"])) == []


def test_gradient_check_rejects_a_leaf_off_by_one_percent(run):
    want = _np_tree(run["jgrad"])
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    planted_in = 0
    for i, (path, w) in enumerate(leaves):
        if np.abs(w).max() <= 1e-3:
            continue
        planted = jax.tree.leaves(run["grad"])
        planted[i] = planted[i] * 1.01
        assert _grad_faults(planted, want) == [jax.tree_util.keystr(path)]
        planted_in += 1
    # every leaf of the audio model's 13; 15 or more of the others'
    assert planted_in >= min(15, len(leaves))


def test_eval_step_matches_reference(run):
    np.testing.assert_allclose(float(run["eval"]["loss"]),
                               float(run["jeval"]["loss"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_three_train_steps_match_reference(run, kind):
    metrics, model, state, jparams, jstate = run[kind]
    for i, (met, jmet) in enumerate(metrics):
        assert set(met) == set(jmet)
        for k in met:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       **STEP_TOL, err_msg=f"step {i} {k}")
    _assert_tree_close(bridge.lm_params_to_reference(model),
                       _np_tree(jparams), STEP_TOL, "params")
    _assert_tree_close(bridge.opt_state_to_reference(state),
                       _np_tree(jstate), STEP_TOL, "opt")
    losses = [float(m["loss"]) for m, _ in metrics]
    assert losses[-1] < losses[0]


def test_adafactor_state_shapes_follow_the_stacked_leaves(run):
    """vr and vc on the hybrid's two-axis leaves: (n_super, attn_every,
    d) and (n_super, attn_every, C) for a (2, 2, d, C) weight;
    (n_super, attn_every) and (n_super, H) for a (2, 2, H) vector."""
    _, _, state, _, jstate = run["adafactor"]
    for path, fac in state["fac"].items():
        want = jstate["fac"]
        for key in path.split("/"):
            want = want[key]
        assert {k: tuple(v.shape) for k, v in fac.items()} == {
            k: v.shape for k, v in want.items()}, path
    if run["cfg"].family == "hybrid":
        fac = state["fac"]["layers/mamba/wz"]
        assert fac["vr"].shape == (2, 2, 64) and fac["vc"].shape == (2, 2, 128)
        fac = state["fac"]["layers/mamba/a_log"]
        assert fac["vr"].shape == (2, 2) and fac["vc"].shape == (2, 8)


def test_remat_on_and_off_give_the_same_numbers(run):
    cfg = run["cfg"]
    _, tb = _batch(cfg, seed=1)
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = T.init_params(c, torch.Generator().manual_seed(4), "cpu")
        total, _ = T.loss_fn(c, model, tb)
        outs.append((total, torch.autograd.grad(total,
                                                list(model.parameters()))))
    (t0, g0), (t1, g1) = outs
    assert torch.equal(t0, t1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and cache (ssm, conv; the hybrid's k/v per shared
    application), then 4 greedy decode steps: the same tokens, logits and
    states within 1e-4."""
    jcfg, cfg = _configs(arch)
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    model = lm_params_from_reference(_np_tree(params), cfg, device="cpu")
    B, P, n_steps = 2, 10, 4
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, b: JT.prefill(jcfg, p, b))(
        params, {"tokens": jnp.asarray(prompts)})
    logits, cache = T.prefill(cfg, model, {"tokens": torch.tensor(prompts)})
    assert set(cache) == set(jcache)
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        np.testing.assert_allclose(to_numpy(cache[name]),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert cache["ssm"].dtype == torch.float32
    s_max = P + n_steps
    jcache = {k: (jnp.pad(v, ((0, 0), (0, 0), (0, s_max - P), (0, 0),
                              (0, 0))) if k in ("k", "v") else v)
              for k, v in jcache.items()}
    cache = serve.pad_cache(cache, s_max)
    jdecode = jax.jit(lambda p, b: JT.decode_step(jcfg, p, b))
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(n_steps):
        jlogits, jcache = jdecode(params, dict(
            tokens=jnp.asarray(tok), cache=jcache,
            cache_index=jnp.asarray(P + i, jnp.int32)))
        logits, cache = T.decode_step(cfg, model, dict(
            tokens=torch.tensor(tok), cache=cache, cache_index=P + i))
        assert int(jcache.pop("index")) == cache.pop("index") == P + i + 1
        np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[
            :, None]
        np.testing.assert_array_equal(
            to_numpy(torch.argmax(logits[:, -1], -1)), tok[:, 0])
    for name in cache:
        np.testing.assert_allclose(to_numpy(cache[name]),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_generate_and_serve_cli(arch, capsys):
    """serve.generate with a cache budget beyond the prompt (s_max), and
    the serving CLI on the CPU."""
    cfg = dataclasses.replace(base.reduced(base.get_config(arch)),
                              n_layers=LAYERS)
    model = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 9),
                            generator=torch.Generator().manual_seed(2),
                            dtype=torch.int32)
    tokens, logits, _ = serve.generate(cfg, model, prompts, 5)
    wide, wlogits, _ = serve.generate(cfg, model, prompts, 5, s_max=64)
    assert torch.equal(tokens, wide)
    for a, b in zip(logits, wlogits):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "6", "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu" and len(eval(lines[3].split(":", 1)[1])) == 3


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_port_checkpoint_continues_in_the_reference(run, kind, tmp_path):
    """The port trains 2 steps and checkpoints; the reference restores the
    files onto its eval_shape tree (the hybrid's (n_super, attn_every,
    ...) leaves and their Adafactor vr/vc among them) and takes the third
    step to the port's loss within 1e-5."""
    jcfg, cfg = run["jcfg"], run["cfg"]
    jb, tb = run["batch"]
    opt = A.OptConfig(kind=kind, **OPT)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(2))
    model = lm_params_from_reference(_np_tree(jparams), cfg, device="cpu")
    state = A.init_opt_state(opt, model.reference_leaves())
    step = ST.make_train_step(cfg, opt)
    for _ in range(2):
        model, state, _ = step(model, state, tb)
    CK.save(str(tmp_path), 2, ST.state_tree(model, state))
    _, _, m = step(model, state, tb)

    n, flat, _ = JCK.restore(str(tmp_path))
    template = jax.eval_shape(lambda: {
        "params": jparams,
        "opt": JA.init_opt_state(JA.OptConfig(kind=kind, **OPT), jparams)})
    tree = JCK.unflatten_like(template, flat)
    assert n == 2 and int(tree["opt"]["step"]) == 2
    _, _, jm = run["jsteps"][kind](jax.tree.map(jnp.asarray, tree["params"]),
                                   jax.tree.map(jnp.asarray, tree["opt"]), jb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_reference_checkpoint_continues_in_the_port(run, kind, tmp_path):
    jcfg, cfg = run["jcfg"], run["cfg"]
    jb, tb = run["batch"]
    opt, jopt = A.OptConfig(kind=kind, **OPT), JA.OptConfig(kind=kind, **OPT)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(5))
    jstate = JA.init_opt_state(jopt, jparams)
    jstep = run["jsteps"][kind]
    for _ in range(2):
        jparams, jstate, _ = jstep(jparams, jstate, jb)
    JCK.save(str(tmp_path), 2, {"params": jparams, "opt": jstate})
    _, _, jm = jstep(jparams, jstate, jb)

    model, state = ST.init_all(cfg, opt, torch.Generator().manual_seed(0),
                               "cpu")
    n, flat, _ = CK.restore(str(tmp_path))
    ST.load_state(model, state,
                  CK.unflatten_like(ST.state_template(model, state), flat))
    assert n == 2 and int(state["step"]) == 2
    _, _, m = ST.make_train_step(cfg, opt)(model, state, tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
