"""Port vs reference: the vlm family (qwen2-vl-7b, reduced to 5 layers:
image patch embeddings before the tokens, M-RoPE over (3, B, S)
positions).

Every case runs twice, on both packages alike: with ``reduced()``'s
sections (16, 24, 24), which overrun the 8 frequency slots of head_dim 16
so that every slot rotates by t (the reference's clipping, which the port
copies), and with sections (2, 3, 3), where t, h and w each rotate their
own slots.  The batches carry grid positions that differ on t, h and w
(``lm_family_cases.grid_positions``), so only the second config can
tell the sections apart: there, feeding the port h and w (or t and h)
swapped moves the logits far beyond the tolerance.

The shared cases are ``tests/lm_family_cases.py``'s (forward and loss
within 1e-5, gradients within rtol 1e-4 / atol 1e-6 with a planted 1%
fault rejected, 3 train steps with AdamW and with Adafactor, remat,
checkpoints both ways).  This file adds the config, the leaves,
``apply_mrope`` against the reference's, prefill + 4 greedy token decode
steps with the positions continued, and the serve CLI's refusal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_family_cases import (  # noqa: F401  the shared test cases
    _configs, _np_batch, _np_tree, grid_positions, make_run,
    test_eval_step_matches_reference, test_forward_train_matches_reference,
    test_gradient_check_rejects_a_leaf_off_by_one_percent,
    test_gradients_match_jax_grad, test_loss_fn_matches_reference,
    test_port_checkpoint_continues_in_the_reference,
    STEP_TOL, _assert_tree_close,
    test_reference_checkpoint_continues_in_the_port,
    test_remat_on_and_off_give_the_same_numbers)
from repro_torch import bridge
from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_reference, to_numpy
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCH = "qwen2-vl-7b"
#: sections that fit head_dim 16's 8 slots; None: reduced()'s own
SECTIONS = (None, (2, 3, 3))


def _kw(sections):
    return {} if sections is None else {"mrope_sections": sections}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arch():
    return ARCH


@pytest.fixture(scope="module", params=SECTIONS, ids=["reduced", "2-3-3"])
def run(request, arch):
    return make_run(arch, **_kw(request.param))


def test_config_equals_reference_field_for_field():
    full, jfull = base.get_config(ARCH), jbase.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    red, jred = base.reduced(full), jbase.reduced(jfull)
    assert dataclasses.asdict(red) == dataclasses.asdict(jred)
    for cfg, jcfg in ((full, jfull), (red, jred)):
        assert cfg.param_count() == jcfg.param_count()
    assert full.mrope_sections == (16, 24, 24) and full.rope_theta == 1e6
    assert (red.vision_tokens, red.resolved_head_dim) == (16, 16)


def _unresolved(jgrad):
    """Per leaf path, the elements whose first gradient is not 0 but lies
    below float32's resolution of that leaf (8 ulps of its largest
    gradient, the floor ``_grad_faults`` holds gradients to): there the
    reference's own float32 error exceeds the gradient, so Adam's first
    step may go either way."""
    out = {}
    for path, w in jax.tree_util.tree_flatten_with_path(_np_tree(jgrad))[0]:
        floor = 8 * np.finfo(np.float32).eps * float(np.abs(w).max())
        out["/".join(str(k.key) for k in path)] = (w != 0) & (
            np.abs(w) <= floor)
    return out


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_three_train_steps_match_reference(run, kind):
    """``lm_family_cases``' case, but for the parameter elements whose first
    gradient float32 cannot resolve (:func:`_unresolved`): with sections
    (2, 3, 3) one element of ``bk`` has a gradient of 1.2e-8 (float64)
    against the reference's float32 error of 1.2e-7 on that leaf (the
    port's: 4.3e-8), and AdamW's normalised step turns that into a
    1.0e-6 gap after three steps.  Such elements (two, or 1%, of a leaf
    at most) are held within the three steps' summed learning rate; every
    other element, the optimizer state and the metrics within rtol 1e-4 /
    atol 1e-6."""
    metrics, model, state, jparams, jstate = run[kind]
    for i, (met, jmet) in enumerate(metrics):
        assert set(met) == set(jmet)
        for k in met:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       **STEP_TOL, err_msg=f"step {i} {k}")
    unresolved = _unresolved(run["jgrad"])
    lr_sum = sum(float(m["lr"]) for m, _ in metrics)
    got = bridge.lm_params_to_reference(model)
    for path, w in jax.tree_util.tree_flatten_with_path(_np_tree(jparams))[0]:
        key = "/".join(str(k.key) for k in path)
        g = got
        for k in key.split("/"):
            g = g[k]
        free = unresolved[key]
        assert free.sum() <= max(2, 0.01 * free.size), key
        np.testing.assert_allclose(g[~free], w[~free], **STEP_TOL,
                                   err_msg=key)
        assert np.all(np.abs(g[free] - w[free]) <= lr_sum), key
    _assert_tree_close(bridge.opt_state_to_reference(state),
                       _np_tree(jstate), STEP_TOL, "opt")
    losses = [float(m["loss"]) for m, _ in metrics]
    assert losses[-1] < losses[0]


def test_leaves_are_the_reference_tree(run):
    cfg = run["cfg"]
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = model.reference_leaves()
    want = jax.tree_util.tree_flatten_with_path(run["jparams"])[0]
    assert sorted(leaves) == sorted(
        "/".join(str(k.key) for k in path) for path, _ in want)
    for path, w in want:
        assert leaves["/".join(str(k.key) for k in path)].shape == w.shape
    assert leaves["layers/attn/bq"].lead == (5,)


@pytest.mark.parametrize("hd,sections", [
    (16, (16, 24, 24)), (16, (2, 3, 3)), (16, (1, 1, 1)), (16, (4, 0, 4)),
    (128, (16, 24, 24)), (32, (8, 4, 4))])
def test_mrope_section_map_and_rotation_match_reference(hd, sections):
    """The section of every frequency slot (overrunning sections clipped,
    slots past their sum in section 0) and the rotated tensor, against
    the reference's ``apply_mrope``, on positions that differ per axis."""
    sec = L.mrope_section_map(hd, sections)
    want_sec = np.zeros(hd // 2, np.int32)
    ofs = 0
    for i, s in enumerate(sections):
        want_sec[ofs:ofs + s] = i
        ofs += s
    np.testing.assert_array_equal(sec, want_sec)
    if sections == (16, 24, 24) and hd == 16:
        assert not sec.any()
    r = np.random.default_rng(hd)
    x = r.normal(size=(2, 12, 3, hd)).astype(np.float32)
    pos = grid_positions(2, 8, 4)
    got = L.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e6, sections)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("swap", [(0, 2, 1), (1, 0, 2)],
                         ids=["h-w", "t-h"])
def test_a_section_swap_is_rejected(run, swap):
    """The port fed two position axes swapped: far beyond the forward's
    1e-5 of the reference with sections (2, 3, 3), and with reduced()'s
    clipped sections when t moves; h and w swapped there change nothing,
    as every slot rotates by t."""
    cfg = run["cfg"]
    jb, tb = run["batch"]
    model = lm_params_from_reference(_np_tree(run["jparams"]), cfg,
                                     device="cpu")
    swapped = dict(tb, positions=tb["positions"][list(swap)])
    with torch.no_grad():
        logits, _ = T.forward_train(cfg, model, swapped)
    jlogits = np.asarray(run["jfwd"][0])
    err = float(np.abs(to_numpy(logits) - jlogits).max())
    if cfg.mrope_sections == (16, 24, 24) and swap == (0, 2, 1):
        assert not L.mrope_section_map(16, cfg.mrope_sections).any()
        assert err <= 1e-5
    else:
        assert err > 1e-2, err


@pytest.mark.parametrize("sections", SECTIONS, ids=["reduced", "2-3-3"])
def test_prefill_and_decode_match_reference(sections):
    """A prefill of 8 image patches and 6 tokens on grid positions, then
    4 greedy decode steps with the positions continued (3, B, 1): the same
    tokens, logits within 1e-4 of the reference's and of
    ``forward_train``'s at each position, and the KV cache within 1e-4."""
    jcfg, cfg = _configs(ARCH, **_kw(sections))
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    model = lm_params_from_reference(_np_tree(params), cfg, device="cpu")
    B, vt, n_text, n_steps = 2, 8, 6, 4
    nb = _np_batch(cfg, seed=8, b=B, s=2 * vt)
    nb["tokens"] = nb["tokens"][:, :n_text]
    pos = grid_positions(B, vt, n_text + n_steps)
    P = vt + n_text
    batch = {"tokens": nb["tokens"], "image_embeds": nb["image_embeds"],
             "positions": pos[:, :, :P]}
    jlogits, jcache = jax.jit(lambda p, b: JT.prefill(jcfg, p, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = T.prefill(cfg, model, {k: torch.tensor(v)
                                           for k, v in batch.items()})
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    s_max = P + n_steps
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, s_max - P), (0, 0), (0, 0)))
              for k, v in jcache.items()}
    cache = serve.pad_cache(cache, s_max)
    jdecode = jax.jit(lambda p, b: JT.decode_step(jcfg, p, b))
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    fed, steps = [], []
    for i in range(n_steps):
        step_pos = pos[:, :, P + i:P + i + 1]
        jlogits, jcache = jdecode(params, dict(
            tokens=jnp.asarray(tok), positions=jnp.asarray(step_pos),
            cache=jcache, cache_index=jnp.asarray(P + i, jnp.int32)))
        logits, cache = T.decode_step(cfg, model, dict(
            tokens=torch.tensor(tok), positions=torch.tensor(step_pos),
            cache=cache, cache_index=P + i))
        assert int(jcache.pop("index")) == cache.pop("index") == P + i + 1
        np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        fed.append(tok)
        steps.append(logits[:, -1])
        tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[
            :, None]
        np.testing.assert_array_equal(
            to_numpy(torch.argmax(logits[:, -1], -1)), tok[:, 0])
    for name in cache:
        np.testing.assert_allclose(to_numpy(cache[name]),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # the same sequence in one forward: image, prompt, the fed tokens
    whole = {"tokens": torch.tensor(np.concatenate([nb["tokens"], *fed], 1)),
             "image_embeds": torch.tensor(nb["image_embeds"]),
             "positions": torch.tensor(pos)}
    with torch.no_grad():
        full, _ = T.forward_train(cfg, model, whole)
    for i, got in enumerate(steps):
        torch.testing.assert_close(got, full[:, P + i], rtol=1e-4, atol=1e-4)


def test_serve_cli_refuses_the_vlm_family():
    """Token prompts carry neither image embeddings nor (3, B, S)
    positions (the reference's CLI fails with a KeyError on
    ``positions``)."""
    with pytest.raises(ValueError, match="M-RoPE positions"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
