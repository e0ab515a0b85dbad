"""Port vs reference: the audio family (musicgen-large, reduced to 5
layers: 4 codebooks of a 128-token vocabulary, sinusoidal positions,
layer norm, GELU).

The shared cases are ``tests/lm_family_cases.py``'s (forward and loss
within 1e-5, every gradient within rtol 1e-4 / atol 1e-6 with a planted
1% fault rejected, 3 train steps with AdamW and with Adafactor, remat,
checkpoints both ways) on a batch of normal frame embeddings and codes.
This file adds the config and the leaves against the reference's,
``sinusoidal_embedding``, prefill + 4 teacher-forced decode steps (the
next frames' embeddings fed in), and the serve CLI's refusal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_family_cases import (  # noqa: F401  the shared test cases
    _configs, _np_batch, _np_tree, make_run,
    test_eval_step_matches_reference, test_forward_train_matches_reference,
    test_gradient_check_rejects_a_leaf_off_by_one_percent,
    test_gradients_match_jax_grad, test_loss_fn_matches_reference,
    test_port_checkpoint_continues_in_the_reference,
    test_reference_checkpoint_continues_in_the_port,
    test_remat_on_and_off_give_the_same_numbers,
    test_three_train_steps_match_reference)
from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_reference, to_numpy
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A

ARCH = "musicgen-large"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arch():
    return ARCH


@pytest.fixture(scope="module")
def run(arch):
    return make_run(arch)


def test_config_equals_reference_field_for_field():
    full, jfull = base.get_config(ARCH), jbase.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    red, jred = base.reduced(full), jbase.reduced(jfull)
    assert dataclasses.asdict(red) == dataclasses.asdict(jred)
    for cfg, jcfg in ((full, jfull), (red, jred)):
        assert cfg.param_count() == jcfg.param_count()
    assert (full.family, full.n_codebooks, full.rope) == ("audio", 4,
                                                          "sinusoidal")
    assert red.n_codebooks == 4


def test_leaves_are_the_reference_tree(run):
    """``heads`` (C, d, V) in place of ``embed`` and ``lm_head``; the
    dense blocks stacked with layer norms (scale and bias) and a GELU
    MLP."""
    cfg = run["cfg"]
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = model.reference_leaves()
    want = jax.tree_util.tree_flatten_with_path(run["jparams"])[0]
    assert sorted(leaves) == sorted(
        "/".join(str(k.key) for k in path) for path, _ in want)
    for path, w in want:
        assert leaves["/".join(str(k.key) for k in path)].shape == w.shape
    assert leaves["heads"].shape == (4, 64, 128)
    assert "embed" not in leaves and "lm_head" not in leaves
    assert leaves["layers/mlp/wi"].lead == (5,)
    assert "layers/ln1/bias" in leaves
    params, _ = ST.abstract_state(base.get_config(ARCH), A.OptConfig())
    jshapes = jax.eval_shape(lambda: JT.init_params(
        jbase.get_config(ARCH), jax.random.PRNGKey(0)))
    assert sum(p.numel() for p in params.parameters()) == sum(
        x.size for x in jax.tree.leaves(jshapes))


@pytest.mark.parametrize("offset", [0, 7, 2047])
def test_sinusoidal_embedding_matches_reference(offset):
    pos = offset + np.arange(24, dtype=np.int32).reshape(2, 12)
    got = L.sinusoidal_embedding(torch.tensor(pos), 64)
    want = JL.sinusoidal_embedding(jnp.asarray(pos), 64)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


def test_prefill_and_teacher_forced_decode_match_reference():
    """A prefill of 10 frames, then 4 decode steps fed the next frames'
    embeddings (the reference's tests feed teacher-forced inputs): logits
    (B, 1, C, V) and the KV cache within 1e-4, and each step's logits
    within 1e-4 of ``forward_train``'s at its position."""
    jcfg, cfg = _configs(ARCH)
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    model = lm_params_from_reference(_np_tree(params), cfg, device="cpu")
    B, P, n_steps = 2, 10, 4
    frames = _np_batch(cfg, seed=8, b=B, s=P + n_steps)["frame_embeds"]
    jlogits, jcache = jax.jit(lambda p, b: JT.prefill(jcfg, p, b))(
        params, {"frame_embeds": jnp.asarray(frames[:, :P])})
    logits, cache = T.prefill(cfg, model,
                              {"frame_embeds": torch.tensor(frames[:, :P])})
    assert tuple(logits.shape) == jlogits.shape == (B, 1, 4, 128)
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    assert set(cache) == set(jcache) == {"k", "v"}
    s_max = P + n_steps
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, s_max - P), (0, 0), (0, 0)))
              for k, v in jcache.items()}
    cache = serve.pad_cache(cache, s_max)
    jdecode = jax.jit(lambda p, b: JT.decode_step(jcfg, p, b))
    with torch.no_grad():
        full, _ = T.forward_train(cfg, model,
                                  {"frame_embeds": torch.tensor(frames)})
    for i in range(n_steps):
        frame = frames[:, P + i:P + i + 1]
        jlogits, jcache = jdecode(params, dict(
            frame_embeds=jnp.asarray(frame), cache=jcache,
            cache_index=jnp.asarray(P + i, jnp.int32)))
        logits, cache = T.decode_step(cfg, model, dict(
            frame_embeds=torch.tensor(frame), cache=cache,
            cache_index=P + i))
        assert int(jcache.pop("index")) == cache.pop("index") == P + i + 1
        np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        torch.testing.assert_close(logits[:, 0], full[:, P + i], rtol=1e-4,
                                   atol=1e-4)
    for name in cache:
        np.testing.assert_allclose(to_numpy(cache[name]),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_serve_cli_refuses_the_audio_family():
    """Token prompts carry no frame embeddings (the reference's CLI fails
    with a KeyError on ``frame_embeds``)."""
    with pytest.raises(ValueError, match="frame embeddings.*make_prefill"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def test_audio_loss_is_the_mean_over_every_code(run):
    """``loss_fn``'s audio loss is the mean cross-entropy over all B * S *
    C entries of ``codes`` (no mask: every entry is a target)."""
    cfg = run["cfg"]
    _, tb = run["batch"]
    model = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    with torch.no_grad():
        logits, _ = T.forward_train(cfg, model, tb)
        _, m = T.loss_fn(cfg, model, tb)
    ls = torch.log_softmax(logits.double(), dim=-1)
    want = -torch.gather(ls, -1, tb["codes"].long()[..., None]).mean()
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-6)
