"""Port vs reference: sequences past the 1,024-token threshold through the
models, where ``_self_attention`` takes flash attention.

A reduced dense model (qwen1.5-4b's family: qkv bias, GQA 4:4) at 2,048
tokens (flash in chunks of 512) and the reduced hybrid (zamba2, 5 layers)
at 1,280 tokens (chunks of 256; the shared block's flash runs between the
Mamba groups), float32, from the reference's parameters: the loss within
1e-5, every gradient within rtol 1e-4 / atol 1e-6 of ``jax.grad``, and
the training forward's logits, the prefill's logits and cache and 2 decode
steps within 1e-4 (over 1,280 tokens the hybrid's logits differ by up to
1.7e-5 from summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro_torch.bridge import _nest, lm_params_from_reference, to_numpy
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.models import flash as FL
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

STEP_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad_faults(got, want):
    """Leaves off by more than rtol 1e-4 / atol max(1e-6, 8 float32 ulps
    of the leaf's largest gradient) (as tests/test_torch_train.py)."""
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


@pytest.mark.parametrize("arch,n_layers,S,chunk", [
    ("qwen1.5-4b", 2, 2048, 512), ("zamba2-1.2b", 5, 1280, 256)])
def test_long_sequences_match_reference(arch, n_layers, S, chunk,
                                        monkeypatch):
    jcfg = dataclasses.replace(jbase.reduced(jbase.get_config(arch)),
                               n_layers=n_layers)
    cfg = dataclasses.replace(base.reduced(base.get_config(arch)),
                              n_layers=n_layers)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(3))
    model = lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    r = np.random.default_rng(S)
    tok = r.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    lab = r.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": torch.tensor(tok), "labels": torch.tensor(lab)}

    chunks = []
    flash = FL.flash_attention
    monkeypatch.setattr(L, "flash_attention", lambda q, k, v, c: (
        chunks.append(c), flash(q, k, v, c))[1])
    total, m = T.loss_fn(cfg, model, tb)
    assert chunks and set(chunks) == {chunk}
    (jtotal, jm), jgrad = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb), has_aux=True))(jparams)
    np.testing.assert_allclose(float(m["loss"].detach()), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    leaves = model.reference_leaves()
    flat = [p for leaf in leaves.values() for p in leaf.members]
    grads = iter(torch.autograd.grad(total, flat))
    got = _nest({k: to_numpy(leaf.stack([next(grads) for _ in leaf.members]))
                 for k, leaf in leaves.items()})
    assert _grad_faults(got, jax.tree.map(np.asarray, jgrad)) == []

    with torch.no_grad():
        logits, _ = T.forward_train(cfg, model, tb)
    jlogits, _ = jax.jit(lambda p, b: JT.forward_train(jcfg, p, b))(jparams,
                                                                    jb)
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)

    # prefill (flash again) and 2 decode steps
    jlast, jcache = jax.jit(lambda p, b: JT.prefill(jcfg, p, b))(
        jparams, {"tokens": jnp.asarray(tok)})
    last, cache = T.prefill(cfg, model, {"tokens": torch.tensor(tok)})
    np.testing.assert_allclose(to_numpy(last), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    for name in cache:
        np.testing.assert_allclose(to_numpy(cache[name]),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    s_max = S + 2
    jcache = {k: (jnp.pad(v, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0)))
                  if k in ("k", "v") else v) for k, v in jcache.items()}
    cache = serve.pad_cache(cache, s_max)
    jdecode = jax.jit(lambda p, b: JT.decode_step(jcfg, p, b))
    nxt = np.asarray(jnp.argmax(jlast[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(2):
        jlast, jcache = jdecode(jparams, dict(
            tokens=jnp.asarray(nxt), cache=jcache,
            cache_index=jnp.asarray(S + i, jnp.int32)))
        jcache.pop("index")
        last, cache = T.decode_step(cfg, model, dict(
            tokens=torch.tensor(nxt), cache=cache, cache_index=S + i))
        cache.pop("index")
        np.testing.assert_allclose(to_numpy(last), np.asarray(jlast),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        nxt = np.asarray(jnp.argmax(jlast[:, -1], -1)).astype(np.int32)[
            :, None]
