"""Port vs reference: the LM example programs (``repro_torch/examples``:
serve_lm, train_lm).

Reduced float32 configs of the examples' models; the reference's weights
(``jax.random``) cross into the port through
``repro_torch.bridge.lm_params_from_reference``, or through a checkpoint
the reference writes where the port's example resumes it, as a user's
run resumes another's.  serve_lm: the greedy tokens equal, the first
step's logits within rtol 1e-4 / atol 1e-5 of the reference's prefill and
decode steps (its cache padded after the prefill, as its example pads).
train_lm: three steps' losses within rtol 1e-4 of the reference's
``make_train_step`` on the same batches, a resume at step 2 giving step
2's loss of the uninterrupted run, and the port's checkpoint read by the
reference's ``checkpoint.manager`` under the reference example's keys.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JCK
from repro.configs.base import ArchConfig as JArchConfig
from repro.data.tokens import DataConfig as JDataConfig
from repro.data.tokens import synth_batch_for as j_batch
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro.optim.adamw import OptConfig as JOptConfig
from repro_torch.bridge import lm_params_from_reference
from repro_torch.examples import serve_lm, train_lm
from repro_torch.launch import steps as ST

#: the examples' models cut to a few narrow layers (float32, as theirs)
SMALL_LM = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=256)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(port_cfg, **kw):
    fields = {f.name: getattr(port_cfg, f.name)
              for f in dataclasses.fields(port_cfg)}
    fields.update(kw)
    return JArchConfig(**fields), dataclasses.replace(port_cfg, **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_serve_lm_tokens_and_logits_match_the_reference(capsys):
    jcfg, cfg = _configs(serve_lm.SERVE_CFG, n_kv_heads=2, **SMALL_LM)
    B, P, G = 4, 16, 8
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    out = serve_lm.run(cfg=cfg, params=lm_params_from_reference(
        _np_tree(jparams), cfg, device="cpu"), batch=B, prompt_len=P,
        gen=G, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu" and lines[-1].startswith("sample:")

    rng = np.random.default_rng(0)
    prompts = jnp.asarray(rng.integers(0, jcfg.vocab_size, (B, P)),
                          jnp.int32)
    np.testing.assert_array_equal(out["prompts"].numpy(), prompts)
    logits, cache = jax.jit(lambda p, b: JT.prefill(jcfg, p, b))(
        jparams, {"tokens": prompts})
    for kn in ("k", "v"):
        cache[kn] = jnp.pad(cache[kn], ((0, 0), (0, 0), (0, G), (0, 0),
                                        (0, 0)))
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(logits[:, -1]), rtol=1e-4,
                               atol=1e-5)
    decode = jax.jit(lambda p, b: JT.decode_step(jcfg, p, b))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    generated = [np.asarray(tok)]
    for i in range(G - 1):
        logits, cache = decode(jparams, dict(tokens=tok, cache=cache,
                                             cache_index=jnp.int32(P + i)))
        cache.pop("index")
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        generated.append(np.asarray(tok))
    np.testing.assert_array_equal(out["tokens"],
                                  np.concatenate(generated, axis=1))
    assert out["tok_s"] > 0


@pytest.fixture(scope="module")
def train_case(tmp_path_factory):
    """The reference's seeded state written as a step-0 checkpoint under
    the example's keys, and the reference's losses of three steps from
    it."""
    jcfg, cfg = _configs(train_lm.CONFIG_100M, n_kv_heads=4, **SMALL_LM)
    steps, seq, batch = 3, 16, 2
    jopt = JOptConfig(lr=3e-4, warmup_steps=20, decay_steps=steps,
                      weight_decay=0.01)
    params, state = JST.init_all(jcfg, jopt, jax.random.PRNGKey(0))
    start = tmp_path_factory.mktemp("start")
    JCK.save(str(start), 0, {"p": params, "o": state})
    data = JDataConfig(seed=0, seq_len=seq, global_batch=batch)
    step_fn = jax.jit(JST.make_train_step(jcfg, jopt))
    losses = []
    for s in range(steps):
        params, state, m = step_fn(params, state, j_batch(jcfg, data, s))
        losses.append(float(m["loss"]))
    return dict(jcfg=jcfg, cfg=cfg, jopt=jopt, start=start, losses=losses,
                kw=dict(seq_len=seq, batch=batch, cfg=cfg, device="cpu"))


def _copy(src, dst):
    import shutil
    shutil.copytree(src, dst)
    return str(dst)


def test_train_lm_resumes_the_reference_and_matches_its_losses(
        train_case, tmp_path, capsys):
    """The port's run resumes the reference's step-0 checkpoint and its
    three losses are within rtol 1e-4 of the reference's steps; the
    reference reads the port's final checkpoint under its example's keys
    (``p``, ``o``) and finds the port's weights and step."""
    d = _copy(train_case["start"], tmp_path / "ck")
    out = train_lm.run(steps=3, ckpt_dir=d, **train_case["kw"])
    assert "resumed from step 0" in capsys.readouterr().out
    assert out["start"] == 0
    np.testing.assert_allclose(out["losses"], train_case["losses"],
                               rtol=1e-4)

    jparams = JT.init_params(train_case["jcfg"], jax.random.PRNGKey(1))
    template = jax.eval_shape(lambda: {
        "p": jparams, "o": JST.init_all(train_case["jcfg"],
                                        train_case["jopt"],
                                        jax.random.PRNGKey(1))[1]})
    n, flat, _ = JCK.restore(d)
    tree = JCK.unflatten_like(template, flat)
    assert n == 3 and int(tree["o"]["step"]) == 3
    port = ST.state_tree(out["params"], out["opt_state"])["params"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree["p"])[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_array_equal(np.asarray(leaf), port[key].numpy())


def test_train_lm_resume_at_step_two_gives_step_two_loss(train_case,
                                                          tmp_path):
    """Stopped after two steps and restarted, the example takes the third
    step from its checkpoint: its loss is the uninterrupted run's third
    loss."""
    whole = train_lm.run(steps=3, ckpt_dir=_copy(train_case["start"],
                                                 tmp_path / "whole"),
                         **train_case["kw"])
    d = _copy(train_case["start"], tmp_path / "cut")
    first = train_lm.run(steps=2, ckpt_dir=d, **train_case["kw"])
    resumed = train_lm.run(steps=3, ckpt_dir=d, **train_case["kw"])
    assert first["losses"] == whole["losses"][:2]
    assert resumed["start"] == 2 and len(resumed["losses"]) == 1
    np.testing.assert_allclose(resumed["losses"][0], whole["losses"][2],
                               rtol=1e-6)


def test_train_lm_configs_are_the_reference_examples():
    """``--small`` is the reference's ~10M variant of the ~100M config;
    both count the reference's parameters; the default checkpoint
    directory is the reference example's."""
    cfg = train_lm.small(train_lm.CONFIG_100M)
    assert (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size) == ("llama-10m", 4, 256, 4, 1024, 8000)
    for port_cfg in (train_lm.CONFIG_100M, cfg, serve_lm.SERVE_CFG):
        jcfg, _ = _configs(port_cfg)
        assert port_cfg.param_count() == jcfg.param_count()
    assert train_lm.CKPT_DIR == "/tmp/repro_100m_ckpt"
