"""Port vs reference: the MoE serving slice of the LM side-workload.

The reference's parameters (made with ``jax.random``) cross into the port
through ``repro_torch.bridge.lm_params_from_reference``; inputs are made
with numpy.  On ``reduced(phi3.5-moe)`` in float32 the layers, the MoE
layer (with and without capacity drops), prefill and greedy decode match
the reference within 1e-4 and choose the same tokens; prefill and decode
also on variants that keep kimi-k2's, granite-34b's, stablelm-12b's and
deepseek-7b's routing and head shapes (:data:`PREFILL_VARIANTS`).
"""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_reference, to_numpy
from repro_torch.configs import base
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

ARCH = "phi3.5-moe-42b-a6.6b"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------------

def test_configs_equal_reference_field_for_field():
    full, jfull = base.get_config(ARCH), jbase.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    red, jred = base.reduced(full), jbase.reduced(jfull)
    assert dataclasses.asdict(red) == dataclasses.asdict(jred)
    for cfg, jcfg in ((full, jfull), (red, jred)):
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    assert full.torch_dtype == torch.bfloat16
    assert red.torch_dtype == torch.float32


def test_unported_architectures_raise():
    """Every architecture of the repository is ported (the audio and vlm
    families, ROADMAP A15.5; life-stn96 for the dry run, A15.6); unknown
    names raise, and the model refuses life-stn96's family, which is no
    LM."""
    for name in ("musicgen-large", "qwen2-vl-7b", "life-stn96"):
        assert base.get_config(name).name == name
    assert set(base.PORTED) == set(base.ARCH_IDS) - {"life-stn96"}
    with pytest.raises(ValueError, match="unknown architecture"):
        base.get_config("gpt-9")
    with pytest.raises(ValueError, match="no LM family"):
        T.init_params(base.get_config("life-stn96"),
                      torch.Generator().manual_seed(0), "cpu")
    for family in ("audio", "vlm"):
        cfg = base.reduced(base.get_config(
            "musicgen-large" if family == "audio" else "qwen2-vl-7b"))
        assert T.init_params(cfg, torch.Generator().manual_seed(0),
                             "cpu").reference_leaves()
    assert base.get_config("mamba2-2.7b").family == "ssm"
    assert base.get_config("zamba2-1.2b").family == "hybrid"


# ----------------------------------------------------------------------------
# parameters across the bridge
# ----------------------------------------------------------------------------

def _leaf(params, name):
    parts = name.split(".")
    if parts[0] == "layers":
        node = params["layers"]
        for key in parts[2:]:
            node = node[key]
        return node[int(parts[1])]
    node = params["prefix"][int(parts[1])] if parts[0] == "prefix" else params
    for key in parts[2:] if parts[0] == "prefix" else parts:
        node = node[key]
    return node


@pytest.mark.parametrize("dtype,first_k_dense", [("float32", 0),
                                                 ("bfloat16", 1)])
def test_lm_params_round_trip(dtype, first_k_dense):
    cfg = dataclasses.replace(base.reduced(base.get_config(ARCH)),
                              dtype=dtype, first_k_dense=first_k_dense)
    jcfg = dataclasses.replace(jbase.reduced(jbase.get_config(ARCH)),
                               dtype=dtype, first_k_dense=first_k_dense)
    params = _np_tree(JT.init_params(jcfg, jax.random.PRNGKey(1)))
    model = lm_params_from_reference(params, cfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    # the reference stacks each of an MoE block's 10 leaves over its layers
    n_moe = cfg.n_layers - first_k_dense
    assert len(names) == len(jax.tree.leaves(params)) + (n_moe - 1) * 10
    for name, p in model.named_parameters():
        want = np.asarray(_leaf(params, name))
        assert str(p.dtype).endswith(want.dtype.name), name
        np.testing.assert_array_equal(to_numpy(p), want.astype(np.float32),
                                      err_msg=name)
    assert len(model.prefix) == first_k_dense
    with pytest.raises(ValueError, match="router"):
        broken = dict(params, layers=dict(params["layers"]))
        broken["layers"]["moe"] = {k: v for k, v in
                                   params["layers"]["moe"].items()
                                   if k != "router"}
        lm_params_from_reference(broken, cfg, device="cpu")


def test_init_params_is_seeded_and_shaped():
    cfg = base.reduced(base.get_config(ARCH))
    a = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    jparams = JT.init_params(jbase.reduced(jbase.get_config(ARCH)),
                             jax.random.PRNGKey(0))
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
        assert tuple(p.shape) == np.asarray(_leaf(jparams, name)).shape, name
    assert len(a.layers) == cfg.n_layers and not a.prefix


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_init_equals_the_scaled_float32_draws(dtype):
    """``normal_init`` scales its float32 draws in place: the same bits as
    scaling a copy, ``(randn * scale).to(dtype)``, for the same seed."""
    shape, scale = (3, 257, 96), (2.0 / (257 + 96)) ** 0.5
    got = L.normal_init(torch.Generator().manual_seed(11), shape, scale,
                        dtype, "cpu")
    want = (torch.randn(shape, generator=torch.Generator().manual_seed(11),
                        dtype=torch.float32) * scale).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(L.dense_init(torch.Generator().manual_seed(4), 96, 40,
                                    dtype, "cpu"),
                       (torch.randn((96, 40), generator=torch.Generator()
                                    .manual_seed(4)) * (2.0 / 136) ** 0.5
                        ).to(dtype))


# ----------------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------------

def test_norms_and_rope_match_reference():
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = r.normal(size=(16,)).astype(np.float32)
    bias = r.normal(size=(16,)).astype(np.float32)
    for kind in ("rms", "ln"):
        p = L.Norm(kind, 16, torch.float32, "cpu")
        p.scale.data.copy_(_t(scale))
        jp = {"scale": jnp.asarray(scale)}
        if kind != "rms":
            p.bias.data.copy_(_t(bias))
            jp["bias"] = jnp.asarray(bias)
        np.testing.assert_allclose(
            to_numpy(L.apply_norm(kind, p, _t(x))),
            np.asarray(JL.apply_norm(kind, jp, jnp.asarray(x))), **TOL)
    pos = r.integers(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        to_numpy(L.apply_rope(_t(x), _t(pos), 1e4)),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        **TOL)


def test_dense_attention_matches_reference():
    r = np.random.default_rng(1)
    q = r.normal(size=(2, 7, 4, 16)).astype(np.float32)
    k = r.normal(size=(2, 7, 2, 16)).astype(np.float32)
    v = r.normal(size=(2, 7, 2, 16)).astype(np.float32)
    for causal in (True, False):
        np.testing.assert_allclose(
            to_numpy(L.dense_attention(_t(q), _t(k), _t(v), causal=causal)),
            np.asarray(JL.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal)),
            **TOL)


def _attention(spec, seed):
    jp = JL.init_attention(jax.random.PRNGKey(seed), spec, jnp.float32)
    p = L.Attention(spec, torch.float32, "cpu")
    for name in ("wq", "wk", "wv", "wo"):
        getattr(p, name).data.copy_(_t(jp[name]))
    return jp, p


def test_attention_prefill_and_decode_match_reference():
    spec = L.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    jspec = JL.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    jp, p = _attention(spec, 2)
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 6, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    out, (k, v) = L.attention_prefill(p, spec, _t(x), _t(pos))
    jout, (jk, jv) = JL.attention_prefill(jp, jspec, jnp.asarray(x),
                                          jnp.asarray(pos))
    for got, want in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    # decode one token at position 6 into a cache of 9 positions
    kc = np.zeros((2, 9, 2, 8), np.float32)
    vc = np.zeros((2, 9, 2, 8), np.float32)
    kc[:, :6], vc[:, :6] = np.asarray(jk), np.asarray(jv)
    x1 = r.normal(size=(2, 1, 32)).astype(np.float32)
    pos1 = np.full((2, 1), 6, np.int32)
    out, (k2, v2) = L.attention_decode(p, spec, _t(x1), _t(pos1),
                                       (_t(kc), _t(vc)), 6)
    jout, (jk2, jv2) = JL.attention_decode(
        jp, jspec, jnp.asarray(x1), jnp.asarray(pos1),
        (jnp.asarray(kc), jnp.asarray(vc)), jnp.asarray(6, jnp.int32))
    for got, want in ((out, jout), (k2, jk2), (v2, jv2)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="cache_index"):
        L.attention_decode(p, spec, _t(x1), _t(pos1), (_t(kc), _t(vc)), 9)


def test_long_prompts_match_the_reference():
    """A prompt past BLOCK_THRESHOLD (1,088 tokens: flash in chunks of 64,
    the one KV head repeated to both query heads) no longer raises: the
    prefill's output and cache match the reference's."""
    spec = L.AttnSpec(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4)
    jspec = JL.AttnSpec(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4)
    jp, p = _attention(spec, 3)
    n = L.BLOCK_THRESHOLD + 64
    x = np.random.default_rng(3).normal(size=(1, n, 8)).astype(np.float32)
    pos = np.arange(n, dtype=np.int32)[None]
    out, (k, v) = L.attention_prefill(p, spec, _t(x), _t(pos))
    jout, (jk, jv) = JL.attention_prefill(jp, jspec, jnp.asarray(x),
                                          jnp.asarray(pos))
    assert out.shape == (1, n, 8) and k.shape == (1, n, 1, 4)
    for got, want in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)


# ----------------------------------------------------------------------------
# the MoE layer
# ----------------------------------------------------------------------------

def _moe_pair(d, ff, E, n_shared, seed):
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), d, ff, E, n_shared,
                       jnp.float32)
    p = MOE.MoE(d, ff, E, n_shared, torch.float32, "cpu")
    for name in ("router", "wi_gate", "wi_up", "wo"):
        getattr(p, name).data.copy_(_t(jp[name]))
    if n_shared:
        for name in ("wi_gate", "wi_up", "wo"):
            getattr(p.shared, name).data.copy_(_t(jp["shared"][name]))
    return jp, p


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, None])
def test_moe_ffn_matches_reference(top_k, capacity_factor):
    """Output and aux loss, at capacity_factor 1.25 (tokens dropped) and
    at E (drop-free)."""
    d, ff, E = 16, 32, 8
    jp, p = _moe_pair(d, ff, E, 0, 4 + top_k)
    cf = float(E) if capacity_factor is None else capacity_factor
    r = np.random.default_rng(top_k)
    # a direction shared by all tokens crowds them onto a few experts
    x = (r.normal(size=(2, 40, d)) + r.normal(size=(d,))).astype(np.float32)
    out, aux = MOE.moe_ffn(p, _t(x), top_k=top_k, capacity_factor=cf)
    jout, jaux = JMOE.moe_ffn(jp, jnp.asarray(x), top_k=top_k,
                              capacity_factor=cf)
    np.testing.assert_allclose(to_numpy(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    full, _ = MOE.moe_ffn(p, _t(x), top_k=top_k, capacity_factor=float(E))
    dropped = not torch.allclose(out, full, **TOL)
    assert dropped == (capacity_factor is not None)


def test_moe_shared_expert_and_capacity_formula():
    jp, p = _moe_pair(8, 16, 4, 1, 9)
    x = np.random.default_rng(5).normal(size=(1, 4, 8)).astype(np.float32)
    out, _ = MOE.moe_ffn(p, _t(x), top_k=2, capacity_factor=4.0)
    jout, _ = JMOE.moe_ffn(jp, jnp.asarray(x), top_k=2, capacity_factor=4.0)
    np.testing.assert_allclose(to_numpy(out), np.asarray(jout), **TOL)
    # prefill 4 x 512 and decode 4 x 1 of phi3.5-moe (16 experts, top-2)
    assert MOE.capacity_of(2048, 2, 16, 1.25) == 320
    assert MOE.t_tile_of(320) == 64
    assert MOE.capacity_of(4, 2, 16, 1.25) == 8 and MOE.t_tile_of(8) == 8


def test_moe_top_k_breaks_ties_to_the_lowest_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = MOE._top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_plain_expert_path_equals_the_kernel_path_on_cpu():
    _, p = _moe_pair(16, 32, 4, 0, 6)
    x = _t(np.random.default_rng(6).normal(size=(2, 8, 16)).astype(
        np.float32))
    n = _build.launches("moe_gmm")
    out, _ = MOE.moe_ffn(p, x, top_k=2)
    p.plain = True
    plain, _ = MOE.moe_ffn(p, x, top_k=2)
    assert torch.equal(out, plain) and _build.launches("moe_gmm") == n


# ----------------------------------------------------------------------------
# prefill + greedy decode against the reference
# ----------------------------------------------------------------------------

def _pad(cache, s_max):
    return {k: np.pad(v, ((0, 0), (0, 0), (0, s_max - v.shape[2]),
                          (0, 0), (0, 0))) for k, v in cache.items()}


#: variants of ``reduced()``: (architecture, fields replaced).  The last four
#: keep what ``reduced()`` erases from the published configurations: kimi-k2's
#: top-8 routing over 32 experts with a shared expert and a dense first
#: layer, its capacity factor and head_dim 28 (for 112) under GQA 32/4;
#: granite's multi-query attention, learned positions, LayerNorm and GELU;
#: stablelm's head_dim 40 (for 160) under GQA 8/2; deepseek's full MHA at
#: head_dim 28
PREFILL_VARIANTS = {
    "reduced": (ARCH, {}),
    "first_k_dense": (ARCH, {"first_k_dense": 1}),
    "capacity_1.25": (ARCH, {"capacity_factor": 1.25}),
    "kimi-k2": ("kimi-k2-1t-a32b", dict(
        d_model=896, n_heads=32, n_kv_heads=4, head_dim=28, d_ff=64,
        n_experts=32, top_k=8, moe_d_ff=32, capacity_factor=1.25)),
    "granite-34b": ("granite-34b", dict(d_model=128, head_dim=32)),
    "stablelm-12b": ("stablelm-12b", dict(d_model=320, n_heads=8,
                                          n_kv_heads=2, head_dim=40)),
    "deepseek-7b": ("deepseek-7b", dict(d_model=112, head_dim=28)),
}


@pytest.mark.parametrize("variant", list(PREFILL_VARIANTS))
def test_prefill_and_decode_match_reference(variant):
    """Prefill logits and cache, then 8 greedy decode steps: the same
    tokens, logits within 1e-4 (float32)."""
    arch, kw = PREFILL_VARIANTS[variant]
    jcfg = dataclasses.replace(jbase.reduced(jbase.get_config(arch)), **kw)
    cfg = dataclasses.replace(base.reduced(base.get_config(arch)), **kw)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_reference(_np_tree(params), cfg, device="cpu")
    B, P, n_steps = 2, 12, 8
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)

    jprefill = jax.jit(lambda p, b: JT.prefill(jcfg, p, b))
    jdecode = jax.jit(lambda p, b: JT.decode_step(jcfg, p, b))
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(prompts)})
    logits, cache = T.prefill(cfg, model, {"tokens": _t(prompts)})
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits), **TOL)
    for name in ("k", "v"):
        assert cache[name].shape == (cfg.n_layers, B, P, cfg.n_kv_heads,
                                     cfg.resolved_head_dim)
        np.testing.assert_allclose(to_numpy(cache[name]),
                                   np.asarray(jcache[name]), **TOL)
    s_max = P + n_steps
    jcache = {k: jnp.asarray(v) for k, v in _pad(_np_tree(jcache),
                                                s_max).items()}
    cache = serve.pad_cache(cache, s_max)
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(n_steps):
        idx = P + i
        jlogits, jcache = jdecode(params, dict(
            tokens=jnp.asarray(tok), cache=jcache,
            cache_index=jnp.asarray(idx, jnp.int32)))
        logits, cache = T.decode_step(cfg, model, dict(
            tokens=_t(tok), cache=cache, cache_index=idx))
        assert int(jcache.pop("index")) == cache.pop("index") == idx + 1
        np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                                   **TOL, err_msg=f"step {i}")
        want = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)
        np.testing.assert_array_equal(
            to_numpy(torch.argmax(logits[:, -1], -1)), want)
        tok = want[:, None]
    for name in ("k", "v"):
        np.testing.assert_allclose(to_numpy(cache[name]),
                                   np.asarray(jcache[name]), **TOL)


def test_generate_matches_stepwise_decoding_and_teacher_forcing():
    """serve.generate: greedy tokens, and a teacher-forced run fed those
    tokens gives the same logits at every step."""
    cfg = base.reduced(base.get_config(ARCH))
    model = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 10),
                            generator=torch.Generator().manual_seed(2),
                            dtype=torch.int32)
    tokens, logits, seconds = serve.generate(cfg, model, prompts, 6)
    assert tokens.shape == (3, 6) and tokens.dtype == torch.int32
    assert len(logits) == 6 and set(seconds) == {"prefill", "decode"}
    forced, flogits, _ = serve.generate(cfg, model, prompts, 6, forced=tokens)
    assert torch.equal(forced, tokens)
    for a, b in zip(logits, flogits):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# the serving CLI
# ----------------------------------------------------------------------------

def test_serve_cli_on_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "5"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("prefill 2x8: ")
    assert lines[2].startswith("decode: ") and "tok/s" in lines[2]
    first_row = eval(lines[3].split(":", 1)[1])
    assert len(first_row) == 5 and all(0 <= t < 128 for t in first_row)


def test_serve_wants_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
