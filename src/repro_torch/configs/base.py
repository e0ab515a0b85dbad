"""Architecture config schema, registry, shape suite and ``reduced()``
(torch counterpart of ``repro/configs/base.py``).

Every architecture ships as ``repro_torch/configs/<id>.py`` exporting
CONFIG (the exact published geometry, the reference's field for field)
and registering itself.  ``reduced()`` derives the reference's
CPU-smoke-testable variant of the same family.  :func:`input_specs`
gives the dry run's batch of a :data:`SHAPES` entry as tensors on the
``meta`` device: shapes and dtypes, no allocation.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple

import torch

SHAPES = {
    # name: (seq_len, global_batch, step kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

ARCH_IDS = (
    "deepseek-7b", "stablelm-12b", "qwen1.5-4b", "granite-34b",
    "zamba2-1.2b", "musicgen-large", "qwen2-vl-7b",
    "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "mamba2-2.7b",
    "life-stn96",
)
#: the LM architectures the port's model runs: every one but life-stn96
#: (the LiFE workload, which only the dry run reads); the dense, MoE,
#: ssm, hybrid, audio and vlm families (kimi-k2's 1 T parameters fit no
#: single card)
PORTED = ("phi3.5-moe-42b-a6.6b", "qwen1.5-4b", "deepseek-7b",
          "stablelm-12b", "granite-34b", "kimi-k2-1t-a32b", "mamba2-2.7b",
          "zamba2-1.2b", "musicgen-large", "qwen2-vl-7b")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope: str = "rope"               # rope | mrope | sinusoidal | learned
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    norm: str = "rms"
    mlp: str = "swiglu"
    tie_embeddings: bool = False
    max_seq_len: int = 8192          # learned-position table size
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    attn_every: int = 0              # hybrid: shared attn+mlp block period
    # modality frontends (stubs: input_specs provide embeddings)
    n_codebooks: int = 0             # audio (EnCodec streams)
    vision_tokens: int = 0           # vlm: image patch embeddings per sample
    # numerics / runtime
    dtype: str = "bfloat16"
    remat: bool = True

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def supports(self, shape: str) -> bool:
        """Which of the input shapes this arch runs (long_500k needs
        sub-quadratic attention)."""
        if shape == "long_500k":
            return self.sub_quadratic
        return True

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS in the roofline)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        n = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
            n += L * attn
        if self.family in ("dense", "audio", "vlm"):
            ff = d * self.d_ff * (3 if self.mlp == "swiglu" else 2)
            n += L * ff
        if self.family == "moe":
            ff_moe = 3 * d * self.moe_d_ff
            dense_layers = self.first_k_dense
            moe_layers = L - dense_layers
            n += moe_layers * (self.n_experts * ff_moe + d * self.n_experts)
            n += moe_layers * self.n_shared_experts * ff_moe
            n += dense_layers * 3 * d * self.d_ff
        if self.family in ("ssm", "hybrid"):
            gn = self.ssm_groups * self.ssm_state
            per = d * (2 * self.d_inner + 2 * gn + self.ssm_heads) \
                + self.d_inner * d
            n += L * per
        if self.family == "hybrid" and self.attn_every:
            n += d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d + 3 * d * self.d_ff
        if self.n_codebooks:
            n += self.n_codebooks * self.vocab_size * d       # heads
            n += self.vocab_size * d                          # embed (stub side)
        elif self.vocab_size:
            n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        attn = L * (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                    + self.n_heads * hd * d)
        ff_moe = 3 * d * self.moe_d_ff
        moe_layers = L - self.first_k_dense
        act = attn + moe_layers * ((self.top_k + self.n_shared_experts) * ff_moe
                                   + d * self.n_experts)
        act += self.first_k_dense * 3 * d * self.d_ff
        act += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(act)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    """The registered configuration ``name``.

    Raises:
        ValueError: ``name`` is no architecture of the repository.
    """
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    if name not in _REGISTRY:
        importlib.import_module(
            "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return _REGISTRY[name]


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 64,
            vocab: int = 128) -> ArchConfig:
    """Small same-family variant for CPU smoke tests."""
    kw: Dict[str, Any] = dict(
        name=cfg.name + "-reduced", n_layers=n_layers, d_model=d_model,
        vocab_size=min(cfg.vocab_size, vocab) if cfg.vocab_size else 0,
        max_seq_len=256, dtype="float32", remat=False,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)),
                  head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=4 * d_model)
    if cfg.n_experts:
        # capacity_factor = n_experts => drop-free routing, so the
        # prefill/decode == forward consistency tests are exact
        kw.update(n_experts=4, top_k=min(2, cfg.top_k), moe_d_ff=2 * d_model,
                  n_shared_experts=min(1, cfg.n_shared_experts),
                  first_k_dense=min(1, cfg.first_k_dense),
                  capacity_factor=4.0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.n_codebooks:
        kw.update(n_codebooks=cfg.n_codebooks)
    if cfg.vision_tokens:
        kw.update(vision_tokens=16)
    return dataclasses.replace(cfg, **kw)


# ----------------------------------------------------------------------------
# Input specs (``meta`` tensors; no allocation)
# ----------------------------------------------------------------------------

def meta_spec(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: str,
                overrides: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Batch specs for ``shape`` (see :data:`SHAPES`) as ``meta`` tensors.
    For decode shapes this is the serve step's batch (one new token and a
    KV/SSM cache of seq_len)."""
    seq, batch, kind = SHAPES[shape]
    if overrides:
        seq = overrides.get("seq_len", seq)
        batch = overrides.get("global_batch", batch)
    f, i32, dt = meta_spec, torch.int32, cfg.torch_dtype
    if kind == "train":
        return _train_batch(cfg, batch, seq, f, i32, dt)
    if kind == "prefill":
        return _prefill_batch(cfg, batch, seq, f, i32, dt)
    return _decode_batch(cfg, batch, seq, f, i32, dt)


def _train_batch(cfg, batch, seq, f, i32, dt):
    if cfg.family == "audio":
        return dict(frame_embeds=f((batch, seq, cfg.d_model), dt),
                    codes=f((batch, seq, cfg.n_codebooks), i32))
    if cfg.family == "vlm":
        vt = cfg.vision_tokens
        return dict(tokens=f((batch, seq - vt), i32),
                    image_embeds=f((batch, vt, cfg.d_model), dt),
                    positions=f((3, batch, seq), i32),
                    labels=f((batch, seq), i32))
    return dict(tokens=f((batch, seq), i32), labels=f((batch, seq), i32))


def _prefill_batch(cfg, batch, seq, f, i32, dt):
    b = _train_batch(cfg, batch, seq, f, i32, dt)
    b.pop("labels", None)
    b.pop("codes", None)
    return b


def _decode_batch(cfg, batch, seq, f, i32, dt):
    """One new token and caches filled to seq tokens."""
    specs: Dict[str, Any] = dict(cache_index=f((), i32))
    if cfg.family == "audio":
        specs["frame_embeds"] = f((batch, 1, cfg.d_model), dt)
    else:
        specs["tokens"] = f((batch, 1), i32)
    if cfg.family == "vlm":
        specs["positions"] = f((3, batch, 1), i32)
    specs["cache"] = cache_specs(cfg, batch, seq, f, dt)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, seq: int, f, dt
                ) -> Dict[str, Any]:
    """The decode cache of ``batch`` rows and ``seq`` positions, each
    entry made by ``f(shape, dtype)``: ``k``/``v`` (L, B, S, KV, hd) for
    the attention families (the hybrid: one per shared-block
    application), ``ssm`` (L, B, H, P, N) float32 and ``conv`` (L, B,
    d_conv - 1, C) for the ssm and hybrid families."""
    hd = cfg.resolved_head_dim
    cache: Dict[str, Any] = {}
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        cache["k"] = f((cfg.n_layers, batch, seq, cfg.n_kv_heads, hd), dt)
        cache["v"] = f((cfg.n_layers, batch, seq, cfg.n_kv_heads, hd), dt)
    if cfg.family in ("ssm", "hybrid"):
        gn = cfg.ssm_groups * cfg.ssm_state
        c_tot = cfg.d_inner + 2 * gn
        cache["ssm"] = f((cfg.n_layers, batch, cfg.ssm_heads,
                          cfg.ssm_head_dim, cfg.ssm_state), torch.float32)
        cache["conv"] = f((cfg.n_layers, batch, cfg.ssm_conv - 1, c_tot), dt)
    if cfg.family == "hybrid" and cfg.attn_every:
        n_apps = sum(1 for i in range(cfg.n_layers)
                     if i % cfg.attn_every == cfg.attn_every - 1)
        cache["k"] = f((n_apps, batch, seq, cfg.n_kv_heads, hd), dt)
        cache["v"] = f((n_apps, batch, seq, cfg.n_kv_heads, hd), dt)
    return cache
