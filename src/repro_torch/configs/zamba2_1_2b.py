"""zamba2-1.2b — hybrid: 38 Mamba2 layers (d2048, ssm_state 64) + a shared
attention+MLP block (32H kv=32, ff8192) applied every 6 layers with separate
KV caches per application.  [arXiv:2411.15242; hf]

As in the reference, the shared block reuses one weight set (as Zamba2
does) but omits the per-application LoRA deltas and the
concat-with-embedding input path."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
))
