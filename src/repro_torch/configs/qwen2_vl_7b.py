"""qwen2-vl-7b — VLM backbone: 28L d3584 28H (GQA kv=4) ff18944 vocab
152064, M-RoPE.  [arXiv:2409.12191; hf]

Backbone only: the dynamic-resolution ViT is a stub — input_specs provide
precomputed patch embeddings + 3-D (t,h,w) position ids."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True,
    rope="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    vision_tokens=1024,
))
