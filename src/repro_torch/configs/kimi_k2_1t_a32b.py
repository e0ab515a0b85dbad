"""kimi-k2-1t-a32b — trillion-param MoE: 61L d7168 64H (GQA kv=8),
MoE 384 experts top-8 with expert ff2048 + 1 shared expert, first layer
dense, vocab 163840.  [paper-table; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432, vocab_size=163840,
    n_experts=384, top_k=8, moe_d_ff=2048,
    n_shared_experts=1, first_k_dense=1,
))
