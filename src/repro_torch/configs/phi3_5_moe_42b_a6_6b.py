"""phi3.5-moe-42b-a6.6b — MoE: 32L d4096 32H (GQA kv=8) expert ff6400,
16 experts top-2, vocab 32064.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2, moe_d_ff=6400,
))
