"""qwen1.5-4b — dense with QKV bias, 40L d2560 20H (GQA kv=20) ff6912
vocab 151936.  [hf:Qwen/Qwen1.5 family; hf]

20 heads don't divide the 16-way model axis: attention shards on head_dim
instead (DESIGN.md §4 sharding notes)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab_size=151936, qkv_bias=True, rope_theta=5e6,
))
