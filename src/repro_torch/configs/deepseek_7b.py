"""deepseek-7b — dense llama-arch, 30L d4096 32H (GQA kv=32 = MHA) ff11008
vocab 102400.  [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=102400, rope_theta=1e4,
))
