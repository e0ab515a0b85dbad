"""granite-34b — dense code model (gpt_bigcode-style), 88L d6144 48H
(MQA kv=1) ff24576 vocab 49152; learned positions, LayerNorm, GELU MLP.
[arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    rope="learned", norm="layer", mlp="gelu", max_seq_len=8192,
))
