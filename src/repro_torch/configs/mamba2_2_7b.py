"""mamba2-2.7b — attention-free SSD: 64L d2560, ssm_state 128, head_dim 64,
expand 2 (80 ssm heads), vocab 50280.  [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
))
