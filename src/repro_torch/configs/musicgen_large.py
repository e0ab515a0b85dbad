"""musicgen-large — decoder-only over EnCodec tokens: 48L d2048 32H (MHA)
ff8192, 4 codebooks x vocab 2048, sinusoidal positions.  [arXiv:2306.05284]

Backbone only: the EnCodec frontend is a stub — input_specs provide
precomputed frame embeddings; text cross-attention conditioning omitted
(DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, n_codebooks=4,
    rope="sinusoidal", norm="layer", mlp="gelu",
))
