"""Serve a small model with batched requests: prefill + greedy decode
(torch counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm

A 60M-parameter dense model with grouped-query attention, random weights
drawn from a seeded ``torch.Generator`` on the device; 8 prompts of 64
tokens, then 32 greedy tokens each through ``launch.serve.generate``.  The
prefill builds the KV cache at its full budget of prompt + generated
positions, so no padding follows it.  The times end in a device
synchronisation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.examples import parser, start
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T

SERVE_CFG = ArchConfig(
    name="serve-demo-60m", family="dense",
    n_layers=6, d_model=384, n_heads=6, n_kv_heads=2,   # GQA
    d_ff=1536, vocab_size=32000, dtype="float32", remat=False)


def run(*, cfg: ArchConfig = SERVE_CFG, params: Optional[T.Transformer] = None,
        batch: int = 8, prompt_len: int = 64, gen: int = 32,
        device: DeviceLike = None) -> dict:
    """Serve one batch; ``params`` replaces the seeded random weights.
    Returns the ``tokens`` (B, gen), the first step's last-position
    ``logits`` (B, V), the prompts, the prefill and decode seconds and
    the decode rate ``tok_s``."""
    dev = start(device)
    if params is None:
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    print(f"model: {cfg.param_count()/1e6:.0f}M params, GQA "
          f"{cfg.n_heads}/{cfg.n_kv_heads}")
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len)),
                              dtype=torch.int32, device=dev)
    tokens, logits, seconds = generate(cfg, params, prompts, gen,
                                       s_max=prompt_len + gen)
    print(f"prefill {batch}x{prompt_len}: {seconds['prefill']*1e3:.0f}ms")
    tok_s = batch * gen / seconds["decode"]
    print(f"decode {gen} tokens x {batch} requests: "
          f"{seconds['decode']*1e3:.0f}ms -> {tok_s:,.0f} tok/s")
    out = tokens.cpu().numpy()
    print("sample:", out[0][:16].tolist())
    return dict(tokens=out, logits=logits[0], prompts=prompts,
                seconds=seconds, tok_s=tok_s)


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
