"""How far bf16 attention's output and gradients lie from float32 as the
query group grows, for the port's flash_attention and for autograd
through dense_attention, on the same bf16 inputs.

For each geometry (H query heads sharing KV heads in groups of H / KV, a
head_dim) it draws q, k, v and the output's gradient in bf16 (seeded),
computes the output and dq, dk, dv with flash (chunk 512) and with
dense_attention in bf16, and with dense_attention in float32 on the same
bf16 values, and prints the largest share of the limit 2e-2 + 2e-2 |x|
(``chip_smoke.py``'s LONG_TOL) by which each bf16 result lies from the
float32 one, and flash's from bf16 dense.  dk and dv sum over a group's
H / KV heads, so their magnitudes, and bf16's error in them, grow with
the group.

    PYTHONPATH=src python tools/flash_bf16_groups.py [--seq 2048]

Runs on the CPU (the port only), about a minute at 2,048 positions; the
last line is JSON.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import dense_attention

#: (label, H, KV, head_dim): qwen1.5-4b's (phase 15a), kimi-k2's,
#: granite-34b's and stablelm-12b's attention
GEOMETRIES = (("qwen1.5-4b", 20, 20, 128), ("kimi-k2-1t-a32b", 64, 8, 112),
              ("granite-34b", 48, 1, 128), ("stablelm-12b", 32, 8, 160))
TOL = dict(rtol=2e-2, atol=2e-2)


def share(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float(((got.float() - want).abs()
                  / (TOL["atol"] + TOL["rtol"] * want.abs())).max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=2048)
    S = ap.parse_args(argv).seq
    out = {}
    for label, H, KV, hd in GEOMETRIES:
        G = H // KV
        g = torch.Generator().manual_seed(60)
        q, k, v, dout = (torch.randn(shape, generator=g).bfloat16()
                         for shape in ((1, S, KV, G, hd), (1, S, KV, hd),
                                       (1, S, KV, hd), (1, S, KV, G, hd)))

        def grads(fn, *ts):
            ts = [t.clone().requires_grad_() for t in ts]
            o = fn(*ts)
            return (o.detach(), *torch.autograd.grad(o, ts, dout.to(o.dtype)))

        def dense(a, b, c):
            return dense_attention(a.reshape(1, S, H, hd), b, c).reshape(
                1, S, KV, G, hd)

        flash = grads(lambda a, b, c: flash_attention(a, b, c, min(512, S)),
                      q, k, v)
        dense16 = grads(dense, q, k, v)
        dense32 = grads(dense, q.float(), k.float(), v.float())
        row = {}
        for i, part in enumerate(("out", "dq", "dk", "dv")):
            row[part] = dict(flash_vs_fp32=share(flash[i], dense32[i]),
                             dense_vs_fp32=share(dense16[i], dense32[i]),
                             flash_vs_dense=share(flash[i], dense16[i]),
                             max_abs=float(dense32[i].abs().max()))
            print(f"{label} (H {H}, KV {KV}, group {G}, hd {hd}, S {S}) "
                  f"{part}: share of 2e-2 + 2e-2 |x| from float32: flash "
                  f"{row[part]['flash_vs_fp32']:.3f}, bf16 dense "
                  f"{row[part]['dense_vs_fp32']:.3f}; flash from bf16 dense "
                  f"{row[part]['flash_vs_dense']:.3f}; largest |x| "
                  f"{row[part]['max_abs']:.2f}")
        out[label] = row
    print(json.dumps({"seq": S, "shares": out}))
    return out


if __name__ == "__main__":
    main()
