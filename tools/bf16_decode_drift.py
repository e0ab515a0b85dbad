"""How far an ssm model's decode steps drift from its training forward in
bf16, in the reference (JAX) and in the port, on the same weights.

A mamba2-family model cut to a width the CPU runs (``--layers`` layers of
d ``--d-model``, vocab 4,096) prefills ``--prompt`` tokens and decodes 6
more; each step's last logits are compared with the training forward's at
the same position over ``--prompt + 256`` tokens, as the long phase of
``chip_smoke.py`` does at full size.  Prints, per package and dtype, the
largest absolute difference per position and its largest share of the
limit 2e-2 + 2e-2 |x|: in bf16 the decode step rounds to bf16 where the
chunked scan keeps float32 (``mamba2_decode`` casts y before the gated
norm, its conv is one product), so the two drift apart with depth; in
float32 they agree.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/bf16_decode_drift.py

Runs on the CPU (both packages), a few minutes; the last line is JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_reference, to_numpy
from repro_torch.configs import base
from repro_torch.launch.serve import pad_cache
from repro_torch.models import transformer as T

STEPS = 6
TOL = dict(rtol=2e-2, atol=2e-2)


def shares(steps, full, prompt: int) -> dict:
    errs, worst = [], []
    for i, got in enumerate(steps):
        want = np.asarray(full[:, prompt - 1 + i], np.float32)
        err = np.abs(np.asarray(got, np.float32) - want)
        errs.append(float(err.max()))
        worst.append(float((err / (TOL["atol"] + TOL["rtol"]
                                   * np.abs(want))).max()))
    return {"max_abs_err": errs, "worst_share": max(worst),
            "logit_std": float(np.asarray(full, np.float32).std())}


def reference(jcfg, params, tokens, prompt: int) -> dict:
    logits, cache = jax.jit(lambda p, b: JT.prefill(jcfg, p, b))(
        params, {"tokens": jnp.asarray(tokens[:, :prompt])})
    steps = [logits[:, -1]]
    decode = jax.jit(lambda p, b: JT.decode_step(jcfg, p, b))
    for i in range(STEPS):
        logits, cache = decode(params, dict(
            tokens=jnp.asarray(tokens[:, prompt + i:prompt + i + 1]),
            cache=cache, cache_index=jnp.asarray(prompt + i, jnp.int32)))
        cache.pop("index")
        steps.append(logits[:, -1])
    full, _ = jax.jit(lambda p, b: JT.forward_train(jcfg, p, b))(
        params, {"tokens": jnp.asarray(tokens)})
    return shares(steps, full, prompt)


def port(cfg, model, tokens, prompt: int) -> dict:
    t = torch.as_tensor(tokens)
    logits, cache = T.prefill(cfg, model, {"tokens": t[:, :prompt]})
    steps = [to_numpy(logits[:, -1])]
    cache = pad_cache(cache, prompt + STEPS)
    for i in range(STEPS):
        logits, cache = T.decode_step(cfg, model, dict(
            tokens=t[:, prompt + i:prompt + i + 1], cache=cache,
            cache_index=prompt + i))
        cache.pop("index")
        steps.append(to_numpy(logits[:, -1]))
    with torch.no_grad():
        full, _ = T.forward_train(cfg, model, {"tokens": t})
    return shares(steps, to_numpy(full), prompt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--prompt", type=int, default=256)
    args = ap.parse_args(argv)
    tokens = np.random.default_rng(1).integers(
        0, 4096, (1, args.prompt + 256)).astype(np.int32)
    out = {}
    for dtype in ("bfloat16", "float32"):
        kw = dict(n_layers=args.layers, d_model=args.d_model,
                  vocab_size=4096, dtype=dtype, remat=False)
        jcfg = dataclasses.replace(jbase.get_config("mamba2-2.7b"), **kw)
        cfg = dataclasses.replace(base.get_config("mamba2-2.7b"), **kw)
        params = JT.init_params(jcfg, jax.random.PRNGKey(0))
        model = lm_params_from_reference(jax.tree.map(np.asarray, params),
                                         cfg, device="cpu")
        out[dtype] = {"reference": reference(jcfg, params, tokens,
                                             args.prompt),
                      "port": port(cfg, model, tokens, args.prompt)}
        for pkg, row in out[dtype].items():
            print(f"{dtype} {pkg}: max abs err per position "
                  f"{[round(e, 4) for e in row['max_abs_err']]}, worst "
                  f"share of 2e-2 + 2e-2 |x| {row['worst_share']:.3f} "
                  f"(logits' std {row['logit_std']:.3f})", flush=True)
    print(json.dumps({"layers": args.layers, "d_model": args.d_model,
                      "prompt": args.prompt, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
