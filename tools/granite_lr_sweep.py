"""granite-34b's first training steps at several learning rates, on the
card: the trainer's main at its defaults (8 x 128 tokens, a warmup of 2
steps) for 3 steps at 12 of 88 layers (the depth ``chip_smoke.py``
phase 21c trains), then the loss of step 0's batch again, each run from
the same seeded weights.  Prints each rate's step losses and step 0's
batch before and after; the last line is JSON.

    PYTHONPATH=src python3 tools/granite_lr_sweep.py [--layers 12]

Needs a CUDA card (about a minute, 70 GB of device memory at 12 layers).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.data.tokens import synth_batch_for
from repro_torch.launch import train
from repro_torch.models import transformer as T

RATES = (3e-3, 3e-4, 1e-4, 3e-5, 1e-5, 3e-6)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    layers = ap.parse_args(argv).layers
    if not torch.cuda.is_available():
        raise SystemExit("granite_lr_sweep: no CUDA device is visible")
    out = {}
    for lr in RATES:
        run = train.main(["--arch", "granite-34b", "--steps", "3",
                          "--layers", str(layers), "--lr", str(lr),
                          "--log-every", "100"])
        with torch.no_grad():
            b0 = synth_batch_for(run.cfg, run.data, 0, device="cuda")
            after = float(T.loss_fn(run.cfg, run.params, b0)[0])
        out[lr] = dict(losses=run.losses, grad_norms=[
            m["grad_norm"] for m in run.metrics], step0_after=after)
        print(f"lr {lr}: step losses {[round(x, 4) for x in run.losses]}, "
              f"gradient norms {[round(m['grad_norm'], 3) for m in run.metrics]}"
              f"; step 0's batch {run.losses[0]:.4f} before, {after:.4f} "
              f"after", flush=True)
        del run, b0
        torch.cuda.empty_cache()
    print(json.dumps({"layers": layers, "device": torch.cuda.get_device_name(0),
                      "rates": {str(k): v for k, v in out.items()}}))
    return out


if __name__ == "__main__":
    main()
