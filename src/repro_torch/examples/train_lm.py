"""End-to-end driver: train a ~100M-param dense LM for a few hundred steps
(torch counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200

Uses the full framework path: config system, deterministic data pipeline,
AdamW with warmup + cosine decay, checkpointing with resume, on a ~100M
llama-style config derived from the deepseek-7b family.  The weights are
drawn from a seeded ``torch.Generator`` on the device.

Checkpoints hold ``{"p": params, "o": opt_state}`` under the reference
example's keys (the parameters by their reference paths, stacked layers
stacked), so either package's run resumes the other's: a port run resumes
a reference run it finds in ``--ckpt-dir`` and the other way round.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import manager as CK
from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import DataConfig, synth_batch_for
from repro_torch.device import DeviceLike
from repro_torch.examples import parser, start
from repro_torch.launch import steps as ST
from repro_torch.optim.adamw import OptConfig

CONFIG_100M = ArchConfig(
    name="llama-100m", family="dense",
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=32000, dtype="float32", remat=False)
#: the reference example's checkpoint directory
CKPT_DIR = "/tmp/repro_100m_ckpt"


def small(cfg: ArchConfig) -> ArchConfig:
    """The ~10M variant of ``--small``."""
    return dataclasses.replace(cfg, name="llama-10m", n_layers=4,
                               d_model=256, n_heads=4, n_kv_heads=4,
                               d_ff=1024, vocab_size=8000)


def _save(ckpt_dir: str, step: int, params, opt_state) -> None:
    tree = ST.state_tree(params, opt_state)
    CK.save(ckpt_dir, step, {"p": tree["params"], "o": tree["opt"]})


def _restore(ckpt_dir: str, params, opt_state) -> int:
    start, flat, _ = CK.restore(ckpt_dir)
    tmpl = ST.state_template(params, opt_state)
    tree = CK.unflatten_like({"p": tmpl["params"], "o": tmpl["opt"]}, flat)
    ST.load_state(params, opt_state,
                  {"params": tree["p"], "opt": tree["o"]})
    return start


def run(*, steps: int = 200, seq_len: int = 256, batch: int = 8,
        ckpt_dir: str = CKPT_DIR, cfg: Optional[ArchConfig] = None,
        device: DeviceLike = None) -> dict:
    """Train from the latest checkpoint in ``ckpt_dir`` (else from the
    seeded weights) to ``steps``; ``cfg`` replaces the 100M config.
    Returns the ``losses`` of the steps run, the ``start`` step, the
    tokens/s of the last logged step, the config and the final state."""
    dev = start(device)
    cfg = CONFIG_100M if cfg is None else cfg
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.0f}M params)")
    opt = OptConfig(lr=3e-4, warmup_steps=20, decay_steps=steps,
                    weight_decay=0.01)
    data = DataConfig(seed=0, seq_len=seq_len, global_batch=batch)

    params, opt_state = ST.init_all(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)
    first = 0
    if CK.latest_step(ckpt_dir) is not None:
        first = _restore(ckpt_dir, params, opt_state)
        print(f"resumed from step {first}")

    step_fn = ST.make_train_step(cfg, opt)
    losses, tput = [], 0.0
    t_start = time.time()
    for step in range(first, steps):
        b = synth_batch_for(cfg, data, step, device=dev)
        params, opt_state, m = step_fn(params, opt_state, b)
        losses.append(float(m["loss"]))
        if step % 20 == 0 or step == steps - 1:
            tput = data.global_batch * data.seq_len / max(
                (time.time() - t_start) / max(len(losses), 1), 1e-9)
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"({tput:,.0f} tok/s)", flush=True)
        if (step + 1) % 100 == 0:
            _save(ckpt_dir, step + 1, params, opt_state)
    _save(ckpt_dir, steps, params, opt_state)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoints in {ckpt_dir}")
    return dict(losses=losses, start=first, tok_s=tput, cfg=cfg,
                params=params, opt_state=opt_state)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR,
                    help=f"checkpoint directory (default {CKPT_DIR}, the "
                         "reference example's): both packages read the "
                         "same files, so a run resumes the latest "
                         "checkpoint found there, whichever package "
                         "wrote it")
    ap.add_argument("--small", action="store_true",
                    help="~10M variant: a few hundred steps complete in "
                         "minutes on one CPU core (same code path)")
    args = ap.parse_args(argv)
    out = run(steps=args.steps, seq_len=args.seq_len, batch=args.batch,
              ckpt_dir=args.ckpt_dir,
              cfg=small(CONFIG_100M) if args.small else None,
              device=args.device)
    losses = out["losses"]
    assert losses[-1] < losses[0], "loss must decrease"
    return out


if __name__ == "__main__":
    main()
