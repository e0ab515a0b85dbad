"""The trainer's CLI: config -> restore-or-init -> step loop (torch
counterpart of ``repro/launch/train.py``, flag for flag).

Fault tolerance as in the reference: atomic checkpoints every
``--ckpt-every`` steps and at the end, in the reference's tree and keys
(either package resumes the other's run); automatic resume from the
latest checkpoint, the data cursor being the step, so a restart replays
the exact batch order; a straggler watchdog that reports a step slower
than 3x the running median.  Step times come from CUDA events on the card
(the host clock on the CPU).

``--model-axis M`` builds the reference's host mesh, ``(world // M, M)``
over the process group (``launch/mesh.py``), and activates it for the
model's hints.  One process is a ``(1, 1)`` mesh; several are started by
``torchrun`` or :func:`repro_torch.distributed.spmd.launch`, which put the
group in the environment, and then the model and its optimizer state are
placed by the sharding rules (``distributed/lm_shard.py``: data
parallelism over ``data``, the experts over ``model``, ZeRO-1), each rank
steps on its rows of the batch, rank 0 prints and writes checkpoints of
whole tensors, and a restart under another mesh shape reshards them.
Without ``--model-axis`` (and outside a group) no mesh is active: the
reference activates a ``(1, 1)`` mesh even then, which moves attention to
its mesh branch.  Beyond the reference's flags, ``--device`` picks the
device, ``--backend`` the group's backend and ``--layers`` cuts the
depth; :func:`main` returns the run's metrics (:class:`TrainRun`), and
its ``opt`` keyword trains with another optimizer than the CLI's AdamW
(Adafactor, on one process or a mesh; the reference's CLI builds only
AdamW), with no flag for it:

  train.main([...], opt=OptConfig(kind="adafactor", lr=1e-3,
                                  warmup_steps=2, decay_steps=50))

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
      --steps 50 --reduced --ckpt-dir /tmp/ck --device cpu

Without ``--device`` it runs on the CUDA card and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import manager as CK
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.data.tokens import DataConfig, synth_batch_for
from repro_torch.device import resolve_device
from repro_torch.distributed import hints, lm_shard, spmd
from repro_torch.launch import mesh as HM
from repro_torch.launch import steps as ST
from repro_torch.optim.adamw import OptConfig

#: a step slower than this multiple of the running median is reported
WATCHDOG_FACTOR = 3.0
WATCHDOG_WINDOW = 20


@dataclasses.dataclass
class TrainRun:
    """What :func:`main` ran: the configurations, the model and optimizer
    state after the last step, the step it started from, and per step its
    metrics (host floats) and milliseconds."""
    cfg: ArchConfig
    opt: OptConfig
    data: DataConfig
    params: torch.nn.Module
    opt_state: Dict
    start: int
    metrics: List[Dict[str, float]]
    step_ms: List[float]

    @property
    def losses(self) -> List[float]:
        return [m["loss"] for m in self.metrics]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--model-axis", type=int, default=None,
                    help="the mesh's model axis (default: no mesh on one "
                         "process, 1 in a process group)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, ... (default: the CUDA card)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep this many layers (a depth cut, for a model "
                         "whose state does not fit the card; 0: all)")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend when the environment "
                         "names a group (default: nccl on the card, gloo on "
                         "the CPU; several ranks on one card need gloo)")
    return ap.parse_args(argv)


class _StepClock:
    """Milliseconds of one step: CUDA events on the card, the host clock
    on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1)
        return (time.perf_counter() - self.t0) * 1e3


def _save(ckpt_dir: str, step: int, cfg: ArchConfig, params, opt_state,
          mesh) -> None:
    """Rank 0 writes whole tensors (every rank gathers them)."""
    tree = ST.state_tree(params, opt_state)
    if mesh is None or mesh.rank == 0:
        CK.save(ckpt_dir, step, tree, meta={"arch": cfg.name})
    if mesh is not None:
        mesh.barrier()


def main(argv=None, *, mesh=None, opt: Optional[OptConfig] = None
         ) -> TrainRun:
    """Run the trainer.  ``mesh``: activate this mesh instead of building
    one from ``--model-axis`` (a shape-only mesh gives one process the
    dispatch groups and attention branch of a mesh run).  ``opt``: the
    optimizer, used as given, instead of the CLI's AdamW (``--lr``,
    warmup over a twentieth of ``--steps`` (at least 2), decay over
    ``--steps``: :func:`cli_opt`)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    joined = spmd.join_process_group(args.backend, dev)
    try:
        return _main(args, dev, mesh, opt or cli_opt(args))
    finally:
        hints.deactivate()
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def cli_opt(args: argparse.Namespace) -> OptConfig:
    """The CLI's optimizer: AdamW at ``--lr``, its schedule from
    ``--steps``."""
    return OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                     decay_steps=args.steps)


def _main(args, dev: torch.device, mesh, opt: OptConfig) -> TrainRun:
    if mesh is None and (args.model_axis is not None
                         or HM.world_size() > 1):
        mesh = HM.make_host_mesh(args.model_axis or 1, dev)
    if mesh is not None:
        hints.activate(mesh)
    live = mesh if getattr(mesh, "live", False) else None
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduce_cfg(cfg), remat=False)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    data = DataConfig(seed=0, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    gen = torch.Generator(device=dev).manual_seed(0)
    if live is None:
        params, opt_state = ST.init_all(cfg, opt, gen, dev)
    else:
        params = ST.init_placed(cfg, live, gen, dev)
        opt_state = lm_shard.sharded(params).init_opt_state(opt)
    say = (functools.partial(print, flush=True)
           if live is None or live.rank == 0 else lambda *a: None)
    start = 0
    if args.ckpt_dir and CK.latest_step(args.ckpt_dir) is not None:
        start = ST.restore_state(args.ckpt_dir, params, opt_state)
        say(f"resumed from step {start}")

    step_fn = ST.make_train_step(cfg, opt)
    clock = _StepClock(dev)
    metrics: List[Dict[str, float]] = []
    durations: List[float] = []
    for step in range(start, args.steps):
        clock.start()
        batch = synth_batch_for(cfg, data, step, device=dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        ms = clock.stop_ms()
        metrics.append({k: float(v) for k, v in m.items()})
        durations.append(ms)
        med = float(np.median(durations[-WATCHDOG_WINDOW:]))
        if ms > WATCHDOG_FACTOR * med and len(durations) > 5:
            say(f"[watchdog] step {step} straggled: {ms / 1e3:.2f}s "
                f"vs median {med / 1e3:.2f}s")
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {metrics[-1]['loss']:.4f} "
                f"gnorm {metrics[-1]['grad_norm']:.3f} "
                f"lr {metrics[-1]['lr']:.2e} {ms:.0f}ms")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(args.ckpt_dir, step + 1, cfg, params, opt_state, live)
    if args.ckpt_dir:
        _save(args.ckpt_dir, args.steps, cfg, params, opt_state, live)
    say("done")
    return TrainRun(cfg=cfg, opt=opt, data=data, params=params,
                    opt_state=opt_state, start=start, metrics=metrics,
                    step_ms=durations)


if __name__ == "__main__":
    main()
