"""Serving driver: batched prefill + greedy decode with a static KV budget
(torch counterpart of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi3.5-moe-42b-a6.6b --reduced --batch 4 --prompt-len 16 \
      --gen 16 --device cpu

Without ``--device`` it runs on the CUDA card and raises without one.
``--model-axis M`` builds and activates the reference's host mesh
``(world // M, M)`` (``launch/mesh.py``); in a process group (``torchrun``
or :func:`repro_torch.distributed.spmd.launch`) the model is placed by the
sharding rules, each data rank generates for its rows of the batch, and
rank 0 prints the whole batch's tokens.  Without ``--model-axis`` (and
outside a group) no mesh is active, where the reference activates a
``(1, 1)`` one.  Beyond the reference's flags, ``--device``,
``--backend`` and ``--layers`` (a depth cut) as the trainer's.

Prompts are token ids, so the audio and vlm families are refused: their
decoders read frame embeddings, or image embeddings with (3, B, S) M-RoPE
positions, which no prompt format of the CLI carries (the reference's CLI
fails on them with a ``KeyError``).  Serve them through
``launch.steps.make_prefill`` / ``make_serve_step`` with their own
batches.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.distributed import hints, lm_shard, spmd
from repro_torch.launch import mesh as HM
from repro_torch.launch.steps import (init_placed, make_prefill,
                                     make_serve_step)
from repro_torch.models import transformer as T


def pad_cache(cache: Dict[str, torch.Tensor], s_max: int) -> Dict:
    """The prefill's ``k``/``v`` of shape (L, B, S, KV, hd), zero-padded
    along S to ``s_max`` positions; an ssm or hybrid cache's ``ssm`` and
    ``conv`` states are left as they are."""
    for kn in ("k", "v"):
        if kn in cache:
            kv = cache[kn]
            cache[kn] = torch.nn.functional.pad(
                kv, (0, 0, 0, 0, 0, s_max - kv.shape[2]))
    return cache


def generate(cfg, params, prompts: torch.Tensor, n_gen: int, *,
             forced: Optional[torch.Tensor] = None,
             s_max: Optional[int] = None,
             ) -> Tuple[torch.Tensor, List[torch.Tensor], Dict[str, float]]:
    """Greedy generation of ``n_gen`` tokens after ``prompts`` (B, P):
    one prefill, then ``n_gen - 1`` decode steps.

    ``forced`` (B, n_gen): feed these tokens to the next step instead of
    the chosen ones (teacher forcing, to hold two runs step by step).
    ``s_max``: the KV cache's positions (the static budget every decode
    step attends over, as the reference's decode masks over it; at least
    ``P + n_gen``, the default; rounded up to a multiple of the ``model``
    axis where the cache splits the sequence over it).
    Returns (the argmax tokens (B, n_gen) int32, each step's last-position
    logits (B, V; on a tensor-parallel mesh this rank's block of V), and
    the seconds of the prefill and of all decode steps, each ending in a
    device synchronisation).  The pick is ``hints.vocab_argmax``: the
    lowest id wins a tie, as ``jnp.argmax``'s."""
    prefill_step, serve_step = make_prefill(cfg), make_serve_step(cfg)
    batch, prompt_len = prompts.shape
    sync = (torch.cuda.synchronize if prompts.device.type == "cuda"
            else lambda: None)

    def pick(logits, i):
        tok = hints.vocab_argmax(logits[:, -1], cfg.vocab_size).to(
            torch.int32)[:, None]
        feed = tok if forced is None else forced[:, i:i + 1]
        return tok, feed

    sync()
    t0 = time.perf_counter()
    positions = T.cache_positions(cfg, max(prompt_len + n_gen, s_max or 0))
    logits, cache = prefill_step(params, {"tokens": prompts},
                                 s_max=positions)
    tok, feed = pick(logits, 0)
    sync()
    seconds = {"prefill": time.perf_counter() - t0}
    tokens, step_logits = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(1, n_gen):
        logits, cache = serve_step(params, dict(
            tokens=feed, cache=cache, cache_index=prompt_len + i - 1))
        cache.pop("index")
        tok, feed = pick(logits, i)
        tokens.append(tok)
        step_logits.append(logits[:, -1])
    sync()
    seconds["decode"] = time.perf_counter() - t0
    return torch.cat(tokens, dim=1), step_logits, seconds


def main(argv=None, *, mesh=None) -> torch.Tensor:
    """Serve one batch; returns the generated tokens (B, gen), the whole
    batch's on every rank.  ``mesh``: activate this mesh instead of
    building one from ``--model-axis``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3.5-moe-42b-a6.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--model-axis", type=int, default=None,
                    help="the mesh's model axis (default: no mesh on one "
                         "process, 1 in a process group)")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, ... (default: the CUDA card)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep this many layers (a depth cut, for a model "
                         "whose weights do not fit the card; 0: all)")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend when the environment "
                         "names a group (default: nccl on the card, gloo on "
                         "the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    joined = spmd.join_process_group(args.backend, dev)
    try:
        return _serve(args, dev, mesh)
    finally:
        hints.deactivate()
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(args, dev: torch.device, mesh) -> torch.Tensor:
    if mesh is None and (args.model_axis is not None
                         or HM.world_size() > 1):
        mesh = HM.make_host_mesh(args.model_axis or 1, dev)
    if mesh is not None:
        hints.activate(mesh)
    live = mesh if getattr(mesh, "live", False) else None
    cfg = get_config(args.arch)
    if cfg.family in ("audio", "vlm"):
        what = ("frame embeddings" if cfg.family == "audio" else
                "image embeddings and (3, B, S) M-RoPE positions")
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family reads {what}, which token "
            "prompts do not carry; serve it through launch.steps."
            "make_prefill / make_serve_step with its own batches")
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    g = torch.Generator(device=dev).manual_seed(0)
    params = (T.init_params(cfg, g, dev) if live is None
              else init_placed(cfg, live, g, dev))
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    if live is not None:
        prompts = lm_shard.sharded(params).shard_batch(
            {"tokens": prompts})["tokens"]
    gen, _, seconds = generate(cfg, params, prompts, args.gen)
    if live is not None:
        gen = live.all_gather(gen, "data", 0)
        if live.rank:
            return gen

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tput = args.batch * (args.gen - 1) / max(seconds["decode"], 1e-9)
    print(f"device: {name}")
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{seconds['prefill'] * 1e3:.1f}ms")
    print(f"decode: {seconds['decode'] * 1e3:.1f}ms total, {tput:.1f} tok/s")
    print("generated tokens (first row):", gen[0].tolist())
    return gen


if __name__ == "__main__":
    main()
