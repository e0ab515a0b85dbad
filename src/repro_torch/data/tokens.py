"""Deterministic synthetic token pipeline: stateless and resumable (torch
counterpart of ``repro/data/tokens.py``).

Every batch is a pure function of ``(seed, step)``, drawn with JAX's
default generator (:mod:`repro_torch.core.prng`), so a batch here is the
reference's batch for the same ``(seed, step)``, and a restart resumes the
exact data order from the checkpointed step (the cursor is the step).

Tokens follow a Zipf-ish marginal with short-range repetition so losses
move; this is a load generator, not a corpus.  :func:`synth_tokens` and
:func:`synth_batch_for` draw on a torch device (the CUDA card unless the
caller asks for another).  The audio and vlm families' stub frontends
take embeddings drawn from a normal distribution (``frame_embeds``,
``image_embeds``) and the audio codebooks' targets uniform integers
(``codes``), as the reference draws them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 1024
    global_batch: int = 8


#: share of positions that repeat the token three places back
REPEAT_P = 0.25
REPEAT_LAG = 3


def _row_keys(cfg: DataConfig, step: int,
              batch_slice: slice | None) -> List[np.ndarray]:
    key = prng.fold_in(prng.prng_key(cfg.seed), step)
    b0, b1 = (0, cfg.global_batch) if batch_slice is None else (
        batch_slice.start, batch_slice.stop)
    return [prng.fold_in(key, b) for b in range(b0, b1)]


def _split(seq) -> Dict:
    """``labels[t] = tokens[t + 1]``."""
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def synth_tokens(cfg: DataConfig, vocab: int, step: int, *,
                 batch_slice: slice | None = None,
                 device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The global (or host-sliced) batch for ``step`` as int32 tensors on
    ``device`` (the CUDA card by default), drawn there one row at a time."""
    dev = resolve_device(device)
    logits = -torch.log1p(torch.arange(vocab, dtype=torch.float32,
                                       device=dev))
    n = cfg.seq_len + 1
    rows = []
    for kb in _row_keys(cfg, step, batch_slice):
        base = prng.categorical(kb, logits, (n,))
        mix = prng.bernoulli(prng.fold_in(kb, 1), REPEAT_P, (n,), dev)
        rows.append(torch.where(mix, torch.roll(base, REPEAT_LAG), base))
    return _split(torch.stack(rows).to(torch.int32))


def synth_batch_for(cfg: ArchConfig, data: DataConfig, step: int, *,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The training batch of ``cfg``'s family for ``step`` on ``device``
    (the layout of ``configs.base.input_specs``' train batch):

      text   ``tokens``, ``labels`` (B, S) int32;
      audio  ``frame_embeds`` (B, S, d) in the config's dtype and
             ``codes`` (B, S, C) int32 in [0, V);
      vlm    ``image_embeds`` (B, Vt, d), ``tokens`` (B, S - Vt) and
             ``labels`` (B, S) (-1 over the image), ``positions``
             (3, B, S) int32 (0..S-1 on every axis), with ``Vt =
             min(vision_tokens, S // 2)``; the tokens are the text batch
             of step ``step``, the image is drawn under step ``step + 1``.
    """
    dev = resolve_device(device)
    if cfg.family == "audio":
        key = prng.fold_in(prng.prng_key(data.seed), step)
        B, S = data.global_batch, data.seq_len
        emb = prng.normal_torch(key, (B, S, cfg.d_model), dev)
        codes = prng.randint(prng.fold_in(key, 1), (B, S, cfg.n_codebooks),
                             0, cfg.vocab_size, dev)
        return {"frame_embeds": emb.to(cfg.torch_dtype), "codes": codes}
    if cfg.family == "vlm":
        B, S = data.global_batch, data.seq_len
        vt = min(cfg.vision_tokens, S // 2)
        base = synth_tokens(dataclasses.replace(data, seq_len=S - vt),
                            cfg.vocab_size, step, device=dev)
        key = prng.fold_in(prng.prng_key(data.seed), step + 1)
        img = prng.normal_torch(key, (B, vt, cfg.d_model), dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(3, B, S)
        labels = torch.cat([torch.full((B, vt), -1, dtype=torch.int32,
                                       device=dev), base["labels"]], dim=1)
        return {"tokens": base["tokens"],
                "image_embeds": img.to(cfg.torch_dtype),
                "positions": pos.contiguous(), "labels": labels}
    return synth_tokens(data, cfg.vocab_size, step, device=dev)

