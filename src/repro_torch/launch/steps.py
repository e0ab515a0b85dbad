"""Serve-step builders (torch counterpart of ``repro/launch/steps.py``).

``make_prefill(cfg)`` returns the prefill and ``make_serve_step(cfg)`` the
one-token decode step, both ``(params, batch) -> (logits, cache)``.  The
train and eval steps wait for the training slice (ROADMAP A15).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def make_prefill(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch)
    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, batch):
        return T.decode_step(cfg, params, batch)
    return serve_step
