"""The example programs (torch counterparts of ``examples/*.py``), each an
entry point of the port:

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.serve_subjects [n_subjects]
  PYTHONPATH=src python -m repro_torch.examples.serve_life [n_subjects]
  PYTHONPATH=src python -m repro_torch.examples.serve_async [n_subjects]
  PYTHONPATH=src python -m repro_torch.examples.prune_connectome [n_fibers]
  PYTHONPATH=src python -m repro_torch.examples.distributed_life
  PYTHONPATH=src python -m repro_torch.examples.serve_lm
  PYTHONPATH=src python -m repro_torch.examples.train_lm [--small] ...

Each keeps the reference example's steps, printed story and assertions.
``run(...)`` takes the example's sizes as keywords (their defaults are the
reference's constants) and returns what the example computes;
``main(argv)`` takes the reference's arguments plus ``--device``.  Without
``--device`` an example runs on the CUDA card and raises without one; its
first output line names the device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import DeviceLike, resolve_device


def start(device: DeviceLike) -> torch.device:
    """Resolve the example's device and print it (on CUDA with the card's
    name) as the example's first output line."""
    dev = resolve_device(device)
    name = (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
            else "")
    print(f"device: {dev}{name}", flush=True)
    return dev


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the port's ``--device`` flag."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, ... (default: the CUDA card)")
    return ap

