"""Distributed LiFE: the paper's workload on a 2-D device mesh (torch
counterpart of ``examples/distributed_life.py``).

    PYTHONPATH=src python -m repro_torch.examples.distributed_life

Runs the 2-D (voxel x fiber) partition of SBBNNLS on a (4, 2) mesh and
checks it against the single-device engine.  Where the device admits a
local mesh of 8 cells (the CPU, or a host with 8 cards) the cells run in
this process (``distributed/mesh.py:LocalMesh``).  One card admits only
(1, 1), so there the 8 cells run as 8 ranks on that card, each a fresh
interpreter joined by gloo over CUDA tensors (NCCL refuses two ranks on
one GPU): the partition's rank files are written once and
``distributed/spmd.py`` runs the same step on each rank's cell.
"""
from __future__ import annotations

import tempfile
import time
from typing import Tuple

import numpy as np

from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.data.dmri import synth_connectome
from repro_torch.device import DeviceLike
from repro_torch.distributed import life_shard as LS
from repro_torch.distributed import spmd
from repro_torch.distributed.mesh import AXES, LocalMesh, max_cells
from repro_torch.examples import parser, start

#: the mesh's (data, model) shape
MESH = (4, 2)
#: seconds the ranks on one card have to start, run and write their
#: outputs
RANK_DEADLINE_S = 300.0


def _local(problem, shards, R: int, C: int, n_iters: int, device):
    """The step on a LocalMesh in this process: (padded w, losses)."""
    mesh = LocalMesh(R, C, device)
    step = LS.make_sharded_step(mesh, shards.meta)
    args = LS.sharded_state(mesh, shards, problem)
    w, losses = args["w"], []
    for it in range(n_iters):
        w, loss = step(args["dsc"], args["wc"], args["b"], w, it)
        losses.append(float(loss))
    return np.concatenate([w[c].cpu().numpy() for c in range(C)]), losses


def _ranks(problem, shards, R: int, C: int, n_iters: int, device):
    """The step on R * C gloo ranks on ``device``: (padded w, losses)."""
    dev = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as d:
        sizes = spmd.write_inputs(d, problem, shards)
        outs = spmd.run(d, sizes, programs=("step2d",),
                        iters={"step2d": n_iters}, backend="gloo",
                        devices=[dev] * (R * C), deadline_s=RANK_DEADLINE_S)
    # ranks 0..C-1 hold mesh row 0: one block of w per column
    w = np.concatenate([outs[c]["step2d_w"] for c in range(C)])
    return w, [float(x) for x in outs[0]["step2d_losses"]]


def run(*, n_fibers: int = 512, n_theta: int = 96, n_atoms: int = 96,
        grid: Tuple[int, int, int] = (16, 16, 16), n_iters: int = 50,
        device: DeviceLike = None) -> dict:
    """The partitioned solve against ``LifeEngine(opt)``; returns both
    weights (``w``, ``w_ref``, host arrays), the ``losses``, the max
    abs difference ``err`` and how the cells ran (``cells``)."""
    dev = start(device)
    problem = synth_connectome(n_fibers=n_fibers, n_theta=n_theta,
                               n_atoms=n_atoms, grid=grid, algorithm="PROB",
                               seed=0, device=dev)
    R, C = MESH
    local = max_cells(dev) >= R * C
    cells = (f"{R * C} cells of a LocalMesh on {dev}" if local else
             f"{R * C} gloo ranks on {dev} (a local mesh on {dev} admits "
             f"at most {max_cells(dev)}; each rank is a process of its own)")
    print(f"mesh: {dict(zip(AXES, (R, C)))} over {cells}")

    t0 = time.time()
    shards = LS.build_life_shards(problem.phi, n_theta, R=R, C=C)
    print(f"inspector: 2-D partition in {time.time()-t0:.2f}s - "
          f"{R}x{C} cells, <= {shards.dsc_values.shape[-1]} nnz/cell "
          f"(equal-nnz, sub-vector-snapped)")

    w_pad, losses = (_local if local else _ranks)(problem, shards, R, C,
                                                  n_iters, dev)
    for it in range(0, n_iters, 10):
        print(f"  iter {it:3d} loss {losses[it]:.4f}")
    w_full = LS.unshard_w(shards, w_pad)

    eng = LifeEngine(problem, LifeConfig(executor="opt", n_iters=n_iters),
                     device=dev)
    w_ref, _ = eng.run()
    w_ref = w_ref.cpu().numpy()
    err = float(np.abs(w_full - w_ref).max())
    print(f"distributed vs single-device max |dw|: {err:.2e}")
    assert err < 1e-2
    print("OK - 2-D mesh partition reproduces the single-device solution")
    return dict(w=w_full, w_ref=w_ref, losses=losses, err=err, cells=cells)


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
