"""SPMD runs of the mesh partition: one process per cell under
``torch.distributed``.

The parent builds the partition once and writes each rank's operands to
``<dir>/rank<k>.npz`` (:func:`write_inputs`), so a rank loads only its own
cell; :func:`run` then starts ``R * C`` fresh interpreters (``python -m
repro_torch.distributed.spmd``: nothing of the parent's state, its CUDA
context included, is inherited, as under the ``spawn`` start method).
Each rank joins the process group at ``tcp://localhost:<free port>`` with
a timeout, builds a :class:`~repro_torch.distributed.mesh.ProcessGroupMesh`
and runs the programs the spec names, in order:

  ``step2d``    :func:`~repro_torch.distributed.life_shard.make_sharded_step`
                for ``iters["step2d"]`` iterations from the given ``w``
  ``step1d``    :func:`~repro_torch.distributed.life_shard.make_sharded_step_1d`
                over the 1-D blocks, whole ``b`` and ``w``
  ``sell_ops``  :func:`~repro_torch.distributed.life_shard.make_sharded_sell_ops`
                once each on probe vectors (kernels B3/B4 on the rank's
                cell on the card)

and writes ``<dir>/out<k>.npz``: each program's results, its seconds
(from a barrier before to a barrier after, the device synchronized) and
the collectives the mesh recorded.  :func:`run` waits for every rank
against one deadline, kills what is left past it, and raises if a rank
failed, so a hung rank fails the caller instead of stalling it.

Backends: gloo on the CPU, and gloo over CUDA tensors for several ranks
on one card (NCCL refuses two ranks on one GPU); NCCL with one rank per
card.

:func:`launch` starts any entry point that way (the LM trainer, the
cohort's CLI) with ``torchrun``'s environment, which
:func:`join_process_group` reads.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed import life_shard as LS

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def write_inputs(directory: str, problem, shards: LS.LifeShards, *,
                 w0: Optional[np.ndarray] = None, sell=None,
                 blocks_1d: Optional[Dict[str, np.ndarray]] = None,
                 probes=None) -> dict:
    """Write the rank files of one partition; returns the spec's problem
    part (sizes) for :func:`run`.

    ``shards`` gives the 2-D cells, ``b`` and ``w`` blocks (``w0``
    defaults to ones); ``sell`` an encode pair ``(dsc, wc)`` of sell
    ShardPhis on the same plan; ``blocks_1d`` the 1-D blocks
    (:func:`~repro_torch.distributed.life_shard.build_life_shards_1d`);
    ``probes`` ``(w, Y)`` for ``sell_ops``, whole (``(Nf,)``,
    ``(Nv, Ntheta)``).
    """
    from repro_torch.bridge import to_numpy
    os.makedirs(directory, exist_ok=True)
    R, C = shards.R, shards.C
    nv_l, nf_l = shards.nv_local, shards.nf_local
    nf = problem.phi.n_fibers
    w0 = np.ones(nf, np.float32) if w0 is None else np.asarray(w0)
    b = to_numpy(problem.b)
    b_pad, w_pad = LS.shard_b(shards, b), LS.shard_w(shards, w0)
    if probes is not None:
        pw = LS.shard_w(shards, np.asarray(probes[0]))
        py = LS.shard_b(shards, np.asarray(probes[1]))
    common = dict(d=to_numpy(problem.dictionary))
    if blocks_1d is not None:
        common.update(b=b, w0=w0)
    np.savez(os.path.join(directory, "common.npz"), **common)
    for r in range(R):
        for c in range(C):
            own = dict(b=b_pad[r * nv_l:(r + 1) * nv_l],
                       w=w_pad[c * nf_l:(c + 1) * nf_l])
            for op in ("dsc", "wc"):
                for k, a in LS.op_arrays(shards, op).items():
                    own[f"{op}_{k}"] = a[r, c]
            if sell is not None:
                for op, sp in zip(("dsc", "wc"), sell):
                    for k, a in sp.arrays.items():
                        own[f"s{op}_{k}"] = a[r, c]
            if probes is not None:
                own.update(pw=pw[c * nf_l:(c + 1) * nf_l],
                           py=py[r * nv_l:(r + 1) * nv_l])
            if blocks_1d is not None:
                for k, a in blocks_1d.items():
                    own[f"b1_{k}"] = a[r * C + c]
            np.savez(os.path.join(directory, f"rank{r * C + c}.npz"), **own)
    return dict(R=R, C=C, n_atoms=problem.phi.n_atoms,
                n_voxels=problem.phi.n_voxels, n_fibers=nf,
                nv_local=nv_l, nf_local=nf_l, n_theta=shards.n_theta,
                row_tile=0 if sell is None else sell[0].row_tile)


def run(directory: str, sizes: dict, *, programs: Sequence[str],
        iters: Dict[str, int], backend: str, devices: Sequence[str],
        deadline_s: float, init_timeout_s: float = 120.0) -> List[dict]:
    """Run ``programs`` on ``R * C`` ranks over the files
    :func:`write_inputs` wrote; returns each rank's outputs (rank order).

    ``devices[k]`` is rank ``k``'s device ("cpu", "cuda:0", ...).

    Raises:
        TimeoutError: a rank was still running at ``deadline_s`` (every
            rank is then killed).
        RuntimeError: a rank exited non-zero (its stderr's tail is in the
            message).
    """
    world = sizes["R"] * sizes["C"]
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, "
                         f"got {len(devices)}")
    spec = dict(sizes, programs=list(programs), iters=dict(iters),
                backend=backend, devices=list(devices), port=free_port(),
                timeout=init_timeout_s, directory=directory)
    spec_path = os.path.join(directory, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = []
    logs = []
    try:
        for k in range(world):
            log = open(os.path.join(directory, f"rank{k}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.distributed.spmd",
                 spec_path, str(k)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
        end = time.monotonic() + deadline_s
        for p in procs:
            p.wait(timeout=max(0.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"{world} ranks still running after "
                           f"{deadline_s:.0f} s; killed ({directory})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [k for k, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for k in failed:
            with open(os.path.join(directory, f"rank{k}.log")) as f:
                tails.append(f"rank {k} (exit {procs[k].returncode}):\n"
                             + f.read()[-3000:])
        raise RuntimeError("SPMD ranks failed:\n" + "\n".join(tails))
    out = []
    for k in range(world):
        with np.load(os.path.join(directory, f"out{k}.npz")) as z:
            out.append({name: z[name] for name in z.files})
    return out


def launch(argv: Sequence[str], world: int, directory: str, *,
           deadline_s: float, env: Optional[Dict[str, str]] = None
           ) -> List[str]:
    """Start ``world`` ranks of ``python <argv>`` (each a fresh
    interpreter, as ``torchrun`` starts them: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR=localhost`` and a free ``MASTER_PORT``
    in the environment, so :func:`join_process_group` finds the group)
    and wait for all of them against one deadline; returns each rank's
    output (``<directory>/rank<k>.log``, stdout and stderr), rank order.

    Raises:
        TimeoutError: a rank was still running at ``deadline_s`` (every
            rank is then killed).
        RuntimeError: a rank exited non-zero (its log's tail is in the
            message).
    """
    os.makedirs(directory, exist_ok=True)
    port = free_port()
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), MASTER_ADDR="localhost",
        MASTER_PORT=str(port), WORLD_SIZE=str(world), **(env or {}))
    procs, logs, paths = [], [], []
    try:
        for k in range(world):
            paths.append(os.path.join(directory, f"rank{k}.log"))
            log = open(paths[-1], "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT,
                env=dict(base, RANK=str(k), LOCAL_RANK=str(k))))
        end = time.monotonic() + deadline_s
        for p in procs:
            p.wait(timeout=max(0.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"{world} ranks of {list(argv)} still running "
                           f"after {deadline_s:.0f} s; killed ({directory})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    texts = []
    for path in paths:
        with open(path) as f:
            texts.append(f.read())
    failed = [k for k, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("SPMD ranks failed:\n" + "\n".join(
            f"rank {k} (exit {procs[k].returncode}):\n{texts[k][-3000:]}"
            for k in failed))
    return texts


def join_process_group(backend: Optional[str], device: torch.device,
                       timeout_s: float = 300.0) -> bool:
    """Join the process group the environment describes (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as :func:`launch` and
    ``torchrun`` set them) unless one is joined already or the
    environment names none.  ``backend`` defaults to nccl on a CUDA
    device and gloo on the CPU; several ranks on one card need gloo
    (NCCL refuses two ranks on one GPU).  Returns whether it joined (the
    caller then destroys the group)."""
    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://",
                            timeout=timedelta(seconds=timeout_s))
    return True


# ----------------------------------------------------------------------------
# one rank
# ----------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_main(spec_path: str, rank: int) -> None:
    import torch.distributed as dist
    from repro_torch.distributed.mesh import ProcessGroupMesh
    with open(spec_path) as f:
        spec = json.load(f)
    R, C = spec["R"], spec["C"]
    dev = torch.device(spec["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        spec["backend"], init_method=f"tcp://localhost:{spec['port']}",
        world_size=R * C, rank=rank,
        timeout=timedelta(seconds=spec["timeout"]))
    try:
        mesh = ProcessGroupMesh(R, C, device=dev)
        out = _programs(spec, mesh, dev)
        out["staged"] = np.asarray(mesh.staged)
        np.savez(os.path.join(spec["directory"], f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _programs(spec: dict, mesh, dev: torch.device) -> dict:
    import torch.distributed as dist
    from repro_torch.kernels import _build
    directory = spec["directory"]
    rc = (mesh.r, mesh.c)
    own = dict(np.load(os.path.join(directory, f"rank{mesh.rank}.npz")))
    common = dict(np.load(os.path.join(directory, "common.npz")))
    d = torch.as_tensor(common["d"], device=dev)
    meta = dict(nv_local=spec["nv_local"], nf_local=spec["nf_local"],
                n_theta=spec["n_theta"])

    def mine(prefix: str) -> dict:
        return {rc: {k[len(prefix):]: a for k, a in own.items()
                     if k.startswith(prefix)}}

    def up(a) -> torch.Tensor:
        return torch.as_tensor(a, device=dev)

    out: dict = {}
    for prog in spec["programs"]:
        n = spec["iters"].get(prog, 1)
        if prog == "step2d":
            kw = dict(n_atoms=spec["n_atoms"], nv_local=spec["nv_local"],
                      nf_local=spec["nf_local"], dictionary=d)
            cd = LS.coo_cells(mesh, mine("dsc_"), "dsc", **kw)
            cw = LS.coo_cells(mesh, mine("wc_"), "wc", **kw)
            b, w = {mesh.r: up(own["b"])}, {mesh.c: up(own["w"])}
            step = LS.make_sharded_step(mesh, meta)

            def body(it, state):
                return step(cd, cw, b, state, it)
            state = w
        elif prog == "step1d":
            cells = LS.coo_cells(
                mesh, mine("b1_"), "dsc", n_atoms=spec["n_atoms"],
                nv_local=spec["n_voxels"], nf_local=spec["n_fibers"],
                dictionary=d)
            b1 = up(common["b"])
            step1 = LS.make_sharded_step_1d(mesh, meta)

            def body(it, state):
                return step1(cells, b1, state, it)
            state = up(common["w0"])
        elif prog == "sell_ops":
            kw = dict(row_tile=spec["row_tile"], dictionary=d)
            sd = LS.sell_cells(mesh, mine("sdsc_"), **kw)
            sw = LS.sell_cells(mesh, mine("swc_"), **kw)
            dsc_fn, wc_fn = LS.make_sharded_sell_ops(mesh, meta)
            pw, py = {mesh.c: up(own["pw"])}, {mesh.r: up(own["py"])}

            def body(it, state):
                return (dsc_fn(sd, pw)[mesh.r].clone(),
                        wc_fn(sw, py)[mesh.c].clone()), None
            state = None
        else:
            raise ValueError(f"unknown SPMD program {prog!r}")
        _build.reset_launches()
        _sync(dev)
        dist.barrier()
        mesh.collectives.clear()
        losses = []
        t0 = time.perf_counter()
        for it in range(n):
            state, loss = body(it, state)
            losses.append(loss)
        _sync(dev)
        dist.barrier()
        out[f"{prog}_seconds"] = np.asarray(time.perf_counter() - t0)
        out[f"{prog}_launches"] = np.asarray(
            [_build.LAUNCHES.get("dsc_sell", 0),
             _build.LAUNCHES.get("wc_sell", 0)])
        out[f"{prog}_coll_bytes"] = np.asarray(
            [b for _, b, _ in mesh.collectives], np.int64)
        out[f"{prog}_coll_groups"] = np.asarray(
            [g for _, _, g in mesh.collectives], np.int64)
        if prog == "step2d":
            out["step2d_w"] = state[mesh.c].cpu().numpy()
            out["step2d_losses"] = torch.stack(losses).cpu().numpy()
        elif prog == "step1d":
            out["step1d_w"] = state.cpu().numpy()
            out["step1d_losses"] = torch.stack(losses).cpu().numpy()
        else:
            out["sell_ops_y"] = state[0].cpu().numpy()
            out["sell_ops_w"] = state[1].cpu().numpy()
    return out


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
