"""Driver of the SBBNNLS cells: the port's engines solving back to back.

A traffic file of this driver names the engine (``life``:
``repro_torch.core.life.LifeEngine``, one subject; ``batched``:
``repro_torch.core.batched.BatchedLifeEngine``, a cohort), its executor
and format, the subjects, the iterations of one solve, how many
iterations one ``step`` call advances, the warm-up and traced
iterations, and how many subjects the check samples.  Every solve starts
from the engine's initial state; the window steps solve after solve
through ``engine.step`` until its time is up.

This module is the one that imports the port: the system under test is
its engines, built from the benchmark's tensors.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict

import torch

from life_bench import gen

SRC = Path(__file__).resolve().parents[2] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.core.batched import BatchedLifeEngine  # noqa: E402
from repro_torch.core.life import LifeConfig, LifeEngine  # noqa: E402
from repro_torch.core.std import PhiTensor  # noqa: E402
from repro_torch.data.dmri import LifeProblem  # noqa: E402

#: LifeConfig fields a traffic file may set (the rest are fixed below)
_ENGINE_FIELDS = ("executor", "format")
#: iterations after which the judged solve's weights are kept
EARLY_ITERS = 10
#: the engines' SpMV attributes, wrapped in ranges in the traced stretch
_OPS = {"life": ("matvec", "rmatvec"), "batched": ("_matvec", "_rmatvec")}


def problem(sub: dict, dictionary: torch.Tensor, config: dict) -> LifeProblem:
    """One subject as the port's ``LifeProblem`` (the same tensors, no
    copy)."""
    gx, gy, gz = config["grid"]
    phi = PhiTensor(atoms=sub["atoms"], voxels=sub["voxels"],
                    fibers=sub["fibers"], values=sub["values"],
                    n_atoms=config["n_atoms"], n_voxels=gx * gy * gz,
                    n_fibers=config["n_fibers"])
    return LifeProblem(phi=phi, dictionary=dictionary, b=sub["b"],
                       w_true=sub["w_true"], stats={}, grid=(gx, gy, gz))


def make_data(config: dict, traffic: dict, seed: int,
              device: torch.device) -> dict:
    """The subjects' tensors, made on ``device``: slot ``s`` drawn from
    seed ``seed + s``, all sharing one dictionary."""
    d = gen.make_dictionary(config["n_atoms"], config["n_theta"], device)
    subjects = [gen.subject(config, seed + s, d, s)
                for s in range(traffic["subjects"])]
    return dict(dictionary=d, subjects=subjects)


class Solver:
    """The engine under test, driven as the traffic file says."""

    def __init__(self, data: dict, config: dict, traffic: dict,
                 overrides: Dict[str, object]):
        self.traffic = traffic
        self.kind = traffic["engine"]
        fields = {k: traffic[k] for k in _ENGINE_FIELDS}
        fields["compute_dtype"] = config["dtype"]
        fields.update(overrides)
        # compaction, tuning, the learned predictor and the plan cache
        # off: every run pays the same set-up and writes nothing
        cfg = LifeConfig(compact_every=0, tune="off", predict="off",
                         plan_cache_dir="", **fields)
        d = data["dictionary"]
        problems = [problem(s, d, config) for s in data["subjects"]]
        if self.kind == "life":
            self.engine = LifeEngine(problems[0], cfg, device=d.device)
        elif self.kind == "batched":
            self.engine = BatchedLifeEngine(problems, cfg, device=d.device)
        else:
            raise ValueError(f"unknown engine {self.kind!r}")
        self.subjects = traffic["subjects"]

    def init(self):
        if self.kind == "life":
            return self.engine.init_state()
        return self.engine.init_states()

    def step(self, state, k: int):
        return self.engine.step(state, k)

    def ops(self):
        """(DSC, WC) as the engine calls them."""
        a, b = _OPS[self.kind]
        return getattr(self.engine, a), getattr(self.engine, b)

    def set_ops(self, dsc, wc) -> None:
        a, b = _OPS[self.kind]
        setattr(self.engine, a, dsc)
        setattr(self.engine, b, wc)

    def warm(self) -> None:
        self.step(self.init(), self.traffic["warmup_iters"])

    def window(self, seconds: float, sync) -> dict:
        """Solve back to back for ``seconds``; the window ends in a
        synchronise.  Keeps the last completed solve (or the one in
        progress when none completed) and every completed solve's final
        losses."""
        solve_iters = self.traffic["solve_iters"]
        early_iters = EARLY_ITERS
        chunk = self.traffic["chunk_iters"]
        state, losses, done, early = self.init(), [], 0, None
        last, finals, iters = None, [], 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            k = min(chunk, solve_iters - done,
                    early_iters - done if done < early_iters else chunk)
            state, ls = self.step(state, k)
            losses.append(ls)
            done += k
            iters += k
            if done == early_iters:
                early = state.w
            if done == solve_iters:
                last = (state, losses, done, early)
                finals.append(ls[..., -1])
                state, losses, done, early = self.init(), [], 0, None
            if time.perf_counter() >= deadline:
                break
        sync()
        elapsed = time.perf_counter() - t0
        if last is None:
            last = (state, losses, done, early)
        state, losses, done, early = last
        return dict(elapsed=elapsed, iters=iters,
                    subject_iters=iters * self.subjects, w=state.w,
                    w_early=early, losses=torch.cat(losses, dim=-1),
                    judged_iters=done, early_iters=early_iters,
                    solve_iters=solve_iters,
                    finals=(torch.stack(finals, dim=-1) if finals else None))

    def outputs(self, data: dict) -> dict:
        """The executor's DSC of ``w_true`` and WC of ``b`` at the timed
        sizes, for every subject."""
        dsc, wc = self.ops()
        subs = data["subjects"]
        if self.kind == "life":
            y = dsc(subs[0]["w_true"])[None]
            g = wc(subs[0]["b"])[None]
        else:
            y = dsc(torch.stack([s["w_true"] for s in subs]))
            g = wc(torch.stack([s["b"] for s in subs]))
        return dict(y=y, g=g)
