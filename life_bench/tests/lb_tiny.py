"""Cells of the benchmark at a size the CPU tests hold: each real cell's
traffic, limits and metrics over a tiny configuration of its own
tractography."""
from __future__ import annotations

import copy

import torch

from life_bench import run

#: the box, fibers and atoms of the tiny stand-ins; the rest (Ntheta
#: aside) is each configuration's own
TINY = dict(n_theta=8, n_atoms=16, n_fibers=300, grid=[10, 10, 10],
            step=0.75, mean_len=8, len_jitter=3)


def cell(name: str, *, subjects: int = 4) -> dict:
    """``run.load_cell(name)`` cut to the tiny size: a 20-iteration solve,
    a cohort of ``subjects``, a 4-iteration traced stretch.  One thread:
    the window is timed, and several test processes sharing the cores,
    each with a thread a core, would leave a tiny window too few
    iterations to judge."""
    torch.set_num_threads(1)
    files = copy.deepcopy(run.load_cell(name))
    files["config"].update(TINY)
    tr = files["traffic"]
    tr.update(solve_iters=20, trace_iters=4)
    if tr["subjects"] > 1:
        tr.update(subjects=subjects)
        # on the CPU a cohort's dots are one torch.bmm each
        # (core/sbbnnls.py:_dots), whose float32 sums over Nv x Ntheta
        # terms run 4e-06 to 1e-05 off, where the card's cuBLAS dots
        # run 1.4e-07 off at the cell's size: the tiny cohort's losses are
        # held to the CPU's sums
        files["limits"]["loss_l2"] = 1e-4
    return files
