"""A run with its timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size, once for each fault the cells can have."""
import json

import pytest
import torch

from life_bench import run
from life_bench.tests import lb_tiny

CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]
CPU = torch.device("cpu")


def _run(name, patch=None, seconds=0.3):
    return run.run_cell(lb_tiny.cell(name), 2 ** 31 + 3, seconds, False, CPU,
                        patch=patch)


def _unchanged(solver):
    """A step that returns its state unchanged."""
    step = solver.step

    def stuck(state, k):
        _, losses = step(state, k)
        return state, losses
    solver.step = stuck


def _half_batch(solver):
    """Half of the cohort left out: the other half's weights never move."""
    step = solver.step

    def half(state, k):
        new, losses = step(state, k)
        keep = state.w.shape[0] // 2
        w = new.w.clone()
        w[keep:] = state.w[keep:]
        return new._replace(w=w), losses
    solver.step = half


def _altered_weight(solver):
    """An answer altered where it is produced: one weight of each step's
    result off by 1%."""
    step = solver.step

    def altered(state, k):
        new, losses = step(state, k)
        w = new.w.clone()
        w.view(-1)[int(torch.argmax(w.view(-1)))] *= 1.01
        return new._replace(w=w), losses
    solver.step = altered


def _altered_product(solver):
    """An answer altered where it is produced: one entry of every DSC
    result off by 1e-3 of the largest."""
    dsc, wc = solver.ops()

    def altered(w):
        y = dsc(w).clone()
        y.view(-1)[0] += 1e-3 * float(y.abs().max())
        return y
    solver.set_ops(altered, wc)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("fault", [_unchanged, _altered_weight,
                                   _altered_product],
                         ids=["unchanged", "altered_weight", "altered_dsc"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    assert _run(name, fault)["correct"] is False


@pytest.mark.parametrize("name", [n for n in CELLS if "cohort" in n])
def test_half_of_the_cohort_left_out_is_not_correct(name):
    assert _run(name, _half_batch)["correct"] is False
