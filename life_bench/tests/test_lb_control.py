"""The control on the card: the program with its own bfloat16 path
switched on (``compute_dtype="bf16"``), at each cell's own size and
window, on three seeds, comes out not correct.  Needs a CUDA card:

    python -m pytest -m gpu life_bench/tests/test_lb_control.py
"""
import json

import pytest
import torch

from life_bench import calibrate, run

SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (2 ** 31 + 401, 2 ** 31 + 402, 2 ** 31 + 403)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_three_seeds(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    files = run.load_cell(name)
    rows = calibrate.readings(files, SEEDS, SPEC["run_seconds"],
                              control=True)
    print(json.dumps(dict(workload=name, rows=rows)))
    assert [r["correct"] for r in rows] == [False] * len(SEEDS), rows
