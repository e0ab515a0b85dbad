"""A rehearsal of each cell on the CPU: the result line has the
contract's shape, and the checks come last on both streams."""
import io
import json

import pytest
import torch

from life_bench import run
from life_bench.tests import lb_tiny

CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_has_the_contract_shape(name, traced):
    files = lb_tiny.cell(name)
    result = run.run_cell(files, 2 ** 31 + 99, 0.3, traced,
                          torch.device("cpu"))
    out, err = io.StringIO(), io.StringIO()
    run.report(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    limits = files["limits"]
    assert set(line["checks"]) == set(limits)
    for k, c in line["checks"].items():
        assert c["limit"] == limits[k] and c["value"] <= c["limit"]
    tail = err.getvalue().strip().splitlines()[-len(limits):]
    assert [t.split()[1] for t in tail] == list(limits)
    if traced:
        assert "breakdown" in line
        assert set(line["device"]) >= {"busy_s", "window_s"}
        # no device here: only the host-clock reader finds something
        assert list(line["metrics"]) == ["setup.build_s"]
    else:
        assert list(line["metrics"]) == [m["name"]
                                         for m in files["end_to_end"]]
        for m in files["end_to_end"]:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]


def test_no_card_means_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""
