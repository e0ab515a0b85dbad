"""A cell, a traffic mix and a per-layer metric that exist only as new
files are found by name: the harness needs no edit."""
import json
import shutil
from pathlib import Path


from life_bench import run
from life_bench.tests import lb_tiny

ROOT = Path(__file__).resolve().parents[2]


def test_new_cell_traffic_and_metric_found_by_name(tmp_path):
    shutil.copytree(ROOT / "life_bench", tmp_path / "life_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    lb = tmp_path / "life_bench"
    traffic = json.loads((lb / "traffic" / "coo-solve.json").read_text())
    traffic["chunk_iters"] = 5
    (lb / "traffic" / "coo-short.json").write_text(json.dumps(traffic))
    (lb / "limits" / "ifod1-500k.coo-short.json").write_text(
        json.dumps({"dsc_rel": 1e-3}))
    (lb / "metrics" / "dsc.calls_per_iter.py").write_text(
        "def read(ctx):\n    return ctx['trace']['calls'].get('dsc', 0)\n")
    spec["workloads"].append(dict(name="ifod1-500k.coo-short",
                                  config="stn96-ifod1-500k",
                                  traffic="coo-short", chips=1, why="test"))
    spec["per_layer"].append(dict(
        name="dsc.calls_per_iter", unit="calls", better="lower",
        source="device_trace", layer="SpMV executor",
        moves="subject_iters_per_s"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    files = run.load_cell("ifod1-500k.coo-short", root=tmp_path)
    assert files["traffic"]["chunk_iters"] == 5
    assert files["limits"] == {"dsc_rel": 1e-3}
    assert "dsc.calls_per_iter" in [m["name"] for m in files["per_layer"]]
    assert run.reader("dsc.calls_per_iter", root=tmp_path)(
        {"trace": {"calls": {"dsc": 7}}}) == 7
    # every cell reads every metric; a reader that finds nothing in a
    # cell returns nothing, and the line leaves the metric out
    old = run.load_cell("ifod1-500k.coo-solve", root=tmp_path)
    assert "dsc.calls_per_iter" in [m["name"] for m in old["per_layer"]]


def test_every_listed_reader_loads_and_reads_a_stretch():
    files = lb_tiny.cell("ifod1-500k.coo-solve")
    ctx = dict(build_s=1.5, bytes=dict(dsc=3.35e9, wc=3.35e9),
               trace=dict(window_s=0.1, busy_s=0.08, calls=dict(dsc=4, wc=3),
                          device_s={"dsc": 0.04, "wc": 0.03, None: 0.01}))
    got = {m["name"]: run.reader(m["name"])(ctx) for m in files["per_layer"]}
    assert got["dsc.hbm_roofline"] == 100.0 * 1e-3 / 0.01
    assert abs(got["wc.hbm_roofline"] - 100.0 * 1e-3 / 0.01) < 1e-9
    assert abs(got["sbbnnls.glue_share"] - 12.5) < 1e-9
    assert abs(got["device.idle_share"] - 20.0) < 1e-9
    assert abs(got["sbbnnls.mfu_hbm"] - 100.0 * 7e-3 / 0.1) < 1e-9
    assert got["setup.build_s"] == 1.5
    # a stretch with no device work: the device readers find nothing
    ctx["trace"] = dict(window_s=0.1, busy_s=0.0, calls={}, device_s={})
    got = {m["name"]: run.reader(m["name"])(ctx) for m in files["per_layer"]}
    assert [k for k, v in got.items() if v is not None] == ["setup.build_s"]
