"""BENCHMARK.json keeps to the contract's form, and every name in it has
its files."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
#: keys of a configuration's file that would be widths of LiFE's data
WIDTHS = ("n_theta", "n_atoms")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert (runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200) <= 43200
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys_and_allowed_names(section):
    entries = SPEC[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)


def test_metric_names_are_unique_across_sections_and_sources_allowed():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for m in metrics:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_every_name_has_its_files():
    here = ROOT / "life_bench"
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            # the source's value of each changed key is kept for the record
            assert NAME.match(k) and k in body["published"]
            assert k not in WIDTHS and not k.endswith(("_dim", "_rank"))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert (here / "traffic" / f"{w['traffic']}.json").is_file()
        assert (here / "limits" / f"{w['name']}.json").is_file()
    for m in SPEC["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file()
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        mine = lambda m: w["name"] in m.get("workloads", [w["name"]])  # noqa: E731
        e2e = {m["name"] for m in SPEC["end_to_end"] if mine(m)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in SPEC["per_layer"] if mine(m)]
        assert layers and all(m["moves"] in e2e for m in layers)
