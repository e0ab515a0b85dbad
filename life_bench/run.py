"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m life_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cell's CUDA cards.
The cell, its configuration and its metrics come from ``BENCHMARK.json``;
the configuration file, the traffic file ``traffic/<traffic>.json``, the
limits file ``limits/<workload>.json`` and each per-layer metric's reader
``metrics/<metric>.py`` are found by name.  A run makes its data on the
card from ``--seed``, builds the engine and warms it up (those two are
``setup_s``), measures for ``--seconds``, and then judges what the window
produced against the plain reference.  With ``--trace 1`` it also traces
a short steady stretch after the window and reports the per-layer
metrics instead of the end-to-end ones.  The numbers compared are the
last lines on standard error and the result's last key, ``checks``.

Exit codes: 0 with a result; 2 without enough CUDA cards; 3 when a JAX
module was loaded; anything else on an error, with no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

import torch  # noqa: E402

from life_bench import check, trace, yardstick  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names a run must never load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything that defines cell ``name``, found by name: its entry,
    configuration, traffic, limits, and the metrics (every cell reports
    them all)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    here = root / HERE.name
    return dict(
        cell=cell,
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=spec["end_to_end"], per_layer=spec["per_layer"])


def reader(metric: str, root: Path = ROOT) -> Callable[[dict], object]:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    mod_name = "life_bench.metrics_" + metric.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(files: dict, seed: int, seconds: float, traced: bool,
             device: torch.device, *,
             overrides: Optional[Dict[str, object]] = None,
             patch: Optional[Callable] = None) -> dict:
    """One run of a cell: data, set-up, window, trace, check.
    ``setup_s`` is the engine's constructor and warm-up: the benchmark's
    own data (with the reference's ``b``) comes before it and is
    ``data_s``.  ``overrides`` are engine settings over the traffic's (the
    control's ``compute_dtype``); ``patch(solver)`` may break the timed
    path (the fault tests)."""
    t_enter = time.perf_counter()
    config, traffic = files["config"], files["traffic"]
    on_cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_cuda else (
        lambda: None)
    drv = importlib.import_module(f"life_bench.drivers.{traffic['driver']}")
    t0 = time.perf_counter()
    data = drv.make_data(config, traffic, seed, device)
    sync()
    data_s = time.perf_counter() - t0
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_setup = time.perf_counter()
    solver = drv.Solver(data, config, traffic, overrides or {})
    sync()
    build_s = time.perf_counter() - t_setup
    if patch is not None:
        patch(solver)
    t0 = time.perf_counter()
    solver.warm()
    sync()
    warm_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_setup
    win = solver.window(seconds, sync)
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    stretch = None
    if traced:
        dsc, wc = solver.ops()
        solver.set_ops(trace.ranged("dsc", dsc), trace.ranged("wc", wc))
        events = trace.profile(
            lambda: solver.step(solver.init(), traffic["trace_iters"]),
            sync, on_cuda)
        solver.set_ops(dsc, wc)
        stretch = trace.reduce(events)
        if stretch is None or (on_cuda and stretch["busy_s"] <= 0):
            raise RuntimeError("the profiler saw no device work in the "
                               "traced stretch")
    outputs = solver.outputs(data)
    sync()
    del solver
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    found = check.numbers(data, config, win, outputs)
    check_s = time.perf_counter() - t0
    checks = check.compare(found, files["limits"])

    storage = (overrides or {}).get("compute_dtype", config["dtype"])
    gx, gy, gz = config["grid"]
    shape = (sum(s["values"].numel() for s in data["subjects"]),
             gx * gy * gz, config["n_fibers"], config["n_atoms"],
             config["n_theta"])
    kw = dict(subjects=traffic["subjects"], storage=storage)
    if traced:
        ctx = dict(trace=stretch, build_s=build_s,
                   bytes=dict(dsc=yardstick.dsc_bytes(*shape, **kw),
                              wc=yardstick.wc_bytes(*shape, **kw)))
        metrics = {}
        for m in files["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(subject_iters_per_s=win["subject_iters"] / win["elapsed"],
                      peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in files["end_to_end"]}
    dev = dict(platform="gpu" if on_cuda else device.type,
               kind=torch.cuda.get_device_name(device) if on_cuda else "cpu",
               count=files["cell"]["chips"], memory_peak_bytes=peak)
    result = dict(correct=all(c["ok"] for c in checks.values()),
                  attempted=win["subject_iters"], failed=0,
                  metrics=metrics, device=dev)
    if traced:
        dev.update(busy_s=stretch["busy_s"], window_s=stretch["window_s"])
        result["breakdown"] = dict(device_ops=stretch["device_ops"],
                                   idle_gaps=stretch["idle_gaps"])
    result["checks"] = {k: dict(value=c["value"], limit=c["limit"])
                        for k, c in checks.items()}
    result["_readings"] = dict(found=found, start_s=t_enter - T_START,
                               data_s=data_s, build_s=build_s,
                               warm_s=warm_s, check_s=check_s,
                               window_s=win["elapsed"],
                               subject_iters=win["subject_iters"],
                               judged_iters=win["judged_iters"],
                               coefficients=shape[0])
    return result


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().replace("\n", "; ") or "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    files = load_cell(args.workload)
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(files, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    report(result, sys.stdout, sys.stderr)
    return 0


def report(result: dict, out, err) -> None:
    """Print the readings and each number compared beside its limit (the
    last lines on ``err``), then the result as the last line on ``out``."""
    readings = result.pop("_readings", None)
    if readings is not None:
        print("readings: " + json.dumps(readings), file=err)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
