"""The traced stretch: ``torch.profiler`` over a few steady iterations,
read back from its Chrome trace.

The DSC and WC callables the engine steps through are wrapped in
``record_function`` ranges named ``dsc`` and ``wc`` for the stretch
only.  A device operation (kernel, memset, copy) belongs to the range
whose host interval holds the runtime call that launched it (matched by
the trace's correlation ids), so kernels launched through ``ctypes``
count like PyTorch's own.  The stretch is the host range
``life_bench.stretch``, which ends after a synchronise.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

STRETCH = "life_bench.stretch"
RANGES = ("dsc", "wc")
_DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function")


def ranged(name: str, fn: Callable) -> Callable:
    """``fn`` inside a ``record_function`` range ``name``."""
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def profile(run: Callable[[], None], sync: Callable[[], None],
            on_cuda: bool) -> List[dict]:
    """Trace ``run`` twice (the first a warm-up the profiler drops) and
    return the kept pass's events."""
    from torch.profiler import ProfilerActivity, schedule
    activities = [ProfilerActivity.CPU]
    if on_cuda:
        activities.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(
                activities=activities,
                schedule=schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for _ in range(2):
                sync()
                with torch.profiler.record_function(STRETCH):
                    run()
                    sync()
                prof.step()
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def op_name(name: str) -> str:
    """A device operation's name without its return type, namespace of
    anonymous scope and parameter list, at most 80 characters."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and name[i - 1:i] != " ":
            name = name[:i]
            break
    if name.startswith("void "):
        name = name[5:]
    return name[:80]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _host_at(host: List[Tuple[float, float, str]], starts: List[float],
             t: float, reach: int = 256) -> str:
    """The innermost host event running at ``t`` (the latest to start of
    those that hold it), looked for among the ``reach`` that started
    last before ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if host[j][1] >= t:
            return host[j][2][:80]
    return "host idle"


def reduce(events: List[dict]) -> Optional[dict]:
    """Seconds and counts of the stretch, by range; None when the trace
    holds no stretch.

    Returns a dict with ``window_s`` (the stretch's host span),
    ``busy_s`` (the union of device operations within it),
    ``device_s`` (device seconds by range, ``None`` for outside both),
    ``calls`` (host ranges by name), ``device_ops`` and ``idle_gaps``
    (the breakdown: seconds by operation name and by what the host was
    doing, longest first, at most 10 each)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    stretch = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == STRETCH]
    if not stretch:
        return None
    s0 = float(stretch[-1]["ts"])
    s1 = s0 + float(stretch[-1]["dur"])
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in xs
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in RANGES and s0 <= float(e["ts"]) <= s1)
    starts = [r[0] for r in ranges]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}

    def owner(corr) -> Optional[str]:
        ts = launch_ts.get(corr)
        if ts is None:
            return None
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ranges[i][0] <= ts <= ranges[i][1]:
            return ranges[i][2]
        return None

    device_s: Dict[Optional[str], float] = defaultdict(float)
    by_op: Dict[str, float] = defaultdict(float)
    spans = []
    for e in xs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a = max(float(e["ts"]), s0)
        b = min(float(e["ts"]) + float(e["dur"]), s1)
        if b <= a:
            continue
        spans.append((a, b))
        sec = (b - a) * 1e-6
        device_s[owner(e.get("args", {}).get("correlation"))] += sec
        by_op[op_name(e["name"])] += sec
    busy = _merge(spans)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs if e.get("cat") in _HOST_CATS
                  and e.get("name") != STRETCH)
    host_starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_host_at(host, host_starts, (a + b) / 2)] += (b - a) * 1e-6
    calls = defaultdict(int)
    for r in ranges:
        calls[r[2]] += 1
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:10]]
    return dict(window_s=(s1 - s0) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                device_s=dict(device_s), calls=dict(calls),
                device_ops=top(by_op), idle_gaps=top(gaps))
