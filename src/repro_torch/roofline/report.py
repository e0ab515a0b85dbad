"""Roofline tables from dry-run JSON records (torch counterpart of
``repro/roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir results/dryrun]
        [--before DIR]

The tables read either package's records (``repro.launch.dryrun`` or
``repro_torch.launch.dryrun``): status, kind, the three roofline terms,
the dominant one, the useful share of the FLOPs, memory per device and
the MFU upper bound.  A record's memory per device is its temp size plus
its arguments: the reference's compiled temp size, the port's traced
peak (``roofline/trace_cost.py``).  A record without a temp size counts
its arguments alone, which the summary says.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(results_dir: str) -> List[Dict]:
    """Every ``<mesh>/<arch>__<shape>.json`` record under ``results_dir``."""
    recs = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*", "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(b: float) -> str:
    """Bytes as GB with two decimals."""
    return f"{b / 1e9:.2f}"


def table(recs: List[Dict], mesh_kind: str) -> str:
    """The markdown table of one mesh's records, rows sorted."""
    rows = []
    header = ("| arch | shape | kind | compute s | memory s | coll s | "
              "dominant | useful | mem GB/dev | MFU-UB |\n"
              "|---|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r.get("mesh_kind") != mesh_kind:
            continue
        if r["status"] != "ok":
            word = "SKIP" if r["status"] == "skipped" else "ERROR"
            rows.append(f"| {r.get('arch', '?')} | {r.get('shape', '?')} | "
                        f"— | {word} | | | | | | |")
            continue
        rl = r["roofline"]
        mem = r["memory"].get("total_bytes_per_device", 0) / 1e9
        mfu = r.get("mfu_upper_bound") or 0.0
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {rl['compute_s']:.4f} | {rl['memory_s']:.4f} "
            f"| {rl['collective_s']:.4f} | **{rl['dominant']}** "
            f"| {rl['useful_ratio']:.2f} | {mem:.1f} "
            f"| {mfu:.3f} |")
    return header + "\n" + "\n".join(sorted(rows))


def summary(recs: List[Dict]) -> str:
    """Cell counts by status, the dominant terms and the best MFU bound."""
    ok = [r for r in recs if r["status"] == "ok"]
    err = [r for r in recs if r["status"] == "error"]
    skip = [r for r in recs if r["status"] == "skipped"]
    refused = [r for r in err if r.get("refused")]
    lines = [f"- cells: {len(recs)} total, {len(ok)} ok, {len(skip)} "
             f"documented skips, {len(err)} errors ({len(refused)} refused "
             f"by the port)"]
    untraced = [r for r in ok
                if r["memory"].get("temp_size_in_bytes") is None]
    if untraced:
        lines.append(f"- {len(untraced)} records' memory per device is "
                     f"their arguments alone (no temp size: "
                     f"{', '.join(sorted({r['arch'] for r in untraced}))})")
    by_dom: Dict[str, int] = {}
    for r in ok:
        d = r["roofline"]["dominant"]
        by_dom[d] = by_dom.get(d, 0) + 1
    lines.append(f"- dominant bottleneck distribution: {by_dom}")
    best = max(ok, key=lambda r: r.get("mfu_upper_bound") or 0, default=None)
    if best is not None and best.get("mfu_upper_bound"):
        lines.append(f"- best MFU upper bound: {best['arch']}/"
                     f"{best['shape']} @ {best['mfu_upper_bound']:.3f}")
    return "\n".join(lines)


#: :func:`compare`'s initial of each dominant term
INITIALS = {"compute": "c", "memory": "m", "collective": "x"}


def compare(before: List[Dict], after: List[Dict]) -> str:
    """A markdown table of two sweeps' ok cells: per mesh and
    architecture one row, per shape the collective GB a device and step
    before and after, each with its dominant term's initial (c, m, x for
    compute, memory, collective)."""
    def key(r):
        return r.get("mesh_kind"), r.get("arch"), r.get("shape")

    old = {key(r): r for r in before if r["status"] == "ok"}
    shapes = sorted({r["shape"] for r in after if r["status"] == "ok"})
    rows: Dict[tuple, Dict[str, str]] = {}
    for r in after:
        if r["status"] != "ok" or key(r) not in old:
            continue
        b = old[key(r)]
        cell = (f"{fmt_bytes(b['collectives']['total'])} "
                f"{INITIALS[b['roofline']['dominant']]} → "
                f"{fmt_bytes(r['collectives']['total'])} "
                f"{INITIALS[r['roofline']['dominant']]}")
        rows.setdefault((r["mesh_kind"], r["arch"]), {})[r["shape"]] = cell
    head = ("| mesh | arch | " + " | ".join(shapes) + " |\n|---|---|"
            + "---|" * len(shapes))
    lines = [f"| {mk} | {arch} | "
             + " | ".join(cells.get(s, "—") for s in shapes) + " |"
             for (mk, arch), cells in sorted(rows.items())]
    return head + "\n" + "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results", "dryrun"))
    ap.add_argument("--before", default=None,
                    help="another sweep's directory: print the collective "
                         "bytes and dominant terms of both, cell by cell")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## Summary\n")
    print(summary(recs))
    for mk in ("pod", "multipod"):
        print(f"\n## {mk} mesh\n")
        print(table(recs, mk))
    if args.before:
        print("\n## Collective GB a device and step, before -> after\n")
        print(compare(load(args.before), recs))


if __name__ == "__main__":
    main()
