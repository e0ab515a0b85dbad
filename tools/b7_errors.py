"""B7's error against its plain version, case by case, in separate
processes: the cases of ``chip_smoke.py``'s phase 7 (the serve shapes and
expert layouts) and 14a (the gradient at the training shapes), each drawn
from its seed on the card, and whether any case's error differs from one
process to the next.  14a's dW is a ``torch.bmm``, not B7, and is listed
apart with its largest magnitude.

    python3 tools/b7_errors.py

Needs one CUDA card.  Prints each process's log, then one JSON line: per
case the errors of every process, and whether they are all identical.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSES = 3


def one_process() -> dict:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as CS
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    CS.phase_device()
    _build.build(["moe_gmm"])
    cfg = get_config(CS.LM_ARCH)
    errors: dict = {}
    CS.phase_lm_kernels(cfg, errors)
    CS.check_train_grads(cfg, errors)
    return {"b7": errors["moe_gmm_cases"], "dw_bmm": errors["dw_bmm"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--one", action="store_true",
                    help="run the cases once in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_process()))
        return 0
    runs = []
    for i in range(PROCESSES):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one"], capture_output=True, text=True,
                             check=True, timeout=600).stdout
        print(f"--- process {i + 1}\n{out}", end="", flush=True)
        runs.append(json.loads(out.strip().splitlines()[-1]))
    b7 = {case: [r["b7"][case] for r in runs] for case in runs[0]["b7"]}
    dw = {case: [r["dw_bmm"][case] for r in runs]
          for case in runs[0]["dw_bmm"]}
    worst = max(b7, key=lambda c: b7[c][0])
    print(json.dumps({
        "processes": len(runs), "b7": b7, "dw_bmm": dw,
        "b7_worst_case": worst, "b7_worst": b7[worst][0],
        "identical": all(len({json.dumps(v) for v in vals}) == 1
                         for vals in (*b7.values(), *dw.values()))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
