"""The benchmark harness's own tests (``life_bench/tests``), each file in a
fresh interpreter.

A benchmark run is a process that never loaded JAX, and
``test_lb_imports.py`` holds the harness to that; this directory's
conftest imports ``jax`` in every worker, so the harness's tests run as
``python -m pytest`` subprocesses from the repository's root instead of
beside these.  Their ``gpu`` tests skip on a machine without a card.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "life_bench" / "tests").glob("test_*.py"))


def test_every_harness_test_file_is_run():
    assert len(FILES) >= 9


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_harness_tests_pass_in_a_fresh_process(path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", str(path.relative_to(ROOT))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-2000:])
