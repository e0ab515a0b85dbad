"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names; the reference and the generator load nothing of the
port."""
import subprocess
import sys

from life_bench import run

SNIPPET_RUN = """
import json, torch
from life_bench import run
from life_bench.tests import lb_tiny
r = run.run_cell(lb_tiny.cell("ifod1-500k.fcoo-solve"), 7, 0.2, True,
                 torch.device("cpu"))
print(json.dumps(run.forbidden_modules()))
"""
SNIPPET_REF = """
import json, sys, torch
from life_bench import check, gen, reference, yardstick
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("repro_torch", "repro", "jax"))))
"""


def _last_json(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    import json
    return json.loads(out.strip().splitlines()[-1])


def test_a_cpu_rehearsal_loads_no_jax_module():
    assert _last_json(SNIPPET_RUN) == []


def test_reference_and_generator_load_nothing_of_the_port():
    assert _last_json(SNIPPET_REF) == []


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro.core"]
