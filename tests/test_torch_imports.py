"""The port imports no JAX and nothing of the reference package.

Walks the syntax tree of every module under src/repro_torch and of
chip_smoke.py: an import of ``jax``, of ``repro`` or of ``ml_dtypes``
(which the card's machine does not have), or of anything under them,
fails, wherever it sits in the file.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for want in ("src/repro_torch/core/life.py",
                 "src/repro_torch/kernels/dsc.py",
                 "src/repro_torch/kernels/wc.py",
                 "src/repro_torch/kernels/fcoo.py",
                 "src/repro_torch/formats/select.py",
                 "src/repro_torch/tune/search.py",
                 "src/repro_torch/core/prng.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/configs/phi3_5_moe_42b_a6_6b.py",
                 "src/repro_torch/kernels/moe_gmm.py",
                 "src/repro_torch/models/layers.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/launch/steps.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/core/batched.py",
                 "src/repro_torch/tune/plan.py",
                 "src/repro_torch/tune/space.py",
                 "src/repro_torch/tune/tuner.py",
                 "src/repro_torch/checkpoint/manager.py",
                 "src/repro_torch/obs/runtime.py",
                 "src/repro_torch/obs/metrics.py",
                 "src/repro_torch/obs/trace.py",
                 "src/repro_torch/obs/__init__.py",
                 "src/repro_torch/roofline/analysis.py",
                 "src/repro_torch/roofline/spmv_bytes.py",
                 "src/repro_torch/serve/scheduler.py",
                 "src/repro_torch/serve/service.py",
                 "src/repro_torch/serve/__init__.py",
                 "src/repro_torch/models/leaves.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/data/tokens.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/models/flash.py",
                 "src/repro_torch/models/mamba2.py",
                 "src/repro_torch/configs/mamba2_2_7b.py",
                 "src/repro_torch/configs/zamba2_1_2b.py",
                 "src/repro_torch/examples/quickstart.py",
                 "src/repro_torch/examples/serve_subjects.py",
                 "src/repro_torch/examples/serve_life.py",
                 "src/repro_torch/examples/serve_async.py",
                 "src/repro_torch/examples/prune_connectome.py",
                 "src/repro_torch/examples/distributed_life.py",
                 "src/repro_torch/examples/serve_lm.py",
                 "src/repro_torch/examples/train_lm.py", "chip_smoke.py"):
        assert want in names


#: the learned-selection, front-line and science slice (ROADMAP A11, A12)
SLICE_TEN = ("learn/features.py", "learn/model.py", "learn/harvest.py",
             "learn/refine.py", "learn/__init__.py", "formats/select.py",
             "tune/tuner.py", "core/plan_cache.py", "core/life.py",
             "serve/frontend.py", "serve/__init__.py", "data/dmri.py",
             "science/prune.py", "science/crossval.py",
             "science/incremental.py", "science/lesion.py",
             "science/__init__.py")


#: the mesh slice (ROADMAP A13)
SLICE_ELEVEN = ("core/inspector.py", "core/plan_cache.py",
                "formats/shard.py", "distributed/__init__.py",
                "distributed/mesh.py", "distributed/life_shard.py",
                "distributed/spmd.py", "core/registry.py", "core/life.py",
                "tune/space.py", "serve/scheduler.py", "serve/service.py",
                "roofline/analysis.py")


#: a fresh interpreter's prelude that makes jax and the reference
#: unimportable
BLOCK = ("import sys\n"
         "class Block:\n"
         "    def find_spec(self, name, path=None, target=None):\n"
         "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
         "            raise ImportError('blocked: ' + name)\n"
         "sys.meta_path.insert(0, Block())\n")


def _run_blocked(code: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


#: the training slice (ROADMAP A15.1)
SLICE_TWELVE = ("models/leaves.py", "optim/adamw.py", "data/tokens.py",
                "launch/train.py")
#: the long-sequence slice (ROADMAP A15.2, A15.4)
SLICE_THIRTEEN = ("models/flash.py", "models/mamba2.py", "models/layers.py",
                  "models/transformer.py")
#: the rest of the mesh: the LM on a (data, model) mesh, the cohort's
#: placement, resharding on load (ROADMAP A13)
SLICE_FOURTEEN = ("launch/mesh.py", "distributed/sharding.py",
                  "distributed/hints.py", "distributed/lm_shard.py",
                  "launch/steps.py", "launch/serve.py", "core/batched.py",
                  "checkpoint/manager.py", "models/moe.py")
#: the audio and vlm families and the dry run (ROADMAP A15.5, A15.6)
SLICE_FIFTEEN = ("launch/dryrun.py", "roofline/report.py", "configs/base.py",
                 "core/prng.py")
#: the example programs as the port's entry points (ROADMAP A14b)
SLICE_NINETEEN = tuple(f"examples/{m}.py" for m in (
    "__init__", "quickstart", "serve_subjects", "serve_life", "serve_async",
    "prune_connectome", "distributed_life", "serve_lm", "train_lm"))
#: the configurations the training, long-sequence and fifteenth slices add
NEW_CONFIGS = ("qwen1.5-4b", "deepseek-7b", "stablelm-12b", "granite-34b",
               "kimi-k2-1t-a32b", "mamba2-2.7b", "zamba2-1.2b",
               "musicgen-large", "qwen2-vl-7b", "life-stn96")


@pytest.mark.parametrize("module", SLICE_TEN + tuple(
    m for m in SLICE_ELEVEN if m not in SLICE_TEN) + SLICE_TWELVE
    + SLICE_THIRTEEN + SLICE_FOURTEEN + SLICE_FIFTEEN + SLICE_NINETEEN)
def test_slice_ten_modules_exist_and_import_alone(module):
    """Each module of the slices ten to fifteen and each example program
    is in the port and imports in a fresh interpreter that has neither jax
    nor the reference importable."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    name = "repro_torch." + module[:-3].replace("/", ".").removesuffix(
        ".__init__")
    _run_blocked(BLOCK + f"import {name}\n")


def test_new_configs_import_alone():
    """The training, long-sequence and fifteenth slices' configurations
    register through get_config in a fresh interpreter without jax or the
    reference."""
    for name in NEW_CONFIGS:
        path = ROOT / "src" / "repro_torch" / "configs" / (
            name.replace("-", "_").replace(".", "_") + ".py")
        assert path in FILES, path
    _run_blocked(BLOCK + "from repro_torch.configs.base import get_config\n"
                 + "".join(f"assert get_config({n!r}).name == {n!r}\n"
                           for n in NEW_CONFIGS))


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imported(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """With no CUDA device visible the smoke run exits non-zero and prints
    no result line, also when copied alone into an empty directory."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
