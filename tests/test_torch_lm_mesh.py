"""The LM on a ``(data, model)`` mesh: grouped MoE dispatch against the
reference's, train steps on meshes of gloo CPU ranks against the port's
single-process step under a shape-only mesh of the same shape (the same
dispatch groups and attention branch) and against the reference's
GSPMD step on 8 host devices, the elastic restart (4, 2) -> (2, 4),
serving on a mesh, and a reduced vlm trained on a (2, 1) mesh (its
``positions`` (3, B, S) split by their batch dim, 1).  Adafactor is held
the same ways: against one process (deepseek-7b at (4, 2), phi3.5-moe
and a reduced kimi-k2 with FSDP experts and per-layer units at (2, 2)),
against the reference's GSPMD Adafactor step, through the restart and
across the packages.

One module fixture runs every multi-rank job once
(``repro_torch.distributed.spmd.launch``: fresh interpreters joined by
``torchrun``'s environment).  Every run starts from one step-0
checkpoint written by the port's trainer, so all of them share weights.
Tolerances: a mesh run against the single-process run of the same G
agrees to float32 summation order (losses rtol 1e-5; weights after three
AdamW or Adafactor steps rtol 1e-4 / atol 1e-5, the factors at rtol 1e-4
with the atol scaled to their largest value); against the reference's
mesh step the losses agree within rtol 1e-4 and the weights within atol
5e-5 (two compilers' float32 products).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JCK
from repro.models import moe as JMOE
from repro_torch.bridge import to_numpy
from repro_torch.checkpoint import manager as CK
from repro_torch.distributed import hints, spmd
from repro_torch.launch import mesh as HM
from repro_torch.launch import serve, train
from repro_torch.models import moe as MOE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("deepseek-7b", "phi3.5-moe-42b-a6.6b")
MESH_SHAPES = ((4, 2), (2, 2))
STEPS = 3
ARGV = ["--reduced", "--steps", str(STEPS), "--seq-len", "32",
        "--global-batch", "8", "--lr", "1e-3", "--log-every", "1",
        "--device", "cpu"]
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
REF_LOSS_RTOL = 1e-4
REF_PARAM_ATOL = 5e-5
DEADLINE_S = 240.0
RANK_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------------
# grouped dispatch
# ----------------------------------------------------------------------------

def _moe_pair(d, ff, E, seed):
    r = np.random.default_rng(seed)
    w = {"router": r.normal(size=(d, E)) * 0.3,
         "wi_gate": r.normal(size=(E, d, ff)) * 0.2,
         "wi_up": r.normal(size=(E, d, ff)) * 0.2,
         "wo": r.normal(size=(E, ff, d)) * 0.2}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    p = MOE.MoE(d, ff, E, 0, torch.float32, "cpu")
    for k, v in w.items():
        getattr(p, k).data.copy_(torch.from_numpy(v))
    return {k: jnp.asarray(v) for k, v in w.items()}, p


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("top_k,capacity", [(2, 8), (1, 16), (2, 40)])
def test_grouped_dispatch_matches_reference(G, top_k, capacity):
    """The port's ``_dispatch`` against the reference's ``_dispatch_group``
    on the same (G, T, d) tokens and weights: capacity 8 drops tokens,
    40 none."""
    d, ff, E, T = 16, 24, 8, 32
    jp, p = _moe_pair(d, ff, E, 10 + G)
    r = np.random.default_rng(G * 7 + top_k)
    x = (r.normal(size=(G, T, d)) + r.normal(size=(d,))).astype(np.float32)
    out, aux = MOE._dispatch(p, torch.from_numpy(x), top_k, capacity, E)
    jout, jaux = JMOE._dispatch_group(jp, jnp.asarray(x), top_k, capacity, E)
    np.testing.assert_allclose(to_numpy(out), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(E * aux.detach().sum() / G), float(jaux),
                               rtol=1e-5)


@pytest.mark.parametrize("G", [2, 4])
def test_moe_ffn_under_a_shape_mesh_dispatches_g_groups(G):
    """A shape-only mesh of G data rows makes ``moe_ffn`` dispatch G
    groups, each with its own capacity, as the reference's does; a token
    count G does not divide falls back to one group."""
    d, ff, E = 16, 24, 8
    jp, p = _moe_pair(d, ff, E, 3)
    x = np.random.default_rng(G).normal(size=(4, 8, d)).astype(np.float32)
    hints.activate(HM.ShapeMesh((G, 2), ("data", "model")))
    try:
        out, aux = MOE.moe_ffn(p, torch.from_numpy(x), top_k=2,
                               capacity_factor=1.0)
        odd, _ = MOE.moe_ffn(p, torch.from_numpy(x[:1, :7]), top_k=2,
                             capacity_factor=1.0)
    finally:
        hints.deactivate()
    tg = 32 // G
    cap = MOE.capacity_of(tg, 2, E, 1.0)
    jout, jaux = JMOE._dispatch_group(jp, jnp.asarray(x.reshape(G, tg, d)),
                                      2, cap, E)
    np.testing.assert_allclose(to_numpy(out).reshape(G, tg, d),
                               np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    one, _ = JMOE._dispatch_group(jp, jnp.asarray(x[:1, :7]), 2,
                                  MOE.capacity_of(7, 2, E, 1.0), E)
    np.testing.assert_allclose(to_numpy(odd)[0], np.asarray(one)[0],
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------------
# mesh runs (one module fixture)
# ----------------------------------------------------------------------------

REFERENCE_RUN = """
import dataclasses, json, sys
import jax, jax.numpy as jnp
from repro import compat
from repro.checkpoint import manager as CK
from repro.configs.base import get_config, reduced
from repro.data.tokens import DataConfig, synth_batch_for
from repro.distributed import hints, sharding as SH
from repro.launch import steps as ST
from repro.optim.adamw import OptConfig

start_dir, out_dir, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
kind = sys.argv[4] if len(sys.argv) > 4 else "adamw"
cfg = dataclasses.replace(reduced(get_config("deepseek-7b")), remat=False)
# the trainer CLI's schedule at --lr 1e-3 --steps 3
opt = OptConfig(kind=kind, lr=1e-3, warmup_steps=max(2, steps // 20),
                decay_steps=steps)
data = DataConfig(seed=0, seq_len=32, global_batch=8)
mesh = compat.make_mesh((4, 2), ("data", "model"))
hints.activate(mesh)
params, opt_state = ST.init_all(cfg, opt, jax.random.PRNGKey(0))
_, flat, _ = CK.restore(start_dir)
tree = CK.unflatten_like(
    jax.eval_shape(lambda: {"params": params, "opt": opt_state}), flat)
params = jax.tree.map(jnp.asarray, tree["params"])
opt_state = jax.tree.map(jnp.asarray, tree["opt"])
step_fn = jax.jit(ST.make_train_step(cfg, opt))
losses = []
with mesh:
    params = CK.place(params, SH.logical_to_shardings(
        mesh, SH.param_specs(cfg, mesh, params)))
    for s in range(steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       synth_batch_for(cfg, data, s))
        losses.append(float(m["loss"]))
CK.save(out_dir, steps, {"params": params, "opt": opt_state},
        meta={"arch": cfg.name})
print("LOSSES", json.dumps(losses))
"""


#: one rank of a job list: joins the group once, then runs each job's
#: entry point in turn (a job of kind "refused" must raise ValueError;
#: "copy" copies a directory on rank 0; a third entry of a "train" job
#: names the JSON file rank 0 writes the returned run's metrics to, or is
#: null, and a fourth holds options: "opt", the trainer's OptConfig
#: fields, and "thresholds", FSDP_PARAM_THRESHOLD and _CHUNK_THRESHOLD
#: for the job)
RANK_JOBS = """
import json, shutil, sys
import torch
import torch.distributed as dist
from repro_torch.distributed import sharding, spmd
from repro_torch.launch import serve, train
from repro_torch.optim import adamw
torch.set_num_threads(1)
spmd.join_process_group("gloo", torch.device("cpu"))
defaults = sharding.FSDP_PARAM_THRESHOLD, adamw._CHUNK_THRESHOLD
for kind, argv, *out in json.load(open(sys.argv[1])):
    opts = out[1] if len(out) > 1 else {}
    out = [o for o in out[:1] if o]
    sharding.FSDP_PARAM_THRESHOLD, adamw._CHUNK_THRESHOLD = opts.get(
        "thresholds", defaults)
    if kind == "copy":
        if dist.get_rank() == 0:
            for dst in argv[1:]:
                shutil.copytree(argv[0], dst)
        dist.barrier()
        continue
    if kind == "refused":
        try:
            train.main(argv)
        except ValueError as exc:
            print("REFUSED", exc, flush=True)
            continue
        raise AssertionError("the job was not refused")
    if "opt" in opts:
        run = train.main(argv, opt=adamw.OptConfig(**opts["opt"]))
    else:
        run = {"train": train.main, "serve": serve.main}[kind](argv)
    if out and dist.get_rank() == 0:
        with open(out[0], "w") as f:
            json.dump({"start": run.start, "metrics": run.metrics,
                       "mesh": run.params.mesh_state.mesh.shape}, f)
    print("JOB DONE", flush=True)
"""


def _launch(argv, world, directory):
    return spmd.launch(argv, world, directory, deadline_s=DEADLINE_S,
                       env=RANK_ENV)


def _jobs(jobs, world, directory):
    """Rank 0's output of ``world`` ranks running ``jobs`` in turn."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "jobs.json")
    with open(path, "w") as f:
        json.dump(jobs, f)
    return _launch(["-c", RANK_JOBS, path], world, directory)[0]


def _restored(ckpt_dir, step=None):
    return CK.restore(ckpt_dir, step)[1]


SERVE_ARGV = ["--arch", "phi3.5-moe-42b-a6.6b", "--reduced", "--device",
              "cpu", "--batch", "4", "--gen", "6"]
#: reduced, 16 image patches and 16 tokens a row at ARGV's --seq-len 32
VLM = "qwen2-vl-7b"


#: Adafactor at the CLI's schedule for ARGV (--lr 1e-3, --steps 3)
ADAFACTOR = dict(kind="adafactor", lr=1e-3, warmup_steps=2,
                 decay_steps=STEPS)
#: the Adafactor jobs: (tag, arch, mesh shape, extra argv, thresholds);
#: kimi-k2 reduced to 3 layers (2 MoE) with the 1 T's paths turned on:
#: FSDP experts (the d_model dim over data) and per-layer units for the
#: expert stacks (2 x 4 x 64 x 128 elements; nothing else reaches 32768)
ADAFACTOR_RUNS = (
    ("deepseek-7b", "deepseek-7b", (4, 2), [], None),
    ("phi3.5-moe", "phi3.5-moe-42b-a6.6b", (2, 2), [], None),
    ("kimi-k2", "kimi-k2-1t-a32b", (2, 2), ["--layers", "3"], (0, 32768)),
)


class _thresholds:
    """FSDP_PARAM_THRESHOLD and _CHUNK_THRESHOLD set for a block (None:
    unchanged)."""

    def __init__(self, values):
        from repro_torch.distributed import sharding
        from repro_torch.optim import adamw
        self.values, self.mods = values, (sharding, adamw)

    def __enter__(self):
        sh, ad = self.mods
        self.saved = sh.FSDP_PARAM_THRESHOLD, ad._CHUNK_THRESHOLD
        if self.values is not None:
            sh.FSDP_PARAM_THRESHOLD, ad._CHUNK_THRESHOLD = self.values

    def __exit__(self, *exc):
        sh, ad = self.mods
        sh.FSDP_PARAM_THRESHOLD, ad._CHUNK_THRESHOLD = self.saved


def _adafactor_runs(root, jobs):
    """The Adafactor cases: each from its own step-0 checkpoint, one
    process under a shape-only mesh, and a mesh job appended to
    ``jobs``; deepseek-7b's (4, 2) checkpoint is then copied and placed
    under (2, 4) and saved again.  Returns the cases' dirs and the
    resave's."""
    from repro_torch.optim.adamw import OptConfig
    opt = OptConfig(**ADAFACTOR)
    out = {}
    for tag, arch, (R, C), extra, th in ADAFACTOR_RUNS:
        base = ["--arch", arch, *ARGV, *extra]
        start, single = str(root / f"af-{tag}-start"), str(
            root / f"af-{tag}-single")
        with _thresholds(th):
            train.main(["--arch", arch, "--reduced", "--steps", "0",
                        "--device", "cpu", *extra, "--ckpt-dir", start],
                       opt=opt)
            shutil.copytree(start, single)
            run = train.main([*base, "--ckpt-dir", single], opt=opt,
                             mesh=HM.ShapeMesh((R, C), ("data", "model")))
        mesh_dir = str(root / f"af-{tag}-mesh")
        shutil.copytree(start, mesh_dir)
        metrics = str(root / f"af-{tag}.json")
        opts = {"opt": ADAFACTOR}
        if th is not None:
            opts["thresholds"] = list(th)
        jobs[R * C].append(("train", [*base, "--model-axis", str(C),
                                      "--ckpt-dir", mesh_dir], metrics,
                            opts))
        out[tag] = dict(single=run, single_dir=single, mesh_dir=mesh_dir,
                        metrics=metrics, start=start, shape=(R, C))
    src = out["deepseek-7b"]["mesh_dir"]
    resaved = str(root / "af-restart-resaved")
    jobs[8] += [("copy", [src, resaved]),
                ("train", ["--arch", "deepseek-7b", "--model-axis", "4",
                           *ARGV, "--ckpt-dir", resaved], None,
                 {"opt": ADAFACTOR})]
    out["resaved"] = resaved
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh job once: two spawns (8 ranks: both archs at (4, 2) and
    the restart under (2, 4), AdamW and Adafactor; 4 ranks: both archs
    at (2, 2), serving, a model axis that does not divide the world, and
    Adafactor on phi3.5-moe and a reduced kimi-k2), the single-process
    counterparts, and the reference's (4, 2) step, AdamW and Adafactor,
    in subprocesses of 8 host devices, which overlap the spawns."""
    root = tmp_path_factory.mktemp("lm_mesh")
    out = {}
    for arch in ARCHS:
        start = str(root / f"{arch}-start")
        train.main(["--arch", arch, *ARGV[:1], "--steps", "0",
                    "--device", "cpu", "--ckpt-dir", start])
        out[arch, "start"] = start
    ref_dir = str(root / "reference-4x2")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c",
                            textwrap.dedent(REFERENCE_RUN),
                            out["deepseek-7b", "start"], ref_dir, str(STEPS)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    jobs = {8: [], 4: []}
    for arch in ARCHS:
        for R, C in MESH_SHAPES:
            tag = f"{arch}-{R}x{C}"
            single = str(root / f"{tag}-single")
            shutil.copytree(out[arch, "start"], single)
            run = train.main(["--arch", arch, *ARGV, "--ckpt-dir", single],
                             mesh=HM.ShapeMesh((R, C), ("data", "model")))
            mesh_dir = str(root / f"{tag}-mesh")
            shutil.copytree(out[arch, "start"], mesh_dir)
            metrics = str(root / f"{tag}.json")
            jobs[R * C].append(("train", [
                "--arch", arch, *ARGV, "--model-axis", str(C), "--ckpt-dir",
                mesh_dir], metrics))
            out[arch, R, C] = dict(single=run, single_dir=single,
                                   mesh_dir=mesh_dir, metrics=metrics)
    # the elastic restart: (4, 2)'s checkpoint placed under (2, 4), saved
    # again at once, then two more steps
    again = str(root / "restart-2x4")
    resaved = str(root / "restart-resaved")
    more = [a if a != str(STEPS) else str(STEPS + 2) for a in ARGV]
    restart = ["--arch", "deepseek-7b", "--model-axis", "4"]
    jobs[8] += [("train", [*restart, *ARGV, "--ckpt-dir", resaved]),
                ("train", [*restart, *more, "--ckpt-dir", again],
                 str(root / "restart.json"))]
    jobs[4] += [("serve", [*SERVE_ARGV, "--model-axis", "2"]),
                ("refused", [*ARGV, "--model-axis", "3"])]
    # the vlm on two data ranks, from its own step-0 checkpoint
    vlm_start = str(root / "vlm-start")
    train.main(["--arch", VLM, "--reduced", "--steps", "0", "--device",
                "cpu", "--ckpt-dir", vlm_start])
    vlm_single, vlm_mesh = str(root / "vlm-single"), str(root / "vlm-mesh")
    shutil.copytree(vlm_start, vlm_single)
    shutil.copytree(vlm_start, vlm_mesh)
    out["vlm"] = dict(
        single=train.main(["--arch", VLM, *ARGV, "--ckpt-dir",
                           vlm_single],
                          mesh=HM.ShapeMesh((2, 1), ("data", "model"))),
        single_dir=vlm_single, mesh_dir=vlm_mesh,
        metrics=str(root / "vlm-2x1.json"))
    out["logs2"] = _jobs([("train", ["--arch", VLM, *ARGV,
                                     "--model-axis", "1", "--ckpt-dir",
                                     vlm_mesh], out["vlm"]["metrics"])],
                         2, str(root / "ranks2"))
    # the (4, 2) checkpoint is copied for the restart jobs once written
    src = out["deepseek-7b", 4, 2]["mesh_dir"]
    jobs[8].insert(len(ARCHS), ("copy", [src, again, resaved]))
    out["adafactor"] = af = _adafactor_runs(root, jobs)
    af_ref_dir = str(root / "reference-4x2-adafactor")
    af_ref = subprocess.Popen([sys.executable, "-c",
                               textwrap.dedent(REFERENCE_RUN),
                               af["deepseek-7b"]["start"], af_ref_dir,
                               str(STEPS), "adafactor"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
    out["logs8"] = _jobs(jobs[8], 8, str(root / "ranks8"))
    out["logs4"] = _jobs(jobs[4], 4, str(root / "ranks4"))
    for arch in ARCHS:
        for R, C in MESH_SHAPES:
            r = out[arch, R, C]
            with open(r["metrics"]) as f:
                r["mesh"] = json.load(f)
    with open(out["vlm"]["metrics"]) as f:
        out["vlm"]["mesh"] = json.load(f)
    out["resaved"] = _restored(resaved, STEPS)
    with open(root / "restart.json") as f:
        out["continued"] = json.load(f)
    for tag, *_ in ADAFACTOR_RUNS:
        with open(af[tag]["metrics"]) as f:
            af[tag]["mesh"] = json.load(f)
    for key, proc, d in (("reference", ref, ref_dir),
                         ("reference-adafactor", af_ref, af_ref_dir)):
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        line = [x for x in stdout.splitlines() if x.startswith("LOSSES")][0]
        out[key] = dict(losses=json.loads(line.split(" ", 1)[1]), dir=d)
    return out


def _losses(metrics):
    return [m["loss"] for m in metrics]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("R,C", MESH_SHAPES)
def test_mesh_train_matches_single_process_of_the_same_g(runs, arch, R, C):
    """Losses and final weights of R * C gloo ranks (data parallel over
    ``data``, the attention heads and MoE experts over ``model``, ZeRO-1)
    against one process under a shape-only (R, C) mesh."""
    r = runs[arch, R, C]
    got, want = _losses(r["mesh"]["metrics"]), r["single"].losses
    assert r["mesh"]["mesh"] == {"data": R, "model": C}
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    mesh_w, single_w = _restored(r["mesh_dir"]), _restored(r["single_dir"])
    assert sorted(mesh_w) == sorted(single_w)
    for k in mesh_w:
        np.testing.assert_allclose(mesh_w[k].numpy(), single_w[k].numpy(),
                                   err_msg=k, **PARAM_TOL)


def test_vlm_mesh_train_matches_single_process(runs):
    """A reduced qwen2-vl on two gloo data ranks at (2, 1): each rank's
    rows of every input, ``positions`` (3, B, S) cut along dim 1 (cut
    along dim 0, 3 rows would not divide over 2 ranks), three steps
    within float32 summation order of one process under a shape-only
    (2, 1) mesh, in losses and final weights."""
    r = runs["vlm"]
    assert r["mesh"]["mesh"] == {"data": 2, "model": 1}
    np.testing.assert_allclose(_losses(r["mesh"]["metrics"]),
                               r["single"].losses, rtol=LOSS_RTOL)
    mesh_w, single_w = _restored(r["mesh_dir"]), _restored(r["single_dir"])
    assert sorted(mesh_w) == sorted(single_w)
    for k in mesh_w:
        np.testing.assert_allclose(mesh_w[k].numpy(), single_w[k].numpy(),
                                   err_msg=k, **PARAM_TOL)


def test_mesh_train_matches_the_reference_mesh_step(runs):
    """deepseek-7b (reduced) on (4, 2): the port's 8 gloo ranks against the
    reference's jitted step under GSPMD on 8 host devices, from one
    checkpoint."""
    r = runs["deepseek-7b", 4, 2]
    ref = runs["reference"]
    np.testing.assert_allclose(_losses(r["mesh"]["metrics"]), ref["losses"],
                               rtol=REF_LOSS_RTOL)
    got = _restored(r["mesh_dir"])
    _, want, _ = JCK.restore(ref["dir"])
    for k in want:
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k].numpy(), want[k],
                                       atol=REF_PARAM_ATOL, rtol=0,
                                       err_msg=k)


def test_elastic_restart_reshards_bit_identically(runs):
    """(4, 2)'s checkpoint restored and placed under (2, 4), then gathered
    and saved again, is bit for bit the same; two more steps give finite
    losses below the first step's."""
    first = _restored(runs["deepseek-7b", 4, 2]["mesh_dir"], STEPS)
    assert sorted(first) == sorted(runs["resaved"])
    for k, v in first.items():
        assert torch.equal(runs["resaved"][k], v), k
    cont = runs["continued"]
    assert cont["start"] == STEPS and cont["mesh"] == {"data": 2, "model": 4}
    losses = _losses(cont["metrics"])
    first_loss = runs["deepseek-7b", 4, 2]["mesh"]["metrics"][0]["loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[-1] < first_loss


def test_sharded_saves_cross_between_the_packages(runs):
    """A checkpoint a (4, 2) mesh of the port wrote reads back bit for bit
    in the reference's restore and unflatten_like; the reference's (4, 2)
    save reads back bit for bit in the port's."""
    import repro.launch.steps as JST
    from repro.configs.base import get_config, reduced
    from repro.optim.adamw import OptConfig as JOpt
    port_dir = runs["deepseek-7b", 4, 2]["mesh_dir"]
    _, jflat, _ = JCK.restore(port_dir)
    flat = _restored(port_dir)
    cfg = dataclasses.replace(reduced(get_config("deepseek-7b")), remat=False)
    template = jax.eval_shape(lambda: dict(zip(
        ("params", "opt"), JST.init_all(cfg, JOpt(), jax.random.PRNGKey(0)))))
    tree = JCK.unflatten_like(template, jflat)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), flat[key].numpy())
    ref_dir = runs["reference"]["dir"]
    _, jflat, _ = JCK.restore(ref_dir)
    flat = _restored(ref_dir)
    assert sorted(jflat) == sorted(flat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(flat[k].numpy(), v)


def test_place_under_a_mesh_cuts_each_ranks_block(runs):
    """``place`` of a restored tree under (2, 4) shardings gives each
    rank the block its coordinates name; the blocks tile the tensor."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.optim.adamw import OptConfig
    flat = _restored(runs["deepseek-7b", 4, 2]["mesh_dir"])
    cfg = dataclasses.replace(reduced(get_config("deepseek-7b")), remat=False)
    shapes = {k[len("params/"):]: v.shape for k, v in flat.items()
              if k.startswith("params/")}
    params = {k: flat["params/" + k] for k in shapes}
    mesh = HM.ShapeMesh((2, 4), ("data", "model"))
    specs = SH.param_specs(cfg, mesh, shapes)
    for r in range(2):
        for c in range(4):
            cell = HM.ShapeMesh((2, 4), ("data", "model"))
            cell.coords, cell.device = {"data": r, "model": c}, "cpu"
            placed = CK.place(params, SH.logical_to_shardings(cell, specs))
            for k, v in placed.items():
                b = SH.shard_bounds(shapes[k], specs[k], cell, cell.coords)
                assert torch.equal(v, params[k][b]), k
    # wq's columns split over model: 4 blocks of a quarter each
    assert specs["layers/attn/wq"][2] == "model"
    _, opt = ST.abstract_state(cfg, OptConfig())
    ospecs = SH.opt_state_specs(cfg, mesh, opt)
    assert ospecs["mu"]["layers/attn/wq"][0] == "data"


def _hold_state(mesh_w, single_w):
    """Every array of two checkpoints: parameters at PARAM_TOL, the
    factors (squares of gradients, far below PARAM_TOL's atol) at its
    rtol with the atol scaled to the array's largest value."""
    assert sorted(mesh_w) == sorted(single_w)
    for k in mesh_w:
        got, want = mesh_w[k].float().numpy(), single_w[k].float().numpy()
        tol = PARAM_TOL
        if k.startswith("opt/fac/"):
            tol = dict(rtol=PARAM_TOL["rtol"],
                       atol=PARAM_TOL["atol"] * float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, err_msg=k, **tol)


@pytest.mark.parametrize("tag", [t for t, *_ in ADAFACTOR_RUNS])
def test_adafactor_mesh_train_matches_single_process(runs, tag):
    """Adafactor on R * C gloo ranks against one process under a
    shape-only (R, C) mesh, from one step-0 checkpoint: losses, final
    weights and the factors (every ``opt/fac`` array).  deepseek-7b at
    (4, 2) (TP columns and rows), phi3.5-moe at (2, 2) (experts over
    ``model``), and kimi-k2 reduced at (2, 2) with the 1 T's paths on:
    its experts' d_model FSDP-sharded over ``data`` (``rfac``'s mean over
    a sharded dim) and the expert stacks updated a layer at a time
    (per-layer RMS)."""
    r = runs["adafactor"][tag]
    R, C = r["shape"]
    assert r["mesh"]["mesh"] == {"data": R, "model": C}
    np.testing.assert_allclose(_losses(r["mesh"]["metrics"]),
                               r["single"].losses, rtol=LOSS_RTOL)
    mesh_w, single_w = _restored(r["mesh_dir"]), _restored(r["single_dir"])
    assert any(k.startswith("opt/fac/") for k in mesh_w)
    assert not any(k.startswith("opt/mu/") for k in mesh_w)
    _hold_state(mesh_w, single_w)


def test_adafactor_mesh_train_matches_the_reference_mesh_step(runs):
    """deepseek-7b (reduced) on (4, 2) with Adafactor: the port's 8 gloo
    ranks against the reference's jitted Adafactor step under GSPMD on 8
    host devices, from one step-0 checkpoint."""
    r = runs["adafactor"]["deepseek-7b"]
    ref = runs["reference-adafactor"]
    np.testing.assert_allclose(_losses(r["mesh"]["metrics"]), ref["losses"],
                               rtol=REF_LOSS_RTOL)
    got = _restored(r["mesh_dir"])
    _, want, _ = JCK.restore(ref["dir"])
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k].numpy(), want[k],
                                       atol=REF_PARAM_ATOL, rtol=0,
                                       err_msg=k)


def test_adafactor_elastic_restart_reshards_bit_identically(runs):
    """An Adafactor checkpoint of (4, 2) restored and placed under (2, 4)
    (each factor's region under the new shape's ``opt_state_specs``),
    then gathered and saved again, is bit for bit the same."""
    first = _restored(runs["adafactor"]["deepseek-7b"]["mesh_dir"], STEPS)
    again = _restored(runs["adafactor"]["resaved"], STEPS)
    assert sorted(first) == sorted(again)
    assert any(k.endswith("/vr") for k in first)
    for k, v in first.items():
        assert torch.equal(again[k], v), k


def test_adafactor_sharded_saves_cross_between_the_packages(runs):
    """An Adafactor checkpoint a (4, 2) mesh of the port wrote reads back
    bit for bit in the reference's restore and ``unflatten_like`` onto
    ``init_opt_state(OptConfig(kind="adafactor"))``; the reference's
    (4, 2) Adafactor save reads back bit for bit in the port's."""
    import repro.launch.steps as JST
    from repro.configs.base import get_config, reduced
    from repro.optim.adamw import OptConfig as JOpt
    port_dir = runs["adafactor"]["deepseek-7b"]["mesh_dir"]
    _, jflat, _ = JCK.restore(port_dir)
    flat = _restored(port_dir)
    cfg = dataclasses.replace(reduced(get_config("deepseek-7b")), remat=False)
    template = jax.eval_shape(lambda: dict(zip(
        ("params", "opt"), JST.init_all(cfg, JOpt(kind="adafactor"),
                                        jax.random.PRNGKey(0)))))
    tree = JCK.unflatten_like(template, jflat)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), flat[key].numpy())
    ref_dir = runs["reference-adafactor"]["dir"]
    _, jflat, _ = JCK.restore(ref_dir)
    flat = _restored(ref_dir)
    assert sorted(jflat) == sorted(flat)
    assert any(k.startswith("opt/fac/") for k in flat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(flat[k].numpy(), v)


@pytest.mark.parametrize("arch", ["musicgen-large", "zamba2-1.2b"])
def test_adafactor_mesh_update_on_one_rank_equals_apply_updates(
        arch, monkeypatch):
    """The mesh's Adafactor (``ShardedLM._adafactor_leaf``) on a (1, 1)
    mesh of one process, whose collectives do nothing, against
    ``optim.adamw.apply_updates`` from the same weights, three steps.
    The chunk threshold at 4096 elements updates musicgen's ``heads`` (3-D
    and not stacked) row by row and zamba2's Mamba leaves (stacked
    ``(n_super, attn_every)``) a leading slice at a time; the update's
    slices of 256 elements sum rows and columns over several slices."""
    from repro_torch.checkpoint import manager as CKM
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.tokens import DataConfig, synth_batch_for
    from repro_torch.distributed import hints, lm_shard
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "_CHUNK_THRESHOLD", 4096)
    monkeypatch.setattr(lm_shard, "_UPDATE_CHUNK", 256)
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=False)
    opt = adamw.OptConfig(**ADAFACTOR)
    mesh = HM.HostMesh(1, 1, "cpu")
    data = DataConfig(seed=0, seq_len=32, global_batch=4)
    hints.activate(mesh)
    try:
        placed = ST.init_placed(cfg, mesh, torch.Generator().manual_seed(0),
                                "cpu")
        placed_state = lm_shard.sharded(placed).init_opt_state(opt)
        whole, state = ST.init_all(cfg, opt,
                                   torch.Generator().manual_seed(0), "cpu")
        step = ST.make_train_step(cfg, opt)
        for s in range(STEPS):
            b = synth_batch_for(cfg, data, s, device="cpu")
            _, placed_state, got = step(placed, placed_state, b)
            _, state, want = step(whole, state, b)
            np.testing.assert_allclose(float(got["loss"]),
                                       float(want["loss"]), rtol=LOSS_RTOL)
        chunked = [v for v in whole.reference_leaves().values()
                   if adamw._chunked(v)]
        assert any(len(v.lead) == (2 if arch == "zamba2-1.2b" else 0)
                   for v in chunked)
        _hold_state(dict(CKM._leaves(ST.state_tree(placed, placed_state))),
                    dict(CKM._leaves(ST.state_tree(whole, state))))
    finally:
        hints.deactivate()


def test_model_axis_must_divide_the_world(runs):
    assert "REFUSED --model-axis 3 does not divide the world of 4" in \
        runs["logs4"]
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        serve.main(["--reduced", "--device", "cpu", "--model-axis", "2"])


def test_mesh_serve_gives_the_single_process_tokens(runs):
    """phi3.5-moe (reduced) served by 4 gloo ranks at (2, 2): each data
    rank generates for its rows (experts over ``model``); rank 0 prints
    the gathered tokens, which equal one process's under a shape-only
    (2, 2) mesh."""
    want = serve.main(SERVE_ARGV, mesh=HM.ShapeMesh((2, 2),
                                                    ("data", "model")))
    line = [x for x in runs["logs4"].splitlines()
            if x.startswith("generated tokens (first row):")][0]
    assert json.loads(line.split(":", 1)[1]) == want[0].tolist()


@pytest.mark.parametrize("arch", [*ARCHS, "zamba2-1.2b"])
def test_placed_init_draws_the_unplaced_models_blocks(arch):
    """``init_placed`` cuts each parameter to the rank's block as its
    layer is drawn: on every cell of (2, 4) the blocks are bit for bit
    those of the unplaced model from the same seed, and the placed model
    keeps the whole shapes for its checkpoints."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.distributed import lm_shard
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    cfg = reduced(get_config(arch))
    whole = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    full = dict(whole.named_parameters())
    for r in range(2):
        for c in range(4):
            cell = HM.ShapeMesh((2, 4), ("data", "model"))
            cell.coords, cell.device = {"data": r, "model": c}, "cpu"
            placed = ST.init_placed(cfg, cell, torch.Generator().manual_seed(0),
                                    "cpu")
            specs = lm_shard.member_specs(cfg, cell, whole)
            for name, p in placed.named_parameters():
                assert torch.equal(p, SH.local_shard(
                    full[name], specs[name][1], cell)), name
            assert any(p.numel() < full[n].numel()
                       for n, p in placed.named_parameters())
            lm = lm_shard.sharded(placed)
            assert lm.full_shapes == {k: v.shape for k, v in
                                      whole.reference_leaves().items()}
