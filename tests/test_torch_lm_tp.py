"""The LM on a live ``(data, model)`` mesh in the reference's
tensor-parallel layout: four gloo CPU ranks run reduced configs at
(2, 2) and (1, 4).

  * no rank gathers a whole ``model``-split weight in a train, prefill or
    decode step (every ``sharding.gather_shard`` call inside
    ``ShardedLM.call`` is recorded by parameter), the Mamba2 mixer's
    (mamba2, zamba2) included: only the FSDP expert axis (kimi-k2 with
    its threshold at 0) is gathered;
  * each rank's KV cache is ``cache_specs``' block under the decode
    layout, in both layouts: KV heads over ``model`` (deepseek-7b, KV 4)
    and the sequence over ``model`` (phi3.5-moe, KV 1); its ``ssm`` cache
    its heads and its ``conv`` cache its block of the concatenated ``[x |
    b | c]`` channels (mamba2, zamba2; at (1, 4) blocks of 40 of 160,
    which cross the streams' boundaries), holding one process's values;
  * the Mamba2 mixer whose heads a model axis does not divide (mamba2
    with one head) runs every head from the gathered columns and serves
    and differentiates as one process;
  * greedy tokens and logits on both meshes equal one process's under a
    shape-only mesh of the same shape (tokens exactly, logits within
    float32 summation order: rtol 1e-4, atol 1e-5) and the reference's
    jitted prefill and decode under GSPMD on four host devices from the
    same weights (tokens exactly, logits atol 5e-5: two compilers'
    float32 products);
  * the vocabulary-parallel greedy pick takes the lowest id on planted
    ties, as ``jnp.argmax``;
  * the vocabulary-parallel loss (the audio family's per codebook, the
    vlm's with image embeddings entering on one ``model`` rank) equals
    ``loss_fn`` on one process within float32 order (rtol 1e-5).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.base import cache_specs, get_config, meta_spec, \
    reduced
from repro_torch.distributed import hints, spmd
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as HM
from repro_torch.launch import steps as ST
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 2), (1, 4))
SERVE_ARCHS = ("deepseek-7b", "phi3.5-moe-42b-a6.6b")
#: the Mamba2 families: served from the reference's weights, as SERVE_ARCHS
SSM_ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
#: mamba2 with one head (a model axis of 2 or 4 does not divide it: the
#: mixer runs every head on every rank), served and differentiated from
#: seed 0 against one process
WHOLE_HEADS = "mamba2-2.7b+whole-heads"
VARIANTS = {WHOLE_HEADS: ("mamba2-2.7b", dict(ssm_head_dim=128))}
#: (arch, FSDP_PARAM_THRESHOLD or None, --layers or None)
STEP_ARCHS = (("deepseek-7b", None, None), ("phi3.5-moe-42b-a6.6b", None,
                                            None),
              ("zamba2-1.2b", None, None), ("kimi-k2-1t-a32b", 0, 3),
              ("mamba2-2.7b", None, None))
LOSS_ARCHS = ("deepseek-7b", "musicgen-large", "qwen2-vl-7b")
#: every family's blocks: SP attention and MLP (deepseek), MQA with
#: gathered k, v and the MoE (phi3.5), learned positions, LayerNorm and
#: GELU (granite), per-codebook heads (musicgen), image embeddings, QKV
#: biases and M-RoPE (qwen2-vl), the hybrid's stream gathered whole for
#: its Mamba blocks (f / g) and its shared block (zamba2), the Mamba2
#: mixer's column blocks, gathered b and c, norm sums and replicated small
#: leaves on the split stream (mamba2) and with every head on every rank
#: (mamba2 with one head), shared experts and a dense prefix (kimi)
GRAD_ARCHS = ("deepseek-7b", "phi3.5-moe-42b-a6.6b", "granite-34b",
              "musicgen-large", "qwen2-vl-7b", "zamba2-1.2b",
              "kimi-k2-1t-a32b", "mamba2-2.7b", WHOLE_HEADS)
#: the whole gradient of the ranks against one process's, per leaf:
#: float32 summation order, the atol scaled by the leaf's largest entry
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
#: bf16 on (1, 2): one process under the shape-only mesh is the tensor-
#: parallel run's counterpart to the last bit (no data-parallel sums)
BITWISE_ARCHS = ("deepseek-7b", "qwen1.5-4b", "mamba2-2.7b", "zamba2-1.2b")
#: but the embedding's gradient, which its lookup's backward accumulates
#: over repeated ids in another order: within a few bf16 ulps
EMBED_RTOL = 2e-2
BATCH, PROMPT, GEN, S_MAX = 4, 16, 6, 24
#: the ranks' generation budget: P + GEN, which a sequence-split cache
#: rounds up to a multiple of C (22 -> 24 at C = 4)
GEN_S_MAX = 22
SEQ, GLOBAL_BATCH = 32, 8
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
REF_LOGIT_ATOL = 5e-5
LOSS_RTOL = 1e-5
RANK_ENV = {"OMP_NUM_THREADS": "1"}

#: planted ties for the greedy pick over V = 16 (four ids a rank at
#: (1, 4)): across ranks, within a rank, everywhere
TIES = np.array([[0, 1, 7, 0, 0, 0, 0, 0, 0, 7, 0, 0, 0, 0, 0, 0],
                 [0, 0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 3, 0, 0],
                 [0, 0, 0, 0, 0, 9, 9, 0, 0, 0, 0, 0, 0, 0, 0, 9],
                 [2] * 16], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REFERENCE_SERVE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from repro.checkpoint import manager as CK
from repro.configs.base import get_config, reduced
from repro.distributed import hints, sharding as SH
from repro.launch import steps as ST
from repro.launch.serve import pad_cache
from repro.models import transformer as T
from repro.optim.adamw import OptConfig

out_dir = sys.argv[1]
archs, meshes = sys.argv[2].split(","), sys.argv[3].split(",")
B, P, GEN, S_MAX = map(int, sys.argv[4:8])
for arch in archs:
    cfg = reduced(get_config(arch))
    params, opt_state = ST.init_all(cfg, OptConfig(), jax.random.PRNGKey(0))
    CK.save(f"{out_dir}/{arch}", 0, {"params": params, "opt": opt_state},
            meta={"arch": cfg.name})
open(f"{out_dir}/SAVED", "w").close()
for arch in archs:
    cfg = reduced(get_config(arch))
    params, opt_state = ST.init_all(cfg, OptConfig(), jax.random.PRNGKey(0))
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)), jnp.int32)
    for shape in meshes:
        R, C = map(int, shape.split("x"))
        mesh = compat.make_mesh((R, C), ("data", "model"))
        hints.activate(mesh)
        prefill = jax.jit(lambda p, b: T.prefill(cfg, p, b))
        decode = jax.jit(lambda p, b: T.decode_step(cfg, p, b))
        toks, logs = [], []
        with mesh:
            placed = CK.place(params, SH.logical_to_shardings(
                mesh, SH.param_specs(cfg, mesh, params)))
            logits, cache = prefill(placed, {"tokens": prompts})
            cache = pad_cache(cache, S_MAX)
            for i in range(GEN):
                tok = jnp.argmax(logits[:, -1], axis=-1).astype(
                    jnp.int32)[:, None]
                toks.append(np.asarray(tok))
                logs.append(np.asarray(logits[:, -1], np.float32))
                if i == GEN - 1:
                    break
                logits, cache = decode(placed, dict(
                    tokens=tok, cache=cache,
                    cache_index=jnp.asarray(P + i, jnp.int32)))
                cache.pop("index")
        hints.deactivate()
        np.savez(f"{out_dir}/{arch}-{shape}.npz",
                 tokens=np.concatenate(toks, 1), logits=np.stack(logs, 1))
print("REFERENCE DONE", flush=True)
"""

#: one rank: joins the group once, runs each job on a (4 / C, C) mesh and
#: writes its own results (``<out>-rank<k>.json``)
RANK_JOBS = """
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.tokens import DataConfig, synth_batch_for
from repro_torch.distributed import hints, lm_shard, spmd
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as HM
from repro_torch.launch import steps as ST
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig
torch.set_num_threads(1)
spmd.join_process_group("gloo", torch.device("cpu"))
rank = dist.get_rank()
calls, names, state = [], {}, {"on": False}
gather = SH.gather_shard


def recorded(t, spec, mesh):
    if state["on"] and any(e is not None for e in spec):
        calls.append([names.get(t.data_ptr(), "?"),
                      [list(SH._axes_of(e)) for e in spec]])
    return gather(t, spec, mesh)


SH.gather_shard = recorded
call = lm_shard.ShardedLM.call


def recording_call(self, fn, *args):
    state["on"] = True
    try:
        return call(self, fn, *args)
    finally:
        state["on"] = False


lm_shard.ShardedLM.call = recording_call
args = json.load(open(sys.argv[1]))
out = {}
default_threshold = SH.FSDP_PARAM_THRESHOLD
for job in args["jobs"]:
    kind, arch, C = job["kind"], job["arch"], job["C"]
    mesh = HM.make_host_mesh(C, "cpu")
    hints.activate(mesh)
    SH.FSDP_PARAM_THRESHOLD = job.get("threshold", default_threshold)
    name, change = args["variants"].get(arch, (arch, {}))
    cfg = dataclasses.replace(reduced(get_config(name)), **change)
    if job.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=job["layers"])
    if job.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=job["dtype"])
    params = ST.init_placed(cfg, mesh, torch.Generator().manual_seed(0),
                            "cpu")
    sharded = lm_shard.sharded(params)
    key = f"{kind}/{arch}/{C}" + (f"/{job['dtype']}" if job.get("dtype")
                                  else "")
    if kind == "serve":
        if job.get("ckpt"):
            state_ = sharded.init_opt_state(OptConfig())
            ST.restore_state(job["ckpt"], params, state_)
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (args["batch"], args["prompt"])),
            dtype=torch.int32)
        local = sharded.shard_batch({"tokens": prompts})["tokens"]
        toks, logits, _ = generate(cfg, params, local, args["gen"],
                                   s_max=args["gen_s_max"])
        logits = torch.stack(logits, 1)
        if logits.shape[-1] != cfg.vocab_size:
            logits = mesh.all_gather(logits, "model", 2)
        toks = mesh.all_gather(toks, "data", 0)
        logits = mesh.all_gather(logits, "data", 0)
        _, cache = ST.make_prefill(cfg)(params, {"tokens": local},
                                        s_max=args["s_max"])
        out[key] = dict(tokens=toks.tolist(), logits=logits.tolist(),
                        cache={k: list(v.shape) for k, v in cache.items()},
                        states={k: cache[k].tolist() for k in ("ssm", "conv")
                                if k in cache},
                        coords=mesh.coords,
                        positions=T.cache_positions(cfg, args["gen_s_max"]))
    elif kind == "steps":
        names.clear()
        names.update({p.data_ptr(): n for n, p in params.named_parameters()})
        calls.clear()
        opt = OptConfig()
        b = synth_batch_for(cfg, DataConfig(seq_len=args["seq"],
                                            global_batch=args["global_batch"]),
                            0, device="cpu")
        state_ = sharded.init_opt_state(opt)
        ST.make_train_step(cfg, opt)(params, state_, b)
        train_calls = list(calls)
        calls.clear()
        local = sharded.shard_batch({"tokens": b["tokens"]})
        _, cache = ST.make_prefill(cfg)(params, local, s_max=args["seq"] + 4)
        prefill_calls = list(calls)
        calls.clear()
        ST.make_serve_step(cfg)(params, dict(
            tokens=local["tokens"][:, -1:], cache=cache,
            cache_index=args["seq"]))
        out[key] = dict(train=train_calls, prefill=prefill_calls,
                        decode=list(calls),
                        over_model=[n for n, s in sharded.gathers.items()
                                    if any("model" in SH._axes_of(e)
                                           for e in s)])
    elif kind == "loss":
        b = synth_batch_for(cfg, DataConfig(seq_len=args["seq"],
                                            global_batch=args["global_batch"]),
                            0, device="cpu")
        with torch.no_grad():
            loss = sharded.call(lambda m, x: T.loss_fn(cfg, m, x)[1]["loss"],
                                sharded.shard_batch(b))
        out[key] = float(mesh.all_reduce(loss.clone(), ("data",)))
    elif kind == "grads":
        b = synth_batch_for(cfg, DataConfig(seq_len=args["seq"],
                                            global_batch=args["global_batch"]),
                            0, device="cpu")

        def loss_and_grads(m, x):
            total, _ = T.loss_fn(cfg, m, x)
            return torch.autograd.grad(total, sharded.flat, allow_unused=True)

        grads = iter(sharded.call(loss_and_grads, sharded.shard_batch(b)))
        whole = {}
        for path, leaf in params.reference_leaves().items():
            spec = SH.P(*sharded.specs[path][len(leaf.lead):])
            gs = [next(grads) for _ in leaf.members]
            gs = [torch.zeros_like(m) if g is None else g
                  for m, g in zip(leaf.members, gs)]
            whole[path] = torch.stack([SH.gather_shard(g, spec, mesh)
                                       for g in gs]).reshape(
                sharded.full_shapes[path])
        if rank == 0:
            torch.save(whole, f"{args['out']}-grads-{key.replace('/', '-')}"
                       ".pt")
        out[key] = sorted(whole)
    elif kind == "argmax":
        ties = torch.as_tensor(args["ties"])
        vl = ties.shape[1] // C
        block = ties[:, mesh.coords["model"] * vl:][:, :vl].contiguous()
        out[key] = hints.vocab_argmax(block, ties.shape[1]).tolist()
    hints.deactivate()
    SH.FSDP_PARAM_THRESHOLD = default_threshold
with open(f"{args['out']}-rank{rank}.json", "w") as f:
    json.dump(out, f)
print("RANK DONE", flush=True)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's mesh serving (a subprocess of four host devices,
    which also writes the weights' checkpoints) overlapping one spawn of
    four gloo ranks that runs every job of both meshes; returns each
    rank's results and the reference's directory."""
    root = tmp_path_factory.mktemp("lm_tp")
    ref_dir = str(root / "reference")
    os.makedirs(ref_dir)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    shapes = ",".join(f"{R}x{C}" for R, C in MESHES)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE_SERVE), ref_dir,
         ",".join(SERVE_ARCHS + SSM_ARCHS), shapes, str(BATCH), str(PROMPT),
         str(GEN),
         str(S_MAX)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    jobs = []
    for _, C in MESHES:
        for arch, threshold, layers in STEP_ARCHS:
            job = dict(kind="steps", arch=arch, C=C)
            if threshold is not None:
                job.update(threshold=threshold, layers=layers)
            jobs.append(job)
        jobs += [dict(kind="loss", arch=a, C=C) for a in LOSS_ARCHS]
        jobs += [dict(kind="grads", arch=a, C=C) for a in GRAD_ARCHS]
        jobs.append(dict(kind="argmax", arch="deepseek-7b", C=C))
    for _, C in MESHES:
        jobs += [dict(kind="serve", arch=a, C=C,
                      ckpt=os.path.join(ref_dir, a))
                 for a in SERVE_ARCHS + SSM_ARCHS]
        jobs.append(dict(kind="serve", arch=WHOLE_HEADS, C=C))
    deadline = time.monotonic() + 300
    while not os.path.exists(os.path.join(ref_dir, "SAVED")):
        assert ref.poll() is None, ref.communicate()[1][-3000:]
        assert time.monotonic() < deadline, "the reference saved nothing"
        time.sleep(0.2)
    path = root / "jobs.json"
    out = str(root / "out")
    path.write_text(json.dumps(dict(
        jobs=jobs, out=out, batch=BATCH, prompt=PROMPT, gen=GEN, s_max=S_MAX,
        variants=VARIANTS,
        gen_s_max=GEN_S_MAX,
        seq=SEQ, global_batch=GLOBAL_BATCH, ties=TIES.tolist())))
    spmd.launch(["-c", RANK_JOBS, str(path)], 4, str(root / "ranks"),
                deadline_s=240.0, env=RANK_ENV)
    # bf16 on (1, 2): tensor parallelism alone, against one process
    bf16 = root / "jobs-bf16.json"
    bf16.write_text(json.dumps(dict(
        jobs=[dict(kind="grads", arch=a, C=2, dtype="bfloat16")
              for a in BITWISE_ARCHS], out=out + "-2", variants=VARIANTS,
        seq=SEQ, global_batch=GLOBAL_BATCH)))
    spmd.launch(["-c", RANK_JOBS, str(bf16)], 2, str(root / "ranks2"),
                deadline_s=240.0, env=RANK_ENV)
    stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0, stderr[-3000:]
    ranks = [json.loads(open(f"{out}-rank{k}.json").read()) for k in range(4)]
    return dict(ranks=ranks, reference=ref_dir, out=out)


def _cfg(arch):
    """The reduced config ``arch`` (a VARIANTS entry's change applied)."""
    name, change = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(reduced(get_config(name)), **change)


def _single(arch, R, C, fn):
    """``fn(cfg)`` on one process under a shape-only (R, C) mesh."""
    hints.activate(HM.ShapeMesh((R, C), ("data", "model")))
    try:
        return fn(_cfg(arch))
    finally:
        hints.deactivate()


def _whole_from(ckpt, cfg):
    """A whole model and optimizer state restored from a checkpoint."""
    params, state = ST.init_all(cfg, OptConfig(),
                                torch.Generator().manual_seed(0), "cpu")
    ST.restore_state(ckpt, params, state)
    return params


@pytest.mark.parametrize("R,C", MESHES)
@pytest.mark.parametrize("arch,threshold,layers", STEP_ARCHS,
                         ids=[a for a, *_ in STEP_ARCHS])
def test_no_rank_gathers_a_model_split_weight(runs, arch, threshold, layers,
                                              R, C):
    """Inside ``ShardedLM.call`` of a train, a prefill and a decode step,
    every rank's ``gather_shard`` calls by parameter: none for the dense,
    MoE, ssm and hybrid models (the Mamba2 mixer's leaves included); over
    ``data`` only the FSDP expert weights; over ``model`` none."""
    for rank in runs["ranks"]:
        got = rank[f"steps/{arch}/{C}"]
        assert not got["over_model"]
        for step in ("train", "prefill", "decode"):
            for name, spec in got[step]:
                axes = {a for entry in spec for a in entry}
                leaf = name.split(".")[-1]
                expert = ".moe." in name and ".shared." not in name and \
                    leaf in ("wi_gate", "wi_up", "wo")
                assert expert and axes == {"data"}, (step, name, spec)
            names = {n for n, _ in got[step]}
            if threshold is not None:
                assert names and all(".moe." in n for n in names), step
            else:
                assert not names, (step, names)


@pytest.mark.parametrize("R,C", MESHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_kv_cache_is_the_cache_specs_block(runs, arch, R, C):
    """Each rank's prefill cache of S_MAX positions has the shape of its
    block of ``cache_specs`` under ``batch_layout``'s decode spec: KV
    heads over ``model`` for deepseek-7b (KV 4), positions over ``model``
    for phi3.5-moe (KV 1), so it holds 1/C of a data rank's cache."""
    cfg = reduced(get_config(arch))
    mesh = HM.ShapeMesh((R, C), ("data", "model"))
    whole = cache_specs(cfg, BATCH, S_MAX, meta_spec, cfg.torch_dtype)
    specs = SH.batch_layout(cfg, mesh, "decode", BATCH)["cache"]
    kv_split = cfg.n_kv_heads % C == 0
    assert (specs["k"][3] == "model") == kv_split
    assert (specs["k"][2] == "model") == (not kv_split)
    for rank in runs["ranks"]:
        got = rank[f"serve/{arch}/{C}"]
        for k in ("k", "v"):
            b = SH.shard_bounds(tuple(whole[k].shape), specs[k], mesh,
                                got["coords"])
            assert got["cache"][k] == [s.stop - s.start for s in b], k


@pytest.mark.parametrize("R,C", MESHES)
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_caches_are_the_cache_specs_block(runs, arch, R, C):
    """Each rank's prefill ``ssm`` and ``conv`` caches are its blocks of
    ``cache_specs`` under ``batch_layout``'s decode spec (its heads; its
    ``C_tot / C`` contiguous channels of ``[x | b | c]``), and hold the
    values of one process's whole cache there (same weights, prompts)."""
    cfg = reduced(get_config(arch))
    mesh = HM.ShapeMesh((R, C), ("data", "model"))
    whole = cache_specs(cfg, BATCH, S_MAX, meta_spec, cfg.torch_dtype)
    specs = SH.batch_layout(cfg, mesh, "decode", BATCH)["cache"]
    assert specs["ssm"][2] == "model" and specs["conv"][3] == "model"
    ckpt = os.path.join(runs["reference"], arch)

    def one(cfg):
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (BATCH, PROMPT)), dtype=torch.int32)
        _, cache = ST.make_prefill(cfg)(_whole_from(ckpt, cfg),
                                        {"tokens": prompts}, s_max=S_MAX)
        return cache

    want = _single(arch, R, C, one)
    for rank in runs["ranks"]:
        got = rank[f"serve/{arch}/{C}"]
        for k in ("ssm", "conv"):
            b = SH.shard_bounds(tuple(whole[k].shape), specs[k], mesh,
                                got["coords"])
            assert got["cache"][k] == [s.stop - s.start for s in b], k
            np.testing.assert_allclose(np.asarray(got["states"][k]),
                                       want[k][b].numpy(), err_msg=k,
                                       **LOGIT_TOL)


@pytest.mark.parametrize("R,C", MESHES)
def test_whole_heads_mixer_serves_as_one_process(runs, R, C):
    """mamba2 with one head on a model axis of 2 or 4: its ``wz wx wb wc``
    and ``out_proj`` stay in their blocks, every rank runs the head from
    the gathered columns, its ``ssm`` cache is whole and its ``conv``
    cache ``cache_specs``' block; tokens and logits equal one process's
    under the shape-only mesh and one process's off a mesh, whose mixer
    runs every channel in one block (seed-0 weights)."""
    cfg = _cfg(WHOLE_HEADS)
    assert cfg.ssm_heads % C
    mesh = HM.ShapeMesh((R, C), ("data", "model"))
    specs = SH.batch_layout(cfg, mesh, "decode", BATCH)["cache"]
    assert specs["ssm"][2] is None and specs["conv"][3] == "model"

    def one(cfg):
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (BATCH, PROMPT)), dtype=torch.int32)
        toks, logits, _ = generate(cfg, params, prompts, GEN, s_max=S_MAX)
        return toks.numpy(), torch.stack(logits, 1).numpy()

    want_t, want_l = _single(WHOLE_HEADS, R, C, one)
    off_t, off_l = one(cfg)
    np.testing.assert_array_equal(want_t, off_t)
    np.testing.assert_allclose(want_l, off_l, **LOGIT_TOL)
    whole = cache_specs(cfg, BATCH, S_MAX, meta_spec, cfg.torch_dtype)
    for rank in runs["ranks"]:
        got = rank[f"serve/{WHOLE_HEADS}/{C}"]
        for k in ("ssm", "conv"):
            b = SH.shard_bounds(tuple(whole[k].shape), specs[k], mesh,
                                got["coords"])
            assert got["cache"][k] == [s.stop - s.start for s in b], k
        np.testing.assert_array_equal(np.asarray(got["tokens"]), want_t)
        np.testing.assert_allclose(np.asarray(got["logits"], np.float32),
                                   want_l, **LOGIT_TOL)
        np.testing.assert_array_equal(np.asarray(got["tokens"]), off_t)
        np.testing.assert_allclose(np.asarray(got["logits"], np.float32),
                                   off_l, **LOGIT_TOL)


@pytest.mark.parametrize("R,C", MESHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS + SSM_ARCHS)
def test_mesh_serving_equals_one_process_and_the_reference(runs, arch, R,
                                                           C):
    """Greedy tokens and every step's logits of the four ranks (logits
    gathered over ``model`` and ``data``) equal one process's under a
    shape-only (R, C) mesh from the same checkpoint, and the reference's
    mesh prefill and decode steps from the weights it wrote."""
    ckpt = os.path.join(runs["reference"], arch)

    def one(cfg):
        params = _whole_from(ckpt, cfg)
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (BATCH, PROMPT)), dtype=torch.int32)
        toks, logits, _ = generate(cfg, params, prompts, GEN, s_max=S_MAX)
        return toks.numpy(), torch.stack(logits, 1).numpy()

    want_t, want_l = _single(arch, R, C, one)
    ref = np.load(os.path.join(runs["reference"], f"{arch}-{R}x{C}.npz"))
    np.testing.assert_array_equal(want_t, ref["tokens"])
    np.testing.assert_allclose(want_l, ref["logits"], rtol=0,
                               atol=REF_LOGIT_ATOL)
    for rank in runs["ranks"]:
        got = rank[f"serve/{arch}/{C}"]
        np.testing.assert_array_equal(np.asarray(got["tokens"]), want_t)
        np.testing.assert_allclose(np.asarray(got["logits"], np.float32),
                                   want_l, **LOGIT_TOL)


@pytest.mark.parametrize("C", [C for _, C in MESHES])
def test_vocab_argmax_takes_the_lowest_id_on_a_tie(runs, C):
    """Planted ties across ranks' vocabulary blocks, within one block and
    over every id: each rank's pick is ``jnp.argmax``'s."""
    want = np.asarray(jnp.argmax(jnp.asarray(TIES), axis=-1)).tolist()
    assert want == [2, 6, 5, 0]
    for rank in runs["ranks"]:
        assert rank[f"argmax/deepseek-7b/{C}"] == want


@pytest.mark.parametrize("R,C", MESHES)
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_vocab_parallel_loss_equals_one_process(runs, arch, R, C):
    """The loss of the four ranks (each data rank's share, summed) with the
    vocabulary-parallel cross entropy equals ``loss_fn`` of the whole
    batch on one process under a shape-only (R, C) mesh, the same
    weights (seed 0)."""
    from repro_torch.data.tokens import DataConfig, synth_batch_for

    def one(cfg):
        model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        b = synth_batch_for(cfg, DataConfig(seq_len=SEQ,
                                            global_batch=GLOBAL_BATCH),
                            0, device="cpu")
        with torch.no_grad():
            return float(T.loss_fn(cfg, model, b)[1]["loss"])

    want = _single(arch, R, C, one)
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank[f"loss/{arch}/{C}"], want,
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("C", [C for _, C in MESHES])
@pytest.mark.parametrize("arch", SERVE_ARCHS + SSM_ARCHS)
def test_cache_positions_round_up_where_the_sequence_splits(runs, arch, C):
    """The ranks generated with a budget of 22 positions: a cache that
    splits the sequence (phi3.5-moe, KV 1) rounds it up to a multiple of
    C, one that splits KV heads keeps it, and so do the ssm and hybrid
    families (their ``ssm`` and ``conv`` caches hold no positions; zamba2's
    KV part splits its heads); one process and the reference use 24 and
    give the same tokens (the test above)."""
    split = reduced(get_config(arch)).n_kv_heads % C != 0
    want = -(-GEN_S_MAX // C) * C if split else GEN_S_MAX
    for rank in runs["ranks"]:
        assert rank[f"serve/{arch}/{C}"]["positions"] == want
    hints.activate(HM.ShapeMesh((1, C), ("data", "model")))
    try:
        assert T.cache_positions(reduced(get_config(arch)),
                                 GEN_S_MAX) == GEN_S_MAX
    finally:
        hints.deactivate()


@pytest.mark.parametrize("R,C", MESHES)
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_mesh_gradients_equal_one_process(runs, arch, R, C):
    """The gradient of the whole batch's loss from the four ranks (each
    leaf's blocks gathered whole) against one process's under a
    shape-only (R, C) mesh, leaf by leaf: the Megatron-SP pair's
    backward, Megatron's ``f`` / ``g``, the norms' sums over ``model`` on
    a split stream and the vocabulary-parallel cross entropy's backward
    (Adam's steps hide a gradient scaled per leaf; this does not)."""
    from repro_torch.data.tokens import DataConfig, synth_batch_for
    got = torch.load(f"{runs['out']}-grads-grads-{arch}-{C}.pt")

    def one(cfg):
        model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        b = synth_batch_for(cfg, DataConfig(seq_len=SEQ,
                                            global_batch=GLOBAL_BATCH),
                            0, device="cpu")
        leaves = model.reference_leaves()
        flat = [p for leaf in leaves.values() for p in leaf.members]
        total, _ = T.loss_fn(cfg, model, b)
        grads = iter(torch.autograd.grad(total, flat, allow_unused=True))
        out = {}
        for path, leaf in leaves.items():
            gs = [next(grads) for _ in leaf.members]
            out[path] = leaf.stack([torch.zeros_like(m) if g is None else g
                                    for m, g in zip(leaf.members, gs)])
        return out

    want = _single(arch, R, C, one)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = w.detach().numpy()
        np.testing.assert_allclose(
            got[path].numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(float(np.abs(w).max()), 1e-30),
            err_msg=path)


@pytest.mark.parametrize("arch", BITWISE_ARCHS)
def test_shape_mesh_process_is_the_tp_run_bit_for_bit(runs, arch):
    """In bf16 on (1, 2), two gloo ranks' gradient (gathered whole) equals
    one process's under a shape-only (1, 2) mesh bit for bit, leaf by
    leaf: that process runs each rank's column, head, row and vocabulary
    blocks and sums them in rank order in float32 (``hints.shape_blocks``),
    so a mesh run's gaps to it are its data-parallel sums alone.  The
    embedding's gradient is held within EMBED_RTOL."""
    from repro_torch.data.tokens import DataConfig, synth_batch_for
    got = torch.load(f"{runs['out']}-2-grads-grads-{arch}-2-bfloat16.pt")

    def one(cfg):
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        b = synth_batch_for(cfg, DataConfig(seq_len=SEQ,
                                            global_batch=GLOBAL_BATCH),
                            0, device="cpu")
        leaves = model.reference_leaves()
        flat = [p for leaf in leaves.values() for p in leaf.members]
        total, _ = T.loss_fn(cfg, model, b)
        grads = iter(torch.autograd.grad(total, flat, allow_unused=True))
        return {path: leaf.stack([next(grads) for _ in leaf.members])
                for path, leaf in leaves.items()}

    want = _single(arch, 1, 2, one)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if path == "embed":
            np.testing.assert_allclose(got[path].float().numpy(),
                                       w.float().numpy(), rtol=EMBED_RTOL,
                                       atol=0, err_msg=path)
            continue
        assert torch.equal(got[path], w), path
