"""The port's sharding rules (``repro_torch/distributed/sharding.py``) against
the reference's, spec for spec, with no devices.

The reference's ``param_spec``, ``param_specs``, ``opt_state_specs`` and
``batch_specs`` read only ``mesh.axis_names`` and ``mesh.shape``, so both
packages are given a shape-only mesh: every registered config of the port,
on the production meshes (16, 16) and (2, 16, 16) with ``pod`` and the
host meshes (4, 2) and (2, 4), over the reference's stacked parameter
shapes (``jax.eval_shape``) and the port's (``Transformer`` on ``meta``).
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jbase
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch.configs import base
from repro_torch.distributed import hints
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as HM
from repro_torch.launch import steps as ST
from repro_torch.optim.adamw import OptConfig

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
}


class _Mesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _norm(spec, ndim=None):
    """A spec as a tuple with one-axis tuples as names, padded with None
    to ``ndim``."""
    parts = [e[0] if isinstance(e, tuple) and len(e) == 1 else
             (tuple(e) if isinstance(e, tuple) else e) for e in spec]
    if ndim is not None:
        parts += [None] * (ndim - len(parts))
    return tuple(parts)


def _ref_path(path) -> str:
    parts = []
    for p in path:
        k = getattr(p, "key", getattr(p, "idx", p))
        parts.append(f"#{k}" if isinstance(k, int) else str(k))
    return "/".join(parts)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = jbase.get_config(arch)
    params = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))
    opt = jax.eval_shape(lambda: JA.init_opt_state(JA.OptConfig(), params))
    return cfg, params, opt


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    cfg = base.get_config(arch)
    params, opt = ST.abstract_state(cfg, OptConfig())
    return cfg, {k: leaf.shape for k, leaf in
                 params.reference_leaves().items()}, opt


def _flat_specs(tree, shapes):
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    shape_of = {_ref_path(p): s.shape for p, s in
                jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for path, spec in leaves:
        key = _ref_path(path)
        out[key] = _norm(spec, len(shape_of[key]))
    return out


CASES = [(arch, m) for arch in base.PORTED for m in MESHES]


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_param_specs_equal_reference(arch, mesh_name):
    mesh = _Mesh(*MESHES[mesh_name])
    jcfg, jparams, _ = _ref_shapes(arch)
    cfg, shapes, _ = _port_shapes(arch)
    want = _flat_specs(JSH.param_specs(jcfg, mesh, jparams), jparams)
    got = {k: _norm(v, len(shapes[k]))
           for k, v in SH.param_specs(cfg, mesh, shapes).items()}
    assert got == want


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_opt_state_specs_equal_reference(arch, mesh_name):
    mesh = _Mesh(*MESHES[mesh_name])
    jcfg, _, jopt = _ref_shapes(arch)
    cfg, _, opt = _port_shapes(arch)
    want = _flat_specs(JSH.opt_state_specs(jcfg, mesh, jopt), jopt)
    got_tree = SH.opt_state_specs(cfg, mesh, opt)
    got = {}
    for kind in ("mu", "nu"):
        for k, v in got_tree[kind].items():
            got[f"{kind}/{k}"] = _norm(v, opt[kind][k].dim())
    got["step"] = _norm(got_tree["step"], 0)
    assert got == want


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_batch_specs_equal_reference(arch, mesh_name):
    mesh = _Mesh(*MESHES[mesh_name])
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
    shapes = [s for s in base.SHAPES if cfg.supports(s)]
    assert shapes == [s for s in jbase.SHAPES if jcfg.supports(s)]
    for shape in shapes:
        want = jax.tree.map(_norm, JSH.batch_specs(jcfg, mesh, shape),
                            is_leaf=lambda x: isinstance(x, JP))
        got = {k: ({kk: _norm(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else _norm(v))
               for k, v in SH.batch_specs(cfg, mesh, shape).items()}
        assert got == want, shape


@pytest.mark.parametrize("arch,path,mesh_name,want", [
    # the hybrid's Mamba layers stack two dims, its tail one
    ("zamba2-1.2b", "layers/mamba/wx", "16x16", (None, None, None, "model")),
    ("zamba2-1.2b", "tail/mamba/wx", "16x16", (None, None, "model")),
    # qwen1.5-4b's 20 heads: 20 * 128 columns still divide 16
    ("qwen1.5-4b", "layers/attn/wq", "16x16", (None, None, "model")),
    ("qwen1.5-4b", "layers/attn/bq", "16x16", (None, "model")),
    # granite's multi-query KV (one head, 128 columns) divides 16 and
    # shards; where the model axis does not divide it, it stays whole
    # (test_granite_kv_replicates_where_it_does_not_divide)
    ("granite-34b", "layers/attn/wk", "16x16", (None, None, "model")),
    # kimi-k2 FSDP-shards its experts' d_model over the batch axes
    ("kimi-k2-1t-a32b", "layers/moe/wi_gate", "16x16",
     (None, "model", "data", None)),
    ("kimi-k2-1t-a32b", "layers/moe/wi_gate", "2x16x16",
     (None, "model", ("pod", "data"), None)),
    ("phi3.5-moe-42b-a6.6b", "layers/moe/wi_gate", "16x16",
     (None, "model", None, None)),
])
def test_named_cases(arch, path, mesh_name, want):
    mesh = HM.ShapeMesh(*MESHES[mesh_name])
    cfg, shapes, _ = _port_shapes(arch)
    got = SH.param_specs(cfg, mesh, shapes)[path]
    assert _norm(got, len(shapes[path])) == want


def test_granite_kv_replicates_where_it_does_not_divide():
    cfg = base.get_config("granite-34b")
    hd = cfg.resolved_head_dim
    mesh = HM.ShapeMesh((1, 3), ("data", "model"))
    assert (cfg.n_kv_heads * hd) % 3
    assert SH.param_spec(cfg, mesh, "attn/wk", (cfg.d_model,
                                                cfg.n_kv_heads * hd)) \
        == (None, None)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_and_blocks(mesh_name):
    """Placements follow the spec (pod the major axis of a shared dim), and
    every cell's block of a tensor tiles it exactly once."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = HM.ShapeMesh(*MESHES[mesh_name])
    names = mesh.axis_names
    spec = SH.P(None, tuple(a for a in names if a != "model"), "model")
    want = tuple(Shard(2) if a == "model" else Shard(1) for a in names)
    assert SH.spec_placements(spec, mesh) == want
    assert SH.spec_placements(SH.P(None, None), mesh) == tuple(
        Replicate() for _ in names)
    shape = (3, 4 * SH.axis_size(mesh, names[:-1]), 2 * mesh.shape["model"])
    t = torch.arange(3 * shape[1] * shape[2]).reshape(shape)
    seen = torch.zeros(shape, dtype=torch.int64)
    coords = [{}]
    for a in names:
        coords = [dict(c, **{a: i}) for c in coords
                  for i in range(mesh.shape[a])]
    for c in coords:
        b = SH.shard_bounds(shape, spec, mesh, c)
        assert torch.equal(SH.local_shard(t, spec, mesh, c), t[b])
        seen[b] += 1
    assert bool((seen == 1).all())
    # pod is the major axis of the shared dim: pod 1's rows follow pod 0's
    if "pod" in names:
        first = SH.shard_bounds(shape, spec, mesh,
                                dict(pod=1, data=0, model=0))[1]
        assert first.start == shape[1] // 2


def test_production_and_host_meshes():
    m = HM.make_production_mesh()
    assert m.axis_names == ("data", "model") and m.shape == {
        "data": 16, "model": 16}
    m2 = HM.make_production_mesh(multi_pod=True)
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    host = HM.make_host_mesh(1)
    assert host.shape == {"data": 1, "model": 1} and not host.live
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        HM.make_host_mesh(2)


def test_hints_follow_the_reference():
    """Activated meshes give the reference's batch axes and sizes; the
    constraints leave tensors as they are; a shape-only mesh runs no
    collective."""
    from repro.distributed import hints as jhints
    for name, (shape, names) in MESHES.items():
        hints.activate(HM.ShapeMesh(shape, names))
        jhints.activate(_Mesh(shape, names))
        try:
            assert hints.batch_axes() == jhints.batch_axes()
            assert hints.axis_size(hints.batch_axes()) == jhints.axis_size(
                jhints.batch_axes())
            assert hints.axis_size("model") == jhints.axis_size("model")
            assert hints.active() and hints.live_mesh() is None
            assert hints.batch_shards() == 1
            x, y = torch.ones(2, 4, 8, 16), torch.ones(2, 4, 8)
            assert hints.attn_heads(x) is x and hints.residual(y) is y
            assert hints.over_model(lambda t: t * 2, x, dim=2).equal(x * 2)
        finally:
            hints.deactivate()
            jhints.deactivate()
    assert not hints.active()


def test_audio_and_vlm_batches_wait_for_their_families():
    """They wait no more (ROADMAP A15.5): the audio and vlm batches of
    every shape equal the reference's on a (4, 2) mesh, a vlm's
    ``positions`` (3, B, S) split by its dim 1, and a family's layout
    applied to another config follows the family."""
    mesh = HM.ShapeMesh((4, 2), ("data", "model"))
    jmesh = _Mesh((4, 2), ("data", "model"))
    for arch in ("musicgen-large", "qwen2-vl-7b"):
        cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
        for shape in base.SHAPES:
            want = jax.tree.map(_norm, JSH.batch_specs(jcfg, jmesh, shape),
                                is_leaf=lambda x: isinstance(x, JP))
            got = {k: ({kk: _norm(vv) for kk, vv in v.items()}
                       if isinstance(v, dict) else _norm(v))
                   for k, v in SH.batch_specs(cfg, mesh, shape).items()}
            assert got == want, (arch, shape)
    vlm = SH.batch_specs(base.get_config("qwen2-vl-7b"), mesh, "train_4k")
    assert _norm(vlm["positions"]) == (None, "data", None)
    cfg = base.get_config("phi3.5-moe-42b-a6.6b")
    import dataclasses
    audio = SH.batch_specs(dataclasses.replace(cfg, family="audio"), mesh,
                           "decode_32k")
    assert set(audio) == {"cache_index", "frame_embeds", "cache"}
