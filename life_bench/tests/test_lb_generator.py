"""The generator: deterministic per seed, merged coefficients, the
semantics of the port's synthetic connectome."""
import torch

from life_bench import gen, run
from life_bench.tests import lb_tiny

CPU = torch.device("cpu")


def _cfg():
    return lb_tiny.cell("ifod1-500k.coo-solve")["config"]


def test_same_seed_same_tensors_and_other_seed_other_tensors():
    cfg = _cfg()
    d = gen.make_dictionary(cfg["n_atoms"], cfg["n_theta"], CPU)
    a, b = gen.subject(cfg, 2 ** 31 + 17, d), gen.subject(cfg, 2 ** 31 + 17, d)
    c = gen.subject(cfg, 2 ** 31 + 18, d)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w_true"], c["w_true"])


def test_coefficients_are_merged_and_in_range():
    cfg = _cfg()
    d = gen.make_dictionary(cfg["n_atoms"], cfg["n_theta"], CPU)
    s = gen.subject(cfg, 5, d)
    nv, nf = 1000, cfg["n_fibers"]
    key = (s["atoms"].long() * nv + s["voxels"].long()) * nf + s["fibers"].long()
    assert key.unique().numel() == key.numel()          # no repeated triple
    assert torch.all(key[1:] > key[:-1])                 # (atom, voxel, fiber) order
    step = cfg["step"]
    steps = s["values"] / step
    assert torch.equal(steps, steps.round()) and steps.min() >= 1
    assert s["values"].max() > step                      # some triples merged
    assert 0 <= int(s["atoms"].min()) and int(s["atoms"].max()) < cfg["n_atoms"]
    assert 0 <= int(s["voxels"].min()) and int(s["voxels"].max()) < nv
    assert 0 <= int(s["fibers"].min()) and int(s["fibers"].max()) < nf
    active = (s["w_true"] > 0).float().mean()
    assert 0.2 < float(active) < 0.5                    # active_frac 0.35
    assert s["b"].shape == (nv, cfg["n_theta"]) and s["b"].dtype == torch.float32


def test_a_fiber_steps_through_neighbouring_voxels():
    cfg = _cfg()
    d = gen.make_dictionary(cfg["n_atoms"], cfg["n_theta"], CPU)
    gen_ = torch.Generator().manual_seed(3)
    a, v, f = gen.streamlines(cfg, gen_, gen.fibonacci_sphere(16).float())
    gx, gy, gz = cfg["grid"]
    # the steps come step by step over all fibers: order them by fiber,
    # each fiber's steps in the order taken
    order = torch.argsort(f, stable=True)
    v, f = v[order], f[order]
    xyz = torch.stack([v // (gy * gz), (v // gz) % gy, v % gz], dim=1)
    same = f[1:] == f[:-1]
    assert int(same.sum()) > 0.5 * f.numel()
    # a step of at most one voxel moves at most one voxel along each axis
    assert int((xyz[1:] - xyz[:-1])[same].abs().max()) <= 1
    assert d.shape == (cfg["n_atoms"], cfg["n_theta"])
    assert torch.allclose(d.mean(dim=1), torch.zeros(cfg["n_atoms"]), atol=1e-6)


def test_ifod1_streamlines_give_the_published_coefficients_a_fiber():
    cfg = dict(run.load_cell("ifod1-500k.coo-solve")["config"], n_fibers=400)
    nv = cfg["grid"][0] * cfg["grid"][1] * cfg["grid"][2]
    a, v, f = gen.streamlines(cfg, torch.Generator().manual_seed(11),
                              gen.fibonacci_sphere(cfg["n_atoms"]).float())
    per_fiber = ((a * nv + v) * 400 + f).unique().numel() / 400
    published = cfg["published"]["coeffs_per_fiber"]
    assert 0.85 * published < per_fiber < 1.15 * published, per_fiber


def test_every_seed_gives_a_slot_the_same_coefficients():
    cfg = _cfg()
    d = gen.make_dictionary(cfg["n_atoms"], cfg["n_theta"], CPU)
    a, c = gen.subject(cfg, 2 ** 31 + 5, d), gen.subject(cfg, 2 ** 31 + 6, d)
    other_slot = gen.subject(cfg, 2 ** 31 + 5, d, slot=1)
    for k in ("atoms", "voxels", "fibers", "values"):
        assert torch.equal(a[k], c[k])
    assert not torch.equal(a["b"], c["b"])
    assert not torch.equal(a["fibers"], other_slot["fibers"])
