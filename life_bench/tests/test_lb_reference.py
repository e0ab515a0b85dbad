"""The plain reference against a float64 brute force: the dense M."""
import torch

from life_bench import gen, reference
from life_bench.tests import lb_tiny

CPU = torch.device("cpu")


def _dense(s, d, nv, nf):
    m = torch.zeros((nv * d.shape[1], nf), dtype=torch.float64)
    for a, v, f, val in zip(s["atoms"].tolist(), s["voxels"].tolist(),
                            s["fibers"].tolist(), s["values"].tolist()):
        m[v * d.shape[1]:(v + 1) * d.shape[1], f] += d[a].double() * val
    return m


def _problem():
    cfg = lb_tiny.cell("prob-50k.cohort2")["config"]
    d = gen.make_dictionary(cfg["n_atoms"], cfg["n_theta"], CPU)
    s = gen.subject(cfg, 11, d)
    op = reference.Operator(s["atoms"], s["voxels"], s["fibers"],
                            s["values"], d, 1000, cfg["n_fibers"])
    return cfg, d, s, op


def test_dsc_and_wc_equal_the_dense_product(monkeypatch):
    # blocks of 300 voxels: the block loop runs more than once
    monkeypatch.setattr(reference, "VOXEL_BLOCK", 300)
    cfg, d, s, op = _problem()
    op = reference.Operator(s["atoms"], s["voxels"], s["fibers"],
                            s["values"], d, 1000, cfg["n_fibers"])
    assert len(op.blocks) == 4
    m = _dense(s, d, 1000, cfg["n_fibers"])
    w = torch.rand(cfg["n_fibers"], dtype=torch.float64)
    y = torch.randn((1000, cfg["n_theta"]), dtype=torch.float64)
    torch.testing.assert_close(op.dsc(w).reshape(-1), m @ w, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(op.wc(y), m.T @ y.reshape(-1), rtol=1e-12,
                               atol=1e-12)


def test_sbbnnls_keeps_weights_nonnegative_and_lowers_the_loss():
    cfg, d, s, op = _problem()
    w, losses, kept = reference.sbbnnls(op, s["b"], 30, keep=(0, 10, 30))
    assert losses.shape == (30,) and w.dtype == torch.float64
    assert float(w.min()) >= 0.0
    assert float(losses[-1]) < 0.1 * float(losses[0])
    assert torch.equal(kept[0], torch.ones_like(w)) and torch.equal(kept[30], w)
    assert sorted(kept) == [0, 10, 30]


def test_reference_step_sizes_follow_the_parity():
    # one iteration from w = 1 by hand: the even branch's step size
    cfg, d, s, op = _problem()
    b = s["b"].double()
    w = torch.ones(cfg["n_fibers"], dtype=torch.float64)
    y = op.dsc(w) - b
    g = op.wc(y)
    gt = torch.where((w > 0) | (g < 0), g, 0.0)
    v = op.dsc(gt)
    vv = op.wc(v)
    vv = torch.where((w > 0) | (vv < 0), vv, 0.0)
    alpha = (v * v).sum() / (vv @ vv)
    w1, losses, _ = reference.sbbnnls(op, s["b"], 1)
    torch.testing.assert_close(w1, torch.clamp_min(w - alpha * gt, 0.0))
    torch.testing.assert_close(losses[0], 0.5 * (y * y).sum())
