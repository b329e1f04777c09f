"""The frozen arithmetic: the ESS copy equals the program's estimator at
this commit, and the shape counts of FLOPs and bytes equal hand counts."""

import json
import math

import pytest
import torch

from nfbench import run, yardstick

FUNNEL = json.loads((run.HERE / "configs" / "funnel64_realnvp.json")
                    .read_text())
LJ = json.loads((run.HERE / "configs" / "lj32_nsf_ar.json").read_text())


def ref(name):
    return run.load_file(run.HERE / "configs" / f"{name}.py",
                         f"nfbench.configs.{name}")


def test_ess_copy_equals_estimator():
    from normalizingflow_tpu_torch.estimators.ess import bulk_ess_per_dim

    g = torch.Generator().manual_seed(5)
    x = torch.randn(200, 16, 6, generator=g, dtype=torch.float64)
    x = torch.cumsum(x, 0) * 0.1 + x  # autocorrelated chains
    want = bulk_ess_per_dim(x)
    got = yardstick.bulk_ess(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    lo = yardstick.min_bulk_ess([x[:70], x[70:]], dim_chunk=4)
    want2 = min(float(want.min()), float(bulk_ess_per_dim(x * x).min()))
    assert lo == pytest.approx(want2, rel=1e-12)


# per layer: 95 MLPs; MLP i reads the 2i features of the i coordinates
# before its own (2 x 4560 in all), then 354 -> 354 -> 95
FIRST = 354 * 2 * sum(range(1, 96))
MACS = FIRST + 95 * (354 * 354 + 354 * 95)


def test_fkl_flops_per_frame_by_hand():
    # the forward's products, the weights' cotangents, and the inputs'
    # except layer 1's first
    want = 2 * (2 * MACS + 2 * MACS + (2 * MACS - FIRST))
    assert ref("lj32_nsf_ar").flops_fkl_step(LJ, 1) == want
    shapes = ref("lj32_nsf_ar").shapes(LJ)
    params = sum(math.prod(s) for s in shapes.values())
    assert params == pytest.approx(43.1e6, rel=0.01)
    # the weights the inputs reach: the dense stacked w1 less its masked
    # entries (each layer's w1 holds 95 x 190 x 354, of which FIRST count)
    w1 = math.prod(shapes["bijector.bijectors.0.cond.w1"])
    needed = params - 2 * (w1 - FIRST)
    # within 6 x those a frame: the biases and layer 1's first products
    assert 0.9 < want / (6 * needed) < 1.0


def test_sample_flops_per_frame_by_hand():
    assert ref("lj32_nsf_ar").flops_sample(LJ, 1) == 2 * 2 * MACS
    assert ref("lj32_nsf_ar").flops_sample(LJ, 1) == pytest.approx(73.3e6,
                                                                   rel=0.01)


def test_funnel_flops_by_hand():
    r = ref("funnel64_realnvp")
    mlp = 32 * 128 + 128 * 128 + 128 * 32          # one MLP's MACs a row
    fwd = 2 * 2 * 4 * mlp                          # 2 layers of 4 MLPs
    assert r.flops_inverse(FUNNEL, 1) == fwd
    assert r.flops_grad_eval(FUNNEL, 1) == 2 * fwd
    assert r.flops_rkl_step(FUNNEL, 1) == 3 * fwd - 2 * 2 * 32 * 128


def test_accept_bytes_by_hand():
    n, d, acc = 131072, 64, 100000
    nbytes, ops = yardstick.fused_bound_bytes_ops(n, d, acc)
    reads = 4 * (3 * n * d + acc * d + 4 * n + d)
    writes = 4 * (2 * acc * d + acc + 2 * n) + n
    assert nbytes == reads + writes and ops == 8 * n * d + 20 * n


def test_rqs_bytes_by_hand():
    # 16 rows inside the domain, K = 8: x, y and log-det columns, all of w
    # and h, and the sectors holding each row's two derivative logits
    k, n = 8, 16
    g = torch.Generator().manual_seed(0)
    w = torch.randn(n, k, generator=g)
    h = torch.randn(n, k, generator=g)
    x = torch.rand(n, generator=g) * 2 - 1
    (fb, fo), (vb, vo) = yardstick.rqs_bytes_ops(x, w, h, False,
                                                 (-1.0, 1.0, -1.0, 1.0))
    column = 4 * n
    params = 4 * n * k
    assert fb - 3 * column - 2 * params in range(32, 32 * 2 * n + 1, 32)
    assert fo == n * (28 * k + 50) and vo == n * (36 * k + 200)
    d_read = fb - 3 * column - 2 * params
    assert vb == (3 * column + column + 2 * params + d_read + 2 * params
                  + 4 * n * (k - 1))


def test_outside_rows_need_x_alone():
    x = torch.full((8,), 5.0)
    w = torch.zeros(8, 8)
    (fb, fo), _ = yardstick.rqs_bytes_ops(x, w, w, False,
                                          (-1.0, 1.0, -1.0, 1.0))
    assert fb == 3 * 32 and fo == 0
