"""NSF_TCL, the transformer-conditioned circular-spline coupling flow
(bijectors/transformer.py), against the plain-torch reference of the
benchmark's lj500_nsf_tcl configuration (nfbench/configs/lj500_nsf_tcl.py),
which imports nothing of the port. The flow has no JAX twin. CPU, float64,
at N = 32 (fcc, 2 x 2 x 2 cells), 2 coupling layers, embedding 32, 2
heads, K = 4, on seeded random weights at a larger output scale than the
configuration's, so that every spline bends.

Tolerances: both sides evaluate the same float64 formulas in different
orders (addmm against einsum, the math attention backend against an
explicit softmax, torch.sum against a fused einsum in the LJ energy), so
they agree to round-off: 1e-10 relative on positions, log-dets and the
loss; 1e-8 on gradients, relative to each leaf's largest entry, as they
pass through 2 x 2 blocks of attention and the LJ energy's r^-14 (a sum
of terms up to ~1e5 cancelling to ~1e1).
"""

import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from normalizingflow_tpu_torch.bijectors import (
    Chain,
    TransformerCoupling,
    circular_rqs,
)
from normalizingflow_tpu_torch.bijectors.rqs import apply_rqs
from normalizingflow_tpu_torch.bijectors.transformer import wrap
from normalizingflow_tpu_torch.config import build_flow_stack
from normalizingflow_tpu_torch.ops import rqs as ops_rqs
from normalizingflow_tpu_torch.targets import LennardJones
from normalizingflow_tpu_torch.train.objectives import reverse_kl

torch.set_num_threads(1)

DT = torch.float64
ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "nfbench" / "configs" / "lj500_nsf_tcl.json")
                 .read_text())
CFG.update(nparticles=32, layers=2, embed_dim=32, num_heads=2, nsplines=4,
           num_freqs=3, final_scale=1.0)
POS_TOL = dict(rtol=1e-10, atol=1e-10)
GRAD_TOL = dict(rtol=1e-8)


def reference():
    path = ROOT / "nfbench" / "configs" / "lj500_nsf_tcl.py"
    spec = importlib.util.spec_from_file_location(
        "nfbench.configs.lj500_nsf_tcl", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = reference()
BOX = REF.box(CFG)


def port_flow(params, cfg=CFG):
    from normalizingflow_tpu_torch.distributions import EinsteinCrystal
    from normalizingflow_tpu_torch.flow import NormalizingFlow

    layers = [TransformerCoupling(
        cfg["nparticles"], REF.box(cfg), i % 3, num_bins=cfg["nsplines"],
        embed_dim=cfg["embed_dim"], num_heads=cfg["num_heads"],
        num_blocks=cfg["num_blocks"], num_freqs=cfg["num_freqs"],
        dtype=DT) for i in range(cfg["layers"])]
    prior = EinsteinCrystal(REF.lattice(cfg, "cpu", DT),
                            alpha=cfg["prior_alpha"], boxlength=REF.box(cfg),
                            dtype=DT)
    flow = NormalizingFlow(prior, Chain(layers))
    with torch.no_grad():
        named = dict(flow.named_parameters())
        assert set(named) == set(params)
        for name, p in named.items():
            p.copy_(params[name])
    return flow


@pytest.fixture(scope="module")
def setup():
    gen = torch.Generator().manual_seed(2024)
    params = REF.cast(REF.init_params(CFG, gen, "cpu"), "float64")
    centers = REF.lattice(CFG, "cpu", DT)
    z = REF.base_draws(CFG, centers.float(), 6, gen).double()
    return params, centers, z


def test_parameter_names_and_count_match_the_reference():
    full = dict(CFG, nparticles=500, layers=24, embed_dim=256, nsplines=16,
                num_freqs=8)
    shapes = REF.shapes(full)
    assert sum(math.prod(s) for s in shapes.values()) == 24 * 1_598_513
    layer = TransformerCoupling(500, REF.box(full), 0, num_bins=16,
                                embed_dim=256, num_heads=2, num_freqs=8,
                                device="meta")
    got = {f"bijector.bijectors.0.{k}": tuple(v.shape)
           for k, v in layer.named_parameters()}
    want = {k: v for k, v in shapes.items()
            if k.startswith("bijector.bijectors.0.")}
    assert list(got.items()) == list(want.items())


def test_sample_and_log_det_match_the_reference(setup):
    params, _, z = setup
    flow = port_flow(params)
    x, ld = flow.inverse(z)
    x_ref, ld_ref = REF.sample(CFG, params, z, "float64")
    torch.testing.assert_close(x, x_ref, **POS_TOL)
    torch.testing.assert_close(ld, ld_ref, **POS_TOL)
    assert float(ld.detach().abs().min()) > 1e-3  # the splines bend


def test_density_direction_matches_the_reference(setup):
    params, _, z = setup
    flow = port_flow(params)
    x, _ = flow.inverse(z)
    zb, ld = flow.bijector.forward(x)
    zb_ref, ld_ref = REF.density(CFG, params, x.detach(), "float64")
    torch.testing.assert_close(zb, zb_ref, **POS_TOL)
    torch.testing.assert_close(ld, ld_ref, **POS_TOL)


def test_inverse_of_forward_returns_the_input(setup):
    params, _, z = setup
    flow = port_flow(params)
    x, ld_inv = flow.inverse(z)
    zb, ld_fwd = flow.bijector.forward(x)
    # z is wrapped into the box on entry; the base draws lie inside it
    torch.testing.assert_close(zb, wrap(z, BOX), rtol=0, atol=1e-12)
    torch.testing.assert_close(ld_fwd, -ld_inv, rtol=0, atol=1e-10)


def test_log_det_equals_autograd_jacobian(setup):
    params, _, z = setup
    flow = port_flow(params)
    for row in z[:3]:
        jac = torch.autograd.functional.jacobian(
            lambda v: flow.inverse(v[None])[0][0], row)
        want = torch.linalg.slogdet(jac)[1]
        torch.testing.assert_close(flow.inverse(row[None])[1][0], want,
                                   rtol=1e-10, atol=1e-10)


def test_permuting_particles_permutes_the_output(setup):
    params, _, z = setup
    flow = port_flow(params)
    perm = torch.randperm(CFG["nparticles"],
                          generator=torch.Generator().manual_seed(3))
    n = CFG["nparticles"]
    x, ld = flow.inverse(z)
    xp, ldp = flow.inverse(z.reshape(-1, n, 3)[:, perm].reshape(z.shape))
    torch.testing.assert_close(xp, x.reshape(-1, n, 3)[:, perm].reshape(
        x.shape), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ldp, ld, rtol=1e-12, atol=1e-11)


def test_reverse_kl_and_every_gradient_match_the_reference(setup):
    params, centers, z = setup
    flow = port_flow(params)
    target = LennardJones(CFG["nparticles"], BOX, cutoff=CFG["cutoff"],
                          kT=CFG["kT"], dtype=DT)
    loss = reverse_kl(flow, target, z=z)
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    ref_loss, ref_grads = REF.loss_and_grads(CFG, p, centers, z, "float64",
                                             chunk=4)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-10)
    for name, param in flow.named_parameters():
        # entries far below the leaf's largest are round-off (the key
        # biases' gradient is 0 exactly: softmax ignores a shift of its
        # row), so the absolute room scales with the leaf
        want = ref_grads[name]
        torch.testing.assert_close(
            param.grad, want, rtol=GRAD_TOL["rtol"],
            atol=GRAD_TOL["rtol"] * float(want.abs().max()),
            msg=lambda m, name=name: f"{name}: {m}")


def test_lj_energy_matches_the_reference(setup):
    _, _, z = setup
    target = LennardJones(CFG["nparticles"], BOX, cutoff=CFG["cutoff"],
                          kT=CFG["kT"], dtype=DT)
    x = z + 0.05 * torch.randn(z.shape, dtype=DT,
                               generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(target.log_prob(x),
                               REF.target_lp(CFG, x, "float64"),
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_circular_spline_equals_the_reference_spline(inverse):
    gen = torch.Generator().manual_seed(5)
    n, k, half = 400, 6, 0.5 * BOX
    w, h, d = (torch.randn(n, k, dtype=DT, generator=gen) for _ in range(3))
    x = (2.0 * torch.rand(n, dtype=DT, generator=gen) - 1.0) * half
    y, ld = circular_rqs(x, w, h, d, inverse=inverse, tail_bound=half)
    y_ref, ld_ref = REF.crqs(x, w, h, d, inverse, -half, half)
    torch.testing.assert_close(y, y_ref, rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(ld, ld_ref, rtol=1e-12, atol=1e-12)


def test_circular_spline_ends_meet_with_one_slope():
    gen = torch.Generator().manual_seed(6)
    half, k = 0.5 * BOX, 5
    w, h, d = (torch.randn(1, k, dtype=DT, generator=gen).expand(2, k)
               for _ in range(3))
    x = torch.tensor([-half, half], dtype=DT)
    y, ld = circular_rqs(x, w, h, d, tail_bound=half)
    # -L/2 and L/2 are one point of the circle; so are their images
    assert torch.equal(wrap(y, BOX)[0], wrap(y, BOX)[1])
    torch.testing.assert_close(y, x, rtol=0, atol=1e-14)
    assert float(ld[0]) == pytest.approx(float(ld[1]), abs=1e-13)
    # and the slope is the learned one, softplus(d_0) + 1e-3, not 1
    slope = 1e-3 + math.log1p(math.exp(float(d[0, 0])))
    assert float(ld[0]) == pytest.approx(math.log(slope), abs=1e-12)


@pytest.mark.parametrize("inverse", [False, True])
def test_circular_fused_function_with_plain_vjp_equals_autograd(inverse):
    """The autograd Function the layers use on the card, with the plain
    circular forward and closed-form VJP in place of the kernels, against
    autograd through the circular twin."""
    gen = torch.Generator().manual_seed(7)
    n, k, half = 300, 4, 0.5 * BOX
    ins = [(2.0 * torch.rand(n, dtype=DT, generator=gen) - 1.0) * half] + [
        torch.randn(n, k, dtype=DT, generator=gen) for _ in range(3)]
    gy, gld = (torch.randn(n, dtype=DT, generator=gen) for _ in range(2))
    a = [t.clone().requires_grad_(True) for t in ins]
    out = ops_rqs.unconstrained_rqs_fused(
        *a, inverse, -half, half, -half, half, forward=ops_rqs.plain_crqs,
        backward=ops_rqs.crqs_vjp_plain)
    got = torch.autograd.grad(out, a, (gy, gld))
    b = [t.clone().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(apply_rqs(*b, inverse=inverse, circular=True,
                                         tail_bound=half), b, (gy, gld))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-10, atol=1e-12)


def test_config_builds_nsf_tcl():
    from normalizingflow_tpu_torch.config import (
        Config,
        DatasetConfig,
        FlowConfig,
    )

    cfg = Config(device="cpu",
                 dataset=DatasetConfig(nparticles=32, rho=1.28),
                 flow=FlowConfig(type="NSF_TCL", nlayers=4, nsplines=4,
                                 embed_dim=16, num_heads=2, num_blocks=1,
                                 num_freqs=2))
    b = (32 / (8 * 1.28)) ** (1 / 3)
    stack = build_flow_stack(cfg, b, dtype=DT,
                             generator=torch.Generator().manual_seed(1))
    layers = list(stack.bijectors)
    assert [type(lay) for lay in layers] == [TransformerCoupling] * 4
    assert [lay.axis for lay in layers] == [0, 1, 2, 0]
    assert all(lay.boxlength == pytest.approx(2 * b) for lay in layers)
    assert len(layers[0].blocks) == 1 and layers[0].num_bins == 4
    z = (torch.rand(3, 96, dtype=DT) - 0.5) * 2 * b
    x, ld = stack.inverse(z)
    zb, ld_back = stack.forward(x)
    torch.testing.assert_close(zb, z, rtol=0, atol=1e-10)
    torch.testing.assert_close(ld_back, -ld, rtol=0, atol=1e-10)


def test_chip_smoke_path_launches_one_circular_call_a_layer(monkeypatch):
    """chip_smoke.py's NSF_TCL path at a toy size, the kernels stood in for
    by the plain twins counting as the wrappers do: a train step launches
    one forward and one VJP a layer, sampling and the density one forward
    a layer."""
    import chip_smoke
    from normalizingflow_tpu_torch.bijectors import transformer
    from normalizingflow_tpu_torch.bijectors.rqs import resolve_bounds

    def fwd(*args):
        ops_rqs.crqs_cuda.launches += 1
        return ops_rqs.plain_crqs(*args)

    def vjp(*args):
        ops_rqs.crqs_vjp_cuda.launches += 1
        return ops_rqs.crqs_vjp_plain(*args)

    def counted(inputs, w, h, d, *, inverse=False, tail_bound=None,
                left=None, right=None, bottom=None, top=None,
                circular=False):
        assert circular
        return ops_rqs.unconstrained_rqs_fused(
            inputs, w, h, d, inverse,
            *resolve_bounds(tail_bound, left, right, bottom, top), fwd, vjp)

    monkeypatch.setattr(transformer, "apply_rqs", counted)
    paths = chip_smoke.circular_path(0, "cpu", cells=2, layers=3,
                                     embed_dim=16)
    assert paths == dict(nsf_tcl_train_step=(3, 3), nsf_tcl_sample=(3, 0),
                         nsf_tcl_density=(3, 0))


@pytest.mark.parametrize("inverse", [False, True])
def test_chip_smoke_circular_bound_counts_sectors_by_hand(inverse):
    """The circular kernels' bytes in chip_smoke.py's count, against a hand
    count: 8 rows inside the box, K = 16 even bins, rows in bins 3, 7, 15
    and 0 twice. Each row reads its bin's two slope logits, idx and idx + 1
    mod K: one 32-byte sector for bins 3 and 0, two for 7 (logits 7 and 8)
    and 15 (15 and 0). Forward: x, y and log-det one sector each (8
    floats), w and h 16 sectors each, d 12; the VJP adds grad_ld's sector
    and writes gw, gh and gd whole (16 sectors each)."""
    import chip_smoke

    half, k = chip_smoke.CRQS_HALF, 16
    bins = torch.tensor([3, 7, 15, 0, 3, 7, 15, 0])
    x = -half + (bins + 0.5) * (2 * half / k)
    w = h = torch.zeros(8, k)
    fwd, vjp, counted = chip_smoke.rqs_bounds(x, w, h, inverse,
                                              (-half, half) * 2,
                                              circular=True)
    assert counted["rows_inside"] == 1.0
    assert fwd[2] == 32 * (3 + 2 * 16 + 12)
    assert vjp[2] == 32 * (3 + 1 + 2 * 16 + 12 + 3 * 16)
