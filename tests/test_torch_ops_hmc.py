"""The port's accept/select (ops/hmc.py) against the JAX package's plain
version and its Pallas kernel (interpret mode), and the wrapper's checks.

The CUDA kernel itself runs only on a GPU; chip_smoke.py holds it against
`accept_select_ref` there. Here the plain version must agree with JAX with
the tolerances tests/test_hmc_pallas.py uses between Pallas and jnp:
selects and the accept decision exactly, accept_prob and d_energy to a few
f32 ulps (a different summation order of the kinetic energy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu.ops.hmc_pallas import (
    _accept_select_pallas,
    _accept_select_ref,
)

from normalizingflow_tpu_torch.ops import hmc as ops_hmc
from normalizingflow_tpu_torch.ops.hmc import (
    _check,
    accept_select,
    accept_select_ref,
)

torch.set_num_threads(1)

NAMES = ("pos", "lp", "grad", "accept_prob", "accepted", "d_energy")


def random_inputs(seed, n, d, dtype=np.float32, nan_rows=True):
    """The inputs of tests/test_hmc_pallas.py, drawn with numpy: divergent
    rows have a NaN lp_new (0::7) or a NaN q with an inf momentum (1::7)."""
    rng = np.random.default_rng(seed)
    nd = [rng.standard_normal((n, d)).astype(dtype) for _ in range(5)]
    q, p, g_new, pos_old, g_old = nd
    lp_new, lp_old, h_old = (rng.standard_normal(n).astype(dtype)
                             for _ in range(3))
    log_u = np.log(rng.uniform(size=n)).astype(dtype)
    inv_m = np.exp(0.3 * rng.standard_normal(d)).astype(dtype)
    if nan_rows:
        lp_new[::7] = np.nan
        q[1::7] = np.nan
        p[1::7, 0] = np.inf
    return q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u, inv_m


def to_torch(args):
    return [torch.from_numpy(a.copy()) for a in args]


def assert_matches(ours, ref, rtol, atol):
    for i, name in enumerate(NAMES):
        a, b = ours[i].numpy(), np.asarray(ref[i])
        if name in ("accept_prob", "d_energy"):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n,d", [(96, 6), (1056, 64)])
def test_ref_matches_jax_f32(n, d):
    args = random_inputs(n + d, n, d)
    ours = accept_select_ref(*to_torch(args))
    jargs = [jnp.asarray(a) for a in args]
    assert_matches(ours, _accept_select_ref(*jargs), rtol=2e-6, atol=1e-6)
    assert_matches(ours, _accept_select_pallas(*jargs, interpret=True),
                   rtol=2e-6, atol=1e-6)
    acc = ours[4].numpy()
    assert acc.dtype == np.bool_ and not acc[::7].any() and not acc[1::7].any()


def test_ref_matches_jax_f64():
    args = random_inputs(5, 200, 10, dtype=np.float64)
    assert_matches(accept_select_ref(*to_torch(args)),
                   _accept_select_ref(*[jnp.asarray(a) for a in args]),
                   rtol=1e-13, atol=1e-13)


def test_nan_h_old_is_rejected():
    """min(0, NaN) is NaN in JAX and torch (fminf would give 0 and accept):
    a row with a NaN h_old must be rejected, with accept_prob NaN."""
    args = list(random_inputs(7, 16, 4, nan_rows=False))
    h_old, log_u = args[7], args[8]
    h_old[3] = np.nan
    h_old[4] = 1e6    # certain accept: dE >> 0
    log_u[3] = log_u[4] = -50.0
    ours = accept_select_ref(*to_torch(args))
    ref = _accept_select_ref(*[jnp.asarray(a) for a in args])
    assert_matches(ours, ref, rtol=2e-6, atol=1e-6)
    assert not bool(ours[4][3]) and bool(ours[4][4])
    assert np.isnan(ours[5][3].item()) and np.isnan(ours[3][3].item())
    np.testing.assert_array_equal(ours[0][3].numpy(), args[3][3])


def test_wrapper_runs_the_plain_version_on_cpu():
    args = to_torch(random_inputs(3, 64, 8))
    ops_hmc.accept_select.launches = 0
    ours = accept_select(*args)
    ref = accept_select_ref(*args)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    # the launch counter counts CUDA kernel launches only
    assert accept_select.launches == 0


def test_kernel_input_checks():
    """What the CUDA wrapper validates before launching, checked on CPU
    tensors (the checks are pure Python)."""
    args = to_torch(random_inputs(4, 32, 8))
    n, d, vec4 = _check(*args)
    assert (n, d) == (32, 8) and vec4
    assert not _check(*to_torch(random_inputs(4, 32, 6)))[2]  # D % 4 != 0
    with pytest.raises(TypeError, match="float32"):
        _check(*[a.double() for a in args])
    bad = list(args)
    bad[1] = args[1][:, :4]
    with pytest.raises(ValueError, match="shape"):
        _check(*bad)
    bad = list(args)
    bad[2] = args[2].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        _check(*bad)
    bad = list(args)
    bad[9] = args[9][:4]
    with pytest.raises(ValueError, match="inv_mass_diag"):
        _check(*bad)
    with pytest.raises(ValueError, match="chains, dim"):
        _check(*to_torch(random_inputs(4, 0, 8)))
