"""The port's ESS and R-hat (estimators/ess.py) against the JAX package on
fixed float64 arrays: AR(1) chains of varied correlation, heavy-tailed
functionals and a drifting chain. rtol 1e-10 (FFT and sort implementations
differ only in rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu.estimators import ess as jess

from normalizingflow_tpu_torch.estimators import ess as tess

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-9


def ar1(seed, n, m, rho, dim=None):
    rng = np.random.default_rng(seed)
    shape = (n, m) if dim is None else (n, m, dim)
    e = rng.standard_normal(shape)
    x = np.empty(shape)
    x[0] = e[0]
    for i in range(1, n):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho**2) * e[i]
    return x


SCALARS = {
    "iid": ar1(0, 200, 6, 0.0),
    "ar0.5": ar1(1, 200, 6, 0.5),
    "ar0.95": ar1(2, 301, 4, 0.95),          # odd draws: split drops one
    "heavy": np.exp(2.0 * ar1(3, 150, 8, 0.3)),
    "drift": ar1(4, 120, 4, 0.2) + np.linspace(0, 3, 120)[:, None],
    "one_chain": ar1(5, 256, 1, 0.4),
}


def close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("fn", ["effective_sample_size", "bulk_ess",
                                "tail_ess", "_split_chains",
                                "_rank_normalize"])
@pytest.mark.parametrize("case", sorted(SCALARS))
def test_scalar_functions_match_jax(fn, case):
    x = SCALARS[case]
    close(getattr(tess, fn)(torch.from_numpy(x)),
          getattr(jess, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("fn,chunk", [("bulk_ess_per_dim", 4),
                                      ("bulk_ess_per_dim", 3),
                                      ("ess_per_dim", 8),
                                      ("ess_per_dim", 5)])
def test_per_dim_functions_match_jax(fn, chunk):
    x = ar1(6, 100, 8, 0.6, dim=7) * np.arange(1, 8)
    close(getattr(tess, fn)(torch.from_numpy(x), dim_chunk=chunk),
          getattr(jess, fn)(jnp.asarray(x), dim_chunk=chunk))


def test_rhat_and_min_ess_match_jax():
    x = ar1(7, 80, 5, 0.7, dim=3)
    x[:, 0, 1] += 2.0  # one chain off: R-hat > 1 in that coordinate
    close(tess.potential_scale_reduction(torch.from_numpy(x)),
          jess.potential_scale_reduction(jnp.asarray(x)))
    close(tess.min_ess(torch.from_numpy(x)), jess.min_ess(jnp.asarray(x)))
