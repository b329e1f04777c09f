"""The moment statistics that hold a fitted flow's draws to its target, for
BASELINE config 3's 32-d fits: tools/jax_vi_bands.py computes the JAX
package's bands with them, and chip_smoke.py's `vi` phase gates the port's
fits on the card with the same functions. numpy only, so that both sides
may import it.
"""

import numpy as np


def banana_cov(dim, b, s0):
    """The closed-form covariance of Banana(dim, b, s0): x0 ~ N(0, s0^2),
    x1 | x0 ~ N(b (x0^2 - s0^2), 1), the rest standard normal, so
    diag(s0^2, 1 + 2 b^2 s0^4, 1, ...) and 0 elsewhere."""
    var = np.ones(dim)
    var[0], var[1] = s0 ** 2, 1 + 2 * b ** 2 * s0 ** 4
    return np.diag(var)


def vi_stats(x, cov):
    """The moment statistics of draws x (n, dim) against the covariance
    cov: var_rel, the largest |variance / the target's - 1|; mean_sd, the
    largest |mean| in the target's standard deviations; corr_err, the mean
    |error| of an off-diagonal correlation."""
    x = np.asarray(x, np.float64)
    sd = np.sqrt(np.diag(cov))
    c = np.cov(x.T)
    csd = np.sqrt(np.diag(c))
    iu = np.triu_indices(len(sd), 1)
    return dict(
        var_rel=float(np.abs(np.diag(c) / np.diag(cov) - 1).max()),
        mean_sd=float(np.abs(x.mean(0) / sd).max()),
        corr_err=float(np.abs((c / np.outer(csd, csd))[iu]
                              - (cov / np.outer(sd, sd))[iu]).mean()))
