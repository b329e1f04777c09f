"""Plain PyTorch Lennard-Jones energy of particles in a periodic cubic box,
for the benchmark's references (configs/lj500_nsf_tcl.py and the HMC data
cell, kinds/hmc_data.py). Imports torch and nfbench.refcore only.

Per pair: the minimum-image separation (each component moved by one box
length where it exceeds half of it), r^2 its squared norm, and for pairs
within the cutoff 4 eps ((s^2/r^2)^6 - (s^2/r^2)^3) less the same at the
cutoff; half of the double sum over distinct particles. In the control's
precision ("tf32") r^2 is a product whose operands are rounded to TF32, as
a tensor core would form it from the separations.
"""

from __future__ import annotations

import torch

from nfbench import refcore


def minimum_image(diff, boxlength):
    return diff - (torch.abs(diff) > 0.5 * boxlength) * torch.sign(
        diff) * boxlength


def energy(pos, boxlength, cutoff, prec, epsilon=1.0, sigma=1.0):
    """Total energy of each configuration: pos (batch, n, 3) -> (batch,)."""
    diff = minimum_image(pos[:, :, None, :] - pos[:, None, :, :], boxlength)
    r2 = refcore.ein("bijk,bijk->bij", diff, diff, prec)
    n = pos.shape[1]
    valid = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    valid = valid & (r2 <= cutoff * cutoff)
    inv6 = (sigma * sigma / torch.where(valid, r2, torch.ones_like(r2))) ** 3
    s6 = (sigma / cutoff) ** 6
    pair = 4.0 * epsilon * (inv6 * inv6 - inv6 - (s6 * s6 - s6))
    pair = torch.where(valid, pair, torch.zeros_like(pair))
    return 0.5 * torch.sum(pair, dim=(1, 2))


def log_prob(x, n, boxlength, cutoff, kT, prec):
    """-U/kT of flattened configurations x (batch, n * 3)."""
    return -energy(x.reshape(x.shape[0], n, 3), boxlength, cutoff, prec) / kT
