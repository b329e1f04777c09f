"""Differentiable EAM iron potential. Twin of normalizingflow_tpu/targets/eam.py.

The energy of a whole batch of frames is computed at once on (batch, n, n)
minimum-image pair distances, and forces come by autograd
(targets/base.py). Two parameterizations, as in JAX:

  * the Finnis-Sinclair (1984) analytic iron model (default): pair term
    V(r) = (r-c)^2 (c0 + c1 r + c2 r^2) for r < c; density
    psi(r) = (r-d)^2 + beta (r-d)^3 / d for r < d; embedding
    F(rho) = -A sqrt(rho);
  * a tabulated DYNAMO "setfl" file (`load_setfl`), evaluated with natural
    cubic splines on its uniform grids, wired from `dataset.input_dir`.

As in JAX:

  * the diagonal of r^2 is set to 1 *before* the square root, so the
    gradient stays finite at self pairs, whose terms are then selected away;
  * the minimum image rounds half to even (torch.round, as jnp.round);
  * the table lookup is JAX's default `take`: the segment index
    floor(x/h) is clamped to the table's segments, so an x past the table
    extrapolates the last cubic, and the gradient flows through t only.

JAX's `split` and `cheb` lookups and their NFTPU_EAM_SPLINE_IMPL switch are
TPU lowering workarounds and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .dataset import TrajectoryTarget

# Finnis & Sinclair (1984) alpha-iron parameters (eV, Angstrom).
FS_IRON = {
    "A": 1.828905,
    "d": 3.569745,
    "beta": 1.8,
    "c": 3.40,
    "c0": 1.2371147,
    "c1": -0.3592185,
    "c2": -0.0385607,
}

SPLINES = ("f_spl", "rho_spl", "rphi_spl")


def _pair_distances(pos, boxlength):
    """(..., n, 3) -> (..., n, n) minimum-image distances, with r = 1 on
    the diagonal, and the (n, n) diagonal mask."""
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    if boxlength is not None:
        diff = diff - torch.round(diff / boxlength) * boxlength
    r2 = torch.sum(diff * diff, dim=-1)
    n = pos.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    r2 = torch.where(eye, torch.ones_like(r2), r2)  # finite sqrt and grad
    return torch.sqrt(r2), eye


def fs_iron_energy(pos, boxlength, params=FS_IRON):
    """Total Finnis-Sinclair energy of each (..., n, 3) configuration."""
    r, eye = _pair_distances(pos, boxlength)
    A, d, beta, c = params["A"], params["d"], params["beta"], params["c"]
    c0, c1, c2 = params["c0"], params["c1"], params["c2"]
    zero = torch.zeros_like(r)

    dr_c = c - r
    pair = torch.where((r < c) & ~eye,
                       dr_c * dr_c * (c0 + c1 * r + c2 * r * r), zero)
    dr_d = r - d
    psi = torch.where((r < d) & ~eye,
                      dr_d * dr_d + beta * dr_d * dr_d * dr_d / d, zero)
    rho = torch.sum(psi, dim=-1)
    embed = -A * torch.sqrt(torch.maximum(rho, rho.new_tensor(1e-12)))
    return 0.5 * torch.sum(pair, dim=(-2, -1)) + torch.sum(embed, dim=-1)


# ------------------------------------------------------------- setfl tables
def _natural_cubic_coeffs(y, h):
    """Natural cubic-spline coefficients on a uniform grid (numpy float64).

    Returns an (n-1, 4) matrix [a, b, c, d] so that on segment k
    (x in [k*h, (k+1)*h], t = x - k*h): f = a + b t + c t^2 + d t^3.
    """
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    # Thomas algorithm for second derivatives M: M[0]=M[n-1]=0,
    # M[i-1] + 4 M[i] + M[i+1] = 6 (y[i+1]-2y[i]+y[i-1]) / h^2.
    rhs = 6.0 * (y[2:] - 2.0 * y[1:-1] + y[:-2]) / (h * h)
    m = np.zeros(n)
    if n > 2:
        cp = np.zeros(n - 2)
        dp = np.zeros(n - 2)
        cp[0] = 1.0 / 4.0
        dp[0] = rhs[0] / 4.0
        for i in range(1, n - 2):
            denom = 4.0 - cp[i - 1]
            cp[i] = 1.0 / denom
            dp[i] = (rhs[i] - dp[i - 1]) / denom
        m[n - 2] = dp[-1]
        for i in range(n - 3, 0, -1):
            m[i] = dp[i - 1] - cp[i - 1] * m[i + 1]
    a = y[:-1]
    b = (y[1:] - y[:-1]) / h - h * (2.0 * m[:-1] + m[1:]) / 6.0
    c = m[:-1] / 2.0
    d = (m[1:] - m[:-1]) / (6.0 * h)
    return np.stack([a, b, c, d], axis=1)


def _spline_eval(coeffs, h, x):
    """Evaluate a uniform-grid cubic spline, `coeffs` (n-1, 4) a tensor on
    x's device, at x (any shape). The segment index is clamped to
    [0, n-2], so the end segments extrapolate."""
    k = torch.clamp(torch.floor(x / h).to(torch.int64), 0,
                    coeffs.shape[0] - 1)
    t = x - k.to(x.dtype) * h
    abcd = coeffs[k]
    a, b, c, d = (abcd[..., j] for j in range(4))
    return ((d * t + c) * t + b) * t + a


def load_setfl(path):
    """Parse a single-element DYNAMO setfl (eam.alloy / eam.fs) file.

    Format: 3 comment lines; `nelements names`; `nrho drho nr dr cutoff`;
    the element's header; then F(rho) [nrho], rho(r) [nr] and r*phi(r) [nr],
    whitespace-separated. Returns {"f_spl", "rho_spl", "rphi_spl"}: the
    (n-1, 4) spline coefficients of each table (numpy float64), and "drho",
    "dr", "cutoff".
    """
    with open(path) as fh:
        lines = fh.read().split("\n")
    vals = lines[4].split()
    nrho, drho, nr, dr, cutoff = (
        int(vals[0]), float(vals[1]), int(vals[2]), float(vals[3]),
        float(vals[4]))
    numbers = []
    for line in lines[6:]:
        numbers.extend(float(tok) for tok in line.split())
    numbers = np.asarray(numbers)
    expected = nrho + 2 * nr
    if numbers.size < expected:
        raise ValueError(
            f"setfl file {path!r} has {numbers.size} values, "
            f"expected {expected} (nrho={nrho}, nr={nr})")
    f_rho = numbers[:nrho]
    rho_r = numbers[nrho:nrho + nr]
    rphi = numbers[nrho + nr:nrho + 2 * nr]
    return {"f_spl": _natural_cubic_coeffs(f_rho, drho), "drho": drho,
            "rho_spl": _natural_cubic_coeffs(rho_r, dr),
            "rphi_spl": _natural_cubic_coeffs(rphi, dr), "dr": dr,
            "cutoff": cutoff}


def tabulated_eam_energy(pos, boxlength, tables):
    """Total energy of each (..., n, 3) configuration from setfl tables by
    cubic-spline interpolation. The spline entries of `tables` may be numpy
    arrays or tensors; they are used in pos's dtype on pos's device."""
    spl = {k: torch.as_tensor(tables[k], dtype=pos.dtype, device=pos.device)
           for k in SPLINES}
    r, eye = _pair_distances(pos, boxlength)
    dr, drho, cutoff = tables["dr"], tables["drho"], tables["cutoff"]
    zero = torch.zeros_like(r)
    within = (r < cutoff) & ~eye
    r_safe = torch.where(within, r, torch.full_like(r, cutoff))
    # setfl stores r*phi (well-behaved at small r); divide by r after interp
    rphi = _spline_eval(spl["rphi_spl"], dr, r_safe)
    phi = rphi / torch.maximum(r_safe, r_safe.new_tensor(dr))
    psi = _spline_eval(spl["rho_spl"], dr, r_safe)
    phi = torch.where(within, phi, zero)
    psi = torch.where(within, psi, zero)
    rho = torch.sum(psi, dim=-1)
    embed = _spline_eval(spl["f_spl"], drho, rho)
    return 0.5 * torch.sum(phi, dim=(-2, -1)) + torch.sum(embed, dim=-1)


class EAMIron(TrajectoryTarget):
    """EAM iron target: potential(x), x (batch, n*3) or (batch, n, 3) ->
    (batch,) energies in eV; log_prob = -U/kT. With `setfl_path` the
    energies come from the table, else from the analytic model. With
    trajectory data attached (`pos_dir` or `update_data`), `sample` draws
    frames from it (the reference's Fe(LAMMPS, SimData) hybrid). The tables
    live on the target's device and dtype."""

    def __init__(self, nparticles, boxlength=None, kT=1.0, setfl_path=None,
                 fs_params=None, pos_dir=None, data_type="xyz", device=None,
                 dtype=None):
        super().__init__()
        self.n_particles = int(nparticles)
        self.point_dim = 3
        self.dim = self.n_particles * 3
        self.boxlength = None if boxlength is None else float(boxlength)
        self.kT = float(kT)
        self.fs_params = dict(fs_params or FS_IRON)
        self.tables = None
        if setfl_path:
            raw = load_setfl(setfl_path)
            dtype_ = dtype or torch.get_default_dtype()
            self.tables = {k: (torch.as_tensor(v, dtype=dtype_, device=device)
                               if k in SPLINES else v)
                           for k, v in raw.items()}
        self._attach(pos_dir, data_type, device, dtype)

    def potential(self, x):
        pos = x.reshape(-1, self.n_particles, 3)
        if self.tables is not None:
            return tabulated_eam_energy(pos, self.boxlength, self.tables)
        return fs_iron_energy(pos, self.boxlength, self.fs_params)

    def log_prob(self, x):
        return -self.potential(x) / self.kT
