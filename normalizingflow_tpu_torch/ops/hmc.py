"""HMC Metropolis accept + state select over a chain batch.

Twin of normalizingflow_tpu/ops/hmc_pallas.py. On CUDA tensors
`accept_select` always launches the hand-written sm_90a kernel in
csrc/accept_select.cu (one pass over the chain state, where the plain
version makes about a dozen eager passes); on CPU tensors it runs
`accept_select_ref`, the line-for-line twin of the JAX package's
`_accept_select_ref`. There is no switch between the two: the tensors'
device decides, and a CUDA call that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "accept_select"


def accept_select_ref(q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old,
                      log_u, inv_mass_diag):
    """Plain PyTorch Metropolis block of mcmc/hmc.py's transition."""
    kin_new = 0.5 * torch.sum(inv_mass_diag * p * p, dim=-1)
    h_new = -lp_new + kin_new
    d_energy = h_old - h_new
    log_accept = torch.minimum(torch.zeros_like(d_energy), d_energy)
    finite = torch.isfinite(h_new)
    accepted = (log_u < log_accept) & finite
    pos = torch.where(accepted[:, None], q, pos_old)
    g = torch.where(accepted[:, None], g_new, g_old)
    lp = torch.where(accepted, lp_new, lp_old)
    accept_prob = torch.where(finite, torch.exp(log_accept),
                              torch.zeros_like(log_accept))
    return pos, lp, g, accept_prob, accepted, d_energy


def _library():
    lib = _build.load(KERNEL)
    fn = lib.nf_accept_select_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u,
           inv_mass_diag):
    if q.dim() != 2 or q.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError(f"q must be (chains, dim) with both >= 1, got "
                         f"{tuple(q.shape)}")
    n, d = q.shape
    named = dict(q=q, p=p, g_new=g_new, pos_old=pos_old, g_old=g_old,
                 lp_new=lp_new, lp_old=lp_old, h_old=h_old, log_u=log_u,
                 inv_mass_diag=inv_mass_diag)
    shapes = dict(q=(n, d), p=(n, d), g_new=(n, d), pos_old=(n, d),
                  g_old=(n, d), lp_new=(n,), lp_old=(n,), h_old=(n,),
                  log_u=(n,), inv_mass_diag=(d,))
    if max(n, d) > 2**31 - 1:
        raise ValueError(f"shape {(n, d)} too large for the kernel")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    vec4 = d % 4 == 0 and all(
        t.data_ptr() % 16 == 0
        for t in (q, p, g_new, pos_old, g_old, inv_mass_diag))
    return n, d, vec4


def accept_select_cuda(q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old,
                       log_u, inv_mass_diag):
    """Launch the CUDA kernel on the current stream; outputs as in
    `accept_select_ref`. Raises on inputs the kernel does not take and on
    a failed launch."""
    n, d, vec4 = _check(q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old,
                        log_u, inv_mass_diag)
    fn = _library()
    pos = torch.empty_like(q)
    g = torch.empty_like(q)
    lp = torch.empty_like(lp_new)
    accept_prob = torch.empty_like(lp_new)
    accepted = torch.empty(n, dtype=torch.bool, device=q.device)
    d_energy = torch.empty_like(lp_new)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (
        q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u,
        inv_mass_diag, pos, lp, g, accept_prob, accepted, d_energy)]
    err = fn(*ptrs, n, d, int(vec4), stream)
    if err != 0:
        raise RuntimeError(f"accept_select kernel launch failed: CUDA error "
                           f"{err}")
    accept_select.launches += 1
    return pos, lp, g, accept_prob, accepted, d_energy


def accept_select(q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u,
                  inv_mass_diag):
    """Fused HMC Metropolis accept + state select over a chain batch.

    Returns (position, log_prob, grad, accept_prob, accepted, d_energy),
    in the JAX package's order and layout. CUDA tensors go to the kernel
    (float32 only; anything else raises), CPU tensors to the plain twin.
    `accept_select.launches` counts kernel launches.
    """
    if q.is_cuda:
        return accept_select_cuda(q, p, g_new, pos_old, g_old, lp_new,
                                  lp_old, h_old, log_u, inv_mass_diag)
    if q.device.type != "cpu":
        raise ValueError(f"accept_select: unsupported device {q.device}")
    return accept_select_ref(q, p, g_new, pos_old, g_old, lp_new, lp_old,
                             h_old, log_u, inv_mass_diag)


accept_select.launches = 0
