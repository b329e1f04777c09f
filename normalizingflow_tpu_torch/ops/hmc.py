"""HMC Metropolis accept + state select over a chain batch.

Twin of normalizingflow_tpu/ops/hmc_pallas.py, and of the tensor ops the
JAX transition runs around it. Two functions, one CUDA kernel
(csrc/accept_select.cu, sm_90a):

  * `accept_select_fused` is the whole tail of a transition after its last
    gradient: the leapfrog's last half-kick, both kinetic energies, the
    Metropolis test and the select, optionally in place over the state.
    `mcmc/hmc.py::hmc_transition` calls it.
  * `accept_select` is the JAX kernel's own function (p and h_old given,
    fresh outputs), kept as the twin of the JAX API.

On CUDA tensors each always launches the kernel; on CPU tensors it runs
its plain version (`accept_select_fused_ref`, `accept_select_ref`, the
line-for-line twins of the JAX code). There is no switch between the two:
the tensors' device decides, and a CUDA call that the kernel cannot take
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "accept_select"
ENTRY = "nf_hmc_accept_f32"
# csrc/accept_select.cu's entry point: 18 pointers, n, d, vec4, the stream
ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p])

_entry = None  # the bound entry point, loaded at the first launch


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


def accept_select_fused_ref(q, p_half, eps, g_new, momentum0, state_pos,
                            state_grad, state_lp, lp_new, log_u,
                            inv_mass_diag, inplace=False):
    """Plain version of the transition's tail: the last half-kick and h_old
    as mcmc/hmc.py computed them, then `accept_select_ref`. With `inplace`
    the results are written into state_pos, state_grad and state_lp (a
    rejected row keeps its values), which are returned."""
    p = p_half + 0.5 * eps * g_new
    h_old = -state_lp + 0.5 * torch.sum(
        inv_mass_diag * momentum0 * momentum0, dim=-1)
    pos, lp, g, accept_prob, accepted, d_energy = accept_select_ref(
        q, p, g_new, state_pos, state_grad, lp_new, state_lp, h_old, log_u,
        inv_mass_diag)
    if inplace:
        pos = state_pos.copy_(pos)
        g = state_grad.copy_(g)
        lp = state_lp.copy_(lp)
    return pos, lp, g, accept_prob, accepted, d_energy


def bind(lib):
    """The entry point of the loaded library `lib`, its signature
    declared."""
    fn = getattr(lib, ENTRY)
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _entry
    if _entry is None:
        _entry = bind(_build.load(KERNEL))
    return _entry


UNFUSED_NAMES = ("q", "p", "g_new", "pos_old", "g_old", "lp_new", "lp_old",
                 "h_old", "log_u", "inv_mass_diag")
FUSED_NAMES = ("q", "p_half", "g_new", "momentum0", "state_pos",
               "state_grad", "eps", "lp_new", "state_lp", "log_u",
               "inv_mass_diag")


def _batch_shape(q):
    """(chains, dim) of q; raises unless both are >= 1 and fit the
    kernel's int indices."""
    if q.dim() != 2 or q.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError(f"q must be (chains, dim) with both >= 1, got "
                         f"{tuple(q.shape)}")
    n, d = q.shape
    if max(n, d) > 2**31 - 1:
        raise ValueError(f"shape {(n, d)} too large for the kernel")
    return n, d


def _check_tensors(names, tensors, shapes):
    """Raise unless every tensor is float32, contiguous, of its shape and on
    the first one's device."""
    device = tensors[0].device
    for name, t, shape in zip(names, tensors, shapes):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, q on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vec4(d, tensors):
    """Whether 16-byte loads are safe: D % 4 == 0 and every pointer
    16-byte aligned."""
    return d % 4 == 0 and not any(t.data_ptr() % 16 for t in tensors)


def _check(q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u,
           inv_mass_diag):
    """Validate `accept_select`'s inputs for the kernel; returns (n, d,
    vec4)."""
    n, d = _batch_shape(q)
    _check_tensors(UNFUSED_NAMES, (q, p, g_new, pos_old, g_old, lp_new,
                                   lp_old, h_old, log_u, inv_mass_diag),
                   ((n, d),) * 5 + ((n,),) * 4 + ((d,),))
    return n, d, _vec4(d, (q, p, g_new, pos_old, g_old, inv_mass_diag))


def _check_fused(q, p_half, eps, g_new, momentum0, state_pos, state_grad,
                 state_lp, lp_new, log_u, inv_mass_diag, inplace):
    """Validate `accept_select_fused`'s inputs for the kernel; returns (n,
    d, vec4). In place, q and g_new must not be the state's own tensors."""
    n, d = _batch_shape(q)
    rows = (q, p_half, g_new, momentum0, state_pos, state_grad)
    _check_tensors(FUSED_NAMES, rows + (eps, lp_new, state_lp, log_u,
                                        inv_mass_diag),
                   ((n, d),) * 6 + ((n, 1),) + ((n,),) * 3 + ((d,),))
    if inplace and {q.data_ptr(), g_new.data_ptr()} & {
            state_pos.data_ptr(), state_grad.data_ptr()}:
        raise ValueError("in place, q and g_new must not share memory with "
                         "the state they are written into")
    return n, d, _vec4(d, rows + (inv_mass_diag,))


def _launch(q, p, g_new, mom0, eps, h_old, lp_new, lp_old, log_u, inv_mass,
            old_pos, old_g, out_pos, out_g, out_lp, n, d, vec4):
    """Launch the kernel on the current stream; returns (accept_prob,
    accepted, d_energy). None stands for a null pointer."""
    accept_prob = torch.empty_like(lp_new)
    accepted = torch.empty(n, dtype=torch.bool, device=q.device)
    d_energy = torch.empty_like(lp_new)
    ptrs = [None if t is None else t.data_ptr() for t in (
        q, p, g_new, mom0, eps, h_old, lp_new, lp_old, log_u, inv_mass,
        old_pos, old_g, out_pos, out_g, out_lp, accept_prob, accepted,
        d_energy)]
    err = _kernel()(*ptrs, n, d, int(vec4),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"accept_select kernel launch failed: CUDA error "
                           f"{err}")
    return accept_prob, accepted, d_energy


def accept_select_cuda(q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old,
                       log_u, inv_mass_diag):
    """`accept_select` by the kernel's unfused form, into fresh outputs.
    Raises on inputs the kernel does not take and on a failed launch."""
    n, d, vec4 = _check(q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old,
                        log_u, inv_mass_diag)
    pos, g = torch.empty_like(q), torch.empty_like(q)
    lp = torch.empty_like(lp_new)
    scalars = _launch(q, p, g_new, None, None, h_old, lp_new, lp_old, log_u,
                      inv_mass_diag, pos_old, g_old, pos, g, lp, n, d, vec4)
    accept_select.launches += 1
    return (pos, lp, g, *scalars)


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


def accept_select_fused_cuda(q, p_half, eps, g_new, momentum0, state_pos,
                             state_grad, state_lp, lp_new, log_u,
                             inv_mass_diag, inplace=False):
    """`accept_select_fused` by the kernel. In place it stores only the
    accepted rows into the state. Raises on inputs the kernel does not take
    and on a failed launch."""
    n, d, vec4 = _check_fused(q, p_half, eps, g_new, momentum0, state_pos,
                              state_grad, state_lp, lp_new, log_u,
                              inv_mass_diag, inplace)
    if inplace:
        pos, g, lp = state_pos, state_grad, state_lp
        old_pos = old_g = None
    else:
        pos, g = torch.empty_like(q), torch.empty_like(q)
        lp = torch.empty_like(lp_new)
        old_pos, old_g = state_pos, state_grad
    scalars = _launch(q, p_half, g_new, momentum0, eps, None, lp_new,
                      state_lp, log_u, inv_mass_diag, old_pos, old_g, pos, g,
                      lp, n, d, vec4)
    accept_select_fused.launches += 1
    return (pos, lp, g, *scalars)


def accept_select_fused(q, p_half, eps, g_new, momentum0, state_pos,
                        state_grad, state_lp, lp_new, log_u, inv_mass_diag,
                        inplace=False):
    """The tail of an HMC transition after its last gradient evaluation.

    From the leapfrog's end before its last half-kick (q, p_half, the step
    eps (chains, 1), g_new, lp_new), the transition's initial momentum
    `momentum0` and the state (position, grad, log_prob) it started from:
    completes the kick, takes both Hamiltonians and the Metropolis test
    against log_u, and selects the new state. Returns (position, log_prob,
    grad, accept_prob, accepted, d_energy) as `accept_select` does. With
    `inplace` the new state is written into state_pos, state_grad and
    state_lp, which are returned; a rejected row is left untouched.

    CUDA tensors go to the kernel (float32 only; anything else raises), CPU
    tensors to `accept_select_fused_ref`. `accept_select_fused.launches`
    counts kernel launches.
    """
    if q.is_cuda:
        return accept_select_fused_cuda(
            q, p_half, eps, g_new, momentum0, state_pos, state_grad,
            state_lp, lp_new, log_u, inv_mass_diag, inplace)
    if q.device.type != "cpu":
        raise ValueError(f"accept_select_fused: unsupported device "
                         f"{q.device}")
    return accept_select_fused_ref(q, p_half, eps, g_new, momentum0,
                                   state_pos, state_grad, state_lp, lp_new,
                                   log_u, inv_mass_diag, inplace)


accept_select_fused.launches = 0
