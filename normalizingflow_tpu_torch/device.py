"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def entry_device(device="cuda"):
    """Resolve an entry point's `device` argument; never fall back to CPU.

    A CUDA device on a host without a usable GPU raises instead of quietly
    running on the CPU. On CUDA, TF32 is switched off for matmuls and cuDNN:
    the port's parity and statistics checks assume full-f32 products, and
    cuDNN convolutions default to TF32.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def check_on(device, *tensors):
    """Raise unless every tensor lies on `device`."""
    for t in tensors:
        if t.device.type != device.type or (
                device.index is not None and t.device != device):
            raise ValueError(f"tensor on {t.device}, expected {device}")
