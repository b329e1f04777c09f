"""apps.train with the autoregressive conditioners' matmuls at a TPU's
default precision.

    python tools/torch_bf16_train.py <config.yaml> [apps.train's arguments]

The JAX package sets no matmul precision, so on a TPU its float32 matmuls
take their operands in bfloat16 and accumulate in float32 (XLA's default
there), in the forward and the backward pass; the port computes them in
full float32. This runs the port's training CLI with the SplineAR and
MaskedAffineAR conditioners' einsums and matmuls on operands rounded to
bfloat16 (their gradients too, as the cast's backward rounds them), so
that a fit made at the TPU's precision can be compared with the port's
own. Parameters, Adam, the spline and its kernels stay float32. Imports
torch and the port only; runs where the config says (the card).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from normalizingflow_tpu_torch.apps import train  # noqa: E402
from normalizingflow_tpu_torch.bijectors import (  # noqa: E402
    autoregressive,
)


def bf16(t):
    """`t` rounded to bfloat16, in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def apply_all(self, feats):
    """_MaskedStackedMLPs.apply_all on bfloat16-rounded operands."""
    w1m = self.w1 * self.row_masks[:, :, None]
    h = torch.tanh(torch.einsum("bf,ifh->ibh", bf16(feats), bf16(w1m))
                   + self.b1[:, None, :])
    h = torch.tanh(torch.einsum("ibh,ihg->ibg", bf16(h), bf16(self.w2))
                   + self.b2[:, None, :])
    return torch.einsum("ibh,iho->ibo", bf16(h), bf16(self.w3)) \
        + self.b3[:, None, :]


def apply_one(self, feats, i):
    """_MaskedStackedMLPs.apply_one on bfloat16-rounded operands."""
    j = i - 1
    h = torch.tanh(bf16(feats) @ bf16(self.w1[j]) + self.b1[j])
    h = torch.tanh(bf16(h) @ bf16(self.w2[j]) + self.b2[j])
    return bf16(h) @ bf16(self.w3[j]) + self.b3[j]


def main(argv=None):
    mlps = autoregressive._MaskedStackedMLPs
    mlps.apply_all, mlps.apply_one = apply_all, apply_one
    code = train.main(list(sys.argv[1:] if argv is None else argv))
    print("conditioner matmuls: bfloat16 operands, float32 accumulation")
    return code


if __name__ == "__main__":
    sys.exit(main())
