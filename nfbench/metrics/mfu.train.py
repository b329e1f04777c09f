"""The whole step's share of the card's fp32 peak (66.9 TFLOP/s, 700 W), in
%: the configuration's matrix-product FLOPs, counted from its shapes, of
the traced units over the traced window (trace: window and units)."""

from nfbench.readers import mfu_pct as read  # noqa: F401
