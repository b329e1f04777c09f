"""Kernel launches in the traced window over the units of work it holds
(trace: kernel records)."""

from nfbench.readers import per_unit_launches as read  # noqa: F401
