"""The device's idle share of the traced window, in %: 1 - busy / window,
busy the union of its kernel, copy and set intervals (trace)."""

from nfbench.readers import idle_pct as read  # noqa: F401
