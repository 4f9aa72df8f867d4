"""The device's idle share of this cell's profiled slice
(perfbench.trace.idle_pct)."""

from perfbench.trace import idle_pct as read  # noqa: F401
