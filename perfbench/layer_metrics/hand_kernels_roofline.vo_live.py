"""The hand-written kernels' share of their roofline in this cell's
profiled slice (perfbench.kernel_bounds.roofline_pct)."""

from perfbench.kernel_bounds import roofline_pct as read  # noqa: F401
