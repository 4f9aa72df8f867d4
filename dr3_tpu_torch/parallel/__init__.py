"""Distribution of the port over torch.distributed (port of dr3_tpu.parallel)."""
