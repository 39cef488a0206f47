"""Experiment entry points of the port: ``roofline`` (the batched tCG
kernels against H100 peaks and against the bare matvec chain, K5)."""
