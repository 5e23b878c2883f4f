"""Differentiable rendering: gradient checks and inverse rendering (port of
gpuspectral_tpu/diff)."""
