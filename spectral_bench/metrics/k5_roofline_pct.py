"""k5_roofline_pct: K5 (integrator/mega_grad.py -> csrc/mega_grad.cu,
kernel mega_grad_kernel) against its bound: the brute-force scan's Woop
tests and the shaded vertices of the step's rays, as the reference traced
them for the first step, over K5's device time a step."""

from spectral_bench.harness import kernels


def read(run):
    return kernels.roofline_pct(run, r"\bmega_grad_kernel\b", "brute")
