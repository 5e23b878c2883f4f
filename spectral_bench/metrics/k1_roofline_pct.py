"""k1_roofline_pct: K1 (integrator/mega.py -> csrc/mega.cu, kernel
mega_kernel) against its bound: the brute-force scan's Woop tests and the
shaded vertices of the reference's rays, per ray, times the frame's rays."""

from spectral_bench.harness import kernels


def read(run):
    return kernels.roofline_pct(run, r"\bmega_kernel\b", "brute")
