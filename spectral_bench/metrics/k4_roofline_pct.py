"""k4_roofline_pct: K4 (integrator/mega_bvh.py -> csrc/mega_bvh.cu, kernel
mega_bvh_kernel) against its bound: reference/bvh_count.py's box and Woop
tests per ray on the reference's recorded rays plus the shaded vertices,
times the frame's rays, and the bytes of the lanes, the tree and the
tables, over K4's device time a frame.  None without a K4 kernel in the
trace or a BVH count."""

from spectral_bench.harness import kernels


def read(run):
    return kernels.roofline_pct(run, r"\bmega_bvh_kernel\b", "bvh")
