"""grad_outside_k5_ms: a step's wall time in the traced window less K5's
device time a step: the packing, the partial planes' zero-fill, the
contraction, Adam, the loss read back and each chunk's start."""

from spectral_bench.harness import kernels


def read(run):
    tr = run.trace
    if tr is None or not tr.units:
        return None
    n = kernels.units(run)
    k5 = tr.kernel_s(r"\bmega_grad_kernel\b")
    if k5 <= 0:
        return None
    return (tr.window_s - k5) / n * 1e3
