"""device_idle_pct.grad: the share of the traced window of a gradient
cell in which no kernel, copy or fill ran on the card."""

from spectral_bench.harness import idle


def read(run):
    return idle.idle_pct(run)
