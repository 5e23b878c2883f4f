"""grad_steps_per_s: every inverse-rendering step the window completed,
over the window's wall time."""

from spectral_bench.harness import stats


def read(run):
    return stats.rate(len(run.unit_s), run.window_s)
