"""render_mpaths_per_s: millions of paths (pixels x samples) of every
frame the window completed, over the window's wall time."""

from spectral_bench.harness import stats


def read(run):
    return stats.rate(sum(run.unit_work), run.window_s) / 1e6
