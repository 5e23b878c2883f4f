"""frame_p95_ms: the nearest-rank 95th percentile of the wall time of
every frame of the window, from its issue to its image in host memory."""

from spectral_bench.harness import stats


def read(run):
    return stats.percentile(run.unit_s, 95) * 1e3
