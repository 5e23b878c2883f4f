"""k5_prep_ms: the port's span "gst.k5.prep" a step (its self time in the
traced window over the steps): the frame's pixel rows, K5's tables with
the attr concatenation, and the partial planes' zero-fill."""

from spectral_bench.harness import spans


def read(run):
    return spans.per_unit_ms(run, "gst.k5.prep")
