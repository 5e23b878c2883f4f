"""k4_prep_ms: the port's span "gst.k4.prep" a frame (its self time in the
traced window over the frames): the frame's pixel rows, K4's tables
(walk_tables, pack_attr, _pack_tables, pack_env), its parameters and its
output planes, made on the host while the card waits for K4's launch.
None from a port without the span."""

from spectral_bench.harness import spans


def read(run):
    return spans.per_unit_ms(run, "gst.k4.prep")
