"""k1_prep_ms: the port's span "gst.k1.prep" a frame (its self time in the
traced window over the frames): the frame's pixel rows, K1's tables
(woop_rows, _pack_tables, pack_env), its parameters and its output planes,
made on the host while the card waits for K1's launch."""

from spectral_bench.harness import spans


def read(run):
    return spans.per_unit_ms(run, "gst.k1.prep")
