"""host_syncs_per_unit.grad: the port's "gst.sync.*" spans (each a read-back
or upload the host waits for) in the traced window, over its units."""

from spectral_bench.harness import spans


def read(run):
    return spans.syncs_per_unit(run)
