"""idle_in_port_pct.grad: the share of the card's idle time in the traced
window during which the host is inside one of the port's spans ("gst.*")
and not waiting in a "gst.sync.*" span.  The rest is the wait itself and
the harness's own work between units (the copy into the pinned buffer,
the sampled pixels' gather, a chunk's hand-off)."""

from spectral_bench.harness import spans


def read(run):
    return spans.idle_in_port_pct(run)
