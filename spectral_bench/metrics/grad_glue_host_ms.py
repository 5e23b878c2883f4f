"""grad_glue_host_ms: the host's own time in the port's inversion a step:
the time inside "gst.invert" spans and outside K5's ("gst.k5.*") and the
waits for the device ("gst.sync.*"), over the steps.  That is each call's
set-up, and each step's loss, contraction, scatter and Adam."""

from spectral_bench.harness import spans


def read(run):
    return spans.glue_ms(run, "gst.invert", ("gst.k5.", spans.SYNC))
