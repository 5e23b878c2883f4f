from .path_tracer import render_image, render_sample, trace_rays  # noqa: F401


def render_image_stats_auto(scene, cfg, timestamp0: int = 0):
    """Render (H, W, 3) plus the total rays traced, picking the integrator.

    For CUDA tensors, eligible (scene, cfg) pairs run the megakernel (K1);
    everything else runs the wavefront, whose intersections go through the
    brute-force kernels (K2).  For CPU tensors the wavefront runs with its
    plain torch scans.  `cfg.intersector == "mega"` forces the megakernel
    (its plain version for CPU tensors)."""
    from .mega import mega_eligible, render_mega
    from .path_tracer import render_image_stats

    on_cuda = scene.device.type == "cuda"
    forced = cfg.intersector == "mega"
    if mega_eligible(scene, cfg) and (forced or (cfg.intersector == "auto" and on_cuda)):
        return render_mega(scene, cfg, timestamp0)
    return render_image_stats(scene, cfg, timestamp0)


def render_image_auto(scene, cfg, timestamp0: int = 0):
    """Render (H, W, 3); see render_image_stats_auto."""
    return render_image_stats_auto(scene, cfg, timestamp0)[0]
