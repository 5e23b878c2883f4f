from .path_tracer import render_image, render_sample, trace_rays  # noqa: F401


def render_image_stats_auto(scene, cfg, timestamp0: int = 0):
    """Render (H, W, 3) plus the total rays traced, picking the integrator
    (gpuspectral_tpu/integrator/__init__.py:4-63):

      * the megakernel (K1) when mega_eligible, for CUDA tensors with
        intersector "auto" or forced with "mega";
      * the fused-BVH megakernel (K4) when mega_bvh_eligible, for CUDA
        tensors with "auto" or forced with "mega_bvh";
      * otherwise the wavefront, on the brute-force kernels (K2) or, with
        cfg.use_bvh, the BVH kernels that cfg.bvh_kernel names (K3 for
        "ftb", K7c-e for "cluster").

    For CPU tensors every path runs its plain torch version.  The call is
    the span "gst.render" (utils/profiling)."""
    from ..utils.profiling import stage
    from .mega import mega_eligible, render_mega
    from .mega_bvh import mega_bvh_eligible, render_mega_bvh
    from .path_tracer import render_image_stats

    with stage("gst.render"):
        auto_cuda = cfg.intersector == "auto" and scene.device.type == "cuda"
        if mega_eligible(scene, cfg) and (cfg.intersector == "mega" or auto_cuda):
            return render_mega(scene, cfg, timestamp0)
        if mega_bvh_eligible(scene, cfg) and (cfg.intersector == "mega_bvh" or auto_cuda):
            return render_mega_bvh(scene, cfg, timestamp0)
        return render_image_stats(scene, cfg, timestamp0)


def render_image_auto(scene, cfg, timestamp0: int = 0):
    """Render (H, W, 3); see render_image_stats_auto."""
    return render_image_stats_auto(scene, cfg, timestamp0)[0]
