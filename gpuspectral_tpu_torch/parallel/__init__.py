"""(tiles x spp) distribution over torch.distributed ranks (port of
gpuspectral_tpu/parallel)."""

from .dist import (make_mesh, render_image_sharded,  # noqa: F401
                   render_image_sharded_fast, grad_step_sharded,
                   grad_step_sharded_fast)
from .launch import initialize, pod_mesh, is_coordinator, gather_image  # noqa: F401
