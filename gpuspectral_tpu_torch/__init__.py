"""gpuspectral_tpu_torch: the path tracer of `gpuspectral_tpu` in PyTorch + CUDA.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's name and semantics, with PyTorch idiom inside:

  scene/       Mitsuba-XML + OBJ loading -> SceneData (dataclass of tensors),
               scenes built in code (zoo.py)
  bvh/         the SAH build (numpy) and the BVH walk kernels
  ops/         RNG, 3D math, sampling, Fresnel/GGX, brute-force intersection
  bsdf/        the 8-BSDF library (sample/eval) with dispatch by kind
  integrator/  the wavefront path tracer (differentiable) and the megakernels
  diff/        gradient checks and inverse rendering
  io/          image, EXR and checkpoint files
  utils/       RenderConfig, benchmark harness, metrics
  cli/         render / benchmark / gradcheck / invert entry points
  csrc/        hand-written CUDA kernels for sm_90a (built by _build.py)

Hand-written kernels: K1 and K4, the path-tracing megakernels (brute force
and BVH; csrc/mega.cu, csrc/mega_bvh.cu), K5 and K6, the same with the
fused gradient hook (csrc/mega_grad.cu, csrc/mega_bvh.cu, csrc/grad.cuh),
K2, brute-force closest / any hit (csrc/isect.cu), K3, BVH closest / any
hit (csrc/bvh.cu), and the wavefront's other BVH kernels: K7a / K7b, the
binned sweep (csrc/binned.cu), K7c-e, the cluster sweep (csrc/cluster.cu),
and K7f / K7g, the dfs walk (csrc/dfs.cu).  Each wrapper runs its plain
PyTorch version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.

The port imports neither JAX nor the JAX package; it keeps its own copies
of the numpy modules it needs.  The multi-device paths and the
progressive engine are not ported yet.

No matmul is on the render path (the camera is explicit component
products), and TF32 is switched off for both matmul and cuDNN so that any
later one runs in full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
