"""gpuspectral_tpu_torch: the path tracer of `gpuspectral_tpu` in PyTorch + CUDA.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's name and semantics, with PyTorch idiom inside:

  scene/       Mitsuba-XML + OBJ loading -> SceneData (dataclass of tensors)
  ops/         RNG, 3D math, sampling, Fresnel/GGX, brute-force intersection
  bsdf/        the 8-BSDF library (sample/eval) with dispatch by kind
  integrator/  the wavefront path tracer and the fused megakernel
  utils/       RenderConfig, benchmark harness
  cli/         render / benchmark entry points
  csrc/        hand-written CUDA kernels for sm_90a (built by _build.py)

Hand-written kernels: K1, the persistent path-tracing megakernel
(csrc/mega.cu, wrapper integrator/mega.py) and K2, the brute-force closest /
any-hit pair (csrc/isect.cu, wrapper ops/cuda_isect.py).  Each wrapper runs
its plain PyTorch version for CPU tensors only; for CUDA tensors it launches
the kernel or raises.

Scope: scenes of at most 2048 triangles, untextured, without environment
emitters.  Anything else raises NotImplementedError naming the later slice
of the port that adds it.

No matmul is on the render path (the camera is explicit component
products), and TF32 is switched off for both matmul and cuDNN so that any
later one runs in full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
