"""Engine: the top-level context object (port of gpuspectral_tpu/engine.py).

Mirrors the reference's Engine/Window/Renderer trio (engine/Engine.h:26-38,
engine/Window.h:23, renderer/Renderer.h:44-57) headless:

  * Engine owns the device and asset-path resolution
    (Engine::assetPath, Engine.cpp:12-15),
  * `load_scene` is the Loader entry (Loader.h:29),
  * `run` is the Window::run + Renderer::run frame loop: progressive
    accumulation with the reference's running-mean semantics
    (raygen.rgen:84-91), one timestamp per frame, optional per-frame
    callback in place of a swapchain present,
  * each frame is a profiling stage named after the reference's pass
    ("Frame"; SURVEY.md §5.1), so traces line up.

The device defaults to the card ("cuda"); without a CUDA device the Engine
raises unless the caller asks for the CPU (device="cpu", the kernels' plain
versions).  The accumulation buffer lives on the device and render_step
updates it in place, as the reference writes its storage image.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .integrator.path_tracer import render_step
from .scene import load_mitsuba_scene
from .scene.data import SceneData, check_device
from .utils.config import RenderConfig
from .utils.metrics import MetricsLogger
from .utils.profiling import stage


class Engine:
    def __init__(self, base_path: str = ".", asset_path: Optional[str] = None,
                 device="cuda"):
        self.base_path = base_path
        self._asset_path = asset_path or os.path.join(base_path, "scenes")
        self.device = check_device(device)
        self.scene: Optional[SceneData] = None
        self.cfg = RenderConfig()
        self.accum: Optional[torch.Tensor] = None
        self.timestamp = 0
        self.metrics = MetricsLogger(None)

    # Engine::assetPath (Engine.cpp:12-15)
    def asset_path(self, name: str = "") -> str:
        return os.path.join(self._asset_path, name)

    # Engine::init (Engine.cpp:37-40) — width/height instead of a window
    def init(self, width: int, height: int, **cfg_kw) -> "Engine":
        self.cfg = self.cfg.replace(width=width, height=height, **cfg_kw)
        self.reset()
        return self

    # loadScene (Loader.cpp:253)
    def load_scene(self, path: str) -> SceneData:
        self.scene, _ = load_mitsuba_scene(path, device=self.device)
        self.reset()
        return self.scene

    def reset(self) -> None:
        """Clear the progressive accumulation buffer."""
        self.accum = torch.zeros((self.cfg.height, self.cfg.width, 3), dtype=torch.float32,
                                 device=self.device)
        self.timestamp = 0

    def _host_image(self) -> np.ndarray:
        """The running mean as a numpy array of its own (a copy: the buffer
        keeps changing in place)."""
        return self.accum.detach().cpu().numpy().copy()

    # Window::run + Renderer::run (Window.cpp:20-25, Renderer.cpp:93-116)
    def run(
        self,
        frames: int,
        on_frame: Optional[Callable[[int, np.ndarray], None]] = None,
        scene: Optional[SceneData] = None,
    ) -> np.ndarray:
        """Run `frames` progressive 1-spp frames; returns the accumulated
        image as numpy.  `on_frame(i, image)` stands in for the swapchain
        present."""
        scene = scene or self.scene
        assert scene is not None, "load_scene first"
        one = self.cfg.replace(spp=1)
        for _ in range(frames):
            t0 = time.time()
            with stage("Frame"):  # FrameMark (Renderer.cpp:94)
                render_step(scene, one, self.accum, self.timestamp)
            self.timestamp += 1
            if on_frame is not None:
                on_frame(self.timestamp, self._host_image())
            self.metrics.log(
                event="frame", timestamp=self.timestamp, seconds=time.time() - t0
            )
        return self._host_image()

    def save(self, path: str, tonemap: bool = False) -> None:
        from .io import write_exr, write_pfm, write_png

        img = self._host_image()
        if path.endswith(".exr"):
            write_exr(path, img)
        elif path.endswith(".pfm"):
            write_pfm(path, img)
        else:
            write_png(path, img, tonemap=tonemap)

    def checkpoint(self, path: str) -> None:
        """Persist resumable progressive state (SURVEY.md §5.4)."""
        from .io.checkpoint import save_checkpoint

        save_checkpoint(path, dict(accum=self._host_image(), timestamp=np.uint32(self.timestamp)))

    def restore(self, path: str) -> None:
        from .io.checkpoint import load_checkpoint

        state = load_checkpoint(path)
        self.accum = torch.tensor(state["accum"], dtype=torch.float32, device=self.device)
        self.timestamp = int(state["timestamp"])
