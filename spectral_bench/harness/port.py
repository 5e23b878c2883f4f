"""The benchmark's calls into the system under test, gpuspectral_tpu_torch:
its scene constructors and its render settings.  Imported only inside
functions, so that the reference and the tests can load this package
without the port."""

from __future__ import annotations

import os


def build_kernels() -> float:
    """Load the port's kernel library (building it on the first run in a
    checkout); returns the seconds it took."""
    import time

    from gpuspectral_tpu_torch import _build

    t = time.perf_counter()
    _build.load()
    return time.perf_counter() - t


def load_scene(spec: dict, root: str, device):
    """The port's SceneData of a configuration's "scene" block."""
    if spec["kind"] == "mitsuba_xml":
        from gpuspectral_tpu_torch.scene import load_mitsuba_scene

        return load_mitsuba_scene(os.path.join(root, spec["file"]), device=device)[0]
    if spec["kind"] == "builtin":
        from gpuspectral_tpu_torch.scene import SceneBuilder
        from gpuspectral_tpu_torch.scene.zoo import BUILTIN

        return BUILTIN[spec["name"]](SceneBuilder()).build(device)
    raise ValueError(f"no scene constructor for {spec}")


def render_config(render: dict, job: dict):
    """The port's RenderConfig: the configuration's render settings and the
    traffic's film, samples and depth."""
    from gpuspectral_tpu_torch.utils.config import RenderConfig

    return RenderConfig(width=job["width"], height=job["height"], spp=job["spp"],
                        max_depth=job["max_depth"], **render)
