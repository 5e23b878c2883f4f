from .data import SceneData, CameraData, SceneBuilder, build_scene, scene_from_arrays  # noqa: F401
from .mitsuba import load_mitsuba_scene  # noqa: F401
from .obj import load_obj  # noqa: F401
