from .config import RenderConfig  # noqa: F401
