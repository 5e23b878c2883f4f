"""Image, EXR and checkpoint files (numpy copies of gpuspectral_tpu/io)."""

from .image import gamma_correct, read_pfm, tonemap_aces, write_exr, write_pfm, write_png  # noqa: F401
