"""scene_load_s: host seconds of the port's scene constructor (parse or
generation, tables, BVH build), ending at a synchronize."""


def read(run):
    return run.scene_load_s
