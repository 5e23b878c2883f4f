"""scene_host_s: the port's own record of its scene load (the registry of
gpuspectral_tpu_torch.utils.profiling): the seconds of "gst.scene.load"
less those of "gst.scene.upload", i.e. the parse, the tables and the BVH
on the host, without the upload and the CUDA context's first use.  None
from a port without the registry or the span."""


def read(run):
    from gpuspectral_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    spans = snapshot() if snapshot is not None else {}
    if "gst.scene.load" not in spans:
        return None
    upload = spans.get("gst.scene.upload", {}).get("seconds", 0.0)
    return spans["gst.scene.load"]["seconds"] - upload
