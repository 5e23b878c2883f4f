"""Worker for tests/test_torch_elastic.py: one rank of an elastic gang.

argv: ckpt_path total_frames fault_at (rank 1 only; -1 = none) timeout_s
(every collective of the group fails after it) [stay_dead: rank 1 of a
gang of more than one also dies at start once the checkpoint has passed
fault_at, so the supervisor must shrink the gang]."""

import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch

torch.set_num_threads(1)  # the gang's ranks share the host's cores

import torch.distributed as dist

from gpuspectral_tpu_torch.io.checkpoint import load_checkpoint
from gpuspectral_tpu_torch.parallel import launch
from gpuspectral_tpu_torch.parallel.elastic import render_chunks
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.utils import RenderConfig

CFG = dict(width=16, height=8, spp=2, max_depth=2, ray_batch=64)


def main() -> int:
    ckpt, total, fault_at = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    stay_dead = sys.argv[5:] == ["stay_dead"]
    launch.initialize(device="cpu", timeout_s=float(sys.argv[4]))  # gloo ranks
    try:
        scene, _ = load_mitsuba_scene(str(REPO / "scenes/cornell/scene.xml"), device="cpu")
        mesh = launch.pod_mesh(spp_shards=1)
        host_id = int(os.environ["GPUSPECTRAL_FAKE_HOST_ID"])
        sick = host_id == 1 and dist.get_world_size() > 1
        if sick and stay_dead and os.path.exists(ckpt) and (
                int(load_checkpoint(ckpt)["frames"]) >= fault_at):
            os._exit(41)  # this host stays dead: only a smaller gang can finish
        my_fault = fault_at if sick else -1
        render_chunks(scene, RenderConfig(**CFG), mesh, total, ckpt, chunk_frames=1,
                      _fault_at=my_fault)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
