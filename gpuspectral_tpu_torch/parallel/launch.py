"""Multi-process launch helpers (port of gpuspectral_tpu/parallel/launch.py;
SURVEY.md §5.8).

The reference has zero multi-device capability; the port scales with the
standard torch.distributed recipe:

  * every rank runs the SAME program, one process a card (`initialize()`
    wires a torch.distributed process group: NCCL from torchrun's RANK /
    WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT),
  * the global (tiles x spp) mesh spans every rank (`pod_mesh`, a
    torch.distributed DeviceMesh); the sharded functions of
    parallel/dist.py are rank-count agnostic,
  * every rank builds the same scene from the same file (the reference's
    per-host asset loading model), so nothing is broadcast: the JAX
    package's `replicate_pytree` and `global_sharded`, which turn host-local
    arrays into global jax.Arrays, have no counterpart here,
  * the sharded renders gather the image to every rank; `gather_image`
    hands it to the coordinator only (None elsewhere) at IO time,
  * failure model: fail-stop with a timeout on every collective (the
    process group's) + the checkpoint/resume layer (io/checkpoint.py,
    parallel/elastic.py).

Local simulation: `GPUSPECTRAL_FAKE_HOSTS=N` (+ `GPUSPECTRAL_FAKE_HOST_ID`,
`GPUSPECTRAL_COORDINATOR`) runs N OS processes over localhost, the same
names as the JAX package's simulation (parallel/elastic.supervise sets
them): gloo collectives on the CPU when the ranks pass device="cpu", NCCL
on cuda:0 .. cuda:N-1 otherwise.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..scene.data import check_device

DEFAULT_TIMEOUT_S = 600.0  # every collective of the group fails after this long


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Create the torch.distributed process group and return this rank's
    device.

    The group's ranks, in order: the GPUSPECTRAL_FAKE_HOSTS=N simulation
    (N ranks, this one GPUSPECTRAL_FAKE_HOST_ID, rendezvous at
    GPUSPECTRAL_COORDINATOR=host:port; any N, so a gang that
    elastic.supervise shrank to one host keeps its names); torchrun's
    environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    else one rank on a free localhost port (where the JAX package skips
    jax.distributed for one process, the DeviceMesh of the sharded
    functions needs a group).  The device picks the backend: NCCL with one
    rank a card (cuda:LOCAL_RANK, or cuda:GPUSPECTRAL_FAKE_HOST_ID in the
    simulation), or gloo when device is "cpu"; without a card the default
    raises.  Every collective of the group fails after timeout_s."""
    dev = check_device(device)
    local_rank = 0
    if "GPUSPECTRAL_FAKE_HOSTS" in os.environ:
        world = int(os.environ["GPUSPECTRAL_FAKE_HOSTS"])
        rank = local_rank = int(os.environ["GPUSPECTRAL_FAKE_HOST_ID"])
        coordinator = os.environ.get("GPUSPECTRAL_COORDINATOR", "127.0.0.1:9473")
    elif "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    else:
        world, rank, coordinator = 1, 0, f"127.0.0.1:{free_port()}"
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if dev.type == "cuda" else None,
    )
    return dev


def local_device() -> torch.device:
    """This rank's device: the card initialize set for an NCCL group, the
    CPU for a gloo one."""
    if not dist.is_initialized():
        raise RuntimeError("parallel.launch.initialize() has not run in this process")
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def pod_mesh(spp_shards: int = 1):
    """Global (tiles, spp) mesh over every rank of the group."""
    from .dist import make_mesh

    return make_mesh(None, spp_shards)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_image(img) -> Optional[np.ndarray]:
    """The full image on the coordinator as numpy; None on every other
    rank.  The sharded renders of parallel/dist.py already gather their
    image to every rank, so this moves nothing between ranks."""
    if not is_coordinator():
        return None
    return torch.as_tensor(img).detach().cpu().numpy()
