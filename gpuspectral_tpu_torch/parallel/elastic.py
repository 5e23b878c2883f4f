"""Elastic failure recovery for long multi-process renders (port of
gpuspectral_tpu/parallel/elastic.py; SURVEY.md §5.3).

The reference's failure model is throw-and-die (std::runtime_error
throughout, e.g. VulkanDevice.cpp:30-31).  This module adds the supervision
layer:

  * workers render PROGRESSIVE CHUNKS (one timestamp = one 1-spp frame per
    rank group) and atomically checkpoint the running-mean accumulator +
    frame counter after every chunk (io/checkpoint.py),
  * a single-process SUPERVISOR runs the worker gang, watches liveness
    (exit codes), and on ANY worker failure kills the gang and relaunches
    it from the last checkpoint — a torch.distributed group is
    gang-scheduled, so gang restart from an exact checkpoint is the
    recovery unit,
  * restarts may SHRINK the gang (fewer processes) when a host stays dead:
    the (tiles x spp) sharding is rank-count agnostic and the accumulator
    is a plain running mean, so the resumed render is exact regardless of
    the new mesh shape.

Recovery is EXACT: frame t's radiance depends only on (scene, cfg, t), so
the mean over frames [0, T) resumed at any boundary reproduces the
uninterrupted result bit for bit (tests/test_torch_elastic.py kills a
worker mid-run).  Workers join the gang through parallel/launch.initialize,
which reads the GPUSPECTRAL_FAKE_HOSTS / GPUSPECTRAL_FAKE_HOST_ID names
that `supervise` sets; the device a worker passes picks gloo on the CPU or
NCCL on cuda:GPUSPECTRAL_FAKE_HOST_ID.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class GangResult:
    restarts: int
    hosts_used: list  # host count per incarnation


def supervise(
    build_cmd: Callable[[int, int], list],
    n_hosts: int,
    *,
    done: Callable[[], bool],
    max_restarts: int = 3,
    allow_shrink: bool = True,
    min_hosts: int = 1,
    poll_s: float = 0.5,
    timeout_s: float = 600.0,
    env_extra: Optional[dict] = None,
) -> GangResult:
    """Run a worker gang until `done()` reports completion.

    build_cmd(host_id, n_hosts) -> argv for one worker process.  On any
    worker death before completion the whole gang is killed and relaunched
    (workers resume from their checkpoint).  After two failed incarnations
    at the same size the gang shrinks by one host (allow_shrink).  An
    incarnation that runs past timeout_s counts as failed.  Each worker's
    output goes to a file of its own (a pipe nobody reads would stall a
    worker that writes much); after too many restarts the RuntimeError
    carries the tail of the last failed incarnation's first failed
    worker."""
    restarts = 0
    hosts_used = []
    hosts = n_hosts
    fails_at_size = 0
    last_log = ""
    while True:
        if done():
            return GangResult(restarts=restarts, hosts_used=hosts_used)
        if restarts > max_restarts:
            raise RuntimeError(
                f"elastic supervisor: exceeded {max_restarts} restarts; last "
                f"failed worker's output:\n{last_log}")
        hosts_used.append(hosts)
        extra = env_extra(len(hosts_used) - 1) if callable(env_extra) else (
            env_extra or {})
        procs, logs = [], []
        for i in range(hosts):
            env = dict(os.environ)
            env.update(extra)
            env["GPUSPECTRAL_FAKE_HOSTS"] = str(hosts)
            env["GPUSPECTRAL_FAKE_HOST_ID"] = str(i)
            logs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                build_cmd(i, hosts), env=env,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        t0 = time.time()
        failed = False
        while True:
            codes = [p.poll() for p in procs]
            if any(c is not None and c != 0 for c in codes):
                failed = True
                break
            if all(c == 0 for c in codes):
                break
            if time.time() - t0 > timeout_s:
                failed = True
                break
            time.sleep(poll_s)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        # a worker that exited on its own before one that was killed
        bad = sorted((p.returncode < 0, i) for i, p in enumerate(procs) if p.returncode != 0)
        if bad:
            logs[bad[0][1]].seek(0)
            last_log = logs[bad[0][1]].read().decode(errors="replace")[-3000:]
        for log in logs:
            log.close()
        if not failed and done():
            return GangResult(restarts=restarts, hosts_used=hosts_used)
        restarts += 1
        fails_at_size += 1
        if allow_shrink and fails_at_size >= 2 and hosts > min_hosts:
            hosts -= 1
            fails_at_size = 0


def render_chunks(scene, cfg, mesh, total_frames: int, ckpt_path: str,
                  chunk_frames: int = 1, on_frame=None,
                  _fault_at: int = -1):
    """Worker-side progressive render loop with exact checkpoint/resume.

    Renders frames [resume_at, total_frames) with render_image_sharded (the
    wavefront; frame t at timestamp0 = t), updating the running-mean
    accumulator (numpy); the coordinator checkpoints atomically every
    `chunk_frames`.  Returns (accum (H,W,3), frames_done).  `_fault_at`
    injects a crash before checkpointing that frame index (tests)."""
    from ..io.checkpoint import load_checkpoint, save_checkpoint
    from . import launch
    from .dist import render_image_sharded

    accum = np.zeros((cfg.height, cfg.width, 3), np.float32)
    start = 0
    if os.path.exists(ckpt_path):
        state = load_checkpoint(ckpt_path)
        accum = np.asarray(state["accum"], np.float32)
        start = int(state["frames"])
    for t in range(start, total_frames):
        if _fault_at == t and start < _fault_at:
            # injected fault (tests): die WITHOUT checkpointing this frame.
            # One-shot by construction: the restarted gang resumes AT the
            # fault frame (start == _fault_at) and runs clean.
            os._exit(41)
        img = render_image_sharded(scene, cfg, mesh, timestamp0=t)
        full = launch.gather_image(img)
        if launch.is_coordinator():
            # running mean (raygen.rgen:84-91 progressive accumulation)
            accum = accum + (np.asarray(full) - accum) / (t + 1)
            if (t + 1) % chunk_frames == 0 or t + 1 == total_frames:
                save_checkpoint(ckpt_path, dict(
                    accum=accum, frames=np.int64(t + 1)))
        if on_frame is not None:
            on_frame(t, accum)
    return accum, total_frames
