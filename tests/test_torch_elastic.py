"""PyTorch port: elastic failure recovery (parallel/elastic.py) and the
multi-device dry run (parallel/dryrun.py) on gloo ranks on the CPU.

A 2-rank gang that loses a rank mid-render must be restarted by the
supervisor from the last exact checkpoint and finish with the SAME image an
uninterrupted run produces (the twin of tests/test_elastic.py:59-80).  Each
rank's collectives time out after RANK_TIMEOUT_S and an incarnation that
runs past GANG_TIMEOUT_S is killed, so a hang fails this file instead of
the suite's clock."""

import os
import sys
import time

import numpy as np
import pytest

from gpuspectral_tpu_torch.io.checkpoint import load_checkpoint
from gpuspectral_tpu_torch.parallel import launch
from gpuspectral_tpu_torch.parallel.dryrun import dryrun_multichip
from gpuspectral_tpu_torch.parallel.elastic import supervise

from torch_common import REPO

RANK_TIMEOUT_S = 60.0
GANG_TIMEOUT_S = 120.0


def _run_gang(tmp_path, tag, total_frames, fault_at, stay_dead=False):
    ckpt = str(tmp_path / f"{tag}.npz")

    def build_cmd(host_id, n_hosts):
        # the injected fault only fires while no checkpoint passed it: after
        # the restart the resume frame is the fault frame, so the rank runs
        # clean (unless it stays dead)
        return [sys.executable, str(REPO / "tests/torch_elastic_worker.py"), ckpt,
                str(total_frames), str(fault_at), str(RANK_TIMEOUT_S)] + (
                    ["stay_dead"] if stay_dead else [])

    def env_extra(incarnation):
        return {"GPUSPECTRAL_COORDINATOR": f"127.0.0.1:{launch.free_port()}"}

    def done():
        if not os.path.exists(ckpt):
            return False
        try:
            return int(load_checkpoint(ckpt)["frames"]) >= total_frames
        except Exception:
            return False

    res = supervise(build_cmd, 2, done=done, max_restarts=3, allow_shrink=stay_dead,
                    timeout_s=GANG_TIMEOUT_S, poll_s=0.2, env_extra=env_extra)
    state = load_checkpoint(ckpt)
    return np.asarray(state["accum"]), int(state["frames"]), res


def test_gang_restart_reproduces_uninterrupted_render(tmp_path):
    total = 5
    img_clean, frames_clean, res_clean = _run_gang(tmp_path, "clean", total, fault_at=-1)
    assert frames_clean == total
    assert res_clean.restarts == 0
    assert np.isfinite(img_clean).all() and img_clean.max() > 0

    # rank 1 dies (os._exit) before checkpointing frame 2; the supervisor
    # relaunches the gang, which resumes from the last checkpoint
    img_fault, frames_fault, res_fault = _run_gang(tmp_path, "fault", total, fault_at=2)
    assert frames_fault == total
    assert res_fault.restarts >= 1
    assert res_fault.hosts_used[:2] == [2, 2]

    # recovery is EXACT: same frames, same running mean
    np.testing.assert_array_equal(img_fault, img_clean)


def test_gang_shrinks_to_one_host_and_stays_exact(tmp_path):
    """Rank 1 dies at frame 2 and again at each restart of two hosts: after
    two failures at that size the supervisor shrinks the gang to one host
    (GPUSPECTRAL_FAKE_HOSTS=1, still gloo on the CPU), which finishes the
    render; a pixel's frames do not depend on the mesh, so the image is
    the two-host clean run's."""
    total = 5
    img_clean, _, _ = _run_gang(tmp_path, "clean", total, fault_at=-1)
    img, frames, res = _run_gang(tmp_path, "shrink", total, fault_at=2, stay_dead=True)
    assert frames == total
    assert res.hosts_used == [2, 2, 1] and res.restarts == 2
    np.testing.assert_array_equal(img, img_clean)


def test_dryrun_multichip_on_gloo():
    line = dryrun_multichip(2, size=32, device="cpu", timeout_s=GANG_TIMEOUT_S)
    assert line.startswith("dryrun_multichip ok: mesh=(tiles 1, spp 2)"), line


def test_supervise_keeps_a_failed_workers_output():
    """A worker that writes more than a pipe holds neither stalls nor runs
    into the supervisor's timeout; after too many restarts the error
    carries the tail of its output."""
    code = "import sys; sys.stdout.write('x' * 200000 + '\\nworker gave up'); sys.exit(3)"
    t0 = time.time()
    with pytest.raises(RuntimeError, match="worker gave up"):
        supervise(lambda i, n: [sys.executable, "-c", code], 1, done=lambda: False,
                  max_restarts=1, poll_s=0.05, timeout_s=GANG_TIMEOUT_S)
    assert time.time() - t0 < 30
