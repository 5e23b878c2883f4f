"""Checkpoint / resume.

The port's copy of gpuspectral_tpu/io/checkpoint.py (numpy only).

The reference has none (SURVEY.md §5.4): its only resumable state is the
progressive-accumulation image living in GPU memory, lost on exit.  Here the
full render/optimization state persists to an .npz and resume is *exact*:

  * progressive rendering: {accum image, timestamp} — the running mean plus
    its sample count reproduce the reference's mix(prev, cur, 1/(t+1))
    recurrence from any point;
  * inverse rendering: {params, opt_state, step, rng timestamp} — the
    counter-based RNG needs no state beyond the timestamp.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

import numpy as np


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Atomic save of a flat dict of arrays/scalars to .npz."""
    flat = {}
    for k, v in state.items():
        flat[k] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> str | None:
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory) if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    cands.sort(key=lambda f: int("".join(c for c in f if c.isdigit()) or 0))
    return os.path.join(directory, cands[-1])
