"""JSONL metrics logging (SURVEY.md §5.5: the reference has no metrics at
all; the rebuild reports per-step rays/s, grad-steps/s and stage timings).
The port's copy of gpuspectral_tpu/utils/metrics.py."""

from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def log(self, **fields) -> dict:
        fields.setdefault("time", time.time())
        if self._fh:
            self._fh.write(json.dumps(fields) + "\n")
            self._fh.flush()
        return fields

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
