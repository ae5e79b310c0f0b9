"""Training metrics: per-step scalars to stdout and to a JSONL file.

Counterpart of ``beer_tpu/utils/metrics.py`` (ELBO/frame and frames/s
per epoch of ``hmm train``), without its optional TensorBoard writer.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsLogger:
    def __init__(self, logdir: Optional[str] = None, stdout: bool = True):
        self.stdout = stdout
        self.jsonl = None
        if logdir:
            logdir = Path(logdir)
            logdir.mkdir(parents=True, exist_ok=True)
            self.jsonl = open(logdir / "metrics.jsonl", "a")
        self._t0 = time.time()

    def log(self, step: int, **scalars) -> None:
        rec = {"step": step, "time": time.time() - self._t0, **scalars}
        if self.stdout:
            parts = " ".join(f"{k}={v:.6g}" for k, v in scalars.items())
            print(f"[step {step}] {parts}")
        if self.jsonl:
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()

    def close(self) -> None:
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None
