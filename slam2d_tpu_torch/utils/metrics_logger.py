"""Run-metrics logging, a copy of the JAX package's
slam2d_tpu/utils/metrics_logger.py.

JSONL always (cheap, greppable, no deps); TensorBoard scalars when
tensorboardX is importable. Scalars worth logging per scan/chunk: score,
N_eff, loop count, scans/s; per optimization: chi2.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, out_dir: str, tensorboard: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self._f = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
            except ImportError:
                pass
        self._t0 = time.time()

    def log(self, step: int, **scalars):
        rec = {"step": step, "t": round(time.time() - self._t0, 3), **scalars}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        self._f.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
