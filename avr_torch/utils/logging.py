"""Logging/observability: python logger + TensorBoard + JSONL metrics (a
copy of ``avr_tpu/utils/logging.py``).

Mirrors reference/utils/logger.py:15-42 (file+console logger) and the
runner's TensorBoard tags (reference/avr_runner.py:203-208,409-417), and
adds a JSONL metrics stream (one object per event) so headless tooling
can consume training curves without TB event parsing. TensorBoard is
optional (tensorboardX); JSONL always works.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def configure_logger(logdir: str, name: str = "avr_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(logdir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsWriter:
    """TensorBoard (if available) + JSONL scalar writer."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:
            pass

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step), "ts": time.time()})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}{k}" if prefix else k, v, step)
        self.flush()

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
