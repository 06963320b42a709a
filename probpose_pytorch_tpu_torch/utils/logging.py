"""Metrics logging (copy of probpose_pytorch_tpu/utils/logging.py): JSON
lines in `<out_dir>/metrics.jsonl` always, TensorBoard where its package is
installed. The port runs one process, so it always writes."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, out_dir: str | Path):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.out_dir / "metrics.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the tensorboard package is optional
            self._tb = None
        else:
            self._tb = SummaryWriter(str(self.out_dir))

    def log(self, step: int, scalars: Mapping[str, Any], prefix: str = "") -> None:
        flat = {(f"{prefix}/{k}" if prefix else k): float(v) for k, v in scalars.items()}
        rec = {"step": int(step), "time": time.time(), **flat}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
