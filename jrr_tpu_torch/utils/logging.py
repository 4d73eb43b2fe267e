"""Structured metrics logging (counterpart of jrr_tpu/utils/logging.py):
a dependency-free JSONL sink with an optional stderr echo and an optional
wandb bridge. Metric names match the reference's wandb series
(scripts/optimize.py:323-337) where a counterpart exists, and jrr_tpu's
records key for key."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

# Reference wandb series (scripts/optimize.py:323-337) → OuterMetrics fields.
REFERENCE_METRIC_NAMES = {
    "joint_loss": "joint_loss",
    "pose_discriminated_loss": "pose_disc_gen_loss",
    "shape_discriminated_loss": "shape_disc_gen_loss",
    "pose_discriminator_loss": "pose_discriminator_loss",
    "shape_discriminator_loss": "shape_discriminator_loss",
    "j_regressor_error": "j_regressor_error",
    "mpjpe": "mpjpe_before_jreg_step",
    "pampjpe": "pampjpe_before_jreg_step",
}


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True, wandb_run=None):
        self.path = path
        self.echo = echo
        self.wandb_run = wandb_run
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"ts": time.time()}
        if step is not None:
            record["step"] = int(step)
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.echo:
            shown = {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in record.items() if k != "ts"}
            print(f"[metrics] {shown}", file=sys.stderr)
        if self.wandb_run is not None:
            self.wandb_run.log(metrics, step=step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def outer_metrics_record(m) -> Dict[str, float]:
    """OuterMetrics (host values) → dict with the reference's names and ours."""
    rec = {name: float(getattr(m, name)) for name in m._fields}
    for ref_name, ours in REFERENCE_METRIC_NAMES.items():
        rec[ref_name] = float(getattr(m, ours))
    rec["mpjpe difference"] = rec["mpjpe_after_jreg_step"] - rec["mpjpe_before_jreg_step"]
    rec["pampjpe difference"] = rec["pampjpe_after_jreg_step"] - rec["pampjpe_before_jreg_step"]
    return rec
