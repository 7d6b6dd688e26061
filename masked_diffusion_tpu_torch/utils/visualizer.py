"""Experiment visualizer (reference utils/visualizer.py:49-197).

wandb-backed when available and enabled; otherwise a JSONL metrics sink so
runs are observable without external services (wandb is not present in the
TPU build image). Image grids are also dropped as PNGs next to the metrics.

A copy of masked_diffusion_tpu/utils/visualizer.py (wandb imported only when
a run asks for it); the port imports nothing of the JAX package.
tests/test_torch_port_host.py holds it equal to the original.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from masked_diffusion_tpu_torch.utils.grids import save_png


def _wandb():
    """The wandb module, or None where it is not installed."""
    try:
        import wandb  # type: ignore
    except ImportError:
        return None
    return wandb


class Visualizer:
    def __init__(self, cfg, log_dir: Optional[str] = None):
        self.cfg = cfg
        self.log_dir = log_dir or "."
        self._wandb = _wandb() if getattr(cfg, "use_wandb", False) else None
        self.use_wandb = self._wandb is not None
        self._metrics_path = os.path.join(self.log_dir, "metrics.jsonl")
        os.makedirs(self.log_dir, exist_ok=True)
        if self.use_wandb:
            self._wandb.init(
                project=getattr(cfg, "wandb_name", "diffusion"),
                name=f"{cfg.method}_{cfg.title}",
                config=cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg.__dict__),
            )

    def reset(self) -> None:
        pass

    def plot_current_losses(self, epoch: int, losses: Dict[str, float], kind: str = "value"):
        record = {"epoch": int(epoch), "time": time.time()}
        record.update({k: float(v) for k, v in losses.items()})
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.use_wandb:
            self._wandb.log({**losses, "epoch": epoch})

    def display_current_results(self, epoch: int, visuals: Dict[str, np.ndarray]):
        payload = {}
        for name, img in visuals.items():
            if img is None:
                continue
            img = np.asarray(img)
            path = os.path.join(self.log_dir, f"{name}_{epoch:05d}.png")
            save_png(np.clip(img, 0.0, 1.0), path)
            if self.use_wandb:
                payload[name] = self._wandb.Image(path)
        if self.use_wandb and payload:
            self._wandb.log({**payload, "epoch": epoch})

    def finish(self) -> None:
        if self.use_wandb:
            self._wandb.finish()
