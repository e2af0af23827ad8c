"""Experiment logging sinks: wandb (optional, off by default) with a no-op
fallback (counterpart of isogs_slam_tpu/utils/logging_utils.py).

When config['use_wandb'] is set and wandb imports, per-iteration loss rows
and eval metrics go to a wandb run; otherwise every call is a no-op.
"""
from __future__ import annotations


class RunLogger:
    def __init__(self, config: dict):
        self._run = None
        if not config.get("use_wandb", False):
            return
        try:
            import wandb
            wcfg = config.get("wandb", {})
            self._run = wandb.init(
                project=wcfg.get("project", "IsoGS-torch"),
                entity=wcfg.get("entity") or None,
                group=wcfg.get("group"), name=wcfg.get("name"),
                config=config)
        except Exception as e:
            print(f"[wandb] disabled ({e.__class__.__name__}: {e})")

    def log(self, data: dict, step: int | None = None):
        if self._run is not None:
            self._run.log(data, step=step)

    def log_block(self, frame: int, stage: str, log_rows):
        """Per-iteration loss rows (loss, im, depth, flat, iso, density,
        mask_frac) for one tracking/mapping phase."""
        if self._run is None:
            return
        import numpy as np
        for step, row in enumerate(np.asarray(log_rows)):
            if np.isnan(row[0]):
                continue
            self._run.log({
                f"{stage}/loss": float(row[0]),
                f"{stage}/image_loss": float(row[1]),
                f"{stage}/depth_loss": float(row[2]),
                f"{stage}/flat_loss": float(row[3]),
                f"{stage}/iso_loss": float(row[4]),
                f"{stage}/mean_density": float(row[5]),
                f"{stage}/mask_frac": float(row[6]),
                f"{stage}/frame": frame, f"{stage}/step": step})

    def finish(self):
        if self._run is not None:
            self._run.finish()
