"""ResultGrid: the return value of Tuner.fit (reference: tune/result_grid.py)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint


class TrialResult:
    def __init__(self, trial):
        self.trial_id = trial.id
        self.config: Dict[str, Any] = trial.config
        self.metrics: Dict[str, Any] = trial.last_result or {}
        self.metrics_history: List[Dict[str, Any]] = trial.metrics_history
        self.error: Optional[str] = trial.error
        self.path = trial.local_dir
        self.checkpoint: Optional[Checkpoint] = (
            Checkpoint(trial.latest_checkpoint)
            if trial.latest_checkpoint else None
        )

    def __repr__(self):
        return (f"TrialResult({self.trial_id}, metrics={self.metrics!r}, "
                f"error={self.error!r})")


class ResultGrid:
    def __init__(self, trials, experiment_path: str):
        self._results = [TrialResult(t) for t in trials]
        self.experiment_path = experiment_path

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> TrialResult:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[str]:
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: str, mode: str = "max") -> TrialResult:
        assert mode in ("max", "min")
        candidates = [r for r in self._results
                      if r.error is None and metric in r.metrics]
        if not candidates:
            raise ValueError(f"no successful trial reported metric {metric!r}")
        sign = 1 if mode == "max" else -1
        return max(candidates, key=lambda r: sign * float(r.metrics[metric]))

    def get_dataframe(self):
        rows = []
        for r in self._results:
            row = {"trial_id": r.trial_id, "error": r.error}
            row.update({f"config/{k}": v for k, v in r.config.items()})
            row.update(r.metrics)
            rows.append(row)
        return rows
