"""Training metrics for decentralized runs.

The quantities the paper plots: per-node error/accuracy (min/mean/max across
nodes -- the dashed lines of Fig. 1), consensus distance
``||Theta - Theta_bar||_F^2`` (the quantity controlled by Lemma 3), and
standard loss aggregation.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from repro_torch.core.mixing import tree_leaves

PyTree = Any

__all__ = ["consensus_distance", "node_spread", "MetricLogger"]


def consensus_distance(params_stack: PyTree) -> torch.Tensor:
    """``||Theta - Theta_bar||_F^2`` over stacked per-node parameters."""
    leaves = tree_leaves(params_stack)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        mean = leaf.mean(dim=0, keepdim=True)
        total = total + torch.sum(torch.square((leaf - mean).float()))
    return total


def node_spread(values) -> dict[str, float]:
    """min/mean/max over the node axis (Fig. 1's solid + dashed lines)."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    v = np.asarray(values)
    if v.size == 0:
        raise ValueError(
            "node_spread: empty value array -- no nodes to aggregate (did "
            "an eval produce zero rows?)"
        )
    return {"min": float(v.min()), "mean": float(v.mean()), "max": float(v.max())}


@dataclasses.dataclass
class MetricLogger:
    """In-memory metric store with CSV export.

    ``aux`` carries run-level (non-per-step) diagnostics.
    """

    history: list[dict] = dataclasses.field(default_factory=list)
    aux: dict = dataclasses.field(default_factory=dict)

    def log(self, step: int, **metrics: float) -> None:
        row = {"step": step}
        row.update({k: float(v) for k, v in metrics.items()})
        self.history.append(row)

    def column(self, key: str, aligned: bool = False) -> np.ndarray:
        """Values of ``key`` across the history.

        By default rows missing the key are skipped. ``aligned=True``
        returns one entry per history row, ``nan`` where the key is
        absent, so two columns with different logging cadences can be
        compared index-to-index.
        """
        if aligned:
            return np.array(
                [float(row.get(key, np.nan)) for row in self.history]
            )
        return np.array([row[key] for row in self.history if key in row])

    @staticmethod
    def _cell(row: dict, key: str) -> str:
        # an empty cell for both a missing key and a NaN value
        v = row.get(key)
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return ""
        return str(v)

    def to_csv(self, path: str) -> None:
        if not self.history:
            return
        keys = sorted({k for row in self.history for k in row})
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for row in self.history:
                f.write(",".join(self._cell(row, k) for k in keys) + "\n")

    def to_jsonl(self, path: str) -> None:
        """One JSON object per history row (ragged rows survive verbatim,
        NaN -> null)."""
        with open(path, "w") as f:
            for row in self.history:
                clean = {
                    k: (None if isinstance(v, float) and np.isnan(v) else v)
                    for k, v in row.items()
                }
                f.write(json.dumps(clean) + "\n")
