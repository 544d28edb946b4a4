"""Online topology adaptation: streaming Pi estimation + mid-training
STL-FW refresh with capture-free schedule hot swaps.

The paper (Section 5) learns a topology once, before training, from a
fixed label-proportion matrix Pi. This subsystem relearns it *during*
training when Pi drifts:

1. ``streaming``  -- exponentially-weighted Pi_hat from minibatch labels
   plus a drift detector on the neighborhood-heterogeneity proxy
   (Proposition 2's ``tau_bar`` evaluated at Pi_hat); a copy of the
   reference's numpy module.
2. ``refresh``    -- a controller that re-runs ``learn_topology`` warm,
   truncates back to a fixed atom capacity, and emits the result as
   fixed-shape ``ScheduleArrays`` on the run's device -- or, with
   ``pool=``, as pool-coordinate ``PoolSwap`` gamma updates.
   ``overlap=True`` runs each solve in a background worker (numpy and
   scipy only: no CUDA call leaves the calling thread).
3. The simulator drivers in ``repro_torch.train.trainer`` take those
   updates at segment boundaries as *data*: with ``rollout="scan"`` the
   new schedule is copied into the captured CUDA graph's buffers, so a
   swap never recaptures the rollout.

Drift workloads to drive it live in ``repro_torch.data.drift``.
"""

from . import refresh, streaming
from .refresh import OnlineTopologyController, RefreshConfig, TopologyRefresher
from .streaming import DriftDetector, StreamingPiEstimator

__all__ = [
    "refresh",
    "streaming",
    "OnlineTopologyController",
    "RefreshConfig",
    "TopologyRefresher",
    "DriftDetector",
    "StreamingPiEstimator",
]
