"""Training metrics for decentralized runs.

The quantities the paper plots: per-node error/accuracy (min/mean/max across
nodes -- the dashed lines of Fig. 1), consensus distance
``||Theta - Theta_bar||_F^2`` (the quantity controlled by Lemma 3), and
standard loss aggregation; and the modeled communication meter
(``mix_bytes_per_step``, ``CommMeter``, ``staleness_transfer_fracs``) the
online drivers return.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from repro_torch.core.compression import make_compressor
from repro_torch.core.mixing import tree_leaves

PyTree = Any

__all__ = [
    "consensus_distance",
    "node_spread",
    "MetricLogger",
    "mix_bytes_per_step",
    "staleness_transfer_fracs",
    "CommMeter",
]


def staleness_transfer_fracs(
    delays, tau_max: int, mode: str = "wait"
) -> tuple[float, float, float]:
    """Closed-form fate split of one step's n(n-1) directed transfers
    under a raw per-source delay vector: ``(on_time, deferred,
    dropped)``, summing to 1.

    The all-gather model: every node sends to every other node, and a
    source with delay d > 0 delivers all its transfers late. Under
    ``"wait"`` nothing is dropped -- late payloads are consumed stale
    (``deferred``). Under ``"degrade"`` a source past the ``tau_max``
    deadline is cut for the step (the repaired schedule self-loops it,
    both directions), so its transfers move from deferred to dropped and
    the delivered support shrinks to the on-time nodes.
    """
    if mode not in ("wait", "degrade"):
        raise ValueError(f"mode must be 'wait' or 'degrade', got {mode!r}")
    d = np.asarray(delays).reshape(-1)
    n = d.shape[0]
    if n < 2:
        return 1.0, 0.0, 0.0
    on = d <= tau_max if mode == "degrade" else np.ones(n, bool)
    n_on = int(on.sum())
    total = n * (n - 1)
    delivered = n_on * (n_on - 1)
    deferred = int(((d > 0) & on).sum()) * (n_on - 1)
    return (
        (delivered - deferred) / total,
        deferred / total,
        (total - delivered) / total,
    )


def mix_bytes_per_step(
    transport: str,
    *,
    n_nodes: int,
    p_total: int,
    n_comm_atoms: int | None = None,
    itemsize: int = 4,
    alive_frac: float = 1.0,
    compression=None,
) -> int:
    """Bytes RECEIVED per node per mixing step, by transport.

    The counter the comm accounting (and the bench acceptance ratios)
    runs on -- a closed-form model of the collective, not a NIC
    counter: every listed transport moves a deterministic byte volume
    per step, so the model IS the measurement up to wire framing.
    ``p_total`` is one node's parameter count; transfers run in f32
    (``itemsize=4``) in all the hot-swappable transports of the reference.
    The port's rank transports move a bfloat16 leaf as bfloat16 (half this
    model for a bfloat16 model); ``repro_torch.core.mixing.collective_bytes``
    counts those bytes.

    ===========  =========================  ==============================
    transport    bytes/node/step            which mix function
    ===========  =========================  ==============================
    dense        0 (single host)            mix_dense / mix_schedule_*
    allgather    (n - 1) * P * itemsize     mix_dense_sharded /
                                            mix_arrays_sharded
    ppermute     n_comm_atoms * P * item    mix_ppermute (static) --
                                            non-identity atoms only
    pool         n_comm_atoms * P * item    mix_ppermute_pool -- staged
                                            non-identity SLOTS (gamma 0
                                            still transfers)
    allreduce    2 (n-1)/n * P * itemsize   mix_allreduce (ring model)
    ===========  =========================  ==============================

    ``alive_frac`` scales the fleet for degraded runs: with a fraction
    of nodes crashed, a dead peer sends nothing (its repaired atom
    entries are self-loops, which move zero bytes), so the effective
    gather degree shrinks proportionally. ``alive_frac=1.0`` (default)
    is the fault-free model above; the faults runner instead keeps the
    full-rate model here and meters per-step delivery honestly through
    :meth:`CommMeter.tick`'s ``delivered_frac``.

    ``compression`` (a ``repro_torch.core.compression.Compressor``, a
    spec string like ``"bf16"`` / ``"topk:0.25"``, or None) swaps the
    per-payload wire layout: the element count and per-element width
    above become the compressor's ``wire_layout(p_total, itemsize)`` --
    bf16 ships the same elements at 2 bytes (exactly half the float32
    model, including under fractional ``alive_frac``), top-k ships
    ``k = max(1, int(P * frac))`` value+index pairs at ``itemsize + 4``
    bytes each. ``dense`` moves nothing, and ``allreduce`` reduces
    in-network (no per-edge payload a CHOCO wire could compress), so a
    non-identity compressor there is refused.
    """
    comp = make_compressor(compression)
    if n_nodes < 1 or p_total < 0:
        raise ValueError(f"bad n_nodes={n_nodes} / p_total={p_total}")
    if not 0.0 <= alive_frac <= 1.0:
        raise ValueError(f"alive_frac must be in [0, 1], got {alive_frac}")
    if comp is None or comp.is_identity or p_total == 0:
        wire_elems, wire_itemsize = p_total, itemsize
    else:
        wire_elems, wire_itemsize = comp.wire_layout(p_total, itemsize)
    if transport == "dense":
        return 0
    if transport == "allgather":
        # (alive - 1) peers actually send; floor at zero for a lone node
        senders = max(alive_frac * n_nodes - 1.0, 0.0)
        return int(senders * wire_elems) * wire_itemsize
    if transport in ("ppermute", "pool"):
        if n_comm_atoms is None:
            raise ValueError(f"transport={transport!r} needs n_comm_atoms")
        return int(alive_frac * n_comm_atoms * wire_elems) * wire_itemsize
    if transport == "allreduce":
        if comp is not None and not comp.is_identity:
            raise ValueError(
                "allreduce has no compressed wire: the ring reduces "
                "in-network, so a CHOCO compressor does not apply -- use a "
                "gossip transport (allgather/ppermute/pool) for compression"
            )
        n_alive = max(alive_frac * n_nodes, 1.0)
        return int(2 * (n_alive - 1) / n_alive * p_total) * itemsize
    raise ValueError(f"unknown transport {transport!r}")


@dataclasses.dataclass
class CommMeter:
    """Accumulates the modeled communication of a training run.

    ``per_step_bytes`` is per NODE per step (the :func:`mix_bytes_per_step`
    unit); a transport change mid-run (e.g. a pool restage that grows
    the staged slot count) updates it via :meth:`set_rate`, which also
    records the change as an event.

    Degraded paths stay honest: ``tick(k, delivered_frac=f)`` splits
    the modeled volume into delivered bytes (``total_bytes``) and bytes
    lost to dead nodes / dropped edges (``dropped_bytes``) -- the BENCH
    curves charge only what actually arrived. Self-loop fallbacks move
    zero bytes so they need no counting; retransmissions DO arrive and
    are added on top via :meth:`retransmit` (``retransmit_bytes``,
    also folded into ``total_bytes``).

    Bounded-delay gossip adds a third fate: a straggler's payload that
    ARRIVES, late. ``tick(k, delivered_frac=f, deferred_frac=d)``
    records that ``d`` of the step's volume was delivered past its
    deadline (``deferred_bytes``, a SUBSET of ``total_bytes`` -- late
    bytes still cross the wire and are charged as delivered, unlike
    dropped bytes, which never arrive). The degrade policy converts
    would-be-deferred transfers into dropped ones (the repaired
    schedule self-loops them), so the deferred/dropped split is exactly
    the wait-vs-degrade policy decision, metered.

    Quarantine adds a fourth fate, also a SUBSET of delivered:
    ``tick(k, ..., quarantined_frac=q)`` records that ``q`` of the
    step's volume crossed the wire touching a quarantined endpoint --
    bytes that were moved but then excluded from consensus by the
    quarantine repair (the repaired W self-loops the node). They are
    the honest cost of the detection window and of keeping a suspect
    isolated; the screen's value proposition (bytes protected vs bytes
    forfeited) is read directly off this counter.
    """

    per_step_bytes: int = 0
    steps: int = 0
    total_bytes: int = 0
    dropped_bytes: int = 0
    deferred_bytes: int = 0
    quarantined_bytes: int = 0
    retransmit_bytes: int = 0
    events: list = dataclasses.field(default_factory=list)

    def tick(
        self,
        k: int = 1,
        delivered_frac: float = 1.0,
        deferred_frac: float = 0.0,
        quarantined_frac: float = 0.0,
    ) -> None:
        if not 0.0 <= delivered_frac <= 1.0:
            raise ValueError(
                f"delivered_frac must be in [0, 1], got {delivered_frac}"
            )
        if not 0.0 <= deferred_frac <= delivered_frac:
            raise ValueError(
                f"deferred_frac must be in [0, delivered_frac="
                f"{delivered_frac}], got {deferred_frac} (deferred bytes "
                f"are a subset of delivered bytes)"
            )
        if not 0.0 <= quarantined_frac <= delivered_frac:
            raise ValueError(
                f"quarantined_frac must be in [0, delivered_frac="
                f"{delivered_frac}], got {quarantined_frac} (quarantined "
                f"bytes are a subset of delivered bytes)"
            )
        self.steps += int(k)
        volume = int(k) * self.per_step_bytes
        delivered = int(volume * delivered_frac)
        self.total_bytes += delivered
        self.dropped_bytes += volume - delivered
        # Derive deferred from the already-truncated delivered volume, not
        # from a second independent int(volume * frac) truncation: the
        # subset invariant (deferred <= delivered, per tick and hence
        # cumulatively) must hold by CONSTRUCTION, not by both roundings
        # happening to land the same way under fractional fates.
        if delivered_frac > 0.0:
            deferred = int(delivered * (deferred_frac / delivered_frac))
            quarantined = int(delivered * (quarantined_frac / delivered_frac))
        else:
            deferred = 0
            quarantined = 0
        self.deferred_bytes += deferred
        self.quarantined_bytes += quarantined

    def retransmit(self, nbytes: int) -> None:
        """Count a successful re-send (delivered, on top of the model)."""
        self.retransmit_bytes += int(nbytes)
        self.total_bytes += int(nbytes)

    def set_rate(self, per_step_bytes: int, step: int | None = None) -> None:
        if per_step_bytes != self.per_step_bytes:
            self.events.append(
                {"step": self.steps if step is None else int(step),
                 "per_step_bytes": int(per_step_bytes)}
            )
        self.per_step_bytes = int(per_step_bytes)

    def summary(self) -> dict:
        return {
            "per_step_bytes": self.per_step_bytes,
            "steps": self.steps,
            "total_bytes": self.total_bytes,
            "dropped_bytes": self.dropped_bytes,
            "deferred_bytes": self.deferred_bytes,
            "quarantined_bytes": self.quarantined_bytes,
            "retransmit_bytes": self.retransmit_bytes,
            "rate_changes": list(self.events),
        }


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
