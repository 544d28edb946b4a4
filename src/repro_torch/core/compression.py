"""Compressed gossip with error feedback, in PyTorch.

CHOCO-style compressed gossip (Koloskova et al., 2019): each node sends a
compressed view of its parameters and keeps an error-feedback (EF)
memory, so what the wire drops is re-injected later instead of lost:

    theta_i <- theta_half_i + sum_j W_ij C(theta_half_j + e_j)
                            - C(theta_half_i + e_i)
    e_i     <- (theta_half_i + e_i) - C(theta_half_i + e_i)

**Wire formats.** :class:`Compressor` is a frozen description of how one
node's payload is encoded: ``identity`` (float32 passthrough; the EF
transports route it to the uncompressed transport when a step is built,
so it is bitwise the uncompressed run), ``bf16`` (a bfloat16 round trip,
2 bytes an element) and ``topk`` (exactly ``k`` entries by magnitude,
shipped as ``k`` float32 values and ``k`` int32 indices).

**EF mixing operators**, in the transport shapes the simulator runs:
dense (:func:`ef_gossip_step`, ``W @ c`` through the ``gossip_mix``
kernel on the card), ``ScheduleArrays`` (:func:`ef_mix_schedule_arrays`,
the compressed views of every leaf mixed in one ``gossip_schedule``
launch) and the bounded-delay ring (:func:`ef_stale_mix_flat`). The wire
format is fixed when a rollout body is built, and the EF memory is a
static tensor of it, so a topology swap stays a ``copy_``.

Top-k on the card: the reference's contract (``compression.py:118-138``)
-- magnitudes in float32, NaN ordered last, +/-inf first, a stable
descending order with ties to the lowest index, exactly
``topk_keep_count`` kept -- is a stable ``torch.sort`` per node row
(``torch.topk`` promises no order among ties).

**One node per rank** (the reference's sharded twins,
``compression.py:442-782``): :func:`mix_arrays_sharded_ef`,
:func:`mix_dense_sharded_ef`, :func:`mix_ppermute_pool_ef` and their
bounded-delay forms compress each rank's own payload once and move the
compressed views through the collectives of ``core.mixing``. The bf16
wire moves bfloat16 (its views are bf16 values, so the float32 they land
as is the reference's, bit for bit), as does a bfloat16 ring; top-k and
a float32 ring move float32.

**Stacked nodes in the rank numerics** (the LM trainer's one-card
layout): :func:`mix_stacked_ef` and :func:`mix_arrays_stacked_stale_ef`
compute what the rank twins compute, node by node (float32 payloads,
one rounding of each combine; the same ``_ef_compress`` and ``_combine``),
with the mix in the gossip kernels a block of columns at a time; the EF
memory and the node-first ring are updated in place, as the rollout's
carries are. The simulator's stacked EF mixes above stay apart because
they follow another reference function: the reference's simulator sums
in the leaves' dtype, mixes every leaf's view in one raveled
``gossip_schedule`` launch (the launch counts its trainers pin), poisons
the senders' views (``corrupt``), and its stale flat path top-k's a
node's whole padded row, where the LM trainer follows the reference's
mesh trainer, whose rank transports take a leaf at a time in float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from .mixing import (
    PermPool,
    ShardStaleState,
    ScheduleArrays,
    STACKED_BLOCK,
    StaleBuffer,
    WireCorruption,
    _mix_flat,
    kernel_mix,
    mix_arrays_stacked_stale,
    stacked_ring_view,
    stacked_stale_slots,
    mix_dense,
    mix_schedule_arrays,
    mix_schedule_arrays_stale,
    stale_push,
    stale_view,
    tree_leaves,
    tree_map,
    _mix_arrays_flat_corrupt,
    _flatten,
    _axpy_slots,
    _check_nodes,
    _check_pool_gammas,
    _corrupt_own,
    _gather_mix,
    _pool_axpy,
    _pool_contribs,
    _sendable,
    _stale_slot,
    axis_index,
    mix_arrays_sharded,
    mix_arrays_sharded_stale,
    mix_dense_sharded,
    mix_ppermute_pool,
    mix_ppermute_pool_stale,
)

PyTree = Any

__all__ = [
    "Compressor",
    "make_compressor",
    "bf16_compress",
    "topk_compress",
    "topk_keep_count",
    "topk_mask",
    "ef_gossip_step",
    "ef_init",
    "ef_mix_schedule_arrays",
    "ef_stale_mix_flat",
    "mix_arrays_sharded_ef",
    "mix_dense_sharded_ef",
    "mix_ppermute_pool_ef",
    "mix_arrays_sharded_stale_ef",
    "mix_ppermute_pool_stale_ef",
    "mix_stacked_ef",
    "mix_arrays_stacked_stale_ef",
]

# a bare callable compressor: no byte model, applied to the operand verbatim
CompressorFn = Callable[[torch.Tensor], torch.Tensor]


def bf16_compress(x: torch.Tensor) -> torch.Tensor:
    """Simulated bf16 wire: the value passed through a bfloat16 round trip."""
    return x.to(torch.bfloat16).to(x.dtype)


def topk_keep_count(size: int, frac: float) -> int:
    """Entries kept by top-k at ``frac``: ``max(1, int(size * frac))``,
    clamped to ``size`` -- the k of the value+index wire layout."""
    if size < 1:
        raise ValueError(f"payload size must be >= 1, got {size}")
    return max(1, min(size, int(size * frac)))


def _topk_rows(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep-mask of the exact top-k of each row of a 2-D ``x``: a stable
    ascending sort of the negated float32 magnitudes (NaN as -inf, so
    last), the first ``k`` positions of each row set."""
    k = topk_keep_count(x.shape[1], frac)
    mag = torch.abs(x.to(torch.float32))
    mag = torch.where(torch.isnan(mag), float("-inf"), mag)
    order = torch.sort(-mag, dim=1, stable=True).indices
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return mask.scatter_(1, order[:, :k], True)


def topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Boolean keep-mask of the exact top-k entries of ``|x|`` (one call
    operand, e.g. one node's payload).

    Ties keep the lowest-index entries, so the mask always has exactly
    ``topk_keep_count(x.numel(), frac)`` true entries; ``+/-inf``
    magnitudes sort first and ``NaN`` last.
    """
    return _topk_rows(x.reshape(1, -1), frac).reshape(x.shape)


def topk_compress(frac: float) -> CompressorFn:
    """Keep exactly ``topk_keep_count(size, frac)`` entries by magnitude of
    each call operand (see :func:`topk_mask`)."""

    def compress(x: torch.Tensor) -> torch.Tensor:
        return torch.where(topk_mask(x, frac), x, torch.zeros_like(x))

    return compress


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A static wire format: value round trip and byte accounting.

    ``__call__`` maps ONE node's payload through the wire; the stacked
    operators apply it to each node row. ``wire_layout`` is the byte
    model ``mix_bytes_per_step`` / ``CommMeter`` meter from.

    ``gamma`` is CHOCO's consensus step size: the EF transports combine
    ``theta + gamma * (sum_j W_ij c_j - c_i)``. It scales only the gossip
    increment, never the wire, so the node mean is preserved for any
    gamma and the byte model is unchanged.
    """

    kind: str  # "identity" | "bf16" | "topk"
    frac: float = 1.0  # top-k keep fraction (ignored by other kinds)
    gamma: float = 1.0  # CHOCO consensus step size

    def __post_init__(self) -> None:
        if self.kind not in ("identity", "bf16", "topk"):
            raise ValueError(f"unknown compressor kind {self.kind!r}")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {self.frac}")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(f"gamma must be in (0, 1], got {self.gamma}")

    @property
    def is_identity(self) -> bool:
        return self.kind == "identity"

    @property
    def routes_to_plain(self) -> bool:
        """True when the EF transports route to the uncompressed path: only
        the undamped identity wire is the plain transport bitwise."""
        return self.is_identity and self.gamma == 1.0

    @property
    def label(self) -> str:
        """Spec string (round-trips through :func:`make_compressor`)."""
        base = self.kind if self.kind != "topk" else f"topk:{self.frac:g}"
        return base if self.gamma == 1.0 else f"{base}:g{self.gamma:g}"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "identity":
            return x
        if self.kind == "bf16":
            return bf16_compress(x)
        return torch.where(topk_mask(x, self.frac), x, torch.zeros_like(x))

    def wire_layout(self, p_total: int, itemsize: int = 4) -> tuple[int, int]:
        """``(elements_on_wire, bytes_per_element)`` for a ``p_total``-
        element payload: identity ``(P, itemsize)``, bf16 ``(P, 2)``, top-k
        ``(k, itemsize + 4)`` (each kept entry ships its value and its
        int32 position)."""
        if self.kind == "bf16":
            return p_total, 2
        if self.kind == "topk":
            return topk_keep_count(p_total, self.frac), itemsize + 4
        return p_total, itemsize

    def wire_bytes(self, p_total: int, itemsize: int = 4) -> int:
        elems, per_elem = self.wire_layout(p_total, itemsize)
        return elems * per_elem

    def wire_ratio(self, p_total: int, itemsize: int = 4) -> float:
        """Closed-form compressed/uncompressed byte ratio."""
        return self.wire_bytes(p_total, itemsize) / (p_total * itemsize)


def make_compressor(spec: "Compressor | str | None") -> "Compressor | None":
    """Normalize a compression spec: None, a Compressor, or a string.

    Strings: ``"none"``/``"identity"``, ``"bf16"``, ``"topk"`` (keep
    fraction 0.25) or ``"topk:<frac>"``; any of them may append a
    ``:g<gamma>`` suffix for the CHOCO step size (e.g.
    ``"topk:0.1:g0.25"``).
    """
    if spec is None:
        return None
    if isinstance(spec, Compressor):
        return spec
    if not isinstance(spec, str):
        raise TypeError(
            f"compression must be None, a Compressor, or a spec string; got "
            f"{type(spec).__name__} (bare callables have no byte model -- "
            f"wrap the format as a Compressor kind instead)"
        )
    parts = spec.split(":")
    kind, gamma, frac = parts[0], 1.0, None
    for tok in parts[1:]:
        if tok.startswith("g") and tok != "g":
            gamma = float(tok[1:])
        elif frac is None and kind == "topk":
            frac = float(tok)
        else:
            raise ValueError(f"unknown compression spec {spec!r}")
    if kind in ("none", "identity"):
        return Compressor("identity", gamma=gamma)
    if kind == "bf16":
        return Compressor("bf16", gamma=gamma)
    if kind == "topk":
        return Compressor("topk", 0.25 if frac is None else frac, gamma=gamma)
    raise ValueError(f"unknown compression spec {spec!r}")


def _require_wire(spec) -> Compressor:
    compressor = make_compressor(spec)
    if compressor is None:
        raise ValueError(
            "an EF transport needs a wire format; pass "
            "compression='identity' for the uncompressed route"
        )
    return compressor


def ef_init(params: PyTree) -> PyTree:
    """Zero EF memory shaped like ``params`` (float32, the wire dtype),
    on the parameters' device."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), params)


def _apply_stacked(compressor, x: torch.Tensor, payload: int | None = None) -> torch.Tensor:
    """Apply a wire format to a stacked (n, ...) operand.

    A :class:`Compressor` models one node's payload, so it applies to each
    node row (each node top-k's or rounds its own row). ``payload`` (a 2-D
    operand only) compresses the first ``payload`` columns and passes the
    rest -- the zero padding of the kernel's row alignment -- through.
    A bare callable is applied to the whole operand verbatim.
    """
    if not isinstance(compressor, Compressor):
        return compressor(x)
    if compressor.kind == "identity":
        return x
    if compressor.kind == "bf16":
        return bf16_compress(x)
    n = x.shape[0]
    rows = x.reshape(n, -1)
    width = rows.shape[1] if payload is None else payload
    keep = _topk_rows(rows[:, :width], compressor.frac)
    if width < rows.shape[1]:
        keep = torch.cat([keep, torch.ones_like(rows[:, width:], dtype=torch.bool)], dim=1)
    return torch.where(keep, rows, torch.zeros_like(rows)).reshape(x.shape)


def ef_gossip_step(
    theta_half: torch.Tensor,
    ef_memory: torch.Tensor,
    W,
    compressor: "Compressor | CompressorFn",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback compressed mixing step on stacked (n, ...)
    parameters with a dense W; returns ``(theta_mixed, new_ef_memory)``.

    ``W @ c`` runs through ``mix_dense`` (the ``gossip_mix`` kernel on the
    card). The identity :class:`Compressor` routes to the plain
    ``W @ theta`` product, so it is bitwise the uncompressed mix.
    """
    if isinstance(compressor, Compressor) and compressor.routes_to_plain:
        return mix_dense(theta_half, W), ef_memory
    g = compressor.gamma if isinstance(compressor, Compressor) else 1.0
    to_send = theta_half + ef_memory
    compressed = _apply_stacked(compressor, to_send)
    new_memory = to_send - compressed
    # consensus on the compressed views: theta_i + sum_j W_ij c_j - c_i
    mixed_c = mix_dense(compressed, W)
    if g == 1.0:
        theta_mixed = theta_half + mixed_c - compressed
    else:
        theta_mixed = theta_half + g * (mixed_c - compressed)
    return theta_mixed, new_memory


def ef_mix_schedule_arrays(
    params_stack: PyTree,
    ef: PyTree,
    arrays: ScheduleArrays,
    compressor: Compressor,
    corrupt: "WireCorruption | None" = None,
    *,
    use_kernel: bool = False,
) -> tuple[PyTree, PyTree]:
    """EF-compressed ``ScheduleArrays`` mixing on stacked parameters;
    returns ``(mixed, new_ef)``.

    Each leaf is compressed on its own, node by node (top-k keeps k of a
    node's LEAF), as the reference does; the compressed views of all
    leaves then mix through ``mix_schedule_arrays`` -- on the card one
    ``gossip_schedule`` launch on their raveled buffer. With the identity
    wire this routes to the plain arrays transport (bitwise) and returns
    ``ef`` untouched. ``corrupt`` poisons each sender's compressed wire
    view; the node's own ``c_i`` and its EF memory stay clean.
    """
    compressor = _require_wire(compressor)
    if compressor.routes_to_plain:
        return mix_schedule_arrays(params_stack, arrays, corrupt=corrupt,
                                   use_kernel=use_kernel), ef
    g = compressor.gamma
    x_leaves, rebuild = _flatten(params_stack)
    e_leaves = tree_leaves(ef)
    if len(e_leaves) != len(x_leaves):
        raise ValueError("ef memory must mirror the parameter pytree")
    cs, new_es = [], []
    for x, e in zip(x_leaves, e_leaves):
        to_send = x + e.to(x.dtype)
        c = _apply_stacked(compressor, to_send)
        new_es.append((to_send - c).to(e.dtype))
        cs.append(c)
    mcs = tree_leaves(mix_schedule_arrays(rebuild(cs), arrays, corrupt=corrupt,
                                          use_kernel=use_kernel))
    outs = [x + mc - c if g == 1.0 else x + g * (mc - c) for x, mc, c in zip(x_leaves, mcs, cs)]
    return rebuild(outs), rebuild(new_es)


def ef_stale_mix_flat(
    flat_half: torch.Tensor,
    ef_flat: torch.Tensor,
    buffer: StaleBuffer,
    arrays: ScheduleArrays,
    delays: torch.Tensor,
    compressor: Compressor,
    corrupt: "WireCorruption | None" = None,
    *,
    payload: int | None = None,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, StaleBuffer]:
    """EF-compressed bounded-delay mixing on the flat (n, P) convention.

    The ring holds the last ``depth`` WIRE payloads (``c = C(theta + e)``,
    or the half-step itself under the identity wire); the EF memory stays
    local and fresh; the combine subtracts the node's own fresh view:

        theta_i <- theta_i + gamma (sum_j W_ij c_j^{t - tau_j} - c_i^t)
        e_i     <- (theta_i + e_i) - c_i^t

    The compressor sees each node's whole flat row (top-k keeps k of the
    row, not of a leaf). ``payload`` is the row's width before the zero
    padding of the kernel's row alignment (None: the whole row). Returns
    ``(mixed, new_ef, buffer)``; the ring is pushed in place. The identity
    wire routes to the plain stale transport and returns ``ef_flat``
    untouched; with zero delays each route is bitwise its fresh twin.
    """
    compressor = _require_wire(compressor)
    if compressor.routes_to_plain:
        buffer = stale_push(buffer, flat_half)
        mixed = mix_schedule_arrays_stale(buffer, arrays, delays, corrupt,
                                          use_kernel=use_kernel)
        return mixed, ef_flat, buffer
    g = compressor.gamma
    to_send = flat_half + ef_flat.to(flat_half.dtype)
    c = _apply_stacked(compressor, to_send, payload)
    new_ef = (to_send - c).to(ef_flat.dtype)
    buffer = stale_push(buffer, c)
    view = stale_view(buffer, delays)
    acc = (
        _mix_flat(view, arrays, use_kernel)
        if corrupt is None
        else _mix_arrays_flat_corrupt(view, arrays, corrupt)
    )
    mixed = flat_half + acc - c if g == 1.0 else flat_half + g * (acc - c)
    return mixed, new_ef, buffer


# ---------------------------------------------------------------------------
# One node per rank: the EF twins of the sharded transports
# ---------------------------------------------------------------------------
#
# Each rank compresses its OWN payload once, ``c_i = C(theta_i + e_i)``,
# keeps ``e_i <- theta_i + e_i - c_i`` and moves ``c_i`` (the metered
# wire); the combine is ``theta_i + gamma (sum_j W_ij c_j - c_i)`` in
# float32, in the fresh transports' accumulation order, so pool and
# all-gather agree bitwise under one wire. The identity wire routes to the
# uncompressed transports and returns ``ef`` untouched (bitwise them).


def _narrow(compressor: Compressor, corrupt) -> torch.dtype | None:
    """The dtype the wire can move in: bfloat16 for the bf16 wire (its
    views are bf16 values; a corrupted payload keeps its float32 bits)."""
    return torch.bfloat16 if compressor.kind == "bf16" and corrupt is None else None


def _on_wire(c: torch.Tensor, compressor: Compressor, corrupt, i: int) -> torch.Tensor:
    """What this rank sends: its view, corrupted if it lies, else in the
    wire's dtype."""
    wire = c if corrupt is None else _corrupt_own(c, corrupt, i)
    narrow = _narrow(compressor, corrupt)
    return wire if narrow is None else wire.to(narrow)


def _combine(x32: torch.Tensor, acc: torch.Tensor, c: torch.Tensor, step: float) -> torch.Tensor:
    return x32 + acc - c if step == 1.0 else x32 + step * (acc - c)


def _ef_compress(x: torch.Tensor, e: torch.Tensor, compress):
    """``(x32, c, new_e)`` of one leaf (or of a block of stacked node rows):
    the float32 payload, its view ``compress(x32 + e)``, the memory left."""
    x32 = x.to(torch.float32)
    to_send = x32 + e.to(torch.float32)
    c = compress(to_send)
    return x32, c, to_send - c


def _ef_leaf_map(params: PyTree, ef: PyTree, fn) -> tuple[PyTree, PyTree]:
    """Leaf by leaf over ``(params, ef)`` with ``fn(x, e) -> (out, new_e)``
    (one leaf's gather live at a time, as in ``core.mixing``)."""
    x_leaves, rebuild = _flatten(params)
    e_leaves = tree_leaves(ef)
    if len(e_leaves) != len(x_leaves):
        raise ValueError("ef memory must mirror the parameter pytree")
    outs, new_es = zip(*(fn(x, e) for x, e in zip(x_leaves, e_leaves))) if x_leaves else ((), ())
    return rebuild(list(outs)), rebuild(list(new_es))


def mix_arrays_sharded_ef(params: PyTree, ef: PyTree, arrays: ScheduleArrays, group,
                          compressor: Compressor, *,
                          corrupt: "WireCorruption | None" = None) -> tuple[PyTree, PyTree]:
    """EF-compressed ``mix_arrays_sharded``: the all-gather moves the
    compressed views; bitwise :func:`mix_ppermute_pool_ef` on the same
    schedule. Returns ``(mixed, new_ef)``."""
    compressor = _require_wire(compressor)
    if compressor.routes_to_plain:
        return mix_arrays_sharded(params, arrays, group, corrupt=corrupt), ef
    step = compressor.gamma
    i = axis_index(group)
    _check_nodes(arrays.n_nodes, group, "the schedule")
    srcs = arrays.perms[:, i]

    def leaf(x, e):
        x32, c, new_e = _ef_compress(x, e, compressor)
        acc = _gather_mix(c, _on_wire(c, compressor, corrupt, i), group,
                          lambda g: _axpy_slots(g, arrays.gammas, srcs), corrupt)
        return _combine(x32, acc, c, step).to(x.dtype), new_e.to(e.dtype)

    return _ef_leaf_map(params, ef, leaf)


def mix_dense_sharded_ef(params: PyTree, ef: PyTree, W, group, compressor: Compressor, *,
                         corrupt: "WireCorruption | None" = None) -> tuple[PyTree, PyTree]:
    """EF-compressed ``mix_dense_sharded``: ``theta_i + sum_j W_ij c_j -
    c_i`` over the gathered views. Returns ``(mixed, new_ef)``."""
    compressor = _require_wire(compressor)
    if compressor.routes_to_plain:
        return mix_dense_sharded(params, W, group, corrupt=corrupt), ef
    step = compressor.gamma
    i = axis_index(group)
    Wt = W if isinstance(W, torch.Tensor) else torch.as_tensor(W, dtype=torch.float32)
    _check_nodes(Wt.shape[0], group, "W")
    row = Wt.to(device=tree_leaves(params)[0].device, dtype=torch.float32)[i]

    def leaf(x, e):
        x32, c, new_e = _ef_compress(x, e, compressor)
        acc = _gather_mix(c, _on_wire(c, compressor, corrupt, i), group, lambda g: (
            row @ g.reshape(g.shape[0], -1).to(torch.float32)).reshape(x.shape), corrupt)
        return _combine(x32, acc, c, step).to(x.dtype), new_e.to(e.dtype)

    return _ef_leaf_map(params, ef, leaf)


def mix_ppermute_pool_ef(params: PyTree, ef: PyTree, gammas: torch.Tensor, pool: PermPool,
                         group, compressor: Compressor,
                         corrupt: "WireCorruption | None" = None) -> tuple[PyTree, PyTree]:
    """EF-compressed staged-pool mixing: the ppermutes ship compressed
    views (``n_comm_slots x wire_bytes(P)`` a rank); gammas and the EF
    memory are data. Returns ``(mixed, new_ef)``."""
    compressor = _require_wire(compressor)
    if compressor.routes_to_plain:
        return mix_ppermute_pool(params, gammas, pool, group, corrupt), ef
    _check_pool_gammas(gammas, pool)
    _check_nodes(pool.n_nodes, group, "the pool")
    step = compressor.gamma
    i = axis_index(group)

    def leaf(x, e):
        x32, c, new_e = _ef_compress(x, e, compressor)
        contribs = _pool_contribs(_on_wire(c, compressor, corrupt, i), c, pool, group)
        acc = _pool_axpy(contribs, gammas, c)
        return _combine(x32, acc, c, step).to(x.dtype), new_e.to(e.dtype)

    return _ef_leaf_map(params, ef, leaf)


def _ef_stale_push(params: PyTree, ef: PyTree, state: ShardStaleState,
                   compressor: Compressor):
    """Compress every leaf and push its view into the ring, leaf by leaf
    (the head advanced once): returns ``(x leaves, rebuild, new ef)``. The
    views are what the ring stores -- its head slot holds this step's --;
    a node's own EF memory never travels, so it stays fresh."""
    x_leaves, rebuild = _flatten(params)
    e_leaves = tree_leaves(ef)
    if len(e_leaves) != len(x_leaves):
        raise ValueError("ef memory must mirror the parameter pytree")
    state.head.add_(1).remainder_(state.depth)
    idx = state.head.reshape(1)
    new_es = []
    for x, e, ring in zip(x_leaves, e_leaves, tree_leaves(state.rings)):
        _, c, new_e = _ef_compress(x, e, compressor)
        ring.index_copy_(0, idx, c.to(ring.dtype).unsqueeze(0))
        new_es.append(new_e.to(e.dtype))
    return x_leaves, rebuild, rebuild(new_es)


def _ring_views(ring: torch.Tensor, head: torch.Tensor, slot: torch.Tensor, corrupt, i: int):
    """``(c, d32, wire)`` of one leaf's ring: this step's view (the head
    slot), the delayed payload as float32, and what this rank sends."""
    c = ring.index_select(0, head.reshape(1))[0].to(torch.float32)
    d = ring.index_select(0, slot)[0]
    d32 = d.to(torch.float32)
    return c, d32, _sendable(d, d32, corrupt, i)


def mix_arrays_sharded_stale_ef(
    params: PyTree, ef: PyTree, state: ShardStaleState, arrays: ScheduleArrays,
    delays: torch.Tensor, group, compressor: Compressor, *,
    corrupt: "WireCorruption | None" = None,
) -> tuple[PyTree, PyTree, ShardStaleState]:
    """EF-compressed bounded-delay ``mix_arrays_sharded``: the ring holds
    the compressed views, the all-gather moves the delayed ones, the
    combine subtracts the node's own fresh view. Returns ``(mixed,
    new_ef, state)``; zero delays are :func:`mix_arrays_sharded_ef`."""
    compressor = _require_wire(compressor)
    if compressor.routes_to_plain:
        mixed, state = mix_arrays_sharded_stale(params, state, arrays, delays, group,
                                                corrupt=corrupt)
        return mixed, ef, state
    step = compressor.gamma
    i = axis_index(group)
    _check_nodes(arrays.n_nodes, group, "the schedule")
    x_leaves, rebuild, new_ef = _ef_stale_push(params, ef, state, compressor)
    slot = _stale_slot(state, delays, i)
    srcs = arrays.perms[:, i]
    outs = []
    for x, ring in zip(x_leaves, tree_leaves(state.rings)):
        c, d32, wire = _ring_views(ring, state.head, slot, corrupt, i)
        acc = _gather_mix(d32, wire, group, lambda g: _axpy_slots(g, arrays.gammas, srcs),
                          corrupt)
        outs.append(_combine(x.to(torch.float32), acc, c, step).to(x.dtype))
    return rebuild(outs), new_ef, state


def mix_ppermute_pool_stale_ef(
    params: PyTree, ef: PyTree, state: ShardStaleState, gammas: torch.Tensor, pool: PermPool,
    delays: torch.Tensor, group, compressor: Compressor,
    corrupt: "WireCorruption | None" = None,
) -> tuple[PyTree, PyTree, ShardStaleState]:
    """EF-compressed bounded-delay staged-pool mixing: every staged
    ppermute ships the node's DELAYED view. Returns ``(mixed, new_ef,
    state)``; zero delays are :func:`mix_ppermute_pool_ef`."""
    compressor = _require_wire(compressor)
    if compressor.routes_to_plain:
        mixed, state = mix_ppermute_pool_stale(params, state, gammas, pool, delays, group,
                                               corrupt)
        return mixed, ef, state
    _check_pool_gammas(gammas, pool)
    _check_nodes(pool.n_nodes, group, "the pool")
    step = compressor.gamma
    i = axis_index(group)
    x_leaves, rebuild, new_ef = _ef_stale_push(params, ef, state, compressor)
    slot = _stale_slot(state, delays, i)
    outs = []
    for x, ring in zip(x_leaves, tree_leaves(state.rings)):
        c, d32, wire = _ring_views(ring, state.head, slot, corrupt, i)
        contribs = _pool_contribs(wire, d32, pool, group)
        outs.append(_combine(x.to(torch.float32), _pool_axpy(contribs, gammas, d32), c,
                             step).to(x.dtype))
    return rebuild(outs), new_ef, state


# ---------------------------------------------------------------------------
# Stacked nodes in the rank transports' numerics (the LM trainer)
# ---------------------------------------------------------------------------
#
# What the rank twins above compute, on (n, ...) leaves: each node's view
# ``c_i = C(theta_i + e_i)`` in float32 (top-k over a node's whole leaf,
# as a rank's compressor sees it), ``e_i <- theta_i + e_i - c_i`` written
# into the EF memory in place, the mix of the views in the gossip kernels
# (float32 sums), and the combine ``theta_i + gamma (sum_j W_ij c_j -
# c_i)`` in the rank transports' order, rounded once to the leaf's dtype.
# An elementwise wire runs a block of ``STACKED_BLOCK`` columns at a
# time, so its float32 temporaries stay a few blocks.


def _rows(t: torch.Tensor, what: str) -> torch.Tensor:
    """(n, -1) rows of a carry written in place (a view: contiguous only)."""
    if not t.is_contiguous():
        raise ValueError(f"the {what} is updated in place: pass contiguous tensors "
                         "(the trainer's step copies init_opt_state's views)")
    return t.view(t.shape[0], -1)


def _blocks(width: int, compressor: Compressor):
    """Column blocks ``(a, b)`` of a node row: one for top-k (a node's
    whole leaf), else ``STACKED_BLOCK`` wide."""
    step = width if compressor.kind == "topk" else STACKED_BLOCK
    return [(a, min(width, a + step)) for a in range(0, width, step)]


def mix_stacked_ef(params: PyTree, ef: PyTree, operand, compressor: Compressor
                   ) -> tuple[PyTree, PyTree]:
    """EF-compressed mixing on stacked nodes by a ``ScheduleArrays``
    (``gossip_schedule``) or an (n, n) W (``gossip_mix``): the stacked
    twin of :func:`mix_arrays_sharded_ef` / :func:`mix_dense_sharded_ef`.
    ``ef`` (float32, contiguous) is updated in place. Returns ``(mixed,
    ef)``; the identity wire is the fresh mix in the kernel, ``ef``
    untouched."""
    compressor = _require_wire(compressor)
    x_leaves, rebuild = _flatten(params)
    if compressor.routes_to_plain:
        return rebuild([kernel_mix(x.reshape(x.shape[0], -1).contiguous(), operand)
                        .reshape(x.shape) for x in x_leaves]), ef
    e_leaves = tree_leaves(ef)
    if len(e_leaves) != len(x_leaves):
        raise ValueError("ef memory must mirror the parameter pytree")
    wire = functools.partial(_apply_stacked, compressor)  # each node row's view
    outs = []
    for x, e in zip(x_leaves, e_leaves):
        rows, erows = x.reshape(x.shape[0], -1), _rows(e, "EF memory")
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        orows = out.view(x.shape[0], -1)
        for a, b in _blocks(rows.shape[1], compressor):
            x32, c, erows[:, a:b] = _ef_compress(rows[:, a:b], erows[:, a:b], wire)
            acc = kernel_mix(c.contiguous(), operand)
            orows[:, a:b] = _combine(x32, acc, c, compressor.gamma)
        outs.append(out)
    return rebuild(outs), ef


def mix_arrays_stacked_stale_ef(params: PyTree, ef: PyTree, rings: PyTree, head: torch.Tensor,
                                arrays: ScheduleArrays, delays: torch.Tensor,
                                compressor: Compressor) -> tuple[PyTree, PyTree]:
    """EF-compressed bounded-delay ``ScheduleArrays`` mixing on stacked
    nodes, the stacked twin of :func:`mix_arrays_sharded_stale_ef`: the
    node-first ring (leaves (n, depth, *leaf); ``head`` advanced once)
    holds the views, node j's from ``delays[j]`` pushes ago is mixed in
    ``gossip_schedule``, the combine subtracts the node's fresh view.
    ``ef`` and the ring are updated in place. Returns ``(mixed, ef)``;
    the identity wire is :func:`mix_arrays_stacked_stale`."""
    compressor = _require_wire(compressor)
    if compressor.routes_to_plain:
        return mix_arrays_stacked_stale(params, rings, head, arrays, delays), ef
    x_leaves, rebuild = _flatten(params)
    e_leaves, r_leaves = tree_leaves(ef), tree_leaves(rings)
    if not len(x_leaves) == len(e_leaves) == len(r_leaves):
        raise ValueError("the EF memory and the ring must mirror the parameter pytree")
    depth = r_leaves[0].shape[1]
    slot = stacked_stale_slots(head, delays, depth)
    wire = functools.partial(_apply_stacked, compressor)  # each node row's view

    idx = head.reshape(1)
    outs = []
    for x, e, ring in zip(x_leaves, e_leaves, r_leaves):
        n = x.shape[0]
        rows, erows = x.reshape(n, -1), _rows(e, "EF memory")
        if not ring.is_contiguous():
            raise ValueError("the ring is updated in place: pass contiguous tensors")
        rrows = ring.view(n, depth, -1)
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        orows = out.view(n, -1)
        for a, b in _blocks(rows.shape[1], compressor):
            x32, c, erows[:, a:b] = _ef_compress(rows[:, a:b], erows[:, a:b], wire)
            block = rrows[:, :, a:b]
            block.index_copy_(1, idx, c.to(ring.dtype).unsqueeze(1))
            acc = kernel_mix(stacked_ring_view(block, slot).float().contiguous(), arrays)
            orows[:, a:b] = _combine(x32, acc, c, compressor.gamma)
        outs.append(out)
    return rebuild(outs), ef
