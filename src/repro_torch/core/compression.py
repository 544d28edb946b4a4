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

The sharded EF twins of the reference (``compression.py:442-782``) come
with the mesh trainer (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .mixing import (
    ScheduleArrays,
    StaleBuffer,
    WireCorruption,
    _mix_flat,
    mix_dense,
    mix_schedule_arrays,
    mix_schedule_arrays_stale,
    stale_push,
    stale_view,
    tree_leaves,
    tree_map,
    _mix_arrays_flat_corrupt,
    _flatten,
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
