"""Gossip mixing of stacked per-node parameters, in PyTorch.

The main-path subset of ``repro/core/mixing.py``: the D-SGD averaging
step ``theta_i <- sum_j W_ij theta_j`` over a leading node axis, as

1. ``mix_dense``            -- ``W @ Theta`` per leaf. Cost ``O(n^2 P)``.
2. ``mix_schedule_stacked`` -- the Birkhoff form of a learned sparse W:
                               ``out = sum_l gamma_l theta[perm_l]``, L
                               row-gathers and AXPYs on one raveled (n, P)
                               buffer. Cost ``O(L n P)`` with ``L << n``.
3. ``mix_schedule_arrays``  -- the same with the schedule as fixed-shape
                               tensors (``ScheduleArrays``).

``mix_stacked`` picks between (1) and (2) by a table measured on the
hardware (``autotune_transport``), or where it has no entry by the
closed-form ``preferred_transport`` cost model.

The fault layer's transports ride the same data plane:
``degrade_schedule`` repairs a schedule around crashed nodes and dropped
edges, the ``StaleBuffer`` ring and ``mix_schedule_arrays_stale`` mix
bounded-delay states (``StragglerPolicy`` / ``straggler_stream`` resolve
the delays), and ``corrupt_wire`` / ``mix_schedule_arrays_screened``
model lying senders and the receiver-side screen.

With one node per rank of a ``torch.distributed`` group (the reference's
``shard_map`` transports), the same mixes run as collectives:
``mix_dense_sharded`` / ``mix_arrays_sharded`` (an all-gather a leaf, W
or the schedule as data), ``mix_ppermute_pool`` (a staged pool of
ppermutes, gammas as data), ``mix_ppermute`` (a static schedule) and
``mix_allreduce`` (the complete graph), the bounded-delay twins over a
per-rank ring (``ShardStaleState``), and the pool's straggler repair
(``degrade_pool_gammas``, ``straggler_pool_stream``); these run outside
the kernels, as the reference's do. The LM trainer's stacked nodes run
the rank transports' numerics in the kernels (``kernel_mix``,
``mix_arrays_stacked_stale`` on a node-first ring, ``spread_sq_stacked``
for the probes).

On a CUDA tensor every mix runs in the hand-written kernels of
``repro_torch.kernels.gossip_mix``: one ``gossip_mix`` launch per leaf on
the dense path, one ``gossip_schedule`` launch on the raveled buffer on
the schedule paths, whatever ``use_kernel`` says. On the CPU the plain
PyTorch code reproduces the reference's two numerics: ``use_kernel=True``
gives the kernel's (every atom gathered, float32 accumulation), and
``use_kernel=False`` the reference's XLA path (identity atoms folded into
one scale, sums in the leaf dtype).

A parameter "pytree" here is a tensor or a dict of tensors; dict leaves
are taken in sorted key order, as ``jax.tree_util`` orders them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.gossip_mix import ops as gossip_ops

__all__ = [
    "BirkhoffSchedule",
    "ScheduleArrays",
    "schedule_to_arrays",
    "arrays_to_matrix",
    "truncate_schedule",
    "PermPool",
    "PoolSwap",
    "mix_schedule_arrays",
    "StackRavelSpec",
    "ravel_stack",
    "unravel_stack",
    "preferred_transport",
    "DENSE_THROUGHPUT_ADVANTAGE",
    "transport_autotune_path",
    "measure_transport",
    "autotune_transport",
    "select_transport",
    "mix_dense",
    "mix_schedule_stacked",
    "mix_stacked",
    "schedule_from_result",
    "schedule_from_matrix",
    "tree_leaves",
    "tree_map",
    "degrade_schedule",
    "StaleBuffer",
    "stale_buffer_init",
    "stale_push",
    "stale_view",
    "mix_schedule_arrays_stale",
    "StragglerPolicy",
    "straggler_stream",
    "WireCorruption",
    "corrupt_wire",
    "ScreenStats",
    "mix_schedule_arrays_screened",
    "degrade_pool_gammas",
    "straggler_pool_stream",
    "collective_bytes",
    "reset_collective_bytes",
    "axis_index",
    "axis_size",
    "group_backend",
    "mix_dense_sharded",
    "mix_arrays_sharded",
    "mix_ppermute_pool",
    "mix_ppermute",
    "mix_allreduce",
    "ShardStaleState",
    "stale_ring_dtype",
    "shard_stale_init",
    "shard_stale_push",
    "mix_arrays_sharded_stale",
    "mix_ppermute_pool_stale",
    "STACKED_BLOCK",
    "kernel_mix",
    "stacked_stale_slots",
    "stacked_ring_view",
    "mix_arrays_stacked_stale",
    "spread_sq_stacked",
    "ALLGATHER_THROUGHPUT_ADVANTAGE",
    "preferred_sharded_transport",
    "measure_sharded_transport",
    "autotune_sharded_transport",
]

PyTree = Any

# Rows of a raveled buffer on the kernel path are padded to a multiple of
# this many elements (16 bytes of bfloat16, 32 of float32), so each row
# starts 16-byte aligned and the schedule kernel takes its vector loads.
KERNEL_ROW_ALIGN = 8


# ---------------------------------------------------------------------------
# Pytrees: a tensor, or a dict of tensors
# ---------------------------------------------------------------------------

def _flatten(tree: PyTree) -> tuple[list[torch.Tensor], Callable[[list], PyTree]]:
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda leaves: dict(zip(keys, leaves))
    raise TypeError(f"expected a tensor or a dict of tensors, got {type(tree).__name__}")


def tree_leaves(tree: PyTree) -> list[torch.Tensor]:
    return _flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` applied leaf by leaf across trees of one structure."""
    leaves, rebuild = _flatten(tree)
    others = [_flatten(t)[0] for t in rest]
    return rebuild([fn(*args) for args in zip(leaves, *others)])


def _on_cuda(tree: PyTree) -> bool:
    return tree_leaves(tree)[0].device.type == "cuda"


def _check_perm_table(perms: np.ndarray, n: int) -> None:
    if perms.size and (perms.min() < 0 or perms.max() >= n):
        raise ValueError(f"permutation entries must lie in [0, {n})")


# ---------------------------------------------------------------------------
# Static schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BirkhoffSchedule:
    """A mixing matrix as a convex combination of permutations.

    ``coeffs[l]`` weights atom ``l``; ``perms[l][i] = j`` means node ``i``
    receives node ``j``'s parameters in atom ``l`` (i.e. ``P_l[i, j] = 1``,
    so ``W = sum_l coeffs[l] P_l``). Atom arrays are python tuples, so
    the schedule is hashable. ``operands(device)`` keeps the kernel's
    tensors per device, made once.
    """

    coeffs: tuple[float, ...]
    perms: tuple[tuple[int, ...], ...]
    _operands: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False, hash=False
    )

    @property
    def n_nodes(self) -> int:
        return len(self.perms[0])

    @property
    def n_atoms(self) -> int:
        return len(self.coeffs)

    @property
    def n_communication_atoms(self) -> int:
        """Atoms that move data (non-identity permutations)."""
        return sum(1 for p in self.perms if tuple(p) != tuple(range(len(p))))

    def identity_weight(self) -> float:
        """Total coefficient mass on identity atoms (a local scale, no I/O)."""
        ident = tuple(range(self.n_nodes))
        return sum(c for c, p in zip(self.coeffs, self.perms) if tuple(p) == ident)

    def communication_atoms(self) -> list[tuple[float, tuple[int, ...]]]:
        """(gamma, perm) pairs for the non-identity atoms."""
        ident = tuple(range(self.n_nodes))
        return [
            (float(c), tuple(p))
            for c, p in zip(self.coeffs, self.perms)
            if tuple(p) != ident
        ]

    def perm_array(self) -> np.ndarray:
        """All atoms as an (L, n) int32 index array (kernel input format)."""
        return np.asarray(self.perms, dtype=np.int32).reshape(self.n_atoms, self.n_nodes)

    def coeff_array(self) -> np.ndarray:
        return np.asarray(self.coeffs, dtype=np.float32)

    def operands(self, device: torch.device | str) -> tuple[torch.Tensor, torch.Tensor]:
        """``(coeffs (L,) float32, perms (L, n) int32)`` as tensors on ``device``.

        Made and checked once per device, so a training loop copies
        nothing from the host per step.
        """
        key = str(torch.device(device))
        ops = self._operands.get(key)
        if ops is None:
            perms = self.perm_array()
            _check_perm_table(perms, self.n_nodes)
            ops = (
                torch.as_tensor(self.coeff_array(), device=device),
                torch.as_tensor(perms, device=device),
            )
            self._operands[key] = ops
        return ops

    def to_matrix(self) -> np.ndarray:
        n = self.n_nodes
        W = np.zeros((n, n))
        for c, perm in zip(self.coeffs, self.perms):
            W[np.arange(n), list(perm)] += c
        return W


def schedule_from_result(result) -> BirkhoffSchedule:
    """Build a schedule from an ``STLFWResult`` (drops zero-weight atoms)."""
    coeffs, perms = [], []
    for c, perm in result.active_atoms():
        coeffs.append(float(c))
        perms.append(tuple(int(x) for x in perm))
    return BirkhoffSchedule(coeffs=tuple(coeffs), perms=tuple(perms))


def schedule_from_matrix(W: np.ndarray, max_atoms: int | None = None, tol: float = 1e-9) -> BirkhoffSchedule:
    """Greedy Birkhoff-von-Neumann decomposition of an arbitrary doubly-
    stochastic matrix (used for baseline topologies like rings/regular
    graphs so they can ride the schedule transport).

    Repeatedly extracts the permutation supported on the largest entries via
    a max-weight assignment, removing ``min`` of its entries each time.
    """
    from .assignment import linear_assignment

    W = np.asarray(W, dtype=np.float64).copy()
    n = W.shape[0]
    coeffs: list[float] = []
    perms: list[tuple[int, ...]] = []
    remaining = W.copy()
    limit = max_atoms if max_atoms is not None else n * n
    for _ in range(limit):
        total = remaining.sum()
        if total <= tol * n:
            break
        # max-weight perfect matching on the remaining mass: forbid zeros.
        cost = np.where(remaining > tol, -remaining, 1e6)
        perm = linear_assignment(cost)
        vals = remaining[np.arange(n), perm]
        if np.any(vals <= tol):
            break
        gamma = float(vals.min())
        coeffs.append(gamma)
        perms.append(tuple(int(x) for x in perm))
        remaining[np.arange(n), perm] -= gamma
    if not coeffs:
        coeffs, perms = [1.0], [tuple(range(n))]
    # Renormalize tiny residual mass into the coefficients.
    s = sum(coeffs)
    coeffs = [c / s for c in coeffs]
    return BirkhoffSchedule(coeffs=tuple(coeffs), perms=tuple(perms))


# ---------------------------------------------------------------------------
# Data-plane schedules
# ---------------------------------------------------------------------------

class ScheduleArrays(NamedTuple):
    """A Birkhoff schedule as data: ``W = sum_l gammas[l] P_{perms[l]}``.

    Attributes:
      gammas: (l_max,) float32 tensor of convex coefficients (sum to 1;
        padding atoms carry exactly 0).
      perms: (l_max, n) int32 tensor, ``perms[l, i] = j`` meaning node
        ``i`` receives node ``j``'s parameters in atom ``l``; padding rows
        are the identity permutation.

    Two schedules with the same ``(l_max, n)`` are interchangeable values
    of the same mixing call.
    """

    gammas: torch.Tensor
    perms: torch.Tensor

    @property
    def l_max(self) -> int:
        return self.perms.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.perms.shape[1]


def schedule_to_arrays(
    schedule: BirkhoffSchedule,
    l_max: int | None = None,
    device: torch.device | str | None = None,
) -> ScheduleArrays:
    """Pad a static schedule into the fixed-shape data-plane format.

    Padding atoms are identity permutations with coefficient 0 -- they
    gather and add exact zeros, so the mixed result is what the unpadded
    schedule produces. ``device=None`` means CUDA.
    """
    device = resolve_device(device)
    L = schedule.n_atoms
    n = schedule.n_nodes
    if l_max is None:
        l_max = L
    if L > l_max:
        raise ValueError(
            f"schedule has {L} atoms > l_max={l_max}; truncate first "
            "(see truncate_schedule)"
        )
    gammas = np.zeros((l_max,), np.float32)
    perms = np.tile(np.arange(n, dtype=np.int32), (l_max, 1))
    gammas[:L] = schedule.coeff_array()
    if L:
        perms[:L] = schedule.perm_array()
    _check_perm_table(perms, n)
    return ScheduleArrays(
        gammas=torch.as_tensor(gammas, device=device),
        perms=torch.as_tensor(perms, device=device),
    )


def arrays_to_matrix(arrays: ScheduleArrays) -> np.ndarray:
    """Densify a data-plane schedule (host-side, for validation/analysis)."""
    gammas = arrays.gammas.detach().cpu().numpy().astype(np.float64)
    perms = arrays.perms.detach().cpu().numpy()
    n = perms.shape[1]
    W = np.zeros((n, n))
    rows = np.arange(n)
    for g, perm in zip(gammas, perms):
        W[rows, perm] += g
    return W


def truncate_schedule(schedule: BirkhoffSchedule, l_max: int) -> BirkhoffSchedule:
    """Keep the ``l_max`` largest-coefficient atoms and renormalize.

    A renormalized sub-combination of permutation atoms is still doubly
    stochastic, so the truncated W stays a valid mixing matrix; what is
    lost is a small amount of mixing mass (bounded by the dropped
    coefficients' sum).
    """
    if l_max < 1:
        raise ValueError("l_max must be >= 1")
    if schedule.n_atoms <= l_max:
        return schedule
    order = np.argsort(np.asarray(schedule.coeffs))[::-1][:l_max]
    order = np.sort(order)  # keep original atom order (identity first)
    coeffs = [schedule.coeffs[i] for i in order]
    total = sum(coeffs)
    if total <= 0.0:
        raise ValueError("truncate_schedule: kept atoms carry no mass")
    return BirkhoffSchedule(
        coeffs=tuple(c / total for c in coeffs),
        perms=tuple(schedule.perms[i] for i in order),
    )


# ---------------------------------------------------------------------------
# Staged permutation pools (host classes of the reference's pool transport)
# ---------------------------------------------------------------------------
#
# The reference compiles the UNION of K permutation atoms once (the
# initial solve's Birkhoff atoms plus identity headroom slots) into its
# mesh transport ``mix_ppermute_pool``, with the per-atom convex
# coefficients as a (K,) data vector: a refresh whose atoms stay inside
# the pool is a pure gamma-value change, an out-of-pool refresh restages
# the pool once. The port keeps the host side -- the pool, the
# projection and the ``PoolSwap`` update the online controller emits --
# so the controller's pool mode works; the sharded transport itself
# comes with the port's mesh trainer.


@dataclasses.dataclass(frozen=True)
class PermPool:
    """A fixed, compiled-in set of permutation atoms ("slots").

    ``perms`` holds ``capacity`` static permutations, identity-padded:
    identity slots cost nothing (a local scale, no communication) and
    serve as headroom -- but REPLACING a slot's permutation changes the
    compiled trace, which is exactly the pool-miss recompile the
    schedule projection exists to avoid. Frozen + tuple-of-tuples, so a
    compiled step can close over a pool hashably.

    The runtime coefficients live OUTSIDE the pool, as a ``(capacity,)``
    gamma vector threaded through the step as data (the reference's
    ``mix_ppermute_pool``, whose port waits for the mesh trainer);
    ``project`` maps any :class:`BirkhoffSchedule` onto that vector.
    """

    perms: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        if not self.perms:
            raise ValueError("PermPool needs at least one slot")
        n = len(self.perms[0])
        for p in self.perms:
            if len(p) != n or sorted(p) != list(range(n)):
                raise ValueError(f"pool slot {p!r} is not a permutation of {n}")

    @property
    def capacity(self) -> int:
        return len(self.perms)

    @property
    def n_nodes(self) -> int:
        return len(self.perms[0])

    @property
    def identity(self) -> tuple[int, ...]:
        return tuple(range(self.n_nodes))

    @property
    def n_comm_slots(self) -> int:
        """Non-identity slots: each moves P bytes per node per mix step
        (gamma 0 or not -- a staged ppermute executes unconditionally)."""
        ident = self.identity
        return sum(1 for p in self.perms if p != ident)

    @classmethod
    def from_schedule(
        cls, schedule: BirkhoffSchedule, capacity: int | None = None
    ) -> "PermPool":
        """Stage a schedule's atoms (deduplicated, order kept), identity-
        padding up to ``capacity`` headroom slots.

        A schedule with more atoms than ``capacity`` is truncated first
        (largest coefficients kept -- :func:`truncate_schedule`), so a
        restage always fits.
        """
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if capacity is not None and schedule.n_atoms > capacity:
            schedule = truncate_schedule(schedule, capacity)
        seen: dict[tuple[int, ...], None] = {}
        for p in schedule.perms:
            seen.setdefault(tuple(int(x) for x in p))
        slots = list(seen)
        n = schedule.n_nodes
        cap = capacity if capacity is not None else len(slots)
        ident = tuple(range(n))
        while len(slots) < cap:
            slots.append(ident)
        return cls(perms=tuple(slots))

    def _slot_index(self) -> dict[tuple[int, ...], int]:
        idx: dict[tuple[int, ...], int] = {}
        for l, p in enumerate(self.perms):
            idx.setdefault(p, l)
        return idx

    def project(self, schedule: BirkhoffSchedule) -> tuple[np.ndarray, float]:
        """Schedule -> pool-aligned gammas; returns ``(gammas, dropped)``.

        Atoms staged in the pool land in their slot; atoms NOT in the
        pool are dropped and their total coefficient mass returned as
        ``dropped`` (pre-renormalization). The kept coefficients are
        renormalized, so the executed W stays doubly stochastic -- the
        same pool-aware truncation argument as
        :func:`truncate_schedule`, with the pool membership (not the
        coefficient rank) deciding who is kept. The caller compares
        ``dropped`` against its miss tolerance to decide between an
        in-pool swap and a restage.
        """
        if schedule.n_nodes != self.n_nodes:
            raise ValueError(
                f"schedule is for {schedule.n_nodes} nodes, pool for {self.n_nodes}"
            )
        idx = self._slot_index()
        gammas = np.zeros((self.capacity,), np.float64)
        dropped = 0.0
        for c, p in zip(schedule.coeffs, schedule.perms):
            slot = idx.get(tuple(int(x) for x in p))
            if slot is None:
                dropped += float(c)
            else:
                gammas[slot] += float(c)
        kept = gammas.sum()
        if kept > 0.0:
            gammas /= kept
        return gammas.astype(np.float32), float(dropped)

    def contains(self, schedule: BirkhoffSchedule) -> bool:
        """True iff every atom of ``schedule`` is staged in this pool."""
        _, dropped = self.project(schedule)
        return dropped == 0.0

    def arrays_for(
        self, gammas: np.ndarray, device: torch.device | str | None = None
    ) -> ScheduleArrays:
        """Pool-aligned gammas as a :class:`ScheduleArrays` (slot order
        preserved) on ``device`` (None = CUDA): the data-plane twin of
        the pool transport, which any ``ScheduleArrays`` mix executes."""
        gammas = np.asarray(gammas, np.float32)
        if gammas.shape != (self.capacity,):
            raise ValueError(
                f"gammas must be ({self.capacity},), got {gammas.shape}"
            )
        device = resolve_device(device)
        perms = np.asarray(self.perms, np.int32).reshape(self.capacity, self.n_nodes)
        return ScheduleArrays(
            gammas=torch.as_tensor(gammas, device=device),
            perms=torch.as_tensor(perms, device=device),
        )

    def to_matrix(self, gammas: np.ndarray) -> np.ndarray:
        """Densify pool slots + gammas (host-side validation)."""
        return arrays_to_matrix(self.arrays_for(gammas, device="cpu"))


@dataclasses.dataclass(frozen=True)
class PoolSwap:
    """A topology update in pool coordinates (what an online refresh
    hands a pool-transport trainer at a segment boundary).

    ``pool is None`` means the update stayed inside the trainer's
    staged pool: applying it is a pure ``(capacity,)`` gamma value
    change (zero retraces). A non-None ``pool`` is a RESTAGE -- the
    refresh emitted out-of-pool atoms beyond the miss tolerance, the
    new pool must be compiled in (one counted recompile on the pool
    transport; pure data on the all-gather transport, which executes
    pool gammas as their ScheduleArrays twin), and ``gammas`` is
    aligned to the NEW pool's slots. ``dropped_mass`` records the
    coefficient mass the projection discarded: the out-of-pool mass
    for an in-pool swap, the capacity-truncation residue for a restage
    (0 iff every refreshed atom fit the pool).
    """

    gammas: np.ndarray
    pool: "PermPool | None" = None
    dropped_mass: float = 0.0

    @property
    def restaged(self) -> bool:
        return self.pool is not None


def _mix_arrays_flat(flat: torch.Tensor, arrays: ScheduleArrays) -> torch.Tensor:
    """``out = sum_l gammas[l] flat[perms[l]]``, summed in ``flat``'s dtype
    (the reference's XLA path, ``mixing.py:340``)."""
    if flat.shape[0] != arrays.n_nodes:
        raise ValueError(
            f"schedule arrays are for {arrays.n_nodes} nodes but the stacked "
            f"parameters have leading axis {flat.shape[0]}"
        )
    acc = torch.zeros_like(flat)
    perms = arrays.perms.long()
    for l in range(arrays.l_max):
        acc = acc + arrays.gammas[l].to(flat.dtype) * flat[perms[l]]
    return acc


def _mix_kernel_form(params_stack: PyTree, coeffs, perms) -> PyTree:
    """One ``gossip_schedule`` call on the raveled buffer (the kernel on a
    CUDA tensor, its plain version on the CPU)."""
    flat, spec = ravel_stack(params_stack, pad_to=KERNEL_ROW_ALIGN)
    return unravel_stack(gossip_ops.gossip_schedule(flat, coeffs, perms), spec)


def mix_schedule_arrays(
    params_stack: PyTree,
    arrays: ScheduleArrays,
    *,
    single_buffer: bool = False,
    use_kernel: bool = False,
    corrupt: "WireCorruption | None" = None,
) -> PyTree:
    """Data-plane Birkhoff mixing: ``l_max`` gathers + AXPYs, with the
    schedule as tensors. Cost ``O(l_max n P)`` (padding atoms are not
    free: choose ``l_max`` as the actual communication budget).

    On a CUDA tensor, or with ``use_kernel``, the whole pytree is raveled
    into one (n, P) buffer and mixed in one ``gossip_schedule`` call.
    (The reference's ``block_p``, its Pallas tile width, has no
    counterpart: the kernel takes any P.)

    ``corrupt`` (a :class:`WireCorruption`) poisons each sender's
    outgoing payload at the wire; None is the untouched transport.
    Self-loops move no bytes and stay clean. (The reference refuses
    ``corrupt`` on its kernel path; here the corrupted mix runs in the
    kernel too, on a stacked source buffer.)
    """
    if corrupt is not None:
        if use_kernel or single_buffer or _on_cuda(params_stack):
            flat, spec = ravel_stack(params_stack)
            return unravel_stack(_mix_arrays_flat_corrupt(flat, arrays, corrupt), spec)
        return tree_map(lambda x: _mix_arrays_flat_corrupt(x, arrays, corrupt), params_stack)
    if use_kernel or _on_cuda(params_stack):
        return _mix_kernel_form(params_stack, arrays.gammas, arrays.perms)
    if single_buffer:
        flat, spec = ravel_stack(params_stack)
        return unravel_stack(_mix_arrays_flat(flat, arrays), spec)
    return tree_map(
        lambda x: _mix_arrays_flat(x.reshape(x.shape[0], -1), arrays).reshape(x.shape),
        params_stack,
    )


# ---------------------------------------------------------------------------
# Single-buffer flatten/unflatten
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackRavelSpec:
    """Recipe for packing an (n, ...)-leaved pytree into one (n, P)
    buffer and back."""

    rebuild: Callable[[list], PyTree]
    shapes: tuple[tuple[int, ...], ...]  # per-leaf shapes *without* node axis
    dtypes: tuple[torch.dtype, ...]
    n_nodes: int
    total: int  # sum of leaf sizes (pre-padding)
    padded: int  # buffer width P (>= total; padded to pad_to)

    @property
    def pad(self) -> int:
        return self.padded - self.total


def ravel_stack(params_stack: PyTree, pad_to: int | None = None) -> tuple[torch.Tensor, StackRavelSpec]:
    """Flatten an (n, ...)-leaved pytree into one contiguous (n, P) buffer.

    ``pad_to`` pads the parameter axis once, with zeros, to a multiple of
    the given width. The buffer dtype is the common ``promote_types`` of
    the leaves; ``unravel_stack`` casts back.
    """
    leaves, rebuild = _flatten(params_stack)
    if not leaves:
        raise ValueError("ravel_stack: empty pytree")
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.ndim < 1 or leaf.shape[0] != n:
            raise ValueError(
                f"ravel_stack: every leaf needs leading node axis {n}, "
                f"got shape {tuple(leaf.shape)}"
            )
    dtypes = tuple(leaf.dtype for leaf in leaves)
    buf_dtype = dtypes[0]
    for dt in dtypes[1:]:
        buf_dtype = torch.promote_types(buf_dtype, dt)
    shapes = tuple(tuple(leaf.shape[1:]) for leaf in leaves)
    sizes = [int(np.prod(s, dtype=np.int64)) if s else 1 for s in shapes]
    total = int(sum(sizes))
    padded = total
    if pad_to is not None and pad_to > 0:
        padded = ((total + pad_to - 1) // pad_to) * pad_to
    flat = torch.empty((n, padded), dtype=buf_dtype, device=leaves[0].device)
    offset = 0
    for leaf, size in zip(leaves, sizes):
        flat[:, offset : offset + size] = leaf.reshape(n, size)
        offset += size
    if padded > total:
        flat[:, total:] = 0
    spec = StackRavelSpec(
        rebuild=rebuild,
        shapes=shapes,
        dtypes=dtypes,
        n_nodes=n,
        total=total,
        padded=padded,
    )
    return flat, spec


def unravel_stack(flat: torch.Tensor, spec: StackRavelSpec) -> PyTree:
    """Inverse of ``ravel_stack`` (drops padding, restores shapes/dtypes).

    The leaves are views into ``flat`` where the dtype is unchanged.
    """
    n = spec.n_nodes
    leaves = []
    offset = 0
    for shape, dtype in zip(spec.shapes, spec.dtypes):
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        piece = flat[:, offset : offset + size]
        leaves.append(piece.reshape((n,) + shape).to(dtype))
        offset += size
    return spec.rebuild(leaves)


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

# Per-element throughput advantage of the dense transport over gather
# AXPYs in the reference's closed form, calibrated there on CPU BLAS. The
# port keeps the same rule, so that ``transport="auto"`` falls back to
# what the reference picks; the measured table below, not this constant,
# carries the card's crossover.
DENSE_THROUGHPUT_ADVANTAGE = 4.0


def preferred_transport(
    n_nodes: int,
    n_atoms: int,
    dense_speedup: float = DENSE_THROUGHPUT_ADVANTAGE,
) -> str:
    """Pick ``"schedule"`` vs ``"dense"`` for the stacked simulator.

    The schedule transport does ``n_atoms`` memory-bound row-gather AXPYs
    per element; the dense transport does ``n_nodes`` MACs per element at
    matmul throughput. ``dense_speedup`` is the per-element throughput
    ratio between the two regimes: the crossover is ``schedule`` iff
    ``n_atoms <= n_nodes / dense_speedup``.
    """
    if dense_speedup <= 0:
        raise ValueError(f"dense_speedup must be positive, got {dense_speedup}")
    return "schedule" if n_atoms <= max(1, int(n_nodes / dense_speedup)) else "dense"


# ---------------------------------------------------------------------------
# Measured transport autotune table
# ---------------------------------------------------------------------------
#
# The reference's table (``mixing.py:1705-1913``) with the port's own file
# and tags: each (hardware, n_nodes, n_atoms, P) bucket -- sizes rounded
# up to powers of two, keyed by a hardware tag (the CUDA device name on
# the card, core count and architecture on the CPU) -- is timed once,
# both transports as the trainers run them (``mix_stacked`` on a pytree of
# the caller's leaf widths: on the card the ravel copy and one
# gossip_schedule launch against one gossip_mix launch a leaf, each
# followed by the local update that reads its output), and
# memoized to experiments/torch/transport_autotune.json, never the
# reference's file. The first caller to miss a bucket sets its record: it
# is timed at that caller's n_nodes, n_atoms and leaf widths (P rounded
# up: both transports are linear in it), not at the bucket's powers of
# two as the reference times it -- near the crossover the two picks can
# differ (n 100, L 10 against the (128, 16) corner on the H100). Lookups
# never measure; ``transport="autotune"`` measures on a miss.

_AUTOTUNE_ENV = "REPRO_TORCH_TRANSPORT_AUTOTUNE"
_autotune_cache: dict[str, dict] | None = None
_autotune_cache_path: str | None = None

# Measuring caps the timed buffer at this many elements (n * P): both
# transports are linear in P, so the winner at the capped width carries
# over to wider buffers.
_MEASURE_MAX_ELEMENTS = 1 << 24  # 64 MiB of f32
_TIMED_LAUNCHES = 30
_WARMUP_LAUNCHES = 5


def transport_autotune_path() -> str:
    """Location of the port's table (override via $REPRO_TORCH_TRANSPORT_AUTOTUNE)."""
    import os

    env = os.environ.get(_AUTOTUNE_ENV)
    if env:
        return env
    return os.path.normpath(os.path.join(
        os.path.dirname(__file__), "..", "..", "..",
        "experiments", "torch", "transport_autotune.json",
    ))


def _pow2_up(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def _p_measured(n_nodes: int, p: int) -> int:
    """The width a measurement times: ``p``, capped at
    ``_MEASURE_MAX_ELEMENTS`` elements in all (but never below 4096)."""
    return min(int(p), max(4096, _MEASURE_MAX_ELEMENTS // max(1, n_nodes)))


def _timed_leaves(leaf_sizes: Sequence[int], p_measured: int) -> list[int]:
    """Per-node leaf widths in the proportions of ``leaf_sizes``, summing
    to ``p_measured``. Each keeps the power-of-two alignment of its width
    up to 16 elements (the kernels' fast paths need 16-byte rows); the
    smallest leaf takes the rounding."""
    sizes = [int(s) for s in leaf_sizes]
    if not sizes or min(sizes) < 1:
        raise ValueError(f"leaf sizes must be positive, got {tuple(leaf_sizes)}")
    total = sum(sizes)
    timed = []
    for s in sizes:
        align = min(16, s & -s)
        timed.append(max(align, s * p_measured // total // align * align))
    small = int(np.argmin(sizes))
    timed[small] = 0
    rest = p_measured - sum(timed)
    if rest < 1:
        return [p_measured]
    timed[small] = rest
    return timed


def _hw_tag(device: torch.device) -> str:
    """Hardware tag of autotune keys: the CUDA device name, normalised as
    the reference normalises a device kind, or ``cpu<cores>-<arch>``."""
    import os
    import platform
    import re

    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        return re.sub(r"[^A-Za-z0-9]+", "-", str(kind)).strip("-").lower()
    arch = platform.machine() or "unknown"
    return f"cpu{os.cpu_count()}-{arch.lower()}"


def _bucket_key(n_nodes: int, n_atoms: int, p: int, device: torch.device) -> str:
    return (
        f"{_hw_tag(device)}_n{_pow2_up(n_nodes)}"
        f"_L{_pow2_up(n_atoms)}_P{_pow2_up(p)}"
    )


def _load_autotune(path: str) -> dict[str, dict]:
    global _autotune_cache, _autotune_cache_path
    if _autotune_cache is not None and _autotune_cache_path == path:
        return _autotune_cache
    import json
    import os

    table: dict[str, dict] = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                table = json.load(f)
        except (OSError, ValueError):  # unreadable table == no table
            table = {}
    _autotune_cache, _autotune_cache_path = table, path
    return table


def _persist_autotune(path: str, table: dict) -> None:
    """Atomically write the table, but only into a directory that already
    exists; otherwise the measurement stays in memory."""
    global _autotune_cache, _autotune_cache_path
    import json
    import os

    try:
        if os.path.isdir(os.path.dirname(path)):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(table, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
    except OSError:
        pass
    _autotune_cache, _autotune_cache_path = table, path


def _card(device: torch.device) -> tuple[str, str | None]:
    """The card's name and its power limit as ``nvidia-smi`` reports it
    (None where it cannot be read)."""
    import subprocess

    name = torch.cuda.get_device_name(device)
    try:
        uuid = str(torch.cuda.get_device_properties(device).uuid)
        rows = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.splitlines()
    except (OSError, subprocess.SubprocessError, AttributeError, RuntimeError):
        return name, None
    for row in rows:
        gpu, _, limit = row.partition(",")
        if gpu.strip().lower().endswith(uuid.lower()):
            return name, limit.strip()
    return name, None


def _median_device_us(fn) -> float:
    """Median device time of ``fn()`` in us over ``_TIMED_LAUNCHES``
    launches, one CUDA event pair each, a ~0.5 ms device sleep queued
    before each so that the pair brackets device work."""
    times = []
    for _ in range(_TIMED_LAUNCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return float(np.median(times))


def _best_host_us(fn, iters: int, repeats: int) -> float:
    """On the CPU: the min over ``repeats`` of an ``iters``-call average."""
    import time

    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
    return best


def _measure(n_nodes: int, n_atoms: int, p: int, leaf_sizes: Sequence[int], seed: int,
             device: torch.device, iters: int, repeats: int) -> tuple[dict, dict]:
    """Both transports' times in us at this bucket, and the record's sizes."""
    p_measured = _p_measured(n_nodes, p)
    rng = np.random.default_rng(seed)
    perms = [rng.permutation(n_nodes) for _ in range(n_atoms)]
    sched = BirkhoffSchedule(
        coeffs=tuple(float(c) for c in np.full(n_atoms, 1.0 / n_atoms)),
        perms=tuple(tuple(int(x) for x in p_) for p_ in perms),
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = [torch.randn((n_nodes, w), generator=gen, device=device)
              for w in _timed_leaves(leaf_sizes, p_measured)]
    tree = leaves[0] if len(leaves) == 1 else {f"{i:03d}": x for i, x in enumerate(leaves)}
    W = torch.as_tensor(sched.to_matrix(), dtype=torch.float32, device=device)
    sched.operands(leaves[0].device)  # made once, as the trainers make them before a run
    grads = [torch.randn(x.shape, generator=gen, device=device) for x in leaves]

    def then_update(mixed) -> list:
        # the next step's local update reads the mix's output (``p - lr g``,
        # core/dsgd.py); on the card the schedule transport's leaves are
        # views of its padded buffer, which that update reads strided
        return [p - 0.1 * g for p, g in zip(tree_leaves(mixed), grads)]

    # both transports as a training step runs them: on the card the ravel
    # copy and one gossip_schedule launch, against one gossip_mix launch a
    # leaf, each followed by the update; on the CPU the plain per-leaf paths
    runs = {
        "schedule": lambda: then_update(mix_stacked(tree, schedule=sched,
                                                    transport="schedule")),
        "dense": lambda: then_update(mix_stacked(tree, W, transport="dense")),
    }
    record = {"n_nodes": n_nodes, "n_atoms": n_atoms, "p": p, "p_measured": p_measured,
              "leaf_sizes": [int(s) for s in leaf_sizes]}
    if device.type == "cuda":
        for fn in runs.values():  # warm both (their libraries load) before timing either
            for _ in range(_WARMUP_LAUNCHES):
                fn()
        torch.cuda.synchronize(device)
        return {k: _median_device_us(fn) for k, fn in runs.items()}, record
    for fn in runs.values():
        fn()
    return {k: _best_host_us(fn, iters, repeats) for k, fn in runs.items()}, record


def measure_transport(
    n_nodes: int, n_atoms: int, p: int, *, leaf_sizes: Sequence[int] | None = None,
    iters: int = 5, repeats: int = 3, seed: int = 0,
    device: torch.device | str | None = None,
) -> dict:
    """Time both stacked transports once at this bucket size (synthetic
    float32 data) and return the measurement record.

    The two transports run as a training step runs them: ``mix_stacked``
    on a pytree whose leaves have the per-node widths ``leaf_sizes``
    (None: one leaf of ``p``), scaled to the timed width, then the next
    step's local update ``p - lr g`` on its output. On the card that is
    the ravel copy and one ``gossip_schedule`` launch, whose output
    leaves the update reads strided (views of the padded buffer),
    against one ``gossip_mix`` launch a leaf; both are warmed up first, then
    each is timed as the median of 30 calls with CUDA events. On the CPU
    the plain per-leaf paths are timed on the host clock (``iters`` and
    ``repeats``). The width is capped so the buffer stays at most
    ``_MEASURE_MAX_ELEMENTS``; the record keeps the requested ``p`` and
    the ``p_measured`` timed, the reference's fields, the leaf widths,
    and the card's name and power limit. Raises inside a CUDA graph
    capture.
    """
    device = resolve_device(device)
    leaf_sizes = tuple(leaf_sizes) if leaf_sizes else (p,)
    if device.type == "cuda":
        from repro_torch.graphs import device_work

        with device_work():  # raises inside a capture
            us, record = _measure(n_nodes, n_atoms, p, leaf_sizes, seed, device, iters, repeats)
        card, limit = _card(device)
        timing = f"median of {_TIMED_LAUNCHES} calls, CUDA events"
    else:
        us, record = _measure(n_nodes, n_atoms, p, leaf_sizes, seed, device, iters, repeats)
        card, limit = None, None
        timing = f"min over {repeats} of {iters}-call averages, host clock"
    record.update({
        "schedule_us": us["schedule"],
        "dense_us": us["dense"],
        "winner": "schedule" if us["schedule"] <= us["dense"] else "dense",
        "backend": device.type,
        "hw": _hw_tag(device),
        "card": card,
        "power_limit": limit,
        "timing": timing,
    })
    return record


def autotune_transport(
    n_nodes: int,
    n_atoms: int,
    p: int,
    *,
    measure: bool = False,
    path: str | None = None,
    dense_speedup: float = DENSE_THROUGHPUT_ADVANTAGE,
    device: torch.device | str | None = None,
    leaf_sizes: Sequence[int] | None = None,
) -> str:
    """``"schedule"`` or ``"dense"`` from the measured table.

    Looks up the power-of-two bucket of ``(n_nodes, n_atoms, p)`` on
    ``device``'s hardware (None = CUDA) in ``transport_autotune_path()``.
    On a hit, returns the measured winner. On a miss: with
    ``measure=True`` times both transports at ``n_nodes`` and
    ``n_atoms`` and the bucket-rounded ``p`` on a pytree of
    ``leaf_sizes`` (per-node leaf widths summing to ``p``; None: one
    leaf), memoizes the record under the bucket and returns its winner;
    otherwise falls back to the closed-form :func:`preferred_transport`.
    """
    device = resolve_device(device)
    path = path or transport_autotune_path()
    key = _bucket_key(n_nodes, n_atoms, p, device)
    table = _load_autotune(path)
    entry = table.get(key)
    if entry is not None and entry.get("winner") in ("schedule", "dense"):
        return entry["winner"]
    if not measure:
        return preferred_transport(n_nodes, n_atoms, dense_speedup)
    entry = measure_transport(n_nodes, n_atoms, _pow2_up(p), leaf_sizes=leaf_sizes,
                              device=device)
    table = dict(table)
    table[key] = entry
    _persist_autotune(path, table)
    return entry["winner"]


def select_transport(
    transport: str,
    params_stack: PyTree,
    W,
    schedule: "BirkhoffSchedule | None",
    dense_speedup: float = DENSE_THROUGHPUT_ADVANTAGE,
) -> str:
    """What ``"auto"`` / ``"autotune"`` resolve to for a static schedule:
    ``"dense"`` without a schedule, ``"schedule"`` without a W (a stored
    ``"dense"`` never wins there: densifying per call is a cost the
    measurement leaves out), else the table's winner on the
    communication atoms (``autotune`` measuring on a miss), or the closed
    form. ``"dense"`` and ``"schedule"`` pass through."""
    if transport not in ("auto", "autotune"):
        return transport
    if schedule is None:
        return "dense"
    if W is None:
        return "schedule"
    leaves = tree_leaves(params_stack)
    sizes = [int(np.prod(leaf.shape[1:], dtype=np.int64)) if leaf.ndim > 1 else 1
             for leaf in leaves]
    return autotune_transport(
        schedule.n_nodes, schedule.n_communication_atoms, sum(sizes),
        measure=transport == "autotune", dense_speedup=dense_speedup,
        device=leaves[0].device, leaf_sizes=sizes,
    )


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

def _as_matrix(W, like: torch.Tensor) -> torch.Tensor:
    if isinstance(W, torch.Tensor):
        return W
    return torch.as_tensor(np.asarray(W), dtype=torch.float32, device=like.device)


def mix_dense(params_stack: PyTree, W, use_kernel: bool = False) -> PyTree:
    """Dense mixing over a leading node axis: ``out[i] = sum_j W[i,j] x[j]``.

    Args:
      params_stack: tensor or dict of tensors with leading axis n.
      W: (n, n) mixing matrix (tensor on the leaves' device, or a host
        array, copied per call -- pass a tensor on hot paths).
      use_kernel: on the CPU, the kernel's numerics (``gossip_mix``'s
        plain version: float32 sum, W cast to the leaf dtype) instead of
        a product in the leaf dtype. On a CUDA tensor every leaf goes
        through the ``gossip_mix`` kernel either way.
    """
    Wt = _as_matrix(W, tree_leaves(params_stack)[0])
    if use_kernel or _on_cuda(params_stack):
        def mix_leaf(x):
            n = x.shape[0]
            out = gossip_ops.gossip_mix(x.reshape(n, -1).contiguous(), Wt)
            return out.reshape(x.shape)

        return tree_map(mix_leaf, params_stack)

    def mix_leaf(x):
        return torch.tensordot(Wt.to(x.dtype), x, dims=([1], [0]))

    return tree_map(mix_leaf, params_stack)


def _mix_schedule_flat(flat: torch.Tensor, schedule: BirkhoffSchedule) -> torch.Tensor:
    """``out = sum_l gamma_l flat[perm_l]`` on one (n, P) buffer, with the
    identity atoms folded into one scale (the reference's XLA path,
    ``mixing.py:2088``)."""
    if flat.shape[0] != schedule.n_nodes:
        raise ValueError(
            f"schedule is for {schedule.n_nodes} nodes but the stacked "
            f"parameters have leading axis {flat.shape[0]}"
        )
    ident_w = schedule.identity_weight()
    acc = None
    if ident_w != 0.0:
        acc = torch.tensor(ident_w, dtype=flat.dtype) * flat
    for gamma, perm in schedule.communication_atoms():
        idx = torch.as_tensor(perm, dtype=torch.long, device=flat.device)
        contrib = torch.tensor(gamma, dtype=flat.dtype) * flat[idx]
        acc = contrib if acc is None else acc + contrib
    return flat if acc is None else acc


def mix_schedule_stacked(
    params_stack: PyTree,
    schedule: BirkhoffSchedule,
    *,
    single_buffer: bool = False,
    use_kernel: bool = False,
) -> PyTree:
    """Sparse Birkhoff mixing on stacked parameters: L gathers + AXPYs.

    ``out = sum_l gamma_l theta[perm_l]`` -- cost ``O(L n P)`` versus the
    dense transport's ``O(n^2 P)``; after ``l`` Frank-Wolfe iterations
    ``L <= l + 1`` (Theorem 2).

    On a CUDA tensor, or with ``use_kernel``, the pytree is raveled into
    one (n, P) buffer (rows padded to ``KERNEL_ROW_ALIGN``) and mixed in
    ONE ``gossip_schedule`` call.
    Otherwise the CPU runs the reference's identity-folded gathers, per
    leaf or, with ``single_buffer``, on one raveled buffer.
    """
    if use_kernel or _on_cuda(params_stack):
        device = tree_leaves(params_stack)[0].device
        return _mix_kernel_form(params_stack, *schedule.operands(device))
    if single_buffer:
        flat, spec = ravel_stack(params_stack)
        return unravel_stack(_mix_schedule_flat(flat, schedule), spec)
    return tree_map(
        lambda x: _mix_schedule_flat(x.reshape(x.shape[0], -1), schedule).reshape(x.shape),
        params_stack,
    )


def mix_stacked(
    params_stack: PyTree,
    W=None,
    schedule: BirkhoffSchedule | ScheduleArrays | None = None,
    *,
    transport: str = "auto",
    use_kernel: bool = False,
    single_buffer: bool = False,
    dense_speedup: float = DENSE_THROUGHPUT_ADVANTAGE,
) -> PyTree:
    """Unified stacked-mixing entry point with automatic transport choice.

    ``schedule`` may be a static :class:`BirkhoffSchedule` or a
    :class:`ScheduleArrays`. The data format always executes on the
    arrays transport (a W passed beside it would go stale at the first
    schedule swap), so ``transport="dense"`` is refused for it.

    ``transport``:
      * ``"auto"``     -- the measured table's winner for this (n, L, P)
                          bucket on this hardware when a measurement
                          exists (``autotune_transport``; lookup only),
                          else the ``preferred_transport`` closed form on
                          the communication atoms, when both a schedule
                          and a W are usable -- else whichever is
                          available. ``dense_speedup`` tunes the closed
                          form's crossover.
      * ``"autotune"`` -- like ``"auto"``, but on a table miss time both
                          transports once at this bucket and memoize the
                          record to ``transport_autotune_path()``. Not
                          inside a CUDA graph capture: the trainers resolve
                          it before any (``train/trainer.py``).
      * ``"dense"``    -- the dense path (W required, or densified from
                          the schedule per call).
      * ``"schedule"`` -- the Birkhoff gather path (schedule required).
    """
    if transport not in ("auto", "autotune", "dense", "schedule"):
        raise ValueError(f"unknown transport {transport!r}")
    if isinstance(schedule, ScheduleArrays):
        if transport == "dense":
            raise ValueError(
                "transport='dense' cannot execute a ScheduleArrays (it would "
                "mix with a static W that a schedule swap never updates); convert "
                "with arrays_to_matrix host-side if you really want dense"
            )
        return mix_schedule_arrays(
            params_stack, schedule,
            single_buffer=single_buffer, use_kernel=use_kernel,
        )
    transport = select_transport(transport, params_stack, W, schedule, dense_speedup)
    if transport == "schedule":
        if schedule is None:
            raise ValueError("transport='schedule' requires a BirkhoffSchedule")
        return mix_schedule_stacked(
            params_stack, schedule, single_buffer=single_buffer, use_kernel=use_kernel
        )
    if W is None:
        if schedule is None:
            raise ValueError("mix_stacked needs W or schedule")
        W = schedule.to_matrix()
    return mix_dense(params_stack, W, use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# Degraded mixing: fault repair on the data-plane schedule
# ---------------------------------------------------------------------------
#
# A crash or a dropped gossip edge breaks some transfers of a Birkhoff
# atom. The repair works at the permutation level (the reference's
# ``mixing.py:430-529``): every cycle of an atom that contains a broken
# transfer collapses to fixed points, so each repaired atom is still a
# permutation and W' = sum_l gammas[l] P'_l stays exactly doubly
# stochastic with the coefficients unchanged. A dead node is a fixed
# point of every atom: its row and column of W' are e_i. The repair
# rewrites only the values of ``perms`` (same shapes), so a degraded
# schedule swaps into a running graph by ``copy_``.


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _repair_perm(perm: np.ndarray, broken: np.ndarray) -> np.ndarray:
    """Collapse every cycle of ``perm`` containing a broken position.

    ``broken[i]`` marks the transfer into position ``i`` (the edge
    ``perm[i] -> i``) as undeliverable.
    """
    n = perm.shape[0]
    out = perm.copy()
    visited = np.zeros(n, bool)
    for start in range(n):
        if visited[start]:
            continue
        cycle = []
        i = start
        bad = False
        while not visited[i]:
            visited[i] = True
            cycle.append(i)
            bad = bad or bool(broken[i])
            i = perm[i]
        if bad:
            idx = np.asarray(cycle)
            out[idx] = idx
    return out


def degrade_schedule(
    arrays: ScheduleArrays,
    alive_mask: np.ndarray,
    dropped_edges=(),
) -> ScheduleArrays:
    """Repair a data-plane schedule on the surviving nodes/edges.

    Args:
      arrays: the fault-free schedule (``W = sum_l gammas[l] P_l``).
      alive_mask: (n,) bool; ``False`` marks a crashed node.
      dropped_edges: iterable of ``(src, dst)`` pairs (or an (m, 2)
        array): node ``dst`` fails to receive node ``src``'s parameters
        this step.

    Returns a ``ScheduleArrays`` with the same gammas and shapes whose
    atoms are repaired permutations, on the device of ``arrays``. Host
    numpy: faults are control-plane events, like topology refreshes.
    """
    perms = _host(arrays.perms)
    l_max, n = perms.shape
    alive = np.asarray(alive_mask, dtype=bool).reshape(n)
    drop = np.zeros((n, n), dtype=bool)
    edges = np.asarray(list(dropped_edges) if not isinstance(dropped_edges, np.ndarray) else dropped_edges)
    if edges.size:
        edges = edges.reshape(-1, 2).astype(np.int64)
        if edges.min() < 0 or edges.max() >= n:
            raise ValueError(f"dropped edge index out of range for n={n}")
        drop[edges[:, 0], edges[:, 1]] = True
    rows = np.arange(n)
    out = perms.copy()
    for l in range(l_max):
        p = perms[l]
        nonself = p != rows
        broken = nonself & (~alive | ~alive[p] | drop[p, rows])
        if broken.any():
            out[l] = _repair_perm(p, broken)
    device = arrays.perms.device if isinstance(arrays.perms, torch.Tensor) else "cpu"
    return ScheduleArrays(
        gammas=torch.as_tensor(_host(arrays.gammas), device=device),
        perms=torch.as_tensor(out.astype(np.int32), device=device),
    )


# ---------------------------------------------------------------------------
# Stale-theta mixing: bounded-delay stragglers through a ring buffer
# ---------------------------------------------------------------------------
#
# Node j's parameters reach the mixing step tau_j^t <= tau_max steps late:
# ``theta_i <- sum_j W_ij theta_j^{t + 1/2 - tau_j^t}`` (source-indexed
# delay). The ring keeps the last ``depth = tau_max + 1`` half-step
# states. In the port the ring is a static tensor of the captured body:
# ``stale_push`` writes into it in place, and its head is an int64
# tensor on the ring's device, advanced and read on the device, so a
# replayed graph pushes into and reads the slots of the step it replays.
# With all delays 0 the view is the state just pushed, gathered bit for
# bit, and it mixes through the same transport as fresh mixing: the
# zero-delay trajectory is the fresh one, bitwise.


class StaleBuffer(NamedTuple):
    """Ring buffer of the last ``depth`` (n, P) half-step states.

    ``head`` (a () int64 tensor on ``buf``'s device) indexes the most
    recent push; slot ``(head - d) % depth`` holds the state from ``d``
    pushes ago.
    """

    buf: torch.Tensor  # (depth, n, P)
    head: torch.Tensor  # () int64

    @property
    def depth(self) -> int:
        return self.buf.shape[0]


def stale_buffer_init(flat: torch.Tensor, depth: int) -> StaleBuffer:
    """Fill all ``depth`` slots with ``flat`` (so a delay larger than the
    number of pushes so far reads the initial state, never garbage)."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1 (tau_max + 1), got {depth}")
    if flat.ndim != 2:
        raise ValueError(f"flat must be (n, P), got shape {tuple(flat.shape)}")
    buf = flat.unsqueeze(0).repeat(depth, 1, 1)
    return StaleBuffer(buf=buf, head=torch.zeros((), dtype=torch.long, device=flat.device))


def stale_push(buffer: StaleBuffer, flat: torch.Tensor) -> StaleBuffer:
    """Advance the ring and write ``flat`` into the new head slot, in
    place (the reference returns a new buffer; here the ring is the
    static tensor a captured body keeps). Returns ``buffer``."""
    buffer.head.add_(1).remainder_(buffer.depth)
    buffer.buf.index_copy_(0, buffer.head.reshape(1), flat.unsqueeze(0).to(buffer.buf.dtype))
    return buffer


def stale_view(buffer: StaleBuffer, delays: torch.Tensor) -> torch.Tensor:
    """Per-source delayed read: row ``j`` is node ``j``'s state from
    ``delays[j]`` pushes ago (``delays`` (n,) int, values in [0, depth);
    larger values alias modulo the ring depth)."""
    n = buffer.buf.shape[1]
    slot = torch.remainder(buffer.head - delays.long(), buffer.depth)
    return buffer.buf[slot, torch.arange(n, device=buffer.buf.device)]


def _mix_flat(flat: torch.Tensor, arrays: ScheduleArrays, use_kernel: bool = False) -> torch.Tensor:
    """One (n, P) buffer through the schedule transport: the
    ``gossip_schedule`` kernel on a CUDA tensor (or its plain version with
    ``use_kernel``), else the reference's XLA-path sum."""
    if use_kernel or flat.is_cuda:
        return gossip_ops.gossip_schedule(flat.contiguous(), arrays.gammas, arrays.perms)
    return _mix_arrays_flat(flat, arrays)


def mix_schedule_arrays_stale(
    buffer: StaleBuffer,
    arrays: ScheduleArrays,
    delays: torch.Tensor,
    corrupt: "WireCorruption | None" = None,
    *,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Bounded-delay data-plane mixing on the flat (n, P) convention.

    ``out = sum_l gammas[l] theta_stale[perms[l]]`` where
    ``theta_stale`` is the delayed view of the ring. The view is gathered
    and then mixed exactly as fresh mixing mixes (one ``gossip_schedule``
    launch on the card), so zero delays reproduce it bitwise.
    ``corrupt`` poisons each sender's delivered payload at the wire
    (self-loops stay clean); None is the untouched transport.
    """
    view = stale_view(buffer, delays)
    if corrupt is not None:
        return _mix_arrays_flat_corrupt(view, arrays, corrupt)
    return _mix_flat(view, arrays, use_kernel)


# ---------------------------------------------------------------------------
# Straggler policy: wait vs deadline-based graceful degradation
# ---------------------------------------------------------------------------
#
# The ring implements the mechanism of bounded-delay mixing; the policy
# decides per node per step what a delay means. Under ``wait`` every
# late payload is consumed at its staleness, clamped to ``tau_max``.
# Under ``degrade`` a delay past the deadline is an outage for the step:
# the schedule is repaired on the on-time support (the cycle collapse of
# ``degrade_schedule``, W exactly doubly stochastic) and the late node
# keeps its own parameters. Both are host-side decisions; what reaches
# the captured body is a repaired schedule and an effective int32 delay
# vector per step, copied into its static input tensors.


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Deadline policy for bounded-delay gossip (frozen/hashable).

    Attributes:
      mode: ``"wait"`` consumes every payload at its staleness, clamped
        to ``tau_max``; ``"degrade"`` treats any delay past ``tau_max`` as
        an offline node for that step and repairs the schedule on the
        on-time support.
      tau_max: the staleness deadline. The ring consuming this policy
        has ``depth == ring_depth == tau_max + 1``.
    """

    mode: str = "wait"
    tau_max: int = 1

    def __post_init__(self):
        if self.mode not in ("wait", "degrade"):
            raise ValueError(
                f"StragglerPolicy mode must be 'wait' or 'degrade', "
                f"got {self.mode!r}"
            )
        if self.tau_max < 0:
            raise ValueError(f"tau_max must be >= 0, got {self.tau_max}")

    @property
    def ring_depth(self) -> int:
        return self.tau_max + 1

    def apply(
        self,
        arrays: ScheduleArrays,
        delays,
        alive_mask=None,
        dropped_edges=(),
    ) -> tuple[ScheduleArrays, np.ndarray]:
        """Resolve one step's raw delay vector against the deadline.

        Returns ``(arrays', eff_delays)``: the (possibly repaired)
        schedule to mix with and the effective (n,) int32 delay vector to
        read the ring at. ``alive_mask`` / ``dropped_edges`` fold crash
        faults into the same single repair; offline nodes always get
        effective delay 0.
        """
        delays = np.asarray(delays, np.int64).reshape(-1)
        n = delays.shape[0]
        if arrays.n_nodes != n:
            raise ValueError(
                f"delays are for {n} nodes, schedule for {arrays.n_nodes}"
            )
        if delays.min() < 0:
            raise ValueError("delays must be non-negative")
        alive = (
            np.ones(n, bool)
            if alive_mask is None
            else np.asarray(alive_mask, bool).reshape(n)
        )
        if self.mode == "wait":
            eff = np.minimum(delays, self.tau_max)
            mask = alive
        else:
            late = delays > self.tau_max
            eff = np.where(late, 0, delays)
            mask = alive & ~late
        eff = np.where(alive, eff, 0).astype(np.int32)
        edges = np.asarray(
            dropped_edges
            if isinstance(dropped_edges, np.ndarray)
            else list(dropped_edges)
        )
        if not mask.all() or edges.size:
            arrays = degrade_schedule(arrays, mask, edges)
        return arrays, eff


def straggler_stream(
    policy: StragglerPolicy,
    arrays: ScheduleArrays,
    delays,
    alive=None,
    edges_at=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resolve a (T, n) raw delay trace into stacked per-step inputs.

    Returns ``(gammas (T, l_max) float32, perms (T, l_max, n) int32, eff
    (T, n) int32)`` on the CPU: one schedule value and one delay vector
    per step, what a stale rollout body reads. ``alive`` is an optional
    (T, n) bool mask and ``edges_at(t)`` an optional per-step dropped-edge
    callback, both folded into each step's single repair.
    """
    delays = np.asarray(delays, np.int64)
    if delays.ndim != 2:
        raise ValueError(f"delays must be (T, n), got shape {delays.shape}")
    T = delays.shape[0]
    g_rows, p_rows, d_rows = [], [], []
    for t in range(T):
        a_t = None if alive is None else np.asarray(alive)[t]
        e_t = () if edges_at is None else edges_at(t)
        sa, eff = policy.apply(
            arrays, delays[t], alive_mask=a_t, dropped_edges=e_t
        )
        g_rows.append(_host(sa.gammas).astype(np.float32))
        p_rows.append(_host(sa.perms).astype(np.int32))
        d_rows.append(eff)
    l_max, n = arrays.perms.shape
    return (
        torch.as_tensor(np.stack(g_rows) if T else np.zeros((0, l_max), np.float32)),
        torch.as_tensor(np.stack(p_rows) if T else np.zeros((0, l_max, n), np.int32)),
        torch.as_tensor(np.stack(d_rows) if T else np.zeros((0, n), np.int32)),
    )


# ---------------------------------------------------------------------------
# Wire corruption and receiver-side screening
# ---------------------------------------------------------------------------
#
# Nodes that lie: corruption applies to the sent payload at the wire --
# a per-sender multiplicative factor (nan / -1 / scale k) and a
# per-sender XOR mask on the float32 bit pattern (bitflip) -- and never
# to the sender's own state: self-loops move no bytes. Both planes are
# (n,) vectors, inputs of the captured body like the delays. The only
# in-graph defense is the non-finite guard (a non-finite payload is
# replaced by the receiver's own); the norm and deviation screens come
# back as per-edge statistics (``ScreenStats``) for the host-side
# quarantine controller (``faults/quarantine.py``).
#
# On the card these mixes run in ``gossip_schedule`` too: the clean
# rows, the wire and (guarded) the receivers' own payloads are stacked
# into one source buffer, and each (atom, receiver) entry picks its row
# of it -- the self-loop, the sender's wire row or the receiver's own --
# so every mix adds the same values in the same order as the clean
# transport, and with nothing corrupt it is the clean mix bit for bit.


class WireCorruption(NamedTuple):
    """Per-sender wire corruption for one mixing step.

    ``mult`` (n,) float32 multiplies the sender's outgoing payload (1.0 =
    honest, ``nan`` poisons, ``-1`` sign-flips, ``k`` rescales); ``xor``
    (n,) int32 is XOR-ed into the float32 bit pattern afterwards (0 =
    honest). Senders with ``mult == 1 and xor == 0`` are delivered
    bitwise verbatim.
    """

    mult: torch.Tensor  # (n,) float32
    xor: torch.Tensor  # (n,) int32


def corrupt_wire(wire: torch.Tensor, corrupt: WireCorruption) -> torch.Tensor:
    """Apply per-sender corruption to an (n, P) float32 wire buffer:
    honest rows are selected untouched, corrupt rows are
    ``bits(bits(x * mult) ^ xor)`` (a reinterpretation of the float32
    bits as int32, not a cast)."""
    if wire.dtype != torch.float32:
        raise ValueError(
            f"corrupt_wire needs a float32 wire payload, got {wire.dtype}"
        )
    bcast = (wire.shape[0],) + (1,) * (wire.ndim - 1)
    mult = corrupt.mult.to(torch.float32).reshape(bcast)
    xor = corrupt.xor.to(torch.int32).reshape(bcast)
    bent = ((wire * mult).view(torch.int32) ^ xor).view(torch.float32)
    # nan != 1.0 is True, so the nan mode lands in the corrupt branch
    dirty = (mult != 1.0) | (xor != 0)
    return torch.where(dirty, bent, wire)


def _stacked_mix(sources: list[torch.Tensor], pick: torch.Tensor,
                 gammas: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_l gammas[l] src[pick[l, i]]`` with ``src`` the
    row-wise concatenation of ``sources`` (each (n, P)): one
    ``gossip_schedule`` call on the stacked buffer, whose extra rows
    gather themselves and are dropped."""
    n = sources[0].shape[0]
    src = torch.cat(sources).contiguous()
    rest = torch.arange(n, src.shape[0], device=src.device, dtype=pick.dtype)
    table = torch.cat([pick, rest.expand(pick.shape[0], -1)], dim=1).to(torch.int32)
    return gossip_ops.gossip_schedule(src, gammas, table)[:n]


def _mix_arrays_flat_corrupt(
    flat: torch.Tensor, arrays: ScheduleArrays, corrupt: WireCorruption
) -> torch.Tensor:
    """The schedule mix with the non-self contributions routed through
    the corrupted wire (a corrupt node's contribution to itself stays
    clean)."""
    if flat.shape[0] != arrays.n_nodes:
        raise ValueError(
            f"schedule arrays are for {arrays.n_nodes} nodes but the stacked "
            f"parameters have leading axis {flat.shape[0]}"
        )
    shape = flat.shape
    flat2 = flat.reshape(shape[0], -1)
    n = shape[0]
    wire = corrupt_wire(flat2, corrupt)
    perms = arrays.perms.long()
    rows = torch.arange(n, device=flat.device)
    pick = torch.where(perms == rows, rows, perms + n)
    return _stacked_mix([flat2, wire], pick, arrays.gammas).reshape(shape)


class ScreenStats(NamedTuple):
    """Per-edge screening statistics from one screened mixing step.

    For atom ``l`` and receiver ``i`` the sender is ``perms[l, i]``;
    entries with ``perms[l, i] == i`` are self-loops (no wire payload;
    the host-side screen skips them).
    """

    sq_own: torch.Tensor  # (n,)        ||own payload||^2 per receiver
    sq_recv: torch.Tensor  # (l_max, n)  ||received payload||^2 per edge
    dot: torch.Tensor  # (l_max, n)  <received, own> per edge
    finite: torch.Tensor  # (l_max, n)  all-finite flag per edge


def mix_schedule_arrays_screened(
    buffer: StaleBuffer,
    arrays: ScheduleArrays,
    delays: torch.Tensor,
    own: torch.Tensor,
    corrupt: WireCorruption | None = None,
    *,
    guard: bool = True,
) -> tuple[torch.Tensor, ScreenStats]:
    """Screened bounded-delay mixing: corrupted wire in, stats out.

    Non-self contributions come off the (optionally corrupted) wire, and
    every edge emits its norm, inner-product and finiteness statistics
    for the host-side screen. ``own`` is the receiver's reference
    payload, its fresh half-step. ``guard=True`` substitutes the
    receiver's own payload for any non-finite contribution; with
    ``guard=False`` the poison propagates (the screen-off baseline). With
    no corruption and all-finite payloads the mixed output is
    :func:`mix_schedule_arrays_stale`'s, bitwise.
    """
    view = stale_view(buffer, delays)
    wire = view if corrupt is None else corrupt_wire(view, corrupt)
    n = view.shape[0]
    rows = torch.arange(n, device=view.device)
    perms = arrays.perms.long()
    self_loop = perms == rows
    pick = torch.where(self_loop, rows, perms + n)  # into [view; wire]
    recv = torch.cat([view, wire])[pick]  # (l_max, n, P)
    finite = torch.isfinite(recv).all(dim=2)
    sq_recv = torch.sum(recv * recv, dim=2)
    dot = torch.sum(recv * own, dim=2)
    sq_own = torch.sum(own * own, dim=1)
    sources = [view, wire]
    if guard:
        pick = torch.where(finite, pick, rows + 2 * n)  # the receiver's own row
        sources.append(own)
    mixed = _stacked_mix(sources, pick, arrays.gammas)
    return mixed, ScreenStats(sq_own=sq_own, sq_recv=sq_recv, dot=dot, finite=finite)


# ---------------------------------------------------------------------------
# Pool-coordinate straggler repair (host numpy)
# ---------------------------------------------------------------------------

def degrade_pool_gammas(pool: "PermPool", gammas, offline_mask) -> np.ndarray:
    """Repair pool-coordinate mixing when some nodes are offline or late.

    The pool transport cannot rewrite its staged permutation slots, so
    every non-identity slot that moves data to or from an offline node is
    zeroed and its coefficient mass ADDED to an identity slot (never
    renormalized): the result is still an exact convex combination of
    permutations in which every offline node is a fixed point of every
    surviving atom. Host-side numpy; the (capacity,) float32 result is a
    pure gamma value change.
    """
    g = np.asarray(_host(gammas), np.float64).copy()
    if g.shape != (pool.capacity,):
        raise ValueError(f"gammas must be ({pool.capacity},), got {g.shape}")
    off = np.asarray(offline_mask, bool).reshape(pool.n_nodes)
    if not off.any():
        return g.astype(np.float32)
    ident = pool.identity
    moved = 0.0
    for l, p in enumerate(pool.perms):
        if p == ident:
            continue
        if any(p[i] != i and (off[i] or off[p[i]]) for i in range(pool.n_nodes)):
            moved += g[l]
            g[l] = 0.0
    # a pool whose staged atoms all survive repairs to itself; otherwise the
    # moved mass lands on the identity slot, so a node whose every neighbour
    # slot was zeroed keeps exactly its own row
    if moved != 0.0:
        try:
            id_slot = pool.perms.index(ident)
        except ValueError:
            raise ValueError(
                "degrade_pool_gammas needs an identity slot to absorb the "
                "dropped mass; stage the pool with headroom "
                "(PermPool.from_schedule pads with identities)"
            ) from None
        g[id_slot] += moved
    return g.astype(np.float32)


def straggler_pool_stream(
    policy: StragglerPolicy, gammas, pool: "PermPool", delays
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pool transport's :func:`straggler_stream`: a (T, n) raw delay
    trace as per-step pool coordinates, ``(gammas (T, capacity) float32,
    eff (T, n) int32)`` on the CPU. Under ``"wait"`` every step keeps the
    base gammas and clamps delays to the deadline; under ``"degrade"``
    past-deadline nodes are repaired out by :func:`degrade_pool_gammas`
    (their effective delay drops to 0)."""
    d = np.asarray(delays, np.int64)
    if d.ndim != 2:
        raise ValueError(f"delays must be (T, n), got shape {d.shape}")
    if d.shape[1] != pool.n_nodes:
        raise ValueError(f"delays are for {d.shape[1]} nodes, pool for {pool.n_nodes}")
    if d.size and d.min() < 0:
        raise ValueError("delays must be non-negative")
    base = np.asarray(_host(gammas), np.float32).reshape(pool.capacity)
    T = d.shape[0]
    g_out = np.empty((T, pool.capacity), np.float32)
    e_out = np.empty(d.shape, np.int32)
    for t in range(T):
        if policy.mode == "wait":
            g_out[t] = base
            e_out[t] = np.minimum(d[t], policy.tau_max)
        else:
            late = d[t] > policy.tau_max
            e_out[t] = np.where(late, 0, d[t])
            g_out[t] = degrade_pool_gammas(pool, base, late) if late.any() else base
    return torch.as_tensor(g_out), torch.as_tensor(e_out)


# ---------------------------------------------------------------------------
# One node per rank: the collective layer
# ---------------------------------------------------------------------------
#
# The reference's mesh transports run inside ``shard_map`` over a node axis
# and mix with ``jax.lax`` collectives. Here each rank of a
# ``torch.distributed`` process group holds one node's parameters (a tensor
# or a dict of tensors, no node axis): the rank in the group is the node
# index, the group's size is n. ``group=None`` is the default (world)
# group. The helpers below stand in for ``lax.axis_index``,
# ``lax.all_gather``, ``lax.ppermute`` and ``lax.pmean``; the backend is
# the group's own (NCCL on cards, gloo on the CPU) and nothing here picks
# another on failure: gloo, which moves CUDA tensors only for
# ``all_reduce`` and ``broadcast``, is refused a CUDA all-gather or
# ppermute.
#
# ``collective_bytes`` counts the bytes this rank receives, per collective,
# as the calls are issued: the all-gather ``(n - 1) x`` the payload, a
# ppermute its one payload (a fixed point is a local copy and moves
# nothing), an all-reduce the ring model ``2 (n - 1) / n x`` the payload
# (the bytes a backend moves inside an all-reduce are not observable
# here). ``collective_calls`` counts the calls. The mesh trainer's own
# collectives count under their own names: tensor parallelism's
# (``train/tensor_parallel.py``: ``tp_all_reduce``, ``tp_all_gather``), the
# gathers of weights at rest (``fsdp_all_gather``) and the gradients'
# mean over a mesh dimension (``grad_all_reduce``). A captured graph's
# replays add its capture's counts (``graphs.GraphRunner``).

collective_bytes = {"all_gather": 0, "ppermute": 0, "all_reduce": 0, "tp_all_reduce": 0,
                    "tp_all_gather": 0, "fsdp_all_gather": 0, "grad_all_reduce": 0}
collective_calls = dict.fromkeys(collective_bytes, 0)


def reset_collective_bytes() -> None:
    """Zero ``collective_bytes`` and ``collective_calls``."""
    for name in collective_bytes:
        collective_bytes[name] = 0
        collective_calls[name] = 0


def _dist():
    import torch.distributed as dist

    return dist


def axis_index(group=None) -> int:
    """This rank's node index: its rank in ``group``."""
    return _dist().get_rank(group)


def axis_size(group=None) -> int:
    """The number of nodes: ``group``'s size."""
    return _dist().get_world_size(group)


def group_backend(group=None) -> str:
    """The backend ``group`` runs on (``"nccl"``, ``"gloo"``)."""
    return str(_dist().get_backend(group))


def _peer(group, r: int) -> int:
    """The global rank of ``group``'s rank ``r`` (what a ``P2POp`` takes)."""
    dist = _dist()
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _check_moves(x: torch.Tensor, group, what: str) -> None:
    if x.is_cuda and group_backend(group) == "gloo":
        raise RuntimeError(
            f"{what} of a CUDA tensor over a gloo group: gloo moves CUDA tensors only for "
            "all_reduce and broadcast; run the ranks' group on the nccl backend")


def _all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_gather``: every rank's ``x`` stacked on a new leading
    axis, ``(n, *x.shape)``, in ``x``'s dtype."""
    _check_moves(x, group, "an all-gather")
    dist = _dist()
    n = axis_size(group)
    flat = x.contiguous().reshape(-1)
    out = torch.empty((n * flat.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    collective_bytes["all_gather"] += (n - 1) * flat.numel() * flat.element_size()
    collective_calls["all_gather"] += 1
    return out.view((n,) + tuple(x.shape))


def _gather_first(x: torch.Tensor, group=None) -> torch.Tensor | None:
    """Every rank's ``x`` stacked on a new leading axis, ``(n,
    *x.shape)`` in ``x``'s dtype, on the group's first rank only (None on
    the others, which hold no copy)."""
    _check_moves(x, group, "a gather")
    dist = _dist()
    x = x.contiguous()
    if axis_index(group) != 0:
        dist.gather(x, None, dst=_peer(group, 0), group=group)
        return None
    out = torch.empty((axis_size(group),) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.gather(x, list(out.unbind(0)), dst=_peer(group, 0), group=group)
    return out


def _ppermute(x: torch.Tensor, pairs, group=None) -> torch.Tensor:
    """``lax.ppermute``: ``pairs`` are ``(source, destination)`` node
    indices; this rank returns what its source sent (zeros without one).
    One ``batch_isend_irecv``; a fixed point ``(i, i)`` is a local copy."""
    dist = _dist()
    i = axis_index(group)
    src = [s for s, d in pairs if d == i]
    dst = [d for s, d in pairs if s == i]
    if src and src[0] == i:
        return x.clone()
    _check_moves(x, group, "a ppermute")
    x = x.contiguous()
    ops = []
    if dst and dst[0] != i:
        ops.append(dist.P2POp(dist.isend, x, _peer(group, dst[0]), group))
    out = torch.empty_like(x) if src else torch.zeros_like(x)
    if src:
        ops.append(dist.P2POp(dist.irecv, out, _peer(group, src[0]), group))
        collective_bytes["ppermute"] += x.numel() * x.element_size()
        collective_calls["ppermute"] += 1
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmean`` in float32: the sum over ranks, divided by n."""
    n = axis_size(group)
    y = x.to(torch.float32, copy=True)
    _dist().all_reduce(y, group=group)
    collective_bytes["all_reduce"] += 2 * (n - 1) * y.numel() * y.element_size() // n
    collective_calls["all_reduce"] += 1
    return y / n


def _psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum`` in float32 (a scalar's: no bytes counted)."""
    y = x.to(torch.float32, copy=True)
    _dist().all_reduce(y, group=group)
    collective_calls["all_reduce"] += 1
    return y


def _corrupt_own(x32: torch.Tensor, corrupt: WireCorruption, i: int) -> torch.Tensor:
    """Node ``i`` corrupts its OWN outgoing payload (``corrupt_wire`` on
    one row): honest nodes send ``x32`` untouched."""
    m = corrupt.mult.to(device=x32.device, dtype=torch.float32)[i]
    b = corrupt.xor.to(device=x32.device, dtype=torch.int32)[i]
    bent = ((x32 * m).view(torch.int32) ^ b).view(torch.float32)
    return torch.where((m != 1.0) | (b != 0), bent, x32)


def _check_nodes(n: int, group, what: str) -> None:
    if n != axis_size(group):
        raise ValueError(f"{what} is for {n} nodes, the group has {axis_size(group)} ranks")


# ---------------------------------------------------------------------------
# One node per rank: the transports
# ---------------------------------------------------------------------------
#
# Every sum runs in float32 and rounds once to the leaf's dtype. The
# reference casts each payload to float32 before it moves; here a payload
# moves in the dtype that holds it exactly -- the leaf's (bfloat16 leaves:
# half the bytes), or the ring's -- and lands as the same float32 values,
# so the results are the same; a corrupted payload moves as the float32
# whose bits were bent. The gather transports gather one leaf at a time and drop
# its ``(n, P_leaf)`` gather before the next leaf's: at most one is live,
# eagerly and under a CUDA-graph capture (whose pool reuses the freed
# block), so the peak is ``n x`` the largest leaf, not ``n x P``.
# ``mix_arrays_sharded`` and ``mix_ppermute_pool`` accumulate slot for slot
# in the same operations (zeros, then ``acc + gamma_l * contrib``), so the
# two agree bitwise on one schedule. ``corrupt`` (a ``WireCorruption``)
# poisons this node's outgoing payload; self-deliveries -- the gathered own
# row, identity slots and the fixed points of staged atoms -- stay clean.


def _sendable(x: torch.Tensor, x32: torch.Tensor, corrupt, i: int) -> torch.Tensor:
    """What this rank sends: its payload ``x`` as held (the leaf, a ring
    slot), or, when it lies, the float32 payload ``x32`` with its bits
    bent."""
    return x if corrupt is None else _corrupt_own(x32, corrupt, i)


def _gather_mix(own: torch.Tensor, wire: torch.Tensor, group, combine, corrupt) -> torch.Tensor:
    """Gather every rank's ``wire``; where this rank lied (``corrupt``),
    restore its own row to its clean float32 payload ``own``; ``combine``
    the ``(n, ...)`` gather (its rows read as float32). The gather is
    dropped on return."""
    g = _all_gather(wire, group)
    if corrupt is not None:
        g[axis_index(group)] = own
    return combine(g)


def _axpy_slots(g: torch.Tensor, gammas: torch.Tensor, srcs: torch.Tensor) -> torch.Tensor:
    """``sum_l gammas[l] g[srcs[l]]`` in slot order from zeros (float32)."""
    acc = torch.zeros(g.shape[1:], dtype=torch.float32, device=g.device)
    gam = gammas.to(device=g.device, dtype=torch.float32)
    srcs = srcs.to(device=g.device, dtype=torch.long)
    for l in range(gam.shape[0]):
        acc = acc + gam[l] * g.index_select(0, srcs[l:l + 1])[0].to(torch.float32)
    return acc


def mix_dense_sharded(params: PyTree, W, group=None, *,
                      corrupt: WireCorruption | None = None) -> PyTree:
    """Dense mixing with one node per rank, W as data: ``theta_i <-
    sum_j W[i, j] theta_j`` by an all-gather of each leaf and this rank's
    row of W (float32). Any W swaps as a value change, at ``(n - 1) P``
    bytes a rank."""
    i = axis_index(group)
    leaves = tree_leaves(params)
    Wt = W if isinstance(W, torch.Tensor) else torch.as_tensor(np.asarray(W, np.float32))
    _check_nodes(Wt.shape[0], group, "W")
    row = Wt.to(device=leaves[0].device, dtype=torch.float32)[i]

    def mix_leaf(x):
        x32 = x.to(torch.float32)
        out = _gather_mix(x32, _sendable(x, x32, corrupt, i), group, lambda g: (
            row @ g.reshape(g.shape[0], -1).to(torch.float32)).reshape(x.shape), corrupt)
        return out.to(x.dtype)

    return tree_map(mix_leaf, params)


def mix_arrays_sharded(params: PyTree, arrays: ScheduleArrays, group=None, *,
                       corrupt: WireCorruption | None = None) -> PyTree:
    """``ScheduleArrays`` mixing with one node per rank: each leaf's
    all-gather, then ``sum_l gammas[l] gathered[perms[l, i]]`` with the
    coefficients and the table as data, in :func:`mix_ppermute_pool`'s
    slot order (bitwise equal to it on the same schedule)."""
    i = axis_index(group)
    _check_nodes(arrays.n_nodes, group, "the schedule")
    srcs = arrays.perms[:, i]

    def mix_leaf(x):
        x32 = x.to(torch.float32)
        return _gather_mix(x32, _sendable(x, x32, corrupt, i), group,
                           lambda g: _axpy_slots(g, arrays.gammas, srcs), corrupt).to(x.dtype)

    return tree_map(mix_leaf, params)


def _pool_contribs(wire: torch.Tensor, own: torch.Tensor, pool: "PermPool", group):
    """Each slot's contribution to this rank, in slot order: ``own`` for
    identity slots and this rank's fixed points (self-deliveries: no
    bytes), the source's ``wire`` by ppermute for the rest."""
    n, ident, i = pool.n_nodes, pool.identity, axis_index(group)
    for perm in pool.perms:
        if perm == ident or perm[i] == i:
            yield own
        else:
            yield _ppermute(wire, [(int(perm[q]), q) for q in range(n)], group).to(torch.float32)


def _check_pool_gammas(gammas: torch.Tensor, pool: "PermPool") -> None:
    if tuple(gammas.shape) != (pool.capacity,):
        raise ValueError(f"gammas must be ({pool.capacity},) to match the pool, "
                         f"got {tuple(gammas.shape)}")


def _pool_axpy(contribs, gammas: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
    gam = gammas.to(device=like.device, dtype=torch.float32)
    for l, contrib in enumerate(contribs):
        acc = acc + gam[l] * contrib
    return acc


def mix_ppermute_pool(params: PyTree, gammas: torch.Tensor, pool: "PermPool", group=None,
                      corrupt: WireCorruption | None = None) -> PyTree:
    """Staged-pool mixing with one node per rank: every non-identity slot
    runs its ppermute (gamma 0 zeroes the contribution, not the transfer),
    identity slots are a local scale; the (capacity,) gammas are data, so
    an in-pool swap is a value change. ``pool.n_comm_slots x P`` bytes a
    rank; bitwise :func:`mix_arrays_sharded` on ``pool.arrays_for``."""
    _check_pool_gammas(gammas, pool)
    _check_nodes(pool.n_nodes, group, "the pool")
    i = axis_index(group)

    def mix_leaf(x):
        x32 = x.to(torch.float32)
        contribs = _pool_contribs(_sendable(x, x32, corrupt, i), x32, pool, group)
        return _pool_axpy(contribs, gammas, x32).to(x.dtype)

    return tree_map(mix_leaf, params)


def mix_ppermute(params: PyTree, schedule: BirkhoffSchedule, group=None) -> PyTree:
    """Birkhoff ppermute mixing with one node per rank, a static schedule:
    ``sum_l gamma_l ppermute(params, P_l)``, the identity atom a local
    scale (no bytes). Node ``i`` receives from ``perm[i]``. The wire moves
    the leaf's dtype; the sum runs in float32 and rounds once (XLA keeps
    the reference's leaf-dtype sum in float32 too, within one rounding)."""
    n = schedule.n_nodes
    _check_nodes(n, group, "the schedule")
    identity = tuple(range(n))

    def mix_leaf(x):
        acc = None
        for gamma, perm in zip(schedule.coeffs, schedule.perms):
            got = x if perm == identity else \
                _ppermute(x, [(int(perm[q]), q) for q in range(n)], group)
            contrib = got.to(torch.float32) * gamma
            acc = contrib if acc is None else acc + contrib
        return acc.to(x.dtype)

    return tree_map(mix_leaf, params)


def mix_allreduce(params: PyTree, group=None) -> PyTree:
    """Complete-graph mixing (C-PSGD), ``theta_i <- mean_j theta_j``: an
    all-reduce in float32, rounded once to the leaf's dtype."""
    return tree_map(lambda x: _pmean(x, group).to(x.dtype), params)


# ---------------------------------------------------------------------------
# One node per rank: bounded delay (a sender-side ring a rank)
# ---------------------------------------------------------------------------
#
# Each rank keeps its own last ``depth`` wire payloads (float32) and sends
# the slot ``delays[i]`` pushes back: source-indexed delay, row for row
# :func:`stale_view`'s. The ring and the delay vector are data; the ring is
# pushed in place and its head is an int64 device tensor, as the stacked
# ring's. With zero delays the slot read is the payload just pushed, so
# both transports are their fresh twins bitwise.


class ShardStaleState(NamedTuple):
    """This rank's ring of its last ``depth`` wire payloads: ``rings``
    mirrors the parameters with leaves ``(depth, *leaf.shape)``, float32
    (or bfloat16, :func:`stale_ring_dtype`); ``head`` (a () int64 tensor
    on the rings' device) the newest slot."""

    rings: PyTree
    head: torch.Tensor

    @property
    def depth(self) -> int:
        return tree_leaves(self.rings)[0].shape[0]


def stale_ring_dtype(params: PyTree, compressor=None) -> torch.dtype:
    """The ring's dtype: bfloat16 where every leaf is bfloat16 and the
    payloads pushed are bf16 values (no compression, the identity or the
    bf16 wire) -- it then holds what the reference's float32 ring holds,
    bit for bit, in half the bytes --, else float32."""
    kind = getattr(compressor, "kind", compressor)
    if kind in (None, "identity", "bf16") and all(
            x.dtype == torch.bfloat16 for x in tree_leaves(params)):
        return torch.bfloat16
    return torch.float32


def shard_stale_init(params: PyTree, depth: int,
                     dtype: torch.dtype = torch.float32) -> ShardStaleState:
    """Every slot of every ring filled with the current payload (a delay
    longer than the pushes so far reads the initial state); ``dtype`` the
    rings' (see :func:`stale_ring_dtype`)."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1 (tau_max + 1), got {depth}")
    rings = tree_map(lambda x: x.to(dtype).unsqueeze(0).repeat(
        (depth,) + (1,) * x.ndim), params)
    device = tree_leaves(params)[0].device
    return ShardStaleState(rings=rings, head=torch.zeros((), dtype=torch.long, device=device))


def shard_stale_push(state: ShardStaleState, params: PyTree) -> ShardStaleState:
    """Advance the head and write this step's payloads, in place; returns
    ``state``."""
    state.head.add_(1).remainder_(state.depth)
    idx = state.head.reshape(1)
    tree_map(lambda r, x: r.index_copy_(0, idx, x.to(r.dtype).unsqueeze(0)),
             state.rings, params)
    return state


def _stale_slot(state: ShardStaleState, delays: torch.Tensor, i: int) -> torch.Tensor:
    """This node's slot under source-indexed delay ``delays[i]``, (1,) int64."""
    d = delays.to(device=state.head.device, dtype=torch.long)[i]
    return torch.remainder(state.head - d, state.depth).reshape(1)


def mix_arrays_sharded_stale(
    params: PyTree, state: ShardStaleState, arrays: ScheduleArrays, delays: torch.Tensor,
    group=None, *, corrupt: WireCorruption | None = None,
) -> tuple[PyTree, ShardStaleState]:
    """Bounded-delay :func:`mix_arrays_sharded`: pushes this step's
    parameters into the ring, gathers each rank's payload from
    ``delays[i]`` pushes ago and accumulates as the fresh transport does.
    Returns ``(mixed, state)`` (the ring pushed in place)."""
    i = axis_index(group)
    _check_nodes(arrays.n_nodes, group, "the schedule")
    state = shard_stale_push(state, params)
    slot = _stale_slot(state, delays, i)
    srcs = arrays.perms[:, i]

    def mix_leaf(x, ring):
        d = ring.index_select(0, slot)[0]
        d32 = d.to(torch.float32)
        return _gather_mix(d32, _sendable(d, d32, corrupt, i), group,
                           lambda g: _axpy_slots(g, arrays.gammas, srcs), corrupt).to(x.dtype)

    return tree_map(mix_leaf, params, state.rings), state


def mix_ppermute_pool_stale(
    params: PyTree, state: ShardStaleState, gammas: torch.Tensor, pool: "PermPool",
    delays: torch.Tensor, group=None, corrupt: WireCorruption | None = None,
) -> tuple[PyTree, ShardStaleState]:
    """Bounded-delay :func:`mix_ppermute_pool`: each staged ppermute moves
    the DELAYED payload, identity slots take the node's own delayed
    payload; the fresh transport's accumulation, so zero delays reproduce
    it bitwise. Returns ``(mixed, state)``."""
    _check_pool_gammas(gammas, pool)
    _check_nodes(pool.n_nodes, group, "the pool")
    i = axis_index(group)
    state = shard_stale_push(state, params)
    slot = _stale_slot(state, delays, i)

    def mix_leaf(x, ring):
        d = ring.index_select(0, slot)[0]
        d32 = d.to(torch.float32)
        contribs = _pool_contribs(_sendable(d, d32, corrupt, i), d32, pool, group)
        return _pool_axpy(contribs, gammas, d32).to(x.dtype)

    return tree_map(mix_leaf, params, state.rings), state


# ---------------------------------------------------------------------------
# Stacked nodes in the rank transports' numerics (the LM trainer)
# ---------------------------------------------------------------------------
#
# The LM trainer stacks its nodes on one card and holds them to the
# reference's mesh trainer, whose node axis runs the sharded transports:
# every mix sums in float32 and rounds once to the leaf's dtype. Here each
# leaf's (n, P_leaf) rows go through the hand-written kernel (on the CPU
# its plain version, the same float32 sums), a block of STACKED_BLOCK
# columns at a time where a wire makes float32 temporaries, so a step
# holds a few blocks of them whatever the model's width. The bounded-delay
# ring is node-first, leaves (n, depth, *leaf) -- the reference's stacked
# layout and the checkpoint's --, pushed in place with a device head.

STACKED_BLOCK = 1 << 22  # columns of a node row a stacked EF mix takes at once


def kernel_mix(flat: torch.Tensor, operand) -> torch.Tensor:
    """(n, P) contiguous rows mixed by ``operand`` in its kernel: a
    ``ScheduleArrays`` in ``gossip_schedule``, an (n, n) W in
    ``gossip_mix``; float32 sums, ``flat``'s dtype out (the kernel on a
    CUDA tensor, its plain version on the CPU)."""
    if isinstance(operand, ScheduleArrays):
        return gossip_ops.gossip_schedule(flat, operand.gammas, operand.perms)
    return gossip_ops.gossip_mix(flat, operand)


def stacked_stale_slots(head: torch.Tensor, delays: torch.Tensor, depth: int) -> torch.Tensor:
    """Advance the ring's ``head`` in place and return each node's read
    slot ``(head - delays[j]) % depth`` (n,) int64: source-indexed delay,
    as :func:`stale_view` and the rank rings read."""
    head.add_(1).remainder_(depth)
    return torch.remainder(head - delays.to(device=head.device, dtype=torch.long), depth)


def stacked_ring_view(ring: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Node j's payload from ring slot ``slot[j]``: (n, *leaf), a copy."""
    return ring[torch.arange(ring.shape[0], device=ring.device), slot]


def mix_arrays_stacked_stale(params: PyTree, rings: PyTree, head: torch.Tensor,
                             arrays: ScheduleArrays, delays: torch.Tensor) -> PyTree:
    """Bounded-delay ``ScheduleArrays`` mixing on stacked nodes, the
    stacked twin of :func:`mix_arrays_sharded_stale`: pushes this step's
    payloads into the node-first ``rings`` (leaves (n, depth, *leaf), the
    ring's dtype; ``head`` advanced once), then mixes node j's payload
    from ``delays[j]`` pushes ago in ``gossip_schedule`` (float32 sums,
    rounded once). Zero delays are the fresh mix. Returns the mixed
    tree."""
    x_leaves, rebuild = _flatten(params)
    r_leaves = tree_leaves(rings)
    if len(r_leaves) != len(x_leaves):
        raise ValueError("the ring must mirror the parameter pytree")
    slot = stacked_stale_slots(head, delays, r_leaves[0].shape[1])
    idx = head.reshape(1)
    outs = []
    for x, ring in zip(x_leaves, r_leaves):
        ring.index_copy_(1, idx, x.to(ring.dtype).unsqueeze(1))
        view = stacked_ring_view(ring, slot).reshape(x.shape[0], -1)
        outs.append(kernel_mix(view, arrays).reshape(x.shape).to(x.dtype))
    return rebuild(outs)


def spread_sq_stacked(tree: PyTree) -> torch.Tensor:
    """``sum_leaves sum_i ||x_i - mean_j x_j||^2`` over the node axis of
    stacked leaves, float32 (the rank probes' pmean / psum, summed a block
    of columns at a time)."""
    tot = None
    for x in tree_leaves(tree):
        rows = x.reshape(x.shape[0], -1)
        for a in range(0, rows.shape[1], STACKED_BLOCK):
            xf = rows[:, a:a + STACKED_BLOCK].float()
            s = torch.sum(torch.square(xf - xf.mean(dim=0, keepdim=True)))
            tot = s if tot is None else tot + s
    return tot


# ---------------------------------------------------------------------------
# One node per rank: cost model and measured table
# ---------------------------------------------------------------------------
#
# The reference's closed form (``mixing.py:1918-1945``): the pool receives
# ``n_comm_slots x P`` bytes a rank, the all-gather ``(n - 1) x P``, and one
# fused all-gather is worth ALLGATHER_THROUGHPUT_ADVANTAGE staged permutes
# per byte. Measured buckets win. Their keys (prefix ``sh_``, in the
# port's table beside the stacked buckets) carry the device name, the
# backend, the number of ranks and whether the ranks share one card: a
# measurement of ranks sharing a card over a socket never decides for
# ranks on cards of their own.

ALLGATHER_THROUGHPUT_ADVANTAGE = 2.0


def preferred_sharded_transport(
    n_nodes: int, n_comm_slots: int,
    allgather_speedup: float = ALLGATHER_THROUGHPUT_ADVANTAGE,
) -> str:
    """``"pool"`` iff ``n_comm_slots <= (n_nodes - 1) / allgather_speedup``
    (at least 1), else ``"allgather"``: the closed form on bytes."""
    if allgather_speedup <= 0:
        raise ValueError(f"allgather_speedup must be positive, got {allgather_speedup}")
    return ("pool" if n_comm_slots <= max(1, int((n_nodes - 1) / allgather_speedup))
            else "allgather")


def _rank_layout(group, device: torch.device) -> str:
    """``"shared"`` when every rank of ``group`` runs on one card (or, on
    the CPU, one host), else ``"distinct"``: a collective, so every rank
    calls it."""
    import socket

    if device.type == "cuda":
        here = (socket.gethostname(), str(torch.cuda.get_device_properties(device).uuid))
    else:
        here = (socket.gethostname(), "cpu")
    seen: list = [None] * axis_size(group)
    _dist().all_gather_object(seen, here, group=group)
    return "shared" if all(s == seen[0] for s in seen) else "distinct"


def _sharded_bucket_key(n_nodes: int, n_comm_slots: int, p: int, device: torch.device,
                        backend: str, layout: str) -> str:
    return (f"sh_{_hw_tag(device)}_{backend}_ranks{n_nodes}_{layout}"
            f"_n{_pow2_up(n_nodes)}_K{_pow2_up(n_comm_slots)}_P{_pow2_up(p)}")


def _rank_seconds(fn, iters: int, repeats: int, device: torch.device, group) -> float:
    """Best over ``repeats`` of an ``iters``-call average, host clock to a
    synchronise after a barrier; the slowest rank's (an all-reduce MAX), so
    every rank reads the same time."""
    import time

    dist = _dist()
    fn()
    best = float("inf")
    for _ in range(repeats):
        dist.barrier(group=group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    t = torch.tensor([best], dtype=torch.float64,
                     device=device if group_backend(group) == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def measure_sharded_transport(
    n_nodes: int, n_comm_slots: int, p: int, *, group=None, iters: int = 3,
    repeats: int = 3, seed: int = 0, device: torch.device | str | None = None,
) -> dict:
    """Time the staged pool against the all-gather once, with one node per
    rank of ``group`` (every rank calls it): synthetic float32 payloads of
    ``p`` elements (capped at ``_MEASURE_MAX_ELEMENTS // n``), random
    atoms from ``seed``, the slowest rank's best-of time in us."""
    device = resolve_device(device)
    _check_nodes(n_nodes, group, "the measurement")
    p_measured = _p_measured(n_nodes, p)
    rng = np.random.default_rng(seed)
    slots = tuple(tuple(int(x) for x in rng.permutation(n_nodes)) for _ in range(n_comm_slots))
    pool = PermPool(perms=slots)
    gammas_np, _ = pool.project(BirkhoffSchedule(
        coeffs=tuple(1.0 / len(slots) for _ in slots), perms=slots))
    gammas = torch.as_tensor(gammas_np, device=device)
    arrays = pool.arrays_for(gammas_np, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + axis_index(group))
    theta = torch.randn((p_measured,), generator=gen, device=device)
    pool_s = _rank_seconds(lambda: mix_ppermute_pool(theta, gammas, pool, group),
                           iters, repeats, device, group)
    ag_s = _rank_seconds(lambda: mix_arrays_sharded(theta, arrays, group),
                         iters, repeats, device, group)
    return {
        "n_nodes": n_nodes, "n_comm_slots": n_comm_slots, "p": p, "p_measured": p_measured,
        "pool_us": pool_s * 1e6, "allgather_us": ag_s * 1e6,
        "winner": "pool" if pool_s <= ag_s else "allgather",
        "backend": group_backend(group), "hw": _hw_tag(device),
        "layout": _rank_layout(group, device),
        "timing": f"best of {repeats} {iters}-call averages, host clock, slowest rank",
    }


def autotune_sharded_transport(
    n_nodes: int, n_comm_slots: int, p: int, *, measure: bool = False, group=None,
    path: str | None = None, allgather_speedup: float = ALLGATHER_THROUGHPUT_ADVANTAGE,
    device: torch.device | str | None = None,
) -> str:
    """``"pool"`` or ``"allgather"`` for ``n_nodes`` ranks of ``group``
    (every rank calls it): the measured bucket's winner on a hit; on a
    miss, with ``measure=True``, both transports are timed once and the
    record memoized (rank 0 writes the table), else the closed form
    :func:`preferred_sharded_transport`."""
    device = resolve_device(device)
    path = path or transport_autotune_path()
    key = _sharded_bucket_key(n_nodes, n_comm_slots, p, device, group_backend(group),
                              _rank_layout(group, device))
    table = _load_autotune(path)
    entry = table.get(key)
    if entry is not None and entry.get("winner") in ("pool", "allgather"):
        return entry["winner"]
    if not measure:
        return preferred_sharded_transport(n_nodes, n_comm_slots, allgather_speedup)
    entry = measure_sharded_transport(n_nodes, _pow2_up(n_comm_slots), _pow2_up(p),
                                      group=group, device=device)
    table = dict(table)
    table[key] = entry
    if axis_index(group) == 0:
        _persist_autotune(path, table)
    else:
        global _autotune_cache, _autotune_cache_path
        _autotune_cache, _autotune_cache_path = table, path
    return entry["winner"]
