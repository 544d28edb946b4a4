"""The tensor-parallel collectives the model blocks take: the Megatron
form of a split over the ``model`` mesh dimension, as autograd functions
on plain tensors (``train/tensor_parallel.py`` says which weight each
placement splits and when each collective runs).

Every block in ``models/`` takes an optional ``tp`` (a :class:`TPGroup`):
None (or a group of one rank) and every function here is the identity,
so the whole model and a rank's split replica run one forward. A block
sees from its weights' shapes whether the rules split it (:func:`split`)
and computes whole where they do not.

Serving reads and writes a rank's block of the caches (``serve.engine``'s
cache specs): ``own_block`` cuts this rank's block of a dimension out of
a tensor every rank holds whole, ``gather_dim`` gathers a dimension's
blocks (forward only: caches take no gradient).

``collective_bytes`` (``core.mixing``) counts what a rank receives under
``"tp_all_reduce"`` and ``"tp_all_gather"``, ``collective_calls`` the
calls.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from repro_torch.core import mixing as _M

from .layers import rms_norm

__all__ = ["TPGroup", "split", "copy_to", "reduce_from", "gather_last", "gather_last_partial",
           "slice_last", "touched", "branch", "latent_norm", "split_rms_norm", "own_block",
           "gather_dim"]


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The ranks one node's replica is split over: ``group`` (None: one
    rank, every collective the identity), its ``size`` and this rank's
    index."""

    group: object = None
    size: int = 1
    rank: int = 0

    @classmethod
    def of(cls, group) -> "TPGroup":
        if group is None:
            return cls()
        n = _M.axis_size(group)
        return cls(group if n > 1 else None, n, _M.axis_index(group) if n > 1 else 0)


def _count(kind: str, nbytes: int) -> None:
    _M.collective_bytes[kind] += nbytes
    _M.collective_calls[kind] += 1


def _all_reduce(x: torch.Tensor, tp: TPGroup, op=None, kind: str = "tp_all_reduce"
                ) -> torch.Tensor:
    import torch.distributed as dist

    y = x.contiguous().clone()
    if op is None:
        dist.all_reduce(y, group=tp.group)
    else:
        dist.all_reduce(y, op=op, group=tp.group)
    _count(kind, 2 * (tp.size - 1) * y.numel() * y.element_size() // tp.size)
    return y


def _all_gather_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    import torch.distributed as dist

    flat = x.contiguous().reshape(-1)
    out = torch.empty((tp.size * flat.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=tp.group)
    _count("tp_all_gather", (tp.size - 1) * flat.numel() * flat.element_size())
    return torch.cat(out.view((tp.size,) + tuple(x.shape)).unbind(0), dim=-1)


def _own_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    w = x.shape[-1] // tp.size
    return x[..., tp.rank * w:(tp.rank + 1) * w].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    """The sum over ranks with its exact adjoint (the gradients' sum over
    ranks): for a sum whose inputs are different batch slices."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_reduce(x, tp, kind="grad_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp, kind="grad_all_reduce"), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, partial):
        ctx.tp, ctx.partial = tp, partial
        return _all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _all_reduce(g, ctx.tp)
        return _own_last(g, ctx.tp), None, None


class _SliceLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _own_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.tp), None


def _one(tp: TPGroup | None) -> bool:
    return tp is None or tp.group is None


def split(tp: TPGroup | None, local: int, full: int) -> TPGroup | None:
    """``tp`` where a block's ``local`` width is a split of ``full`` (the
    rules split the block), else None: the block computes whole."""
    return None if _one(tp) or local >= full else tp


def copy_to(x: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """Identity forward, the gradient all-reduced: where a replicated
    activation or weight enters a computation split over the ranks."""
    return x if _one(tp) else _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """All-reduce forward, identity backward: partial sums."""
    return x if _one(tp) else _ReduceFrom.apply(x, tp)


def gather_last(x: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """The last dimension gathered forward, this rank's block of the
    gradient backward: a split activation replicated computation reads."""
    return x if _one(tp) else _GatherLast.apply(x, tp, False)


def gather_last_partial(x: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """The same gather, the gradient's blocks summed over ranks backward:
    a split activation this rank's split computation reads whole."""
    return x if _one(tp) else _GatherLast.apply(x, tp, True)


def slice_last(x: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """This rank's block of a replicated vector forward, the gradient's
    blocks gathered backward."""
    return x if _one(tp) else _SliceLast.apply(x, tp)


def touched(heads: int, dh: int, tp: TPGroup | None) -> tuple[int, int, int]:
    """The heads this rank's block of ``heads * dh`` columns touches,
    ``[lo, hi)``, and where its block starts in their columns (every head
    without a split)."""
    if _one(tp):
        return 0, heads, 0
    width = heads * dh // tp.size
    c0 = tp.rank * width
    lo = c0 // dh
    return lo, -(-(c0 + width) // dh), c0 - lo * dh


def branch(x_local: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """A recurrent block's branch split by features, whole for the gates
    that read all of it (the RG-LRU's ``w_a`` / ``w_x``, the mLSTM's
    ``wq`` / ``wk`` / ``wv`` by columns): gathered, its gradient summed
    over the ranks' columns."""
    return gather_last_partial(x_local, tp)


def latent_norm(c_local: torch.Tensor, norm, eps: float, tp: TPGroup | None,
                split_latent: bool) -> torch.Tensor:
    """MLA's normalised latents, whole on every rank: a latent the rules
    split is gathered first (``kv_norm`` is an RMS norm over all r of
    them), then normalised with the whole scale; the rank's heads read
    it, so its gradient is summed over ranks."""
    c = gather_last_partial(c_local, tp) if split_latent else c_local
    return rms_norm(types.SimpleNamespace(scale=copy_to(norm.scale, tp)), c, eps)


def split_rms_norm(x_local: torch.Tensor, norm, eps: float, tp: TPGroup | None
                   ) -> torch.Tensor:
    """``rms_norm`` over features split over ranks: the sum of squares
    reduced (its gradient summed back), the whole scale's block."""
    if _one(tp):
        return rms_norm(norm, x_local, eps)
    x32 = x_local.float()
    ss = copy_to(reduce_from(x32.square().sum(dim=-1, keepdim=True), tp), tp)
    normed = x32 * torch.rsqrt(ss / (x_local.shape[-1] * tp.size) + eps)
    return (normed * slice_last(norm.scale, tp).float()).to(x_local.dtype)


def own_block(x: torch.Tensor, tp: TPGroup | None, dim: int) -> torch.Tensor:
    """This rank's block of dimension ``dim`` of ``x`` (every rank holds it
    whole), contiguous."""
    if _one(tp):
        return x
    width = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * width, width).contiguous()


def gather_dim(x: torch.Tensor, tp: TPGroup | None, dim: int) -> torch.Tensor:
    """The ranks' blocks of dimension ``dim`` gathered (forward only)."""
    if _one(tp):
        return x
    return _all_gather_last(x.movedim(dim, -1), tp).movedim(-1, dim).contiguous()
