"""Public wrapper of the device auction kernel (``csrc/auction.cu``).

On a CUDA tensor :func:`auction` launches the hand-written kernel, built
with nvcc at first use: one launch is one whole solve. There is no
fallback on the card: a build or launch failure raises. On a CPU tensor
it runs the plain version, ``ref.auction_ref``. The host contract of the
LMO (shortcuts, warm-state vetting, errors) lives in
``repro_torch.core.assignment_jit``.

``launch_counts["auction"]`` is raised by one at every launch and
nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from .ref import STATS, auction_ref

__all__ = ["auction", "work_sizes", "launch_counts", "reset_launch_counts"]

launch_counts = {"auction": 0}

_P = ctypes.c_void_p
_ARGTYPES = [
    _P, _P, _P, _P, ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_double,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    _P, _P, _P, _P, _P, _P,
]


def reset_launch_counts() -> None:
    launch_counts["auction"] = 0


def work_sizes(n: int) -> tuple[int, int]:
    """Float64 and int32 entries of device scratch one solve of n uses:
    prices, profits, slack and row maxima, the slack sum's power-of-two
    tree; col_of_row and owner (the layout ``auction_f64`` documents)."""
    return 4 * n + (1 << max(0, (n - 1).bit_length())), 2 * n


def _check(name: str, x: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if not isinstance(x, torch.Tensor) or tuple(x.shape) != shape or x.dtype != dtype:
        raise ValueError(f"{name} must be a {dtype} tensor of shape {shape}, got "
                         f"{getattr(x, 'dtype', type(x).__name__)} {tuple(getattr(x, 'shape', ()))}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device} but cost is on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def auction(
    cost: torch.Tensor,
    warm_prices: torch.Tensor,
    warm_col: torch.Tensor,
    *,
    warm_scale: float,
    have_warm: bool,
    rel_grid: float,
    scaling: float,
    forward_reverse: bool,
    validate: bool,
    gs_threshold: int,
    max_iters: int,
    benefit: torch.Tensor | None = None,
    out: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    work: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One auction solve; returns ``(col_of_row int32, prices float64,
    stats int64)`` as ``ref.auction_ref`` does (see its docstring).

    On the card the kernel writes the snapped benefit matrix into
    ``benefit`` ((n, n) float64 scratch; ``cost`` itself may be passed)
    and its results into ``out``, using ``work`` (float64 and int32
    tensors of :func:`work_sizes`) as scratch: all three are required
    there (``core.assignment_jit.AuctionWorkspace.buffers`` holds them),
    and the wrapper allocates nothing. The launch goes on the current
    stream and does not synchronise: read ``stats`` after the stream has
    run. On the CPU the three are not used.
    """
    if not isinstance(cost, torch.Tensor) or cost.ndim != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(f"cost must be a square (n, n) tensor, got "
                         f"{tuple(getattr(cost, 'shape', ()))}")
    n = cost.shape[0]
    if n < 2:
        raise ValueError(f"the auction kernel solves n >= 2, got n = {n}")
    device = cost.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    _check("cost", cost, (n, n), torch.float64, device)
    _check("warm_prices", warm_prices, (n,), torch.float64, device)
    _check("warm_col", warm_col, (n,), torch.int32, device)
    kw = dict(warm_scale=float(warm_scale), have_warm=bool(have_warm), rel_grid=float(rel_grid),
              scaling=float(scaling), forward_reverse=bool(forward_reverse),
              validate=bool(validate), gs_threshold=int(gs_threshold),
              max_iters=int(max_iters))
    if device.type == "cpu":
        return auction_ref(cost, warm_prices, warm_col, **kw)
    if benefit is None or out is None or work is None:
        raise ValueError("on the card the auction needs its benefit, out and work buffers "
                         "(an AuctionWorkspace's buffers)")
    col, prices, stats = out
    _check("benefit", benefit, (n, n), torch.float64, device)
    _check("col_of_row out", col, (n,), torch.int32, device)
    _check("prices out", prices, (n,), torch.float64, device)
    _check("stats out", stats, (len(STATS),), torch.int64, device)
    nf, ni = work_sizes(n)
    _check("float64 work", work[0], (nf,), torch.float64, device)
    _check("int32 work", work[1], (ni,), torch.int32, device)
    from repro_torch.kernels import _build

    with torch.cuda.device(device):
        fn = _build.kernel_function("auction", "auction_f64", _ARGTYPES)
        status = fn(
            cost.data_ptr(), benefit.data_ptr(), warm_prices.data_ptr(), warm_col.data_ptr(),
            kw["warm_scale"], int(kw["have_warm"]), kw["rel_grid"], kw["scaling"],
            int(kw["forward_reverse"]), int(kw["validate"]), kw["gs_threshold"],
            kw["max_iters"], n, prices.data_ptr(), col.data_ptr(), stats.data_ptr(),
            work[0].data_ptr(), work[1].data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"auction launch failed: cudaError {status}")
    launch_counts["auction"] += 1
    return col, prices, stats
