"""Public wrapper for the RG-LRU scan kernel.

On a CUDA tensor ``rglru_scan`` launches the hand-written kernel
(``csrc/rglru_scan.cu``), built with nvcc at first use; there is no
fallback to another implementation on the card. On a CPU tensor it runs
the plain version in ``ref.py``. The kernel masks ragged S and D itself,
so nothing is padded (the reference's ``ops.py`` pads time with a = 1,
b = 0 and falls back to its oracle below S = 256). There is no ``h0``:
the RG-LRU block folds a carried state into ``b[:, 0]`` first, as the
reference's block does.

The kernel carries the state between time tiles through a small
workspace (a ticket counter and a flag a tile, zeroed here on the
launch's stream before every launch, and the tiles' published values);
``kernel_design`` names the tiling.

The kernel has no backward pass, as the reference's has none: a CUDA
call on an input that requires grad raises instead of detaching it.

``launch_counts["rglru_scan"]`` rises by one at every launch and nowhere
else. On a ``meta`` tensor (the dry run's shape-only pass) nothing
launches or counts: the call returns an empty output and appends its
shape to ``meta_calls``.
"""

from __future__ import annotations

import ctypes

import torch

from .ref import rglru_scan_ref

__all__ = ["rglru_scan", "kernel_design", "launch_counts", "reset_launch_counts", "meta_calls"]

launch_counts = {"rglru_scan": 0}
# the shapes of the calls made on meta tensors (the dry run reads them)
meta_calls: list[dict] = []

_SYMBOLS = {torch.float32: "rglru_scan_f32", torch.bfloat16: "rglru_scan_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P, _P, _P]


def reset_launch_counts() -> None:
    launch_counts["rglru_scan"] = 0


def _workspace(B: int, S: int, D: int) -> tuple[int, int, int]:
    """(bytes to zero, bytes of scratch, time steps of a tile) of a scan."""
    from repro_torch.kernels import _build

    fn = _build.kernel_function("rglru_scan", "rglru_scan_workspace",
                                [_I, _I, _I, _P, _P])
    zeroed, scratch = ctypes.c_int64(), ctypes.c_int64()
    tile = fn(B, S, D, ctypes.addressof(zeroed), ctypes.addressof(scratch))
    return zeroed.value, scratch.value, tile


def kernel_design() -> str:
    """The CUDA kernel's design, with its tile."""
    return (f"one-pass chained scan, deterministic look-back to an origin every 8 tiles, "
            f"tiles of 32 features x {_workspace(1, 1, 1)[2]} steps")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t h_{t-1} + b_t over axis 1 of (B, S, D),
    h_{-1} = 0. Float32 arithmetic inside; returns a's dtype."""
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor) or t.ndim != 3:
            raise ValueError(f"{name} must be a 3-D (B, S, D) tensor")
        if t.dtype not in _SYMBOLS:
            raise TypeError(f"{name} dtype must be float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (B, S, D)")
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"a and b differ: {tuple(a.shape)} {a.dtype} vs "
                         f"{tuple(b.shape)} {b.dtype}")
    if a.device != b.device or a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"a and b must share a cpu or cuda device, got {a.device}, {b.device}")
    if a.device.type == "meta":
        meta_calls.append(dict(zip("BSD", a.shape)))
        return torch.empty_like(a)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.requires_grad or b.requires_grad:
        raise RuntimeError("rglru_scan: no backward kernel; the reference kernel has none")
    B, S, D = a.shape
    h = torch.empty_like(a)
    if a.numel() == 0:
        return h
    from repro_torch.kernels import _build

    with torch.cuda.device(a.device):
        zeroed, scratch, _ = _workspace(B, S, D)
        flags = torch.zeros(zeroed, dtype=torch.uint8, device=a.device)
        values = torch.empty(scratch, dtype=torch.uint8, device=a.device)
        fn = _build.kernel_function("rglru_scan", _SYMBOLS[a.dtype], _ARGTYPES)
        status = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D, flags.data_ptr(),
                    values.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"rglru_scan launch failed: cudaError {status}")
    launch_counts["rglru_scan"] += 1
    return h
