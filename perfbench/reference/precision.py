"""The precisions the plain references compute in.

``"float32"`` and ``"bfloat16"`` are what the configurations state. The
controls compute in the next precision down: ``"tf32"`` rounds every
product's operands to TF32's 10-bit mantissa (nearest, ties to even) and
accumulates in float32, as the tensor cores do; ``"fp8"`` scales each
operand by its largest magnitude onto float8_e4m3's range, rounds it
there and multiplies the rounded values, accumulating in float32. Both are
written out, so that they compute the same on the CPU and on the card,
whatever ``torch.backends`` allows.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def no_tf32() -> None:
    """float32 products in float32 on the card (no TF32 in cuBLAS or cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits."""
    i = x.float().contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0x0FFF + lsb, -8192)
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3 under a per-tensor scale, back in
    ``x``'s dtype (a straight-through estimate under autograd)."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand of a product as ``precision`` takes it."""
    if precision == "tf32":
        return x + (round_tf32(x).to(x.dtype) - x).detach()
    if precision == "fp8":
        return round_fp8(x)
    return x


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` (batched as ``torch.matmul``) in ``precision``."""
    return torch.matmul(rounded(a, precision), rounded(b, precision))
