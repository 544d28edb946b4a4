"""Public wrapper for the flash attention kernel.

On a CUDA tensor ``flash_attention`` launches a hand-written kernel,
built with nvcc at first use and picked by dtype: bfloat16 inputs go to
the tensor-core kernel (``csrc/flash_attention_wgmma.cuh``: a TMA producer
warpgroup feeding two wgmma consumer warpgroups, bf16 products, float32
sums and softmax), float32 inputs to the CUDA-core kernel
(``csrc/flash_attention.cu``: full float32 FMA, which the 2e-3 float32
parity needs). There is no fallback to another implementation on the
card: a failed launch raises. On a CPU tensor it runs the plain version
in ``ref.py``.

Two detours of the reference's ``ops.py`` are not carried over: the
kernel takes any S >= 1 and masks the ragged q and kv edges itself (the
reference falls back to its oracle below S = 128 and pads S), and it
applies the true ``D**-0.5`` in float32 (the reference pads D to a
multiple of 128 and pre-scales q in q's dtype), or the ``scale`` it is
given: a caller that zero-pads q and k to a kernel head dim (MLA's 192
to 256) keeps the scale of its own. Head dims are those of the repo's
configs: 32, 64, 128 and 256.

Under autograd (grad enabled and an input that requires grad) a
bfloat16 call on the card is a ``torch.autograd.Function``: the forward
kernel also writes each row's float32 log-sum-exp and the float32 output,
and the backward is two more hand-written kernels
(``csrc/flash_attention_bwd.cu``: dQ, then dK and dV summed over each GQA
group inside a block; bf16 products, float32 sums, no atomics, so a call
is bitwise repeatable). Float32 inputs that require grad raise on the
card: the CUDA-core kernel has no backward. On the CPU autograd
differentiates ``flash_attention_ref``.

The bfloat16 kernel reads q, k and v with TMA, which needs 16-byte
aligned addresses (every fresh tensor has one): a view that starts
elsewhere is first copied into a fresh tensor.

``launch_counts["flash_attention"]`` rises by one at every forward
launch of either kernel and nowhere else; ``launch_counts
["flash_attention_bwd"]`` by one at every backward call (its two
launches).

On a ``meta`` tensor (the dry run's shape-only pass, ``launch/dryrun.py``)
nothing launches and nothing is counted: the call returns an empty output
of q's shape and appends its shape to ``meta_calls``, from which the dry
run adds the launch's FLOPs.
"""

from __future__ import annotations

import ctypes

import torch

from .ref import flash_attention_ref

__all__ = [
    "flash_attention", "kernel_design", "launch_counts", "reset_launch_counts", "HEAD_DIMS",
    "meta_calls",
]

launch_counts = {"flash_attention": 0, "flash_attention_bwd": 0}
# the shapes of the calls made on meta tensors (the dry run reads them)
meta_calls: list[dict] = []
HEAD_DIMS = (32, 64, 128, 256)

_SYMBOLS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# q, k, v, out, B, S, H, Hkv, D, causal, window, softcap, scale (<= 0: D^-0.5), stream
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_F, _F, _P]
# flash_attention_bf16_save: q, k, v, out, o32, lse, then as above
_SAVE_ARGTYPES = [_P] * 6 + [_I] * 7 + [_F, _F, _P]
# q, k, v, dout, o32, lse, delta, dq, dk, dv, B, S, H, Hkv, D, causal, window, softcap, scale,
# stream
_BWD_ARGTYPES = [_P] * 10 + [_I] * 7 + [_F, _F, _P]
LSE_PAD = 128  # the saved log-sum-exp's rows: S rounded up to a multiple of this


_DESIGNS = {
    torch.bfloat16: "tensor-core wgmma bf16, TMA producer warpgroup, f32 sums "
                    "(flash_attention_wgmma.cuh)",
    torch.float32: "cuda-core f32 fma (flash_attention.cu)",
}


def kernel_design(dtype: torch.dtype) -> str:
    """The kernel ``flash_attention`` launches on the card for ``dtype``."""
    return _DESIGNS[dtype]


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window, softcap, scale) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"{name} must be a 4-D (B, S, heads, D) tensor")
        if t.dtype not in _SYMBOLS:
            raise TypeError(f"{name} dtype must be float32 or bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device} but q is on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (B, S, heads, D)")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != D:
        raise ValueError(f"k, v must be (B={B}, S={S}, Hkv, D={D}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"Hkv={k.shape[2]} must divide H={H}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernel takes {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap < 0.0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    if scale is not None and not scale > 0.0:
        raise ValueError(f"scale must be > 0 or None, got {scale}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash attention with GQA. q: (B, S, H, D); k/v: (B, S, Hkv, D).

    Causal (``kpos <= qpos``) unless ``causal=False``; ``window`` keeps
    ``kpos > qpos - window``; the logits are scaled by ``scale`` (None:
    ``D**-0.5``); ``softcap > 0`` applies ``cap * tanh(s / cap)`` to the
    scaled logits before the mask. Float32 sums and softmax inside
    (on the card, bfloat16 inputs multiply on the tensor cores and the
    softmax weights enter P V as two bfloat16 parts); returns q's dtype.
    Differentiable: on the card for bfloat16 inputs, on the CPU always.
    """
    _check(q, k, v, window, softcap, scale)
    if q.device.type == "meta":
        B, S, H, D = q.shape
        meta_calls.append({"B": B, "S": S, "H": H, "Hkv": k.shape[2], "D": D,
                           "causal": causal, "window": window})
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                   scale=scale)
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"B * H = {q.shape[0] * q.shape[2]} exceeds the grid's y limit of 65535")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.dtype != torch.bfloat16:
            raise RuntimeError(f"flash_attention: no backward kernel for {q.dtype} (the "
                               "tensor-core kernel's backward takes bfloat16 only)")
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _forward(*_aligned(q, k, v), causal, window, softcap, scale, save=False)[0]


def _aligned(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """bfloat16 tensors at 16-byte aligned addresses (TMA reads only
    those): a view that starts elsewhere is copied into a fresh tensor."""
    return tuple(t.clone() if t.dtype == torch.bfloat16 and t.data_ptr() % 16 else t for t in ts)


def _s_pad(S: int) -> int:
    return -(-S // LSE_PAD) * LSE_PAD


def _forward(q, k, v, causal, window, softcap, scale, *, save: bool):
    """The forward launch: out, and with ``save`` (bfloat16 only) the
    float32 output and the (B, H, S_pad) float32 log-sum-exp."""
    from repro_torch.kernels import _build

    B, S, H, D = q.shape
    out = torch.empty_like(q)
    o32 = lse = None
    if save:
        o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H, _s_pad(S)), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, o32, lse
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    symbol, argtypes = _SYMBOLS[q.dtype], _ARGTYPES
    if save:
        ptrs += [o32.data_ptr(), lse.data_ptr()]
        symbol, argtypes = "flash_attention_bf16_save", _SAVE_ARGTYPES
    with torch.cuda.device(q.device):
        fn = _build.kernel_function("flash_attention", symbol, argtypes)
        status = fn(*ptrs, B, S, H, k.shape[2], D, int(causal),
                    0 if window is None else int(window), float(softcap),
                    0.0 if scale is None else float(scale),
                    torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {status}")
    launch_counts["flash_attention"] += 1
    return out, o32, lse


def _backward(q, k, v, dout, o32, lse, causal, window, softcap, scale):
    """dq, dk, dv (bfloat16) from the saved forward and the output's gradient."""
    from repro_torch.kernels import _build

    B, S, H, D = q.shape
    (dout,) = _aligned(dout.to(q.dtype).contiguous())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, _s_pad(S)), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        fn = _build.kernel_function("flash_attention_bwd", "flash_attention_bwd_bf16",
                                    _BWD_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), o32.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B, S, H, k.shape[2], D, int(causal),
                    0 if window is None else int(window), float(softcap),
                    0.0 if scale is None else float(scale),
                    torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_attention backward launch failed: cudaError {status}")
    launch_counts["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The bfloat16 kernel under autograd: the forward saves the float32
    output and log-sum-exp, the backward launches the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        q, k, v = _aligned(q, k, v)
        out, o32, lse = _forward(q, k, v, causal, window, softcap, scale, save=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.opts = (causal, window, softcap, scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, dout, o32, lse, *ctx.opts)
        return dq, dk, dv, None, None, None, None
