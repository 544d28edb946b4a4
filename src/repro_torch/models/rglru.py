"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t)                    (recurrence gate)
    i_t = sigmoid(W_x x_t)                    (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)    (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence and prefill recurrence is the linear scan of
``kernels.rglru_scan``: with ``impl="kernel"`` it goes through
``ops.rglru_scan`` (the hand-written CUDA kernel on the card, its plain
version on the CPU), with ``impl="plain"`` through the plain
``rglru_scan_ref``. (The reference's block always runs
``lax.associative_scan``; its kernel computes the same recurrence but is
not wired in.) Decode is one elementwise step.

Block layout (Griffin's recurrent block):
  norm -> {gate branch: linear+GeLU} x {rnn branch: linear -> causal conv ->
  RG-LRU} -> multiply -> output linear -> residual.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

from . import parallel as P
from .common import IMPLS, ModelConfig, dtype_of, truncated_normal_
from .layers import RMSNorm, causal_conv1d, rms_norm

__all__ = ["RGLRUBlock", "init_rglru_block", "rglru_block", "init_rglru_state"]

_C = 8.0


class RGLRUBlock(nn.Module):
    """``norm``, ``w_gate`` / ``w_rnn_in`` (d, dr), ``conv_w`` (width, dr),
    ``w_a`` / ``w_x`` (dr, dr), ``lam`` (dr,) float32, ``w_out`` (dr, d)."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = dtype_of(cfg)
        d, dr = cfg.d_model, cfg.resolved_rnn_width

        def empty(*shape, dtype=dt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        self.norm = RMSNorm(d, dt, device)
        self.w_gate = empty(d, dr)
        self.w_rnn_in = empty(d, dr)
        self.conv_w = empty(cfg.conv_width, dr)
        self.w_a = empty(dr, dr)
        self.w_x = empty(dr, dr)
        self.lam = empty(dr, dtype=torch.float32)
        self.w_out = empty(dr, d)

    def init_weights(self, generator: torch.Generator) -> None:
        d, dr = self.w_gate.shape
        truncated_normal_(self.w_gate, d**-0.5, generator)
        truncated_normal_(self.w_rnn_in, d**-0.5, generator)
        truncated_normal_(self.conv_w, 0.1, generator)
        truncated_normal_(self.w_a, dr**-0.5, generator)
        truncated_normal_(self.w_x, dr**-0.5, generator)
        # Lambda so that a^(1/c) ~ U[0.9, 0.999], as in the paper
        u = torch.empty(dr, dtype=torch.float32, device=self.lam.device)
        u.uniform_(0.9, 0.999, generator=generator)
        with torch.no_grad():
            self.lam.copy_(torch.log(torch.expm1(-torch.log(u))))  # softplus^{-1}(-log u)
        truncated_normal_(self.w_out, dr**-0.5, generator)


def init_rglru_block(
    cfg: ModelConfig, *, generator: torch.Generator, device: torch.device | str
) -> RGLRUBlock:
    block = RGLRUBlock(cfg, device)
    block.init_weights(generator)
    return block


def init_rglru_state(
    cfg: ModelConfig, batch: int, device: torch.device | str | None = None
) -> dict:
    """Zero recurrence and conv states on ``device`` (None = CUDA)."""
    device = resolve_device(device)
    dr = cfg.resolved_rnn_width
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dtype_of(cfg), device=device),
    }


def rglru_block(
    params: RGLRUBlock,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: dict | None = None,
    impl: str = "kernel",
    tp: P.TPGroup | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """x: (B,S,D) -> (x + block(x), new state). Scan (state None, or a
    prefill with S > 1) or one decode step (state and S == 1).

    A given ``state`` is written in place (``copy_``: the new ``h`` and
    conv tail land in its own tensors, so a captured decode step reads and
    writes the same storage at every replay) and returned.

    ``tp`` (a split replica): the gate and input
    branches by columns, the conv on the rank's features (its block of a
    whole ``conv_w``), the recurrence and input gates from the gathered
    branch (``parallel.branch``: they read all of it; the branch is
    gathered, not the gate product split), the scan on the rank's
    features, ``w_out`` by rows and its partial sums reduced."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    B, S, D = x.shape
    tp = P.split(tp, params.w_gate.shape[1], cfg.resolved_rnn_width)
    xn = P.copy_to(rms_norm(params.norm, x, cfg.norm_eps), tp)
    gate = F.gelu(xn @ params.w_gate, approximate="tanh")  # (B,S,dr)
    rnn_in = xn @ params.w_rnn_in
    conv_w = params.conv_w
    if conv_w.shape[-1] != rnn_in.shape[-1]:
        conv_w = P.slice_last(conv_w, tp)
    rnn_in, new_conv = causal_conv1d(rnn_in, conv_w, None if state is None else state["conv"])
    if state is not None:
        state["conv"].copy_(new_conv)

    full = P.branch(rnn_in, tp)
    r = torch.sigmoid((full @ params.w_a).float())
    i = torch.sigmoid((full @ params.w_x).float())
    softplus = torch.logaddexp(params.lam, torch.zeros_like(params.lam))  # jax's softplus
    log_a = -_C * softplus * r  # (B,S,dr), <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * rnn_in.float())

    if state is None or S > 1:
        if state is not None:
            # fold the carried state into the first step
            b[:, 0] += a[:, 0] * state["h"]
        scan = scan_ops.rglru_scan if impl == "kernel" else rglru_scan_ref
        h = scan(a, b)
        if state is not None:
            state["h"].copy_(h[:, -1])
    else:
        h = (a[:, 0] * state["h"] + b[:, 0])[:, None, :]
        state["h"].copy_(h[:, 0])

    out = (h.to(x.dtype) * gate) @ params.w_out
    return x + P.reduce_from(out, tp), state
