"""xLSTM blocks (Beck et al., 2024 -- arXiv:2405.04517): mLSTM and sLSTM.

* mLSTM: matrix-memory LSTM with exponential gating. The full sequence
  runs the *parallel* (quadratic, attention-like) form, or above 2048
  positions (a multiple of 512) the *chunkwise* form: a Python loop over
  chunks carrying the (C, n, m) state, where the reference runs
  ``lax.scan``. A prefill (a state and S > 1) runs the parallel form and
  the final state's closed form; decode the O(1) recurrent step.
* sLSTM: scalar-memory LSTM with recurrent weights and exponential gating,
  sequential in time. Decode (S == 1) takes one ``_slstm_step``. A full
  sequence or a prefill runs the time loop: on the card as CUDA graphs of
  at most ``MAX_LOOP_STEPS`` steps (``repro_torch.graphs``: one set of
  static buffers per batch size and width, a body per length, captured at
  its second run, so repeated calls capture once), each body reading a
  static slice of the gate inputs and carrying static ``c`` / ``n`` /
  ``h`` / ``m`` tensors; on the CPU the same bodies run eagerly, counted as
  on the card. :func:`slstm_loop` ``("eager")`` runs a plain step-by-step
  loop instead, bitwise the captured one; so does training (under
  autograd, where the block's weights or gate inputs need gradients: a
  graph has no backward pass). A failed capture raises; nothing falls
  back to the eager loop.

Numerics are the reference's: the gates, ``log_sigmoid``, the decay
matrix and every einsum in float32 (full float32 products on the card:
TF32 stays off), ``-inf`` masking then ``max(m, -1e30)``, the
``max(|.|, exp(-m))`` normaliser, the conv summing its taps in the input
dtype in tap order (``layers.causal_conv1d``, shared with the RG-LRU
block), outputs cast back to the input dtype. The sLSTM's
recurrent product is one batched product per head over the four gates'
weights laid side by side (the same sums as the reference's einsum).

Block structure follows the xLSTM paper: the mLSTM block is a pre-norm
up-projection (factor 2) sandwich with a causal conv on the q/k path and a
learnable skip + output gate; the sLSTM block is post-norm with a GeLU
up/down FFN of factor 4/3. States are written in place (``copy_``), so a
captured decode step reads and writes the same tensors at every replay.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.graphs import Body, GraphRunner

from . import parallel as P
from .common import ModelConfig, dtype_of, truncated_normal_
from .layers import RMSNorm, causal_conv1d, rms_norm

__all__ = [
    "MLSTMBlock",
    "SLSTMBlock",
    "init_mlstm_block",
    "mlstm_block",
    "init_mlstm_state",
    "init_slstm_block",
    "slstm_block",
    "init_slstm_state",
    "reset_state_",
    "slstm_loop",
    "loop_captures",
    "MAX_LOOP_STEPS",
]

_MLSTM_PROJ = 2.0  # up-projection factor of the mLSTM block
_SLSTM_FF = 4.0 / 3.0  # FFN factor of the sLSTM block
_M_INIT = -1e30  # the stabiliser state m of a fresh sequence


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMBlock(nn.Module):
    """``norm``, ``w_up`` / ``w_gate`` (d, d_in), ``conv_w`` (width, d_in),
    ``wq`` / ``wk`` / ``wv`` (d_in, d_in), ``w_if`` (d_in, 2h), ``b_if``
    (2h,), ``out_norm``, ``w_down`` (d_in, d); d_in = 2 d."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = dtype_of(cfg)
        d = cfg.d_model
        d_in = int(d * _MLSTM_PROJ)
        h = cfg.num_heads
        self.norm = RMSNorm(d, dt, device)
        self.w_up = _empty((d, d_in), dt, device)
        self.w_gate = _empty((d, d_in), dt, device)
        self.conv_w = _empty((cfg.conv_width, d_in), dt, device)
        self.wq = _empty((d_in, d_in), dt, device)
        self.wk = _empty((d_in, d_in), dt, device)
        self.wv = _empty((d_in, d_in), dt, device)
        self.w_if = _empty((d_in, 2 * h), dt, device)
        self.b_if = nn.Parameter(torch.zeros(2 * h, dtype=dt, device=device))
        self.out_norm = RMSNorm(d_in, dt, device)
        self.w_down = _empty((d_in, d), dt, device)

    def init_weights(self, generator: torch.Generator) -> None:
        d, d_in = self.w_up.shape
        for w in (self.w_up, self.w_gate):
            truncated_normal_(w, d**-0.5, generator)
        truncated_normal_(self.conv_w, 0.1, generator)
        for w in (self.wq, self.wk, self.wv, self.w_if, self.w_down):
            truncated_normal_(w, d_in**-0.5, generator)


def init_mlstm_block(
    cfg: ModelConfig, *, generator: torch.Generator, device: torch.device | str
) -> MLSTMBlock:
    block = MLSTMBlock(cfg, device)
    block.init_weights(generator)
    return block


def _mlstm_parallel(q, k, v, i_tilde, f_tilde):
    """Parallel mLSTM. q/k/v: (B,H,S,Dh); i_tilde/f_tilde: (B,H,S)."""
    B, H, S, Dh = q.shape
    log_f = F.logsigmoid(f_tilde.float())  # (B,H,S)
    Fc = torch.cumsum(log_f, dim=-1)
    # D[t, s] = F_t - F_s + log i_s   for s <= t
    D = Fc[..., :, None] - Fc[..., None, :] + i_tilde.float()[..., None, :]
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    D = torch.where(causal, D, float("-inf"))
    m = D.amax(dim=-1, keepdim=True).clamp(min=_M_INIT)  # (B,H,S,1); guards all -inf rows
    decay = torch.exp(D - m)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    scores = scores * (Dh**-0.5) * decay
    norm = torch.maximum(scores.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))
    h_out = torch.einsum("bhts,bhsd->bhtd", scores / norm, v.float())
    return h_out.to(q.dtype)


_CHUNK_THRESHOLD = 2048
_CHUNK = 512


def _mlstm_chunkwise(q, k, v, i_tilde, f_tilde, chunk: int = _CHUNK):
    """Chunkwise-parallel mLSTM (xLSTM paper App. formulation).

    Splits time into chunks; within a chunk the quadratic parallel form is
    used, across chunks the (C, n, m) recurrent state is carried by a
    Python loop (the reference's ``lax.scan``). Peak memory
    O(B*H*chunk*chunk) instead of O(B*H*S^2).

    q/k/v: (B,H,S,Dh); gates: (B,H,S). Returns (B,H,S,Dh).
    """
    B, H, S, Dh = q.shape
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    log_f = F.logsigmoid(f_tilde.float())
    i32 = i_tilde.float()
    q32 = q.float()
    k32 = k.float() * (Dh**-0.5)
    v32 = v.float()
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()

    C0 = torch.zeros((B, H, Dh, Dh), dtype=torch.float32, device=q.device)
    n0 = torch.zeros((B, H, Dh), dtype=torch.float32, device=q.device)
    m0 = torch.full((B, H), _M_INIT, dtype=torch.float32, device=q.device)
    hs = []
    for c0 in range(0, S, chunk):
        rows = slice(c0, c0 + chunk)
        qx, kx, vx = q32[:, :, rows], k32[:, :, rows], v32[:, :, rows]
        fx, ix = log_f[..., rows], i32[..., rows]
        Fc = torch.cumsum(fx, dim=-1)  # (B,H,chunk) decay from chunk start
        # intra-chunk log weights D[t,s] = F_t - F_s + log i_s (s <= t)
        D = Fc[..., :, None] - Fc[..., None, :] + ix[..., None, :]
        D = torch.where(causal, D, float("-inf"))
        m_intra = D.amax(dim=-1)  # (B,H,chunk)
        # inter contribution decays from the carried state: b_t = F_t + m0
        b = Fc + m0[..., None]
        m_t = torch.maximum(m_intra.clamp(min=_M_INIT), b)
        a = torch.exp(D - m_t[..., None])  # (B,H,chunk,chunk)
        scores = torch.einsum("bhtd,bhsd->bhts", qx, kx) * a
        w_inter = torch.exp(b - m_t)  # (B,H,chunk)
        inter_num = torch.einsum("bhde,bhte->bhtd", C0, qx)  # contract key dim
        num = torch.einsum("bhts,bhsd->bhtd", scores, vx) + w_inter[..., None] * inter_num
        den_dot = scores.sum(dim=-1) + w_inter * torch.einsum("bhd,bhtd->bht", n0, qx)
        den = torch.maximum(den_dot.abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])  # (B,H,chunk,Dh)

        # state update to chunk end
        F_last = Fc[..., -1]  # (B,H)
        w_log = F_last[..., None] - Fc + ix  # (B,H,chunk)
        m_new = torch.maximum(F_last + m0, w_log.amax(dim=-1))
        scale_old = torch.exp(F_last + m0 - m_new)  # (B,H)
        w = torch.exp(w_log - m_new[..., None])  # (B,H,chunk)
        C0 = scale_old[..., None, None] * C0 + torch.einsum("bhs,bhsd,bhse->bhde", w, vx, kx)
        n0 = scale_old[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", w, kx)
        m0 = m_new
    return torch.cat(hs, dim=2).to(q.dtype)


def _mlstm_recurrent_step(q, k, v, i_tilde, f_tilde, state):
    """One decode step. q/k/v: (B,H,Dh); gates: (B,H). state: dict(C,n,m).
    Returns (h, the new state as new tensors)."""
    C, n, m = state["C"], state["n"], state["m"]
    log_f = F.logsigmoid(f_tilde.float())
    m_new = torch.maximum(log_f + m, i_tilde.float())
    i_p = torch.exp(i_tilde.float() - m_new)[..., None]
    f_p = torch.exp(log_f + m - m_new)[..., None]
    k32, v32, q32 = k.float(), v.float(), q.float()
    Dh = q.shape[-1]
    k32 = k32 * (Dh**-0.5)
    C_new = f_p[..., None] * C + i_p[..., None] * (v32[..., :, None] * k32[..., None, :])
    n_new = f_p * n + i_p * k32
    num = torch.einsum("bhdk,bhk->bhd", C_new, q32)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, q32).abs()[..., None],
                        torch.exp(-m_new)[..., None])
    h = (num / den).to(q.dtype)
    return h, {"C": C_new, "n": n_new, "m": m_new}


def _mlstm_step_split(q, k, v, i_tilde, f_tilde, state, tp):
    """One decode step on a state split over ``tp`` by its last dimension
    (``serve.engine``'s cache specs: ``C`` (B, H, dh, dh / m), ``n`` (B, H,
    dh / m), ``m`` (B, H) or its head block): q / k / v (B, H, dh) and the
    gates (B, H) of every head. The state's update is elementwise on the
    rank's block of the key dimension; the readout's products over it are
    summed over the ranks. Returns (h (B, H, dh), the new state's block)."""
    C, n, m = state["C"], state["n"], state["m"]
    H, Dh = q.shape[1], q.shape[-1]
    m_all = m if m.shape[-1] == H else P.gather_dim(m, tp, m.ndim - 1)
    log_f = F.logsigmoid(f_tilde.float())
    m_new = torch.maximum(log_f + m_all, i_tilde.float())
    i_p = torch.exp(i_tilde.float() - m_new)[..., None]
    f_p = torch.exp(log_f + m_all - m_new)[..., None]
    kb = P.own_block(k.float() * (Dh**-0.5), tp, 2)
    qb = P.own_block(q.float(), tp, 2)
    C_new = f_p[..., None] * C + i_p[..., None] * (v.float()[..., :, None] * kb[..., None, :])
    n_new = f_p * n + i_p * kb
    num = P.reduce_from(torch.einsum("bhdk,bhk->bhd", C_new, qb), tp)
    dot = P.reduce_from(torch.einsum("bhk,bhk->bh", n_new, qb), tp)
    den = torch.maximum(dot.abs()[..., None], torch.exp(-m_new)[..., None])
    h = (num / den).to(q.dtype)
    m_out = m_new if m.shape[-1] == H else P.own_block(m_new, tp, 1)
    return h, {"C": C_new, "n": n_new, "m": m_out}


def _mlstm_prefill_state(k, v, i_tilde, f_tilde):
    """The closed form of the state after a prefill from a fresh state:
    C_T, n_T, m_T of the exp-gate weights at the last position."""
    dh = k.shape[-1]
    log_f = F.logsigmoid(f_tilde.float())
    Fc = torch.cumsum(log_f, dim=-1)  # (B,h,S)
    w_log = Fc[..., -1:] - Fc + i_tilde.float()  # exp-gate weights at T
    m_T = w_log.amax(dim=-1)  # (B,h)
    w = torch.exp(w_log - m_T[..., None])  # (B,h,S)
    k_sc = k.float() * (dh**-0.5)
    C_T = torch.einsum("bhs,bhsd,bhse->bhde", w, v.float(), k_sc)
    n_T = torch.einsum("bhs,bhsd->bhd", w, k_sc)
    return {"C": C_T, "n": n_T, "m": m_T}


def init_mlstm_state(
    cfg: ModelConfig, batch: int, device: torch.device | str | None = None
) -> dict:
    """A fresh mLSTM state on ``device`` (None = CUDA): C, n zero, m -1e30,
    the conv tail zero."""
    device = resolve_device(device)
    d_in = int(cfg.d_model * _MLSTM_PROJ)
    h = cfg.num_heads
    dh = d_in // h
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
        "m": torch.full((batch, h), _M_INIT, dtype=f32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_in), dtype=dtype_of(cfg),
                            device=device),
    }


def mlstm_block(
    params: MLSTMBlock, cfg: ModelConfig, x: torch.Tensor, state: dict | None = None,
    tp: P.TPGroup | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """x: (B,S,D) -> (x + block(x), state). Parallel (or chunkwise) form
    when state is None; the recurrent step at S == 1; a prefill (S > 1,
    from a fresh state) otherwise. A given state is written in place.

    ``tp`` (a split replica): up / gate branches by
    columns, the conv on the rank's features, q / k / v by columns from
    the gathered conv and up branches, the gates (``w_if`` whole) for the
    rank's heads, the output norm over the split features, ``w_down`` by
    rows. Heads split inside a head are gathered; the rank runs every head
    its columns touch and keeps its columns. A state split by its last
    dimension (``serve.engine``'s cache specs; the conv tail by the rank's
    features): a decode step gathers every head's q / k / v and runs
    ``_mlstm_step_split``; a prefill's closed-form state takes every
    head's keys and values and keeps its block."""
    B, S, D = x.shape
    h = cfg.num_heads
    ctp = tp  # the state's block follows the cache specs
    tp = P.split(tp, params.w_up.shape[1], int(D * _MLSTM_PROJ))
    xn = P.copy_to(rms_norm(params.norm, x, cfg.norm_eps), tp)
    up = xn @ params.w_up  # (B,S,d_in): the rank's columns under tp
    gate = xn @ params.w_gate
    d_in = up.shape[-1]
    dh = params.wq.shape[0] // h
    split_state = state is not None and state["C"].shape[-1] < dh
    if split_state and tp is None:
        raise ValueError("an mLSTM state split over model needs the block split with it")

    conv_w = params.conv_w
    if conv_w.shape[-1] != d_in:
        conv_w = P.slice_last(conv_w, tp)
    conv_out, new_conv = causal_conv1d(up, conv_w, None if state is None else state["conv"])
    conv_out = F.silu(conv_out)

    conv_full, up_full = P.branch(conv_out, tp), P.branch(up, tp)
    q, k, v = conv_full @ params.wq, conv_full @ params.wk, up_full @ params.wv
    gates = conv_full @ P.copy_to(params.w_if, tp) + P.copy_to(params.b_if, tp)  # (B,S,2h)
    if split_state:
        # every head's q / k / v (the rank's columns gathered): the state's
        # block spans every head
        qa, ka, va = (P.gather_last(t, tp).reshape(B, S, h, dh).transpose(1, 2)
                      for t in (q, k, v))
    lo, hi, off = P.touched(h, dh, tp)
    if split_state and S == 1:
        lo, hi, off = 0, h, tp.rank * d_in
        q, k, v = qa, ka, va
    else:
        if tp is not None and h % tp.size:
            q, k, v = (P.gather_last_partial(t, tp)[..., lo * dh:hi * dh] for t in (q, k, v))
        q, k, v = (t.reshape(B, S, hi - lo, dh).transpose(1, 2) for t in (q, k, v))
    i_tilde = gates[..., lo:hi].transpose(1, 2)  # (B,h,S)
    f_tilde = gates[..., h + lo:h + hi].transpose(1, 2)

    if state is None:
        if S > _CHUNK_THRESHOLD and S % _CHUNK == 0:
            h_out = _mlstm_chunkwise(q, k, v, i_tilde, f_tilde)
        else:
            h_out = _mlstm_parallel(q, k, v, i_tilde, f_tilde)  # (B,h,S,dh)
    else:
        if S == 1 and split_state:
            h_step, new = _mlstm_step_split(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                            i_tilde[:, :, 0], f_tilde[:, :, 0], state, ctp)
            h_out = h_step[:, :, None, :]
        elif S == 1:
            if state["C"].shape[1] != hi - lo:
                raise ValueError("an mLSTM state of every head beside split heads")
            h_step, new = _mlstm_recurrent_step(
                q[:, :, 0], k[:, :, 0], v[:, :, 0], i_tilde[:, :, 0], f_tilde[:, :, 0], state)
            h_out = h_step[:, :, None, :]  # (B,h,1,dh)
        else:
            # Prefill: parallel output + closed-form final state (assumes the
            # incoming state is fresh, which is how the serve engine starts a
            # prefill: transformer.reset_cache_)
            h_out = _mlstm_parallel(q, k, v, i_tilde, f_tilde)
            if split_state:
                new = _mlstm_prefill_state(ka, va,
                                           gates[..., :h].transpose(1, 2),
                                           gates[..., h:].transpose(1, 2))
                new = {"C": P.own_block(new["C"], ctp, 3), "n": P.own_block(new["n"], ctp, 2),
                       "m": new["m"] if state["m"].shape[-1] == h else
                       P.own_block(new["m"], ctp, 1)}
            else:
                new = _mlstm_prefill_state(k, v, i_tilde, f_tilde)
        for name, value in new.items():
            state[name].copy_(value)
        state["conv"].copy_(new_conv)

    h_seq = h_out.transpose(1, 2).reshape(B, S, (hi - lo) * dh)
    if tp is not None:
        h_seq = h_seq[..., off:off + d_in]
    h_seq = P.split_rms_norm(h_seq, params.out_norm, cfg.norm_eps, tp)
    out = (h_seq * F.silu(gate)) @ params.w_down
    return x + P.reduce_from(out, tp), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMBlock(nn.Module):
    """``norm``, ``w_in`` (d, 4d) and ``b_in`` (4d,) for the gates z, i, f,
    o; ``r`` (4, h, dh, dh) per-head recurrent weights; ``out_norm``,
    ``ffn_norm``, ``w_ff_up`` (d, ff), ``w_ff_down`` (ff, d); ff = 4/3 d."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = dtype_of(cfg)
        d = cfg.d_model
        h = cfg.num_heads
        dh = d // h
        ff = int(d * _SLSTM_FF)
        self.norm = RMSNorm(d, dt, device)
        self.w_in = _empty((d, 4 * d), dt, device)
        self.b_in = nn.Parameter(torch.zeros(4 * d, dtype=dt, device=device))
        self.r = _empty((4, h, dh, dh), dt, device)
        self.out_norm = RMSNorm(d, dt, device)
        self.ffn_norm = RMSNorm(d, dt, device)
        self.w_ff_up = _empty((d, ff), dt, device)
        self.w_ff_down = _empty((ff, d), dt, device)

    def init_weights(self, generator: torch.Generator) -> None:
        d, ff = self.w_ff_up.shape
        truncated_normal_(self.w_in, d**-0.5, generator)
        truncated_normal_(self.r, self.r.shape[-1] ** -0.5, generator)
        truncated_normal_(self.w_ff_up, d**-0.5, generator)
        truncated_normal_(self.w_ff_down, ff**-0.5, generator)


def init_slstm_block(
    cfg: ModelConfig, *, generator: torch.Generator, device: torch.device | str
) -> SLSTMBlock:
    block = SLSTMBlock(cfg, device)
    block.init_weights(generator)
    return block


def init_slstm_state(
    cfg: ModelConfig, batch: int, device: torch.device | str | None = None,
    heads: int | None = None,
) -> dict:
    """A fresh sLSTM state on ``device`` (None = CUDA): c, n, h zero, m
    -1e30, for ``heads`` of the model's heads (default: all). Three zero
    tensors, where the reference shares one array: the states are written
    in place, and aliases would overwrite one another."""
    device = resolve_device(device)
    h = cfg.num_heads
    shape = (batch, h if heads is None else heads, cfg.d_model // h)
    state = {k: torch.zeros(shape, dtype=torch.float32, device=device) for k in ("c", "n", "h")}
    state["m"] = torch.full(shape, _M_INIT, dtype=torch.float32, device=device)
    return state


def reset_state_(state: dict) -> dict:
    """Put an mLSTM or sLSTM state back to its fresh values in place: m to
    -1e30, everything else to zero."""
    for name, t in state.items():
        t.fill_(_M_INIT if name == "m" else 0)
    return state


def _recurrent_weights(r: torch.Tensor) -> torch.Tensor:
    """``r`` (4, h, dh, dh) as float32 (h, dh, 4 dh): each head's four gate
    matrices side by side, for one batched product per step."""
    g, h, dh, _ = r.shape
    return r.float().permute(1, 2, 0, 3).reshape(h, dh, g * dh)


def _slstm_cell(rr: torch.Tensor, state: dict, x_t: torch.Tensor) -> dict:
    """One sLSTM step with the recurrent weights ``rr`` of
    ``_recurrent_weights``. x_t: (B, 4d) pre-projected gate inputs; state:
    dict(c, n, h, m) of (B, h, dh). Returns the new state (new tensors)."""
    B = x_t.shape[0]
    h_heads, dh = rr.shape[0], rr.shape[1]
    c, n, h_prev, m = state["c"], state["n"], state["h"], state["m"]
    # recurrent contribution: per-gate, per-head  h_prev @ r[g, head]
    rec = torch.bmm(h_prev.transpose(0, 1), rr)  # (h, B, 4 dh)
    rec = rec.reshape(h_heads, B, 4, dh).permute(2, 1, 0, 3)  # (4, B, h, dh)
    gates = x_t.reshape(B, 4, h_heads, dh).transpose(0, 1).float() + rec
    z_t = torch.tanh(gates[0])
    i_tilde = gates[1]
    f_tilde = gates[2]
    o_t = torch.sigmoid(gates[3])
    log_f = F.logsigmoid(f_tilde)
    decayed = log_f + m  # the reference forms it twice; the same value
    m_new = torch.maximum(decayed, i_tilde)
    i_p = torch.exp(i_tilde - m_new)
    f_p = torch.exp(decayed - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = torch.maximum(f_p * n + i_p, torch.exp(-m_new))
    h_new = o_t * (c_new / n_new)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_step(params: SLSTMBlock, cfg: ModelConfig, state: dict, x_t: torch.Tensor) -> dict:
    """x_t: (B, 4d) pre-projected gate inputs. state: dict(c, n, h, m)."""
    return _slstm_cell(_recurrent_weights(params.r), state, x_t)


MAX_LOOP_STEPS = 64  # steps in one captured body of the sLSTM time loop
_LOOP_MODES = ("captured", "eager")
_loop_mode = ["captured"]


@contextlib.contextmanager
def slstm_loop(mode: str) -> Iterator[None]:
    """Run the sLSTM time loop ``"captured"`` (the default: CUDA graphs of
    at most ``MAX_LOOP_STEPS`` steps on the card, the same bodies eagerly on
    the CPU) or ``"eager"`` (one step at a time) inside the block."""
    if mode not in _LOOP_MODES:
        raise ValueError(f"mode must be one of {_LOOP_MODES}, got {mode!r}")
    was = _loop_mode[0]
    _loop_mode[0] = mode
    try:
        yield
    finally:
        _loop_mode[0] = was


class _LoopBuffers:
    """The static tensors and bodies of the captured sLSTM loop for one
    (device, batch, heads, head width): the recurrent weights ``rr``, the
    carried ``c`` / ``n`` / ``h`` / ``m``, and per body length T its input
    slice (T, B, 4d) and output (T, B, h, dh), all float32."""

    @torch.inference_mode(False)  # normal tensors: usable in and out of inference mode
    def __init__(self, device: torch.device, B: int, h: int, dh: int):
        f32 = torch.float32
        self.rr = torch.empty((h, dh, 4 * dh), dtype=f32, device=device)
        self.carry = {k: torch.empty((B, h, dh), dtype=f32, device=device)
                      for k in ("c", "n", "h", "m")}
        self.graphs = GraphRunner("xlstm.slstm_loop", device)
        self._bodies: dict[int, tuple[Body, torch.Tensor, torch.Tensor]] = {}
        self._shape = (B, h, dh, device)

    @torch.inference_mode(False)
    def body(self, T: int) -> tuple[Body, torch.Tensor, torch.Tensor]:
        if T not in self._bodies:
            B, h, dh, device = self._shape
            x = torch.empty((T, B, 4 * h * dh), dtype=torch.float32, device=device)
            out = torch.empty((T, B, h, dh), dtype=torch.float32, device=device)

            def fn() -> None:
                st = self.carry
                hs = []
                for t in range(T):
                    st = _slstm_cell(self.rr, st, x[t])
                    hs.append(st["h"])
                torch.stack(hs, out=out)
                for name, value in st.items():
                    self.carry[name].copy_(value)

            self._bodies[T] = (Body(fn), x, out)
        return self._bodies[T]


_LOOPS: dict[tuple, _LoopBuffers] = {}


def loop_captures() -> int:
    """Captures of the sLSTM loop's bodies so far, over every shape (on the
    CPU: the runs that would capture)."""
    return sum(buf.graphs.n_traces for buf in _LOOPS.values())


def _slstm_eager(rr: torch.Tensor, xs: torch.Tensor, init: dict) -> tuple[torch.Tensor, dict]:
    """The sLSTM time loop step by step over xs (S, B, 4d) float32, under
    autograd where its inputs need gradients: (h at every step (S, B, h,
    dh), the final state)."""
    st, hs = init, []
    for t in range(xs.shape[0]):
        st = _slstm_cell(rr, st, xs[t])
        hs.append(st["h"])
    return torch.stack(hs), st


def _slstm_scan(params: SLSTMBlock, gate_in: torch.Tensor, init: dict) -> tuple[torch.Tensor, dict]:
    """The sLSTM time loop over gate_in (B, S, 4d) from ``init``: (h at every
    step (S, B, h, dh) float32, the final state)."""
    B, S, _ = gate_in.shape
    rr = _recurrent_weights(params.r)
    xs = gate_in.float().transpose(0, 1)  # (S, B, 4d), cast once rather than at each step
    if _loop_mode[0] == "eager" or torch.is_grad_enabled() and (
            gate_in.requires_grad or params.r.requires_grad):
        # step by step (training: the captured loop has no backward pass)
        return _slstm_eager(rr, xs, init)
    h, dh = rr.shape[0], rr.shape[1]
    key = (str(gate_in.device), B, h, dh)
    if key not in _LOOPS:
        _LOOPS[key] = _LoopBuffers(gate_in.device, B, h, dh)
    buf = _LOOPS[key]
    buf.rr.copy_(rr)
    for name, value in init.items():
        buf.carry[name].copy_(value)
    hs = torch.empty((S, B, h, dh), dtype=torch.float32, device=gate_in.device)
    for t0 in range(0, S, MAX_LOOP_STEPS):
        T = min(MAX_LOOP_STEPS, S - t0)
        body, x, out = buf.body(T)
        x.copy_(xs[t0 : t0 + T])
        buf.graphs.run(body, f"sLSTM loop body of {T} steps")
        hs[t0 : t0 + T].copy_(out)
    return hs, buf.carry


def slstm_block(
    params: SLSTMBlock, cfg: ModelConfig, x: torch.Tensor, state: dict | None = None,
    tp: P.TPGroup | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """x: (B,S,D) -> (block(x), state). The time loop (state None, or a
    prefill with S > 1, from the given state); one step at S == 1 with a
    state. A given state is written in place.

    ``tp`` (a split replica), where the rules split
    them: the gate inputs gathered whole (``w_in``'s contiguous columns
    hand a rank whole gates, not heads); the time loop on the rank's
    heads of ``r`` (their hidden states gathered after it); the FFN by
    columns / rows. The rest computes whole. A state split by its last
    dimension (``serve.engine``'s cache specs) is gathered whole before
    the loop, the new state's heads gathered after it and its block
    kept."""
    B, S, D = x.shape
    H = cfg.num_heads
    dh = D // H
    ctp = tp  # the state's block follows the cache specs
    xn = rms_norm(params.norm, x, cfg.norm_eps)
    heads = P.split(tp, params.r.shape[1], H)
    cols = P.split(tp, params.w_in.shape[1], 4 * D)
    if cols is not None:
        g = P.copy_to(xn, cols) @ params.w_in
        gate_in = P.gather_last_partial(g, cols) if heads else P.gather_last(g, cols)
    else:
        gate_in = P.copy_to(xn, heads) @ P.copy_to(params.w_in, heads)
    gate_in = gate_in + P.copy_to(params.b_in, heads)  # (B,S,4D)
    Hl = params.r.shape[1]
    h0 = 0 if heads is None else heads.rank * Hl
    if heads is not None:
        gate_in = gate_in.reshape(B, S, 4, H, dh)[:, :, :, h0:h0 + Hl].reshape(B, S, 4 * Hl * dh)
    split_state = state is not None and state["c"].shape[-1] < dh
    run = state
    if state is not None and (split_state or heads is not None):
        # the rank's heads of the whole state
        run = {k: (P.gather_dim(v, ctp, 2) if split_state else v)[:, h0:h0 + Hl]
               for k, v in state.items()}

    if state is None or S > 1:
        init = run if run is not None else init_slstm_state(cfg, B, x.device, Hl)
        hs, final = _slstm_scan(params, gate_in, init)  # (S,B,h,dh)
        h_seq = P.gather_last(hs.transpose(0, 1).reshape(B, S, Hl * dh).to(x.dtype), heads)
    else:
        final = _slstm_step(params, cfg, run, gate_in[:, 0])
        h_seq = P.gather_dim(final["h"], heads, 1).reshape(B, 1, D).to(x.dtype)
    if state is not None:
        for name, value in final.items():
            if heads is not None:
                value = P.gather_dim(value, heads, 1)
            if split_state:
                value = P.own_block(value, ctp, 2)
            state[name].copy_(value)

    h_seq = rms_norm(params.out_norm, h_seq, cfg.norm_eps)
    y = x + h_seq
    # post FFN (factor 4/3, GeLU)
    ff = P.split(tp, params.w_ff_up.shape[1], int(D * _SLSTM_FF))
    ffn_in = P.copy_to(rms_norm(params.ffn_norm, y, cfg.norm_eps), ff)
    ffn = F.gelu(ffn_in @ params.w_ff_up, approximate="tanh") @ params.w_ff_down
    return y + P.reduce_from(ffn, ff), state
