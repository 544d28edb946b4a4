"""The flash-attention backward kernels on the card: gradients against
autograd through the plain version, bitwise repeatability, and the
launch count of a captured training segment.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). This file imports no JAX, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_bwd_cuda.py

Tolerances. The reference is autograd through ``flash_attention_ref`` in
float32 on the same bfloat16 inputs (upcast), on the card with TF32 off.
The kernels round dq, dk and dv to bfloat16 once (half an ulp: 2^-8 of
the value at most); their float32 sums run in another order, and P and
dS enter the products as two bfloat16 parts (~16 bits each): so each
element within 2^-7 of its reference value, relative (twice the
rounding), plus 2^-9 of the tensor's largest reference magnitude (an
element whose sum cancels has no relative scale; 2^-9 of the largest is
under a bf16 ulp of it), plus 1e-6 where the whole gradient is zero (at
S = 1 dq and dk are: the kernels' difference of two float32 sums of
dO v there is a few float32 ulps). The float32 reference's own bfloat16
rounding passes the same test.

That bound would also pass a backward that fed P and dS to the tensor
cores as one bfloat16 part each: the rounding of a P or dS is of the
output's order, and the sums average it down. So
``test_backward_keeps_p_and_ds_to_two_bf16_parts`` holds the RMS error
instead: a one-part backward, emulated in float32 with P and dS rounded
to bfloat16, adds its own rounding to the outputs' and reads about
sqrt(2) times the error of the outputs' rounding alone (0.71 to 0.72 for
dq, dk and dv at the cell's shape); the kernels must read at most 0.85 of
it.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.train.lm_trainer import make_train_setup  # noqa: E402

REL = 2.0 ** -7
ABS = 2.0 ** -9
FLOOR = 1e-6  # for a gradient that is exactly zero (one position: dq = dk = 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa_ops.reset_launch_counts()
    return torch.device("cuda")


def _randn(shape, device, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=gen)).to(torch.bfloat16).to(device)


def _inputs(B, S, H, Hkv, D, device, seed=0):
    q = _randn((B, S, H, D), device, seed + 1)
    k = _randn((B, S, Hkv, D), device, seed + 2)
    v = _randn((B, S, Hkv, D), device, seed + 3)
    dout = _randn((B, S, H, D), device, seed + 4)
    return q, k, v, dout


def _kernel_grads(q, k, v, dout, **kw):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, **kw)
    return out, torch.autograd.grad(out, leaves, dout)


def _plain_grads(q, k, v, dout, **kw):
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(*leaves, **kw)
    return out, torch.autograd.grad(out, leaves, dout.float())


def _excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (REL |want| + ABS max |want| + FLOOR): at most 1
    holds."""
    want = want.float()
    err = (got.float() - want).abs()
    return float((err / (REL * want.abs() + ABS * want.abs().max() + FLOOR)).max())


CASES = [
    # (B, S, H, Hkv, D, window, softcap)
    (2, 1024, 16, 8, 128, None, 0.0),   # qwen3-0.6b's layer, the LM cell's shape
    (2, 1000, 16, 8, 128, None, 0.0),   # ragged S
    (1, 129, 4, 4, 128, None, 0.0),     # one row past a tile, group 1
    (2, 700, 8, 2, 128, 100, 0.0),      # window, group 4
    (2, 600, 8, 4, 128, None, 50.0),    # softcap
    (1, 333, 4, 2, 32, None, 0.0),      # head dims
    (1, 333, 4, 2, 64, 77, 30.0),
    (1, 333, 4, 1, 256, None, 0.0),
    (2, 513, 8, 4, 256, 200, 50.0),     # gemma2's local layer, cut down
    (1, 1, 4, 2, 128, None, 0.0),       # one position
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,window,softcap", CASES)
def test_flash_attention_grads_match_plain_on_card(cuda, B, S, H, Hkv, D, window, softcap):
    q, k, v, dout = _inputs(B, S, H, Hkv, D, cuda, seed=S + D)
    kw = dict(window=window, softcap=softcap)
    out, got = _kernel_grads(q, k, v, dout, **kw)
    _, want = _plain_grads(q, k, v, dout, **kw)
    torch.cuda.synchronize()
    assert fa_ops.launch_counts == {"flash_attention": 1, "flash_attention_bwd": 1}
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g.float()).all(), name
        assert _excess(w.to(torch.bfloat16), w) <= 1.0, name  # the rounding alone passes
        assert _excess(g, w) <= 1.0, (name, _excess(g, w))


def _one_part_grads(q, k, v, dout):
    """Causal dq, dk, dv as a backward that rounds P and dS to one bfloat16
    part each before their products would give them: float32 otherwise
    (the products of the card's float32 matmuls with TF32 off), the
    outputs rounded once to bfloat16."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, dout))  # (B, H, S, D)
    kf, vf = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)
    scale = D ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax((qf @ kf.transpose(-1, -2) * scale).masked_fill(~causal, -math.inf), -1)
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * (p @ vf)).sum(-1, keepdim=True)
    p1 = p.to(torch.bfloat16).float()
    ds1 = (p * (dp - delta) * scale).to(torch.bfloat16).float()
    dq = ds1 @ kf
    dk = (ds1.transpose(-1, -2) @ qf).unflatten(1, (-1, G)).sum(2)
    dv = (p1.transpose(-1, -2) @ dof).unflatten(1, (-1, G)).sum(2)
    return [t.transpose(1, 2).to(torch.bfloat16) for t in (dq, dk, dv)]


def _rms(t: torch.Tensor) -> float:
    return float(t.float().pow(2).mean().sqrt())


@pytest.mark.cuda
def test_backward_keeps_p_and_ds_to_two_bf16_parts(cuda):
    """At the LM cell's layer the kernels' RMS error against the float32
    plain backward is at most 0.85 of a one-part backward's (module
    docstring): P and dS enter the products as two bfloat16 parts."""
    q, k, v, dout = _inputs(2, 1024, 16, 8, 128, cuda, seed=11)
    _, got = _kernel_grads(q, k, v, dout)
    _, want = _plain_grads(q, k, v, dout)
    one = _one_part_grads(q, k, v, dout)
    for name, g, w, o in zip("qkv", got, want, one):
        assert _excess(o, w) <= 1.0, name  # the elementwise bound cannot tell them apart
        ratio = _rms(g.float() - w) / _rms(o.float() - w)
        assert ratio <= 0.85, (name, ratio)


@pytest.mark.cuda
def test_flash_attention_non_causal_grads_on_card(cuda):
    q, k, v, dout = _inputs(1, 300, 4, 2, 64, cuda, seed=7)
    for window in (None, 77):
        _, got = _kernel_grads(q, k, v, dout, causal=False, window=window)
        _, want = _plain_grads(q, k, v, dout, causal=False, window=window)
        for g, w in zip(got, want):
            assert _excess(g, w) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("D,window,softcap", [(128, None, 0.0), (256, 100, 50.0)])
def test_flash_attention_backward_is_bitwise_repeatable(cuda, D, window, softcap):
    q, k, v, dout = _inputs(2, 1024, 16, 8, D, cuda, seed=5)
    kw = dict(window=window, softcap=softcap)
    out1, g1 = _kernel_grads(q, k, v, dout, **kw)
    out2, g2 = _kernel_grads(q, k, v, dout, **kw)
    assert torch.equal(out1, out2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.cuda
def test_flash_attention_forward_outputs_do_not_change_the_inference_launch(cuda):
    """The forward under autograd writes its saved outputs beside the
    bf16 one; the bf16 output is the inference launch's, bitwise."""
    q, k, v, _ = _inputs(2, 1000, 16, 8, 128, cuda, seed=9)
    inference = fa_ops.flash_attention(q, k, v, window=300)
    training, _ = _kernel_grads(q, k, v, torch.ones_like(q), window=300)
    assert torch.equal(inference, training)


@pytest.mark.cuda
def test_flash_attention_float32_grad_still_raises(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        fa_ops.flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        fa_ops.flash_attention(q, q, q)  # no grad: the forward kernel, no backward
    assert fa_ops.launch_counts == {"flash_attention": 1, "flash_attention_bwd": 0}


@pytest.mark.cuda
def test_captured_segment_counts_one_backward_a_layer_node_step(cuda):
    """qwen3-0.6b (28 layers) in bfloat16 on 4 stacked nodes trains through
    the kernels by default: a replayed 8-step captured segment counts
    28 x 4 x 8 = 896 backward calls, as many forwards, and runs no
    ``_sdpa``."""
    from repro_torch.models import attention

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="bfloat16")
    n, steps, B, S = 4, 8, 1, 128
    setup = make_train_setup(cfg, n_nodes=n, lr=1e-3, device=cuda)
    assert setup._core.loss_module.impl == "kernel"
    params = setup.init_params(0)
    multi = setup.multi_step_fn("scan")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (steps, n, B, S), generator=g).to(cuda)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    p, o = params, None
    calls = []
    plain = attention._sdpa
    attention._sdpa = lambda *a, **kw: calls.append(1) or plain(*a, **kw)
    try:
        for _ in range(2):  # the eager warm-up, then the capture (and its replay)
            p, o, lo = multi(p, o, batches)
        fa_ops.reset_launch_counts()
        p, o, lo = multi(p, o, batches)  # a replay
        torch.cuda.synchronize()
    finally:
        attention._sdpa = plain
    assert multi.n_traces == 1 and torch.isfinite(lo).all()
    assert fa_ops.launch_counts == {"flash_attention": 896, "flash_attention_bwd": 896}
    assert not calls
