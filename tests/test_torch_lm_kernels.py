"""The port's flash_attention and rglru_scan wrappers against the reference's.

On the CPU the port's ``ops.flash_attention`` / ``ops.rglru_scan`` run
their plain versions; they are held against the reference's ``ops``
functions as the reference's own tests run them (Pallas interpret mode
from S = 128 / 256 up, its jnp oracle below) at the reference's
tolerances: flash attention 2e-3 (float32) and 3e-2 (bfloat16),
``tests/test_kernels.py``; the scan 1e-4 and 3e-2,
``tests/test_kernel_rglru.py``. The CUDA kernels themselves are held
against the plain versions on the card in ``test_torch_lm_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.flash_attention import flash_attention as J_flash  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as J_scan  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref as port_scan_ref  # noqa: E402

JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_scan_ref = jax.jit(rglru_scan_ref)  # eager associative_scan takes seconds a call


def _pair(x: np.ndarray, dtype: str):
    """The same values for both packages: numpy rounded to ``dtype`` once."""
    j = jnp.asarray(x, JAX_DTYPE[dtype])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TORCH_DTYPE[dtype])


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# the reference's CASES (tests/test_kernels.py:60-69) plus S < 128, where
# the reference's ops fall back to its oracle and the port's kernel does not
CASES = [
    # (B, S, H, Hkv, D, window, softcap)
    (1, 128, 2, 2, 64, None, 0.0),
    (2, 256, 4, 2, 64, None, 0.0),
    (1, 256, 4, 1, 128, None, 0.0),   # MQA
    (1, 256, 4, 4, 32, 64, 0.0),      # sliding window
    (1, 384, 2, 2, 128, None, 50.0),  # softcap (gemma2)
    (1, 128, 8, 4, 256, 128, 0.0),    # gemma-style 256 head dim + window
    (2, 512, 4, 2, 64, 100, 30.0),    # window + softcap + odd window
    (2, 1, 4, 1, 64, None, 0.0),      # one position
    (1, 100, 10, 1, 256, 33, 50.0),   # recurrentgemma heads, ragged S < 128
]


@pytest.mark.parametrize("B,S,H,Hkv,D,window,softcap", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(B, S, H, Hkv, D, window, softcap, dtype):
    rng = np.random.default_rng(B * 1000 + S + D)
    qj, qt = _pair(rng.normal(size=(B, S, H, D)), dtype)
    kj, kt = _pair(rng.normal(size=(B, S, Hkv, D)), dtype)
    vj, vt = _pair(rng.normal(size=(B, S, Hkv, D)), dtype)
    fa_ops.reset_launch_counts()
    out = fa_ops.flash_attention(qt, kt, vt, causal=True, window=window, softcap=softcap)
    ref = J_flash(qj, kj, vj, causal=True, window=window, softcap=softcap)
    assert out.dtype == TORCH_DTYPE[dtype] and out.shape == (B, S, H, D)
    _close(out, ref, 2e-3 if dtype == "float32" else 3e-2)
    assert fa_ops.launch_counts["flash_attention"] == 0  # the CPU runs no kernel


def test_flash_attention_non_causal_matches_reference_ref():
    from repro.kernels.flash_attention import flash_attention_ref as J_ref

    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 40, 4, 32)) for _ in range(3))
    args = [_pair(x, "float32") for x in (q, k[:, :, :2], v[:, :, :2])]
    out = fa_ops.flash_attention(*(t for _, t in args), causal=False, window=7)
    ref = J_ref(*(j for j, _ in args), causal=False, window=7)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize(
    "shapes,kwargs,err",
    [
        (((1, 8, 2, 48), (1, 8, 2, 48)), {}, ValueError),     # head dim 48
        (((1, 8, 3, 32), (1, 8, 2, 32)), {}, ValueError),     # Hkv does not divide H
        (((1, 8, 2, 32), (1, 9, 2, 32)), {}, ValueError),     # S differs
        (((1, 8, 2, 32), (1, 8, 2, 32)), {"window": 0}, ValueError),
    ],
)
def test_flash_attention_rejects_bad_inputs(shapes, kwargs, err):
    q = torch.zeros(shapes[0])
    kv = torch.zeros(shapes[1])
    with pytest.raises(err):
        fa_ops.flash_attention(q, kv, kv, **kwargs)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))


GRAD_CASES = [c for c in CASES if c[1] > 1] + [(1, 70, 4, 4, 64, None, 20.0)]


@pytest.mark.parametrize("B,S,H,Hkv,D,window,softcap", GRAD_CASES)
def test_flash_attention_grads_match_plain_sdpa_on_cpu(B, S, H, Hkv, D, window, softcap):
    """On the CPU autograd differentiates ``ops.flash_attention`` (its
    plain version): dq, dk, dv equal those of the training path's plain
    ``_sdpa`` under the same causal / window mask, in float32 (1e-5: two
    float32 softmaxes, their sums in other orders)."""
    from types import SimpleNamespace

    from repro_torch.models.attention import _causal_mask, _sdpa

    rng = np.random.default_rng(S + D + H)
    leaves = [torch.tensor(rng.normal(size=shape), dtype=torch.float32, requires_grad=True)
              for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    dout = torch.tensor(rng.normal(size=(B, S, H, D)), dtype=torch.float32)
    out = fa_ops.flash_attention(*leaves, window=window, softcap=softcap)
    got = torch.autograd.grad(out, leaves, dout)
    plain = _sdpa(*leaves, _causal_mask(S, S, window), SimpleNamespace(attn_logit_softcap=softcap))
    want = torch.autograd.grad(plain, leaves, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_flash_attention_grads_through_the_smoke_lm_on_cpu():
    """qwen3-0.6b's smoke config (float32): every parameter's gradient of
    the loss through ``impl="kernel"`` (autograd through
    ``ops.flash_attention``) equals that through ``impl="plain"``
    (``_sdpa``) within 1e-5 relative plus 1e-6 of the leaf's largest
    magnitude."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry

    cfg = get_smoke_config("qwen3-0.6b")
    model = registry.init_model(cfg, seed=0, device="cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 48)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    params = [p.requires_grad_() for _, p in model.named_parameters()]
    grads = {}
    for impl in ("kernel", "plain"):
        loss = registry.loss_fn(model, cfg, batch, impl=impl)[0]
        grads[impl] = torch.autograd.grad(loss, params)
    for g, w in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(g, w, atol=1e-6 * float(w.abs().max()) + 1e-12, rtol=1e-5)


def test_tensor_parallel_loss_takes_the_trainers_impl(monkeypatch):
    """The mesh trainers' forward (``tensor_parallel.lm_loss``, here on
    one rank with every leaf whole) attends through ``ops.flash_attention``
    once a layer under ``impl="kernel"``, which the trainer resolves to on
    the card, and not under ``impl="plain"``; the losses and gradients
    agree (float32, 1e-5)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry
    from repro_torch.train import tensor_parallel

    cfg = get_smoke_config("qwen3-0.6b")
    model = registry.init_model(cfg, seed=0, device="cpu")
    params = {k: p.detach().requires_grad_() for k, p in model.named_parameters()}
    plan = tensor_parallel.make_plan(cfg, {k: (None,) * p.ndim for k, p in params.items()}, 1)
    toks = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    calls = []
    flash = fa_ops.flash_attention
    monkeypatch.setattr(fa_ops, "flash_attention", lambda *a, **kw: calls.append(1) or
                        flash(*a, **kw))
    out = {}
    for impl in ("kernel", "plain"):
        calls.clear()
        loss = tensor_parallel.lm_loss(params, cfg, batch, plan,
                                       tensor_parallel.TPGroup.of(None), impl=impl)
        out[impl] = (loss, torch.autograd.grad(loss, list(params.values())), len(calls))
    assert out["kernel"][2] == cfg.num_layers and out["plain"][2] == 0
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], atol=1e-5, rtol=1e-5)
    for g, w in zip(out["kernel"][1], out["plain"][1]):
        torch.testing.assert_close(g, w, atol=1e-6 * float(w.abs().max()) + 1e-12, rtol=1e-5)


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------

def _ab(rng, B, S, D, dtype):
    return (_pair(rng.uniform(0.6, 0.999, (B, S, D)), dtype),
            _pair(rng.normal(size=(B, S, D)) * 0.2, dtype))


@pytest.mark.parametrize("B,S,D", [(1, 256, 128), (2, 512, 512), (1, 1000, 300), (3, 300, 700)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_matches_reference(B, S, D, dtype):
    rng = np.random.default_rng(B * S + D)
    (aj, at), (bj, bt) = _ab(rng, B, S, D, dtype)
    scan_ops.reset_launch_counts()
    out = scan_ops.rglru_scan(at, bt)
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert out.dtype == TORCH_DTYPE[dtype] and out.shape == (B, S, D)
    _close(out, J_scan(aj, bj, block_s=256, block_d=512), tol)  # the Pallas kernel
    _close(out, J_scan_ref(aj, bj), tol)
    assert scan_ops.launch_counts["rglru_scan"] == 0


@pytest.mark.parametrize("B,S,D", [(2, 1, 16), (2, 77, 130), (1, 300, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_ref_with_h0_matches_reference(B, S, D, dtype):
    rng = np.random.default_rng(S + D)
    (aj, at), (bj, bt) = _ab(rng, B, S, D, dtype)
    h0j, h0t = _pair(rng.normal(size=(B, D)), dtype)
    tol = 1e-4 if dtype == "float32" else 3e-2
    _close(port_scan_ref(at, bt, h0t), J_scan_ref(aj, bj, h0j), tol)


def test_rglru_scan_rejects_bad_inputs():
    a = torch.ones(1, 4, 8)
    with pytest.raises(ValueError):
        scan_ops.rglru_scan(a, torch.ones(1, 4, 9))
    with pytest.raises(ValueError):
        scan_ops.rglru_scan(a[0], a[0])
    with pytest.raises(TypeError):
        scan_ops.rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError):
        scan_ops.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
