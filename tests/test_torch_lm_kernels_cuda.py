"""The hand-written flash_attention and rglru_scan kernels against their
plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). This file imports no JAX, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_kernels_cuda.py

Tolerances: flash attention 2e-3 (float32, the reference's) and 1e-2
(bfloat16: outputs over a 2048-key window are ~0.04, so the reference's
3e-2 would hold nothing; 1e-2 is a few bf16 ulps of them, as in
``chip_smoke.py``); the scan 1e-4 and 3e-2, the reference's. Float32
inputs run the CUDA-core kernel, bfloat16 inputs the tensor-core one.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import registry  # noqa: E402

FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-2}
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa_ops.reset_launch_counts()
    scan_ops.reset_launch_counts()
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, 0.0), (100, 50.0), (2048, 0.0)])
@pytest.mark.parametrize("H,Hkv", [(10, 1), (8, 4), (4, 4)])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [1, 100, 128, 129, 1000, 2049])
def test_flash_attention_matches_plain_on_card(cuda, S, D, H, Hkv, window, softcap, dtype):
    B = 2
    q = _randn((B, S, H, D), dtype, cuda, 1)
    k = _randn((B, S, Hkv, D), dtype, cuda, 2)
    v = _randn((B, S, Hkv, D), dtype, cuda, 3)
    out = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap)
    plain = flash_attention_ref(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
    assert fa_ops.launch_counts["flash_attention"] == 1


@pytest.mark.cuda
def test_flash_attention_headline_shape_bf16_on_card(cuda):
    """recurrentgemma-2b's layer: B 2, S 4096, H 10, one kv head, D 256,
    window 2048, bfloat16 (the tensor-core kernel)."""
    q = _randn((2, 4096, 10, 256), torch.bfloat16, cuda, 4)
    k = _randn((2, 4096, 1, 256), torch.bfloat16, cuda, 5)
    v = _randn((2, 4096, 1, 256), torch.bfloat16, cuda, 6)
    out = fa_ops.flash_attention(q, k, v, window=2048)
    plain = flash_attention_ref(q, k, v, window=2048)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain.float(), atol=1e-2, rtol=1e-2)
    assert fa_ops.launch_counts["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,Hkv,D,window,softcap", [
    (4096, 16, 8, 128, None, 0.0),    # qwen3-0.6b: 2-way GQA
    (4096, 40, 8, 128, None, 0.0),    # qwen2.5-14b: 5-way GQA
    (4096, 8, 1, 256, None, 0.0),     # gemma-2b: MQA
    (8192, 8, 4, 256, 4096, 50.0),    # gemma2-2b local layer, past its window
    (4096, 8, 4, 256, None, 50.0),    # gemma2-2b global layer
])
def test_flash_attention_dense_family_shapes_bf16_on_card(cuda, S, H, Hkv, D, window, softcap):
    """The dense families' scoring layers at B = 2, bfloat16."""
    q = _randn((2, S, H, D), torch.bfloat16, cuda, 7)
    k = _randn((2, S, Hkv, D), torch.bfloat16, cuda, 8)
    v = _randn((2, S, Hkv, D), torch.bfloat16, cuda, 9)
    out = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap)
    plain = flash_attention_ref(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain.float(), atol=1e-2, rtol=1e-2)
    assert fa_ops.launch_counts["flash_attention"] == 1


@pytest.mark.cuda
def test_flash_attention_non_causal_on_card(cuda):
    q, k, v = (_randn((1, 300, 4, 64), torch.float32, cuda, s) for s in range(3))
    out = fa_ops.flash_attention(q, k, v, causal=False, window=77)
    plain = flash_attention_ref(q, k, v, causal=False, window=77)
    torch.testing.assert_close(out, plain, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [77, None])
def test_flash_attention_non_causal_both_kernels_on_card(cuda, dtype, window):
    q, k, v = (_randn((1, 300, 4, 64), dtype, cuda, s) for s in range(3))
    out = fa_ops.flash_attention(q, k, v, causal=False, window=window)
    plain = flash_attention_ref(q, k, v, causal=False, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_attention_raises_on_card_instead_of_falling_back(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        fa_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        fa_ops.flash_attention(q, q.detach(), q.detach())
    assert fa_ops.launch_counts["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 256])
def test_flash_attention_bf16_misaligned_views_on_card(cuda, D):
    """TMA reads 16-byte aligned addresses only: views at an odd offset
    into a larger buffer give the result of aligned copies."""
    B, S, H, Hkv = 2, 200, 4, 2
    gen = torch.Generator().manual_seed(D)
    views = []
    for heads in (H, Hkv, Hkv):
        n = B * S * heads * D
        buf = torch.randn(n + 1, generator=gen).to(torch.bfloat16).to(cuda)
        views.append(buf[1:].view(B, S, heads, D))
    assert all(t.data_ptr() % 16 for t in views)
    q, k, v = views
    out = fa_ops.flash_attention(q, k, v, window=64)
    aligned = fa_ops.flash_attention(q.clone(), k.clone(), v.clone(), window=64)
    torch.testing.assert_close(out, aligned, atol=0, rtol=0)
    plain = flash_attention_ref(q.float().cpu(), k.float().cpu(), v.float().cpu(), window=64)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float().cpu(), plain, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# The kernel's time tiles are 256 steps: S = 255, 256 and 257 sit at one
# tile's edge; S = 2^17 with one chain of 32 features makes 512 tiles in a
# row, a look-back chain far longer than the blocks resident at once.
@pytest.mark.parametrize("B,S,D", [(1, 1, 1), (2, 100, 300), (1, 17, 33), (3, 1000, 2560),
                                   (2, 4097, 2561), (2, 255, 2561), (2, 256, 64), (2, 257, 33),
                                   (1, 2**17, 32)])
def test_rglru_scan_matches_plain_on_card(cuda, B, S, D, dtype):
    gen = torch.Generator().manual_seed(S + D)
    a = (torch.rand((B, S, D), generator=gen) * 0.399 + 0.6).to(dtype).to(cuda)
    b = (torch.randn((B, S, D), generator=gen) * 0.2).to(dtype).to(cuda)
    out = scan_ops.rglru_scan(a, b)
    plain = rglru_scan_ref(a, b)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == a.shape
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
    assert scan_ops.launch_counts["rglru_scan"] == 1
    with pytest.raises(RuntimeError, match="no backward kernel"):
        scan_ops.rglru_scan(a.float().requires_grad_(), b.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_back_to_back_on_card(cuda, dtype):
    """Three launches on one stream, one of another shape in between: each
    zeroes its own workspace, so the tickets and flags start afresh. A
    tile folds the same values in the same order on every launch, so two
    launches on the same inputs are bitwise equal."""
    gen = torch.Generator().manual_seed(7)
    a = (torch.rand((2, 3000, 96), generator=gen) * 0.399 + 0.6).to(dtype).to(cuda)
    b = (torch.randn((2, 3000, 96), generator=gen) * 0.2).to(dtype).to(cuda)
    first = scan_ops.rglru_scan(a, b)
    small = scan_ops.rglru_scan(a[:1, :300].contiguous(), b[:1, :300].contiguous())
    second = scan_ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert scan_ops.launch_counts["rglru_scan"] == 3
    tol = SCAN_TOL[dtype]
    plain = rglru_scan_ref(a, b).float()
    for out in (first, second):
        torch.testing.assert_close(out.float(), plain, atol=tol, rtol=tol)
    assert torch.equal(second, first)
    torch.testing.assert_close(small.float(), plain[:1, :300], atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D", [(2, 4096, 2560), (1, 32768, 2560), (3, 1001, 2561)])
def test_rglru_scan_is_deterministic_on_card(cuda, B, S, D, dtype):
    """recurrentgemma-2b's layer, a 32768-step chain (128 time tiles, 16
    origins) and a ragged shape: repeated launches give the same bits."""
    gen = torch.Generator().manual_seed(S + D)
    a = (torch.rand((B, S, D), generator=gen) * 0.399 + 0.6).to(dtype).to(cuda)
    b = (torch.randn((B, S, D), generator=gen) * 0.2).to(dtype).to(cuda)
    first = scan_ops.rglru_scan(a, b)
    for _ in range(3):
        assert torch.equal(scan_ops.rglru_scan(a, b), first)


@pytest.mark.cuda
def test_model_on_card_goes_through_the_kernels(cuda):
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"), num_layers=5)
    model = registry.init_model(cfg, seed=0, device=cuda)
    batch = registry.make_inputs(cfg, 2, 200, device=cuda)
    with torch.inference_mode():
        kernel, _, _ = registry.model_forward(model, cfg, batch, impl="kernel")
        assert fa_ops.launch_counts["flash_attention"] == 1  # one local_attn layer
        assert scan_ops.launch_counts["rglru_scan"] == 4
        plain, _, _ = registry.model_forward(model, cfg, batch, impl="plain")
    assert fa_ops.launch_counts["flash_attention"] == 1
    torch.testing.assert_close(kernel, plain, atol=1e-4, rtol=1e-4)
