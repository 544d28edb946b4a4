"""DeepSeek-V2-Lite's new paths on the card: the flash kernels at an
explicit softmax scale (MLA's, on q / k / v zero-padded to 256), the held
experts' grouped products, and a captured training segment of the smoke
model that trains MLA through the flash forward and backward.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_deepseek_lite_cuda.py

Tolerances are ``test_torch_flash_bwd_cuda.py``'s: the kernels against
autograd through ``flash_attention_ref`` in float32 on the same bfloat16
inputs, each element within 2^-7 relative plus 2^-9 of the largest
reference magnitude. The grouped products against a per-expert loop of
bfloat16 products: both round each expert's output to bfloat16 once, and
the gate-weighted sums differ in order and in the gate's rounding, so
within 2^-6 relative plus 2^-8 of the largest.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402

REL, ABS = 2.0 ** -7, 2.0 ** -9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa_ops.reset_launch_counts()
    return torch.device("cuda")


def _close(got, want, rel=REL, abs_=ABS):
    got, want = got.float(), want.float()
    bound = rel * want.abs() + abs_ * want.abs().max() + 1e-6
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [17, 300, 1024])
def test_flash_at_an_explicit_scale_forward_and_backward(cuda, S):
    """MLA's padded heads: q / k at 192 and v at 128 zero-padded to 256, the
    scale 192^-0.5 mscale^2; the kernels against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    B, H, D = 2, 4, 256
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=cuda) for _ in range(3))
    q[..., 192:] = 0
    k[..., 192:] = 0
    v[..., 128:] = 0
    q, k, v = (t.bfloat16().requires_grad_() for t in (q, k, v))
    scale = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
    out = fa_ops.flash_attention(q, k, v, causal=True, scale=scale)
    dout = torch.randn(out.shape, generator=gen, device=cuda).bfloat16()
    grads = torch.autograd.grad(out, (q, k, v), dout)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_ref(*leaves, causal=True, scale=scale)
    ref_grads = torch.autograd.grad(ref, leaves, dout.float())
    _close(out, ref)
    assert bool((out[..., 128:] == 0).all())
    for g, r in zip(grads, ref_grads):
        _close(g, r)
    assert fa_ops.launch_counts == {"flash_attention": 1, "flash_attention_bwd": 1}


def _loop_experts(x, gates, ids, w_gate, w_up, w_down, first):
    """The held share as a loop over experts (host-synchronising)."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(w_gate.shape[0]):
        t, j = torch.nonzero(ids == first + e, as_tuple=True)
        h = torch.nn.functional.silu(x[t] @ w_gate[e]) * (x[t] @ w_up[e])
        out.index_add_(0, t, (h @ w_down[e]).float() * gates[t, j][:, None])
    return out


@pytest.mark.cuda
def test_grouped_held_experts_match_a_loop_and_capture(cuda):
    """At DeepSeek-V2-Lite's widths: 8 of 64 experts held from expert 8, a
    skewed routing; the grouped products against a loop, then captured in a
    CUDA graph and replayed on other routes."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    T, D, F, G, K, E = 4096, 2048, 1408, 8, 6, 64
    x = torch.randn((T, D), generator=gen, device=cuda).bfloat16()
    w = [(torch.randn(shape, generator=gen, device=cuda) * shape[1] ** -0.5).bfloat16()
         for shape in ((G, D, F), (G, D, F), (G, F, D))]
    logits = torch.randn((T, E), generator=gen, device=cuda)
    logits[:, 8:11] += 3.0  # most tokens pick three held experts
    gates, ids = torch.topk(torch.softmax(logits, -1), K, dim=-1)
    got = moe._held_experts(x, gates, *moe.sort_choices(ids, 8, G), *w)
    _close(got, _loop_experts(x, gates, ids, *w, 8), 2.0 ** -6, 2.0 ** -8)
    static_ids, static_gates = ids.clone(), gates.clone()

    def body():
        return moe._held_experts(x, static_gates, *moe.sort_choices(static_ids, 8, G), *w)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    logits2 = torch.randn((T, E), generator=gen, device=cuda)
    gates2, ids2 = torch.topk(torch.softmax(logits2, -1), K, dim=-1)
    static_ids.copy_(ids2)
    static_gates.copy_(gates2)
    graph.replay()
    _close(out, _loop_experts(x, gates2, ids2, *w, 8), 2.0 ** -6, 2.0 ** -8)


@pytest.mark.cuda
def test_smoke_model_trains_mla_through_flash_captured(cuda):
    """The smoke model in bf16, 4 stacked nodes, a captured 2-step segment:
    each node's every layer launches one flash forward and one backward a
    step; the replay's losses are the eager loop's."""
    from repro_torch.core.mixing import schedule_from_result
    from repro_torch.core.stl_fw import learn_topology
    from repro_torch.train.lm_trainer import make_train_setup

    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-lite"), dtype="bfloat16")
    sched = schedule_from_result(learn_topology(np.eye(4), 2))
    setup = make_train_setup(cfg, n_nodes=4, schedule=sched, device=cuda)
    params = setup.init_params(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 4, 2, 65), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
    loop = setup.multi_step_fn("loop")
    _, _, want = loop(params, None, batch)
    scan = setup.multi_step_fn("scan")
    for _ in range(3):
        fa_ops.reset_launch_counts()
        _, _, got = scan(params, None, batch)
    assert scan.n_traces == 1
    assert fa_ops.launch_counts == {"flash_attention": 2 * 4 * cfg.num_layers,
                                    "flash_attention_bwd": 2 * 4 * cfg.num_layers}
    assert torch.equal(got, want), (got, want)
    assert all(int(v.sum()) > 0 for v in setup.expert_loads.values())
