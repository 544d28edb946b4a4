"""The MoE block, MLA attention and the MoE families' captured decode on
the card.

Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no JAX (the CPU files hold the port against the reference),
so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

* ``moe_forward`` and ``mla_attention`` on the card against the same
  modules on the CPU (float32 at 1e-5, float32 products in full float32),
  with drops (capacity factor 1.0) and through MLA's chunked branch;
* a CUDA-graph capture of ``moe_forward`` replayed on new inputs equals
  the eager forward on them bitwise (the routing is read on the device);
* each smoke model's kernel path on the card against its plain path on
  the CPU (1e-4), and its captured decode (``generate``'s ``Decoder``)
  bitwise an eager ``decode_step`` loop over steps whose routing changes,
  with one capture.
"""

import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import attention as P_attn  # noqa: E402
from repro_torch.models import moe as P_moe  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

FAMILIES = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path is checked only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa_ops.reset_launch_counts()
    return torch.device("cuda")


def _x(B, S, D, seed, scale=1.0):
    return torch.randn((B, S, D), generator=torch.Generator().manual_seed(seed)) * scale


def _moe(name, **moe):
    cfg = get_smoke_config(name)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    module = P_moe.init_moe(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return cfg, module.requires_grad_(False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_forward_on_card_matches_cpu(cuda, name, cf):
    cfg, module = _moe(name, capacity_factor=cf)
    x = _x(2, 64, cfg.d_model, 1)
    with torch.inference_mode():
        out, aux = P_moe.moe_forward(module, cfg, x)
        gpu_out, gpu_aux = P_moe.moe_forward(copy.deepcopy(module).to(cuda), cfg, x.to(cuda))
    assert gpu_out.device.type == "cuda"
    torch.testing.assert_close(gpu_out.cpu(), out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gpu_aux.cpu(), aux, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_moe_forward_replays_as_a_graph(cuda):
    """Capture one forward, then replay it on three other inputs: each
    replay equals the eager forward bitwise, and the routes differ."""
    cfg, module = _moe("qwen3-moe-30b-a3b", capacity_factor=1.0)
    module = module.to(cuda)
    static_x = _x(2, 16, cfg.d_model, 2).to(cuda)
    with torch.inference_mode():
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            P_moe.moe_forward(module, cfg, static_x)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out, static_aux = P_moe.moe_forward(module, cfg, static_x)
        routes = set()
        for seed in (3, 4, 5):
            x = _x(2, 16, cfg.d_model, seed).to(cuda)
            static_x.copy_(x)
            graph.replay()
            out, aux = P_moe.moe_forward(module, cfg, x)
            assert torch.equal(static_out, out) and torch.equal(static_aux, aux)
            routes.add(tuple(P_moe.route(module, cfg, x)[2].flatten().tolist()))
    assert len(routes) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("S,window", [(24, None), (24, 7), (2560, None)])
def test_mla_attention_on_card_matches_cpu(cuda, S, window):
    cfg = get_smoke_config("deepseek-v2-236b")
    module = P_attn.init_mla_attention(cfg, generator=torch.Generator().manual_seed(0),
                                       device="cpu").requires_grad_(False)
    x = _x(1, S, cfg.d_model, 6, scale=0.5)
    pos = torch.arange(S)[None]
    with torch.inference_mode():
        out, _ = P_attn.mla_attention(module, cfg, x, positions=pos, window=window)
        gpu, _ = P_attn.mla_attention(copy.deepcopy(module).to(cuda), cfg, x.to(cuda),
                                      positions=pos.to(cuda), window=window)
    torch.testing.assert_close(gpu.cpu(), out, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_mla_prefill_and_decode_on_card_match_cpu(cuda):
    cfg = get_smoke_config("deepseek-v2-236b")
    module = P_attn.init_mla_attention(cfg, generator=torch.Generator().manual_seed(1),
                                       device="cpu").requires_grad_(False)
    gpu_module = copy.deepcopy(module).to(cuda)
    x = _x(2, 14, cfg.d_model, 7, scale=0.5)
    caches = {d: P_attn.init_mla_attention_cache(cfg, 2, 16, device=d) for d in ("cpu", "cuda")}
    with torch.inference_mode():
        for lo, hi in ((0, 10), (10, 11), (11, 12), (12, 13), (13, 14)):
            pos = torch.arange(lo, hi)[None].expand(2, hi - lo)
            out, _ = P_attn.mla_attention(module, cfg, x[:, lo:hi], positions=pos,
                                          cache=caches["cpu"])
            gpu, _ = P_attn.mla_attention(gpu_module, cfg, x[:, lo:hi].to(cuda),
                                          positions=pos.to(cuda), cache=caches["cuda"])
            torch.testing.assert_close(gpu.cpu(), out, atol=1e-5, rtol=1e-5)
    assert int(caches["cuda"]["index"]) == 14


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_smoke_model_kernel_path_on_card_matches_cpu_plain(cuda, name):
    cfg = get_smoke_config(name)
    model = registry.init_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(model).to(cuda)
    batch = registry.make_inputs(cfg, 2, 256, seed=0, device="cpu")
    with torch.inference_mode():
        cpu_logits, _, cpu_aux = registry.model_forward(model, cfg, batch, impl="plain")
        gpu_logits, _, gpu_aux = registry.model_forward(
            gpu_model, cfg, {k: v.to(cuda) for k, v in batch.items()}, impl="kernel")
    torch.testing.assert_close(gpu_logits.cpu(), cpu_logits, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gpu_aux.cpu(), cpu_aux, atol=1e-5, rtol=1e-5)
    # MLA is plain on every path: only qwen3-moe's GQA layers launch flash
    want = cfg.num_layers if cfg.mla is None else 0
    assert fa_ops.launch_counts["flash_attention"] == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_captured_decode_is_bitwise_the_eager_loop(cuda, name, dtype, monkeypatch):
    cfg = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    model = registry.init_model(cfg, seed=1, device=cuda)
    prompt = registry.make_inputs(cfg, 2, 20, seed=2, device=cuda)["tokens"]
    new = 10
    routes = []
    route = P_moe.route

    def recording(params, c, x):
        out = route(params, c, x)
        if params is model.layers[0].mlp and x.shape[1] == 1:
            routes.append(out[2].clone())
        return out

    monkeypatch.setattr(P_moe, "route", recording)
    with torch.inference_mode():
        logits, cache = engine.prefill(model, cfg, prompt, max_len=20 + new + 1)
        eager, tok = [logits], logits.argmax(-1, keepdim=True)
        for pos in range(20, 20 + new - 1):
            logits, cache = engine.decode_step(model, cfg, tok, torch.full((2, 1), pos,
                                                                         device=cuda), cache)
            eager.append(logits)
            tok = logits.argmax(-1, keepdim=True)
    assert len({tuple(r.flatten().tolist()) for r in routes}) > 1
    monkeypatch.setattr(P_moe, "route", route)  # a capture records no host copies
    out = engine.generate(model, cfg, prompt, max_new_tokens=new, device=cuda)
    dec = engine.decoder_for(model, cfg, 2, 20 + new + 1)
    assert dec.n_captures == 1
    dec.start(prompt)
    graph = [dec.logits.clone()]
    for _ in range(new - 1):
        dec.step()
        graph.append(dec.logits.clone())
    assert dec.n_captures == 1
    assert torch.equal(out, torch.cat([e.argmax(-1, keepdim=True) for e in eager], dim=1))
    assert all(torch.equal(a, b) for a, b in zip(graph, eager))
