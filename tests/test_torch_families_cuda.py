"""xlstm-350m, whisper-small and llava-next-mistral-7b on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no JAX (the CPU files hold the port against the reference),
so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_families_cuda.py

* the sLSTM time loop captured as CUDA graphs (bodies of 64 steps and a
  tail) bitwise the eager step-by-step loop, at the smoke width and at
  xlstm-350m's, one capture per body length, none on a second call;
* each smoke model's kernel path on the card against its plain path on
  the CPU (float32, 1e-4; llava's attention layers launch
  ``flash_attention``, xLSTM and whisper none);
* each family's captured decode (``generate``'s ``Decoder``) bitwise an
  eager ``decode_step`` loop, with one capture, in float32 and bfloat16.
"""

import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.common import dtype_of  # noqa: E402
from repro_torch.models import xlstm as P_x  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

FAMILIES = ["xlstm-350m", "whisper-small", "llava-next-mistral-7b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path is checked only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa_ops.reset_launch_counts()
    return torch.device("cuda")


def _extra(cfg, B: int, device, seed: int = 3) -> dict:
    """The stub inputs a family's prompt goes with: frames or patch embeddings."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.arch_type == "audio":
        shape = (B, cfg.encoder.num_frames, cfg.d_model)
        return {"frames": (torch.randn(shape, generator=gen) * 0.1).to(device, dtype_of(cfg))}
    if cfg.arch_type == "vlm":
        shape = (B, cfg.vision.num_patches, cfg.d_model)
        return {"image_embeds": (torch.randn(shape, generator=gen) * 0.1).to(device,
                                                                           dtype_of(cfg))}
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("name,S", [("smoke", 150), ("full", 300)])
def test_captured_slstm_loop_is_bitwise_the_eager_loop(cuda, name, S):
    cfg = get_smoke_config("xlstm-350m") if name == "smoke" else get_config("xlstm-350m")
    block = P_x.init_slstm_block(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                                 device=cuda).requires_grad_(False)
    gen = torch.Generator(device=cuda).manual_seed(1)
    B = 3  # a batch size no other test runs: these bodies are new
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=cuda).to(dtype_of(cfg))
    outs = {}
    with torch.inference_mode():
        for mode in ("eager", "captured", "captured"):
            state = P_x.init_slstm_state(cfg, B, cuda)
            before = P_x.loop_captures()
            with P_x.slstm_loop(mode):
                y, _ = P_x.slstm_block(block, cfg, x, state)
            outs.setdefault(mode, []).append((y, state, P_x.loop_captures() - before))
    eager = outs["eager"][0]
    for y, state, _ in outs["captured"]:
        assert torch.equal(y, eager[0])
        for k in ("c", "n", "h", "m"):
            assert torch.equal(state[k], eager[1][k])
    # the 64-step body captures in the first call (its second run), the tail's
    # at its second run: in the second call; nothing after that
    assert outs["captured"][0][2] + outs["captured"][1][2] == 2
    with torch.inference_mode():
        before = P_x.loop_captures()
        P_x.slstm_block(block, cfg, x)
        assert P_x.loop_captures() == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_smoke_model_kernel_path_on_card_matches_cpu_plain(cuda, name):
    cfg = get_smoke_config(name)
    model = registry.init_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(model).to(cuda)
    batch = registry.make_inputs(cfg, 2, 256, seed=0, device="cpu")
    batch.update(_extra(cfg, 2, "cpu"))
    with torch.inference_mode():
        cpu_logits, _, _ = registry.model_forward(model, cfg, batch, impl="plain")
        gpu_logits, _, _ = registry.model_forward(
            gpu_model, cfg, {k: v.to(cuda) for k, v in batch.items()}, impl="kernel")
        cpu_loss, _ = registry.loss_fn(model, cfg, batch, impl="plain")
        gpu_loss, _ = registry.loss_fn(gpu_model, cfg, {k: v.to(cuda) for k, v in batch.items()},
                                       impl="kernel")
    torch.testing.assert_close(gpu_logits.cpu(), cpu_logits, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gpu_loss.cpu(), cpu_loss, atol=1e-4, rtol=1e-4)
    want = 2 * cfg.num_layers if cfg.arch_type == "vlm" else 0  # the forward and the loss
    assert fa_ops.launch_counts["flash_attention"] == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_captured_decode_is_bitwise_the_eager_loop(cuda, name, dtype):
    cfg = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    model = registry.init_model(cfg, seed=1, device=cuda)
    prompt = registry.make_inputs(cfg, 2, 20, seed=2, device=cuda)["tokens"]
    extra = _extra(cfg, 2, cuda)
    S = prompt.shape[1]
    total = S + (cfg.vision.num_patches if cfg.arch_type == "vlm" else 0)
    new = 10
    with torch.inference_mode():
        logits, cache = engine.prefill(model, cfg, prompt, max_len=total + new + 1, **extra)
        eager, tok = [logits], logits.argmax(-1, keepdim=True)
        for pos in range(total, total + new - 1):
            logits, cache = engine.decode_step(model, cfg, tok, torch.full((2, 1), pos,
                                                                         device=cuda), cache)
            eager.append(logits)
            tok = logits.argmax(-1, keepdim=True)
    out = engine.generate(model, cfg, prompt, max_new_tokens=new, device=cuda, **extra)
    dec = engine.decoder_for(model, cfg, 2, total + new + 1)
    assert dec.n_captures == 1
    dec.start(prompt, **extra)
    graph = [dec.logits.clone()]
    for _ in range(new - 1):
        dec.step()
        graph.append(dec.logits.clone())
    assert dec.n_captures == 1
    assert torch.equal(out, torch.cat([e.argmax(-1, keepdim=True) for e in eager], dim=1))
    assert all(torch.equal(a, b) for a, b in zip(graph, eager))
