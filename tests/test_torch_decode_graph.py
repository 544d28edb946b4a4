"""The captured decode step: device-index caches and the ``Decoder``.

* The caches' ``index`` is a 0-d int64 tensor on the cache's device,
  advanced in place; full and window caches (a ring that wraps) hold the
  reference's ``kvcache`` buffers and index after the same writes.
* The decoder's step reads nothing on the host: with every host read of a
  tensor made to raise, a step still runs.
* On the CPU the decoder's step runs eagerly: its tokens and each step's
  logits are bitwise those of a loop over ``decode_step`` from
  ``prefill``, for every ported family (the rings of gemma2's and
  recurrentgemma's smoke configs wrap), and RG-LRU states are written in
  their own tensors.
* ``generate`` keeps one decoder per model: two calls at one ``(B,
  max_len)`` count one capture, another shape gets its own decoder.
* A prompt or a step past ``max_len`` raises before anything runs.
* On the card (``cuda``-marked, skipped here): ``generate`` captured once,
  tokens and logits bitwise those of the eager loop.

The reference (JAX) is imported only by the test that compares with it,
so the card tests also run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_graph.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import kvcache as P_kv  # noqa: E402
from repro_torch.models import registry, rglru, transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

FAMILIES = ["qwen3-0.6b", "gemma-2b", "gemma2-2b", "qwen2.5-14b", "recurrentgemma-2b"]


def _prompt(cfg, B: int, S: int, seed: int = 0) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)))


def _model(name: str, seed: int = 0, device="cpu"):
    cfg = get_smoke_config(name)
    return registry.init_model(cfg, seed=seed, device=device), cfg


def eager_loop(model, cfg, prompt: torch.Tensor, new_tokens: int):
    """Greedy decoding as a loop over ``decode_step`` from ``prefill``:
    (tokens (B, new_tokens), each step's logits)."""
    B, S = prompt.shape
    with torch.inference_mode():
        logits, cache = engine.prefill(model, cfg, prompt, max_len=S + new_tokens + 1)
        toks, all_logits = [logits.argmax(-1, keepdim=True)], [logits]
        for pos in range(S, S + new_tokens - 1):
            position = torch.full((B, 1), pos, device=prompt.device)
            logits, cache = engine.decode_step(model, cfg, toks[-1], position, cache)
            toks.append(logits.argmax(-1, keepdim=True))
            all_logits.append(logits)
    return torch.cat(toks, dim=1), all_logits


def decoder_run(model, cfg, prompt: torch.Tensor, new_tokens: int):
    """The same through the model's decoder, one step at a time."""
    B, S = prompt.shape
    dec = engine.decoder_for(model, cfg, B, S + new_tokens + 1)
    dec.start(prompt)
    all_logits = [dec.logits.clone()]
    for _ in range(new_tokens - 1):
        dec.step()
        all_logits.append(dec.logits.clone())
    return dec.tokens[:, S : S + new_tokens].clone(), all_logits, dec


# ---------------------------------------------------------------------------
# Device-index caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [8, 5])
@pytest.mark.parametrize("first", [3, 8, 13])
def test_device_index_caches_match_reference(first, window):
    """A first write of ``first`` positions (clamped to the ring's last
    ``window`` when longer), then single-position writes that wrap."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import kvcache as J_kv

    rng = np.random.default_rng(first + window)
    jc = J_kv.init_window_cache(2, window, 1, 4, jnp.float32)
    pc = P_kv.init_window_cache(2, window, 1, 4, torch.float32, "cpu")
    jf = J_kv.init_full_cache(2, 32, 1, 4, jnp.float32)
    pf = P_kv.init_full_cache(2, 32, 1, 4, torch.float32, "cpu")
    indices = (pc["index"], pf["index"])
    for n in (first,) + (1,) * 9:
        k = rng.normal(size=(2, n, 1, 4)).astype(np.float32)
        v = k - 1.0
        jc = J_kv.update_window_cache(jc, jnp.asarray(k), jnp.asarray(v))
        pc = P_kv.update_window_cache(pc, torch.tensor(k), torch.tensor(v))
        jf = J_kv.update_full_cache(jf, jnp.asarray(k), jnp.asarray(v))
        pf = P_kv.update_full_cache(pf, torch.tensor(k), torch.tensor(v))
        for port, ref in ((pc, jc), (pf, jf)):
            np.testing.assert_array_equal(port["k"].numpy(), np.asarray(ref["k"]))
            np.testing.assert_array_equal(port["v"].numpy(), np.asarray(ref["v"]))
            assert port["index"].shape == () and port["index"].dtype == torch.int64
            assert int(port["index"]) == int(ref["index"])
    # advanced in place: the tensors the caches were made with
    assert pc["index"] is indices[0] and pf["index"] is indices[1]


def test_caches_start_with_a_device_index():
    cfg = get_smoke_config("gemma2-2b")
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    assert [sorted(layer) for layer in cache] == [["index", "k", "v"]] * 2
    for layer in cache:
        assert isinstance(layer["index"], torch.Tensor) and layer["index"].dtype == torch.int64
        assert layer["index"].shape == () and int(layer["index"]) == 0
    assert cache[0]["k"].shape[1] == 8 and cache[1]["k"].shape[1] == 16  # ring, full


def test_rglru_decode_writes_its_state_in_place():
    cfg = get_smoke_config("recurrentgemma-2b")
    block = rglru.init_rglru_block(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = rglru.init_rglru_state(cfg, 2, device="cpu")
    h, conv = state["h"], state["conv"]
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        for lo, hi in ((0, 3), (3, 4), (4, 5)):  # a prefill, then two steps
            _, new = rglru.rglru_block(block, cfg, x[:, lo:hi], state)
            assert new["h"] is h and new["conv"] is conv
            assert float(h.abs().sum()) > 0 and float(conv.abs().sum()) > 0


# ---------------------------------------------------------------------------
# The decoder on the CPU
# ---------------------------------------------------------------------------

def test_decode_step_reads_nothing_on_the_host(monkeypatch):
    """Every host read of a tensor raises during the decoder's steps."""
    model, cfg = _model("gemma2-2b")
    dec = engine.decoder_for(model, cfg, 2, 20)
    dec.start(_prompt(cfg, 2, 11))

    def refuse(*args, **kwargs):
        raise AssertionError("a host read of a tensor inside the decode step")

    for name in ("item", "tolist", "__int__", "__index__", "__bool__", "__float__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for _ in range(3):
        dec.step()
    monkeypatch.undo()
    assert dec.n_captures == 1 and int(dec.position[0, 0]) == 14


@pytest.mark.parametrize("name", FAMILIES)
def test_decoder_is_bitwise_the_decode_step_loop(name):
    """B = 2, a 24-token prompt, 8 new tokens: each step's logits and the
    tokens bitwise; one capture counted."""
    model, cfg = _model(name, seed=3)
    prompt = _prompt(cfg, 2, 24, seed=4)
    ref_toks, ref_logits = eager_loop(model, cfg, prompt, 8)
    toks, logits, dec = decoder_run(model, cfg, prompt, 8)
    assert torch.equal(toks, ref_toks)
    assert len(logits) == len(ref_logits) == 8
    for a, b in zip(logits, ref_logits):
        assert torch.equal(a, b)
    assert dec.n_captures == 1
    out = engine.generate(model, cfg, prompt.numpy(), max_new_tokens=8, device="cpu")
    assert torch.equal(out, ref_toks)
    assert engine.decoder_for(model, cfg, 2, 33) is dec and dec.n_captures == 1


def test_one_capture_per_shape_across_generate_calls():
    model, cfg = _model("qwen3-0.6b", seed=5)
    a, b = _prompt(cfg, 2, 10, seed=6), _prompt(cfg, 2, 10, seed=7)
    first = engine.generate(model, cfg, a, max_new_tokens=6, device="cpu")
    dec = engine.decoder_for(model, cfg, 2, 17)
    assert dec.n_captures == 1
    second = engine.generate(model, cfg, b, max_new_tokens=6, device="cpu")
    assert engine.decoder_for(model, cfg, 2, 17) is dec and dec.n_captures == 1
    assert torch.equal(first, eager_loop(model, cfg, a, 6)[0])
    assert torch.equal(second, eager_loop(model, cfg, b, 6)[0])
    # another shape: a decoder of its own (the model keeps only that one)
    third = engine.generate(model, cfg, a[:1], max_new_tokens=6, device="cpu")
    other = engine.decoder_for(model, cfg, 1, 17)
    assert other is not dec and other.n_captures == 1
    assert torch.equal(third, first[:1])
    # a prompt of another length at the same (B, max_len) reuses the decoder
    fourth = engine.generate(model, cfg, a[:1, :7], max_new_tokens=9, device="cpu")
    assert engine.decoder_for(model, cfg, 1, 17) is other and other.n_captures == 1
    assert torch.equal(fourth, eager_loop(model, cfg, a[:1, :7], 9)[0])
    # one new token: no decode step at all
    assert torch.equal(engine.generate(model, cfg, a, max_new_tokens=1, device="cpu"),
                       first[:, :1])


def test_decoders_are_per_model_and_follow_its_weights():
    model, cfg = _model("gemma-2b", seed=8)
    twin = registry.init_model(cfg, seed=8, device="cpu")
    dec = engine.decoder_for(model, cfg, 2, 12)
    assert engine.decoder_for(twin, cfg, 2, 12) is not dec
    assert engine.decoder_for(model, cfg, 2, 12) is dec
    # weights moved to new storage: the graph would read the old, so a new decoder
    model.embed.table = torch.nn.Parameter(model.embed.table.detach().clone(),
                                           requires_grad=False)
    assert engine.decoder_for(model, cfg, 2, 12) is not dec
    with pytest.raises(ValueError, match="built for"):
        engine.decoder_for(model, dataclasses.replace(cfg, d_ff=64), 2, 12)


def test_overflow_raises_before_any_step_runs():
    model, cfg = _model("qwen2.5-14b", seed=9)
    dec = engine.Decoder(model, cfg, 2, 12)
    with pytest.raises(ValueError, match="full cache of 12 positions cannot take 13 more at 0"):
        dec.start(_prompt(cfg, 2, 13))
    assert all(int(layer["index"]) == 0 for layer in dec.cache) and dec.n_captures == 0
    with pytest.raises(ValueError, match="cannot take 13 more at 0"):
        engine.prefill(model, cfg, _prompt(cfg, 2, 13), max_len=12)
    with pytest.raises(ValueError, match="batches of 2"):
        dec.start(_prompt(cfg, 3, 4))
    dec.start(_prompt(cfg, 2, 9))
    for _ in range(3):
        dec.step()
    before = [dec.tokens.clone(), dec.position.clone(), dec.logits.clone()]
    with pytest.raises(ValueError, match="full cache of 12 positions cannot take 1 more at 12"):
        dec.step()
    assert all(int(layer["index"]) == 12 for layer in dec.cache)
    for a, b in zip(before, (dec.tokens, dec.position, dec.logits)):
        assert torch.equal(a, b)
    assert dec.n_captures == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode step is captured only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_captured_decode_is_bitwise_the_eager_loop_on_card(cuda, name):
    """A 24-token prompt, 12 new tokens, twice: one capture, and the
    replays' tokens and logits bitwise those of the eager loop."""
    model, cfg = _model(name, seed=10, device=cuda)
    prompt = _prompt(cfg, 2, 24, seed=11).to(cuda)
    ref_toks, ref_logits = eager_loop(model, cfg, prompt, 12)
    for _ in range(2):
        toks, logits, dec = decoder_run(model, cfg, prompt, 12)
        assert torch.equal(toks, ref_toks)
        for a, b in zip(logits, ref_logits):
            assert torch.equal(a, b)
    assert dec.n_captures == 1 and dec.capture_s is not None
    out = engine.generate(model, cfg, prompt, max_new_tokens=12)
    assert torch.equal(out, ref_toks) and dec.n_captures == 1
