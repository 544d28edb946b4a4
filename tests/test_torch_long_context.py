"""The port's long-context serving mode against the reference's.

``long_context=True`` (``prefill``, ``decode_step``, ``generate``) gives
every attention layer a window ring of ``min(long_context_window,
max_len)`` slots, an MLA layer a latent ring of exactly
``long_context_window`` slots, and passes ``window_override`` to every
forward; whisper ignores the flag. Each family runs at its smoke config
(float32) with ``long_context_window = 8`` and prompts longer than 8, so
every ring wraps in the prefill and again while decoding: qwen3 (dense),
gemma2 (local + global), recurrentgemma (RG-LRU + local), deepseek
(MLA), whisper (flag ignored) and xlstm (no attention). The reference's
``init_model`` weights, constant leaves perturbed, go into the port
through ``convert``; both packages serve the same numpy prompts:

* greedy ``generate(long_context=True)``: the reference's tokens;
* the prefill's logits and 8 teacher-forced decode steps' logits within
  1e-4 of the reference's (``TOL``);
* the long-context caches' shapes are the reference's, and a prompt longer
  than ``max_len`` is taken (a ring has no end) where the full cache
  refuses it;
* a long-context ``generate`` after a full one at the same shape builds a
  new decoder.

MLA's ring: the reference's prefill write clamps its start (a
``dynamic_update_slice``), so after a prompt of S > L positions with S
mod L != 0 its ring holds position p at slot p - (S - L), where its decode
steps expect slot p mod L, and it decodes away from its own windowed full
forward. The port writes position p at slot p mod L. So deepseek's
prompts against the reference's long-context decode are 16 tokens (L
divides S); at 13 the port is held to the reference's full forward with
``window_override = 8``, and the reference's own long-context decode is
shown to leave it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_smoke_config as J_get_smoke  # noqa: E402
from repro.models import init_model as J_init_model  # noqa: E402
from repro.models import registry as J_registry  # noqa: E402
from repro.models import transformer as J_transformer  # noqa: E402
from repro.serve import engine as J_engine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import kvcache, registry, transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

TOL = 1e-4
WINDOW = 8
NEW = 8
FAMILIES = ["qwen3-0.6b", "gemma2-2b", "recurrentgemma-2b", "deepseek-v2-236b",
            "whisper-small", "xlstm-350m"]
# prompt lengths: 13 leaves the rings unaligned, 16 is a multiple of the
# window; deepseek's MLA ring takes only the aligned one against the
# reference (module docstring)
CASES = [(name, S) for name in FAMILIES for S in (13, 16)
         if (name, S) != ("deepseek-v2-236b", 13)]


def _perturbed(tree, seed: int):
    rng = np.random.default_rng(seed)

    def move(leaf):
        leaf = np.asarray(leaf)
        if leaf.size > 1 and np.all(leaf == leaf.flat[0]):
            noise = rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
            return (leaf.astype(np.float32) + noise).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map(move, tree)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    jcfg = dataclasses.replace(J_get_smoke(name), long_context_window=WINDOW)
    pcfg = dataclasses.replace(get_smoke_config(name), long_context_window=WINDOW)
    tree = _perturbed(jax.tree_util.tree_map(np.asarray,
                                             J_init_model(jax.random.PRNGKey(0), jcfg)), 1)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    frames = None
    if jcfg.arch_type == "audio":
        frames = (np.random.default_rng(7).normal(
            size=(2, jcfg.encoder.num_frames, jcfg.d_model)) * 0.1).astype(np.float32)
    return dict(name=name, jcfg=jcfg, pcfg=pcfg, params=params, model=model, frames=frames)


def _tokens(cfg, S: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, S))


def _kw(fam, port: bool) -> dict:
    if fam["frames"] is None:
        return {}
    return {"frames": torch.as_tensor(fam["frames"]) if port else jnp.asarray(fam["frames"])}


def _close(port: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S", [13, 16])
def test_generate_long_context_matches_reference_tokens(family, S):
    if (family["name"], S) not in CASES:
        _held_to_windowed_forward(family, S)
        return
    jcfg, pcfg = family["jcfg"], family["pcfg"]
    prompt = _tokens(jcfg, S)
    ref = np.asarray(J_engine.generate(family["params"], jcfg, jnp.asarray(prompt, jnp.int32),
                                       max_new_tokens=NEW, long_context=True,
                                       **_kw(family, False)))
    out = engine.generate(family["model"], pcfg, prompt, max_new_tokens=NEW, long_context=True,
                          device="cpu", **_kw(family, True))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("S", [13, 16])
def test_prefill_and_decode_logits_match_reference(family, S):
    if (family["name"], S) not in CASES:
        _held_to_windowed_forward(family, S)
        return
    jcfg, pcfg, params, model = family["jcfg"], family["pcfg"], family["params"], family["model"]
    toks = _tokens(jcfg, S + NEW, seed=5)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    ref_logits, ref_cache = J_engine.prefill(params, jcfg, jt[:, :S], max_len=S + NEW + 1,
                                             long_context=True, **_kw(family, False))
    with torch.inference_mode():
        logits, cache = engine.prefill(model, pcfg, tt[:, :S], max_len=S + NEW + 1,
                                       long_context=True, **_kw(family, True))
        _close(logits, ref_logits)
        for j in range(NEW):
            pos = S + j
            ref_logits, ref_cache = J_engine.decode_step(
                params, jcfg, jt[:, pos:pos + 1], jnp.full((2, 1), pos), ref_cache,
                long_context=True)
            logits, cache = engine.decode_step(
                model, pcfg, tt[:, pos:pos + 1], torch.full((2, 1), pos), cache,
                long_context=True)
            _close(logits, ref_logits)


def _windowed_forward(params, jcfg, toks):
    full, _, _ = J_transformer.forward(params, jcfg, jnp.asarray(toks, jnp.int32),
                                       window_override=jcfg.long_context_window)
    return np.asarray(full)


def _held_to_windowed_forward(fam, S: int) -> None:
    """deepseek at an unaligned prompt: the port's long-context prefill and
    decode within ``TOL`` of the reference's windowed full forward, which
    the reference's own long-context decode leaves (module docstring)."""
    jcfg, pcfg, params, model = fam["jcfg"], fam["pcfg"], fam["params"], fam["model"]
    toks = _tokens(jcfg, S + NEW, seed=5)
    full = _windowed_forward(params, jcfg, toks)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    _, ref_cache = J_engine.prefill(params, jcfg, jt[:, :S], max_len=S + NEW + 1,
                                    long_context=True)
    ref_err = 0.0
    with torch.inference_mode():
        logits, cache = engine.prefill(model, pcfg, tt[:, :S], max_len=S + NEW + 1,
                                       long_context=True)
        _close(logits, full[:, S - 1])
        for j in range(NEW):
            pos = S + j
            logits, cache = engine.decode_step(model, pcfg, tt[:, pos:pos + 1],
                                               torch.full((2, 1), pos), cache, long_context=True)
            _close(logits, full[:, pos])
            ref_logits, ref_cache = J_engine.decode_step(
                params, jcfg, jt[:, pos:pos + 1], jnp.full((2, 1), pos), ref_cache,
                long_context=True)
            ref_err = max(ref_err, float(np.abs(np.asarray(ref_logits) - full[:, pos]).max()))
    assert ref_err > 1e-2, ref_err  # the reference's clamped prefill write


def test_long_context_logits_match_the_windowed_full_forward(family):
    """Prefill and decode in the long-context mode against the reference's
    full forward with ``window_override`` at the same positions (whisper:
    its full forward, the flag ignored)."""
    jcfg, pcfg, params, model = family["jcfg"], family["pcfg"], family["params"], family["model"]
    S = 13
    toks = _tokens(jcfg, S + NEW, seed=11)
    if jcfg.arch_type == "audio":
        batch = {"tokens": jnp.asarray(toks, jnp.int32), "frames": jnp.asarray(family["frames"])}
        full = np.asarray(J_registry.model_forward(params, jcfg, batch)[0])
    else:
        full = _windowed_forward(params, jcfg, toks)
    tt = torch.as_tensor(toks)
    with torch.inference_mode():
        logits, cache = engine.prefill(model, pcfg, tt[:, :S], max_len=S + NEW + 1,
                                       long_context=True, **_kw(family, True))
        tol = 2e-3 if jcfg.arch_type in ("audio", "ssm") else TOL
        np.testing.assert_allclose(logits.numpy(), full[:, S - 1], atol=tol, rtol=tol)
        for j in range(NEW):
            pos = S + j
            logits, cache = engine.decode_step(model, pcfg, tt[:, pos:pos + 1],
                                               torch.full((2, 1), pos), cache, long_context=True)
            np.testing.assert_allclose(logits.numpy(), full[:, pos], atol=tol, rtol=tol)


@pytest.mark.parametrize("max_len", [5, 40])
@pytest.mark.parametrize("name", [f for f in FAMILIES if f != "whisper-small"])
def test_long_context_cache_shapes_match_reference(name, max_len):
    """Every layer's cache in the long-context mode has the reference's
    shapes: window rings of min(window, max_len), MLA rings of exactly the
    window, recurrent states as they are. An MLA ring says it is one
    (``"ring": True``, a key the reference's caches have not: its MLA
    write always wraps)."""
    jcfg = dataclasses.replace(J_get_smoke(name), long_context_window=WINDOW)
    pcfg = dataclasses.replace(get_smoke_config(name), long_context_window=WINDOW)
    ref = J_transformer.init_cache(jcfg, 2, max_len, long_context=True)
    reps = jcfg.num_layers // len(jcfg.layer_pattern)
    plen = len(jcfg.layer_pattern)
    ref_layers = []
    for i in range(jcfg.num_layers):
        g, j = divmod(i, plen)
        if g < reps:
            ref_layers.append(jax.tree_util.tree_map(lambda x: x[g], ref["stages"][j]))
        else:
            ref_layers.append(ref["tail"][i - reps * plen])
    port = transformer.init_cache(pcfg, 2, max_len, long_context=True, device="cpu")
    assert len(port) == len(ref_layers)
    for layer, ref_layer in zip(port, ref_layers):
        assert set(layer) - {"ring"} == set(ref_layer)
        assert layer.get("ring", False) == ("c_kv" in layer)
        for key, value in layer.items():
            if key == "ring":
                continue
            if key == "index":
                assert value.shape == () and int(value) == 0
                continue
            assert tuple(value.shape) == tuple(np.shape(ref_layer[key])), (key, max_len)


def test_long_context_prefill_takes_a_prompt_past_max_len():
    """A ring has no end: a prompt longer than ``max_len`` prefills in the
    long-context mode (dense rings of min(window, max_len), MLA's of the
    window) and is refused with full caches."""
    for name in ("qwen3-0.6b", "deepseek-v2-236b"):
        cfg = dataclasses.replace(get_smoke_config(name), long_context_window=WINDOW)
        model = registry.init_model(cfg, seed=0, device="cpu")
        toks = torch.as_tensor(_tokens(cfg, 20))
        with torch.inference_mode():
            logits, cache = engine.prefill(model, cfg, toks, max_len=12, long_context=True)
            assert torch.isfinite(logits).all()
            assert int(cache[0]["index"]) == 20
            with pytest.raises(ValueError, match="cannot take"):
                engine.prefill(model, cfg, toks, max_len=12)


def test_mla_ring_write_wraps_and_the_append_refuses():
    """``update_mla_ring`` puts position p at slot p mod L (the last L of a
    longer write); ``update_mla_cache`` refuses a write longer than the
    cache."""
    cache = kvcache.init_mla_cache(1, 4, 2, 1, torch.float32, device="cpu")
    c = torch.arange(6, dtype=torch.float32).reshape(1, 6, 1).expand(1, 6, 2)
    r = torch.arange(6, dtype=torch.float32).reshape(1, 6, 1)
    kvcache.update_mla_ring(cache, c, r)
    assert cache["k_rope"][0, :, 0].tolist() == [4.0, 5.0, 2.0, 3.0]
    kvcache.update_mla_ring(cache, c[:, :1] + 6, r[:, :1] + 6)
    assert cache["k_rope"][0, :, 0].tolist() == [4.0, 5.0, 6.0, 3.0]
    assert int(cache["index"]) == 7
    full = kvcache.init_mla_cache(1, 4, 2, 1, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="cannot take"):
        kvcache.update_mla_cache(full, c, r)


def test_mla_write_follows_the_cache_not_the_window():
    """The MLA write is the cache's own: a full cache given
    ``window_override`` still appends (and refuses a write past its end),
    a long-context ring wraps."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), long_context_window=WINDOW)
    model = registry.init_model(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(_tokens(cfg, 20))
    pos = torch.arange(20)[None].expand(2, 20)
    with torch.inference_mode():
        full = transformer.init_cache(cfg, 2, 12, device="cpu")
        with pytest.raises(ValueError, match="MLA cache of 12 positions cannot take 20"):
            model(toks, cache=full, positions=pos, window_override=WINDOW)
        ring = transformer.init_cache(cfg, 2, 12, long_context=True, device="cpu")
        _, ring, _ = model(toks, cache=ring, positions=pos, window_override=WINDOW)
        assert all(layer["ring"] and int(layer["index"]) == 20 for layer in ring)
        transformer.reset_cache_(cfg, ring)
    assert all(layer["ring"] and int(layer["index"]) == 0 for layer in ring)


def test_long_context_generate_after_a_full_one_builds_a_new_decoder():
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), long_context_window=WINDOW)
    model = registry.init_model(cfg, seed=0, device="cpu")
    prompt = _tokens(cfg, 13)
    engine.generate(model, cfg, prompt, max_new_tokens=4, device="cpu")
    full = engine.decoder_for(model, cfg, 2, 13 + 4 + 1)
    assert not full.long_context and full.n_captures == 1
    assert full.cache[0]["k"].shape[1] == 18
    engine.generate(model, cfg, prompt, max_new_tokens=4, long_context=True, device="cpu")
    ring = engine.decoder_for(model, cfg, 2, 13 + 4 + 1, long_context=True)
    assert ring is not full and ring.long_context
    assert ring.n_captures == 1  # its own capture, not the full decoder's
    assert ring.cache[0]["k"].shape[1] == WINDOW
    assert engine.decoder_for(model, cfg, 2, 18) is not ring  # back to full: another new one


def test_whisper_ignores_long_context():
    cfg = dataclasses.replace(get_smoke_config("whisper-small"), long_context_window=WINDOW)
    model = registry.init_model(cfg, seed=0, device="cpu")
    frames = torch.as_tensor((np.random.default_rng(1).normal(
        size=(2, cfg.encoder.num_frames, cfg.d_model)) * 0.1).astype(np.float32))
    prompt = _tokens(cfg, 13)
    a = engine.generate(model, cfg, prompt, max_new_tokens=6, frames=frames, device="cpu")
    b = engine.generate(model, cfg, prompt, max_new_tokens=6, frames=frames,
                        long_context=True, device="cpu")
    assert torch.equal(a, b)
    dec = engine.decoder_for(model, cfg, 2, 13 + 6 + 1, long_context=True)
    assert not dec.long_context
