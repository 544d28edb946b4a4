"""The port's whisper (``repro_torch.models.whisper``) against the reference.

Pieces, in float32 on the same numpy inputs at 1e-5: ``layer_norm``,
``sinusoidal_positions``, ``cross_attention``, and the encoder's attention
(``attention(..., causal=False)`` at zero positions: RoPE at angle 0 is
the identity, so it is the reference's bidirectional attention).

whisper-small end to end at its smoke config, with the reference's
``init_whisper`` weights (every constant leaf -- the layer norms' scales
and biases -- perturbed, as in ``test_torch_dense_families.py``) carried
over by ``convert``, and frames N(0, 0.1) as the reference's
``test_decode_consistency.py`` draws them: the encoder's states, logits
within 1e-4 (the attention is plain on both paths), the loss within 1e-5
(aux 0), decode against the full forward within 2e-3 at that test's shape,
greedy ``generate`` the reference's tokens (twice through one decoder, and
for other frames, which land in the decoder's static encoder buffer), the
``Decoder`` bitwise a ``decode_step`` loop, the weights round trip bitwise,
``get_config`` field for field and the full config's 0.238 B parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as J_get_config  # noqa: E402
from repro.configs import get_smoke_config as J_get_smoke  # noqa: E402
from repro.models import attention as J_attn  # noqa: E402
from repro.models import init_model as J_init_model  # noqa: E402
from repro.models import layers as J_layers  # noqa: E402
from repro.models import param_count as J_param_count  # noqa: E402
from repro.models import registry as J_registry  # noqa: E402
from repro.models import whisper as J_w  # noqa: E402
from repro.serve import engine as J_engine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.common import reference_dict  # noqa: E402
from repro_torch.configs import PORTED, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import attention as P_attn  # noqa: E402
from repro_torch.models import layers as P_layers  # noqa: E402
from repro_torch.models import param_count, registry  # noqa: E402
from repro_torch.models import whisper as P_w  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

NAME = "whisper-small"
TOL = 1e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(tree, seed: int):
    """The reference's weights with every constant leaf (layer-norm scales
    and biases) moved off its constant by N(0, 0.1) noise, as numpy."""
    rng = np.random.default_rng(seed)

    def move(leaf):
        leaf = np.asarray(leaf)
        if leaf.size > 1 and np.all(leaf == leaf.flat[0]):
            noise = rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
            return (leaf.astype(np.float32) + noise).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map(move, tree)


def _close(port: torch.Tensor, ref, tol: float = TOL) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _cfgs():
    return J_get_smoke(NAME), get_smoke_config(NAME)


def _attn_params(seed: int):
    jcfg, pcfg = _cfgs()
    tree = np_tree(J_attn.init_cross_attention(jax.random.PRNGKey(seed), jcfg))
    module = convert.module_params_from_numpy(P_attn.Attention(pcfg, "cpu"), tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), module, jcfg, pcfg


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

def test_layer_norm_matches_reference():
    tree = {"scale": 1.0 + _normal((64,), 0, 0.1), "bias": _normal((64,), 1, 0.1)}
    module = convert.module_params_from_numpy(P_layers.LayerNorm(64, torch.float32, "cpu"), tree)
    x = _normal((2, 7, 64), 2, 3.0) + 1.5
    ref = J_layers.layer_norm({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x), 1e-5)
    _close(P_layers.layer_norm(module, torch.as_tensor(x), 1e-5), ref)
    fresh = P_layers.init_layer_norm(64, torch.bfloat16, "cpu")
    assert fresh.scale.dtype == torch.bfloat16
    assert torch.equal(fresh.scale.detach(), torch.ones(64, dtype=torch.bfloat16))
    assert torch.equal(fresh.bias.detach(), torch.zeros(64, dtype=torch.bfloat16))


@pytest.mark.parametrize("length,dim", [(50, 64), (448, 64), (4096, 64), (1500, 32)])
def test_sinusoidal_positions_match_reference(length, dim):
    """The frequencies come from ``exp``, which XLA and PyTorch may round an
    ulp apart; at these widths the tables stay within 1e-5 to row 4095."""
    ref = J_layers.sinusoidal_positions(length, dim, jnp.float32)
    tab = P_layers.sinusoidal_positions(length, dim, torch.float32)
    assert tab.shape == (length, dim) and tab.dtype == torch.float32
    _close(tab, ref)
    assert P_layers.sinusoidal_positions(8, dim, torch.bfloat16).dtype == torch.bfloat16


def test_cross_attention_matches_reference():
    params, module, jcfg, pcfg = _attn_params(0)
    x, enc = _normal((2, 9, 64), 3), _normal((2, 50, 64), 4)
    ref = J_attn.cross_attention(params, jcfg, jnp.asarray(x), jnp.asarray(enc))
    with torch.inference_mode():
        out = P_attn.cross_attention(module, pcfg, torch.as_tensor(x), torch.as_tensor(enc))
    assert out.shape == (2, 9, 64)
    _close(out, ref)


def test_encoder_attention_is_the_references_bidirectional_attention():
    """``attention(..., causal=False)`` at zero positions is the reference's
    ``_bidir_attention``, and RoPE at angle 0 leaves q and k exactly as
    they were: the same output as attention of the unrotated projections."""
    params, module, jcfg, pcfg = _attn_params(1)
    x = _normal((2, 50, 64), 5)
    ref = J_w._bidir_attention(params, jcfg, jnp.asarray(x))
    zeros = torch.zeros((2, 50), dtype=torch.int64)
    with torch.inference_mode():
        out, cache = P_attn.attention(module, pcfg, torch.as_tensor(x), positions=zeros,
                                      causal=False, impl="plain")
        q, k, v = P_attn._project_qkv(module, pcfg, torch.as_tensor(x))
        plain = P_attn._sdpa(q, k, v, None, pcfg).reshape(2, 50, -1) @ module.wo
    assert cache is None
    _close(out, ref)
    assert torch.equal(out, plain)


# ---------------------------------------------------------------------------
# whisper-small end to end
# ---------------------------------------------------------------------------

def _batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"frames": _normal((B, cfg.encoder.num_frames, cfg.d_model), seed + 100, 0.1),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v, jnp.int32 if k != "frames" else jnp.float32)
            for k, v in batch.items()}


def _torch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def family():
    """Perturbed reference weights in both packages, and both packages'
    logits, losses and encoder states (B = 2, S = 40 decoder tokens)."""
    jcfg, pcfg = _cfgs()
    tree = perturbed(np_tree(J_w.init_whisper(jax.random.PRNGKey(0), jcfg)), 1)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    batch = _batch(jcfg, 2, 40)
    jbatch, tbatch = _jax(batch), _torch(batch)
    scored = {}
    for jimpl, pimpl in (("xla", "plain"), ("pallas", "kernel")):
        ref_logits, _, _ = J_registry.model_forward(params, jcfg, jbatch, impl=jimpl)
        ref_loss, _ = J_registry.loss_fn(params, jcfg, jbatch, impl=jimpl)
        with torch.inference_mode():
            logits, cache, aux = registry.model_forward(model, pcfg, tbatch, impl=pimpl)
            loss, metrics = registry.loss_fn(model, pcfg, tbatch, impl=pimpl)
        scored[pimpl] = dict(ref_logits=ref_logits, ref_loss=ref_loss, logits=logits,
                             cache=cache, aux=aux, loss=loss, metrics=metrics)
    return dict(jcfg=jcfg, pcfg=pcfg, tree=tree, params=params, model=model, batch=batch,
                scored=scored)


def test_encoder_states_match_reference(family):
    frames = family["batch"]["frames"]
    ref = J_w.encode(family["params"], family["jcfg"], jnp.asarray(frames))
    with torch.inference_mode():
        out = P_w.encode(family["model"], family["pcfg"], torch.as_tensor(frames))
    assert out.shape == (2, family["pcfg"].encoder.num_frames, family["pcfg"].d_model)
    _close(out, ref)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_logits_match_reference(family, impl):
    s = family["scored"][impl]
    assert s["logits"].shape == (2, 40, family["pcfg"].vocab_size)
    assert s["cache"] is None and float(s["aux"]) == 0.0
    _close(s["logits"], s["ref_logits"], 1e-4)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_loss_matches_reference(family, impl):
    s = family["scored"][impl]
    loss = float(s["loss"])
    assert np.isfinite(loss) and loss > np.log(family["pcfg"].vocab_size) - 1.0
    assert float(s["metrics"]["nll"]) == loss and float(s["metrics"]["aux"]) == 0.0
    np.testing.assert_allclose(loss, float(s["ref_loss"]), atol=1e-5, rtol=1e-5)


def test_decode_matches_full_forward():
    """The reference's decode-consistency check on the port, with the
    reference's weights and draws: encode, prefill 23 tokens, decode the
    24th -- through ``prefill`` / ``decode_step`` and through the decoder."""
    jcfg, pcfg = _cfgs()
    S, B = 24, 2
    params = J_init_model(jax.random.PRNGKey(1), jcfg)
    frames = np.array(jax.random.normal(jax.random.PRNGKey(2),
                                        (B, jcfg.encoder.num_frames, jcfg.d_model)) * 0.1)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(3), (B, S), 0, jcfg.vocab_size))
    model = convert.lm_params_from_numpy(np_tree(params), pcfg, "cpu")
    enc = J_w.encode(params, jcfg, jnp.asarray(frames))
    jcache = J_w.init_whisper_cache(jcfg, B, S + 8, enc)
    pos = jnp.broadcast_to(jnp.arange(S - 1)[None], (B, S - 1))
    _, jcache, _ = J_w.whisper_forward(params, jcfg, None, jnp.asarray(toks[:, : S - 1]),
                                       cache=jcache, positions=pos)
    ref, _, _ = J_w.whisper_forward(params, jcfg, None, jnp.asarray(toks[:, S - 1 :]),
                                    cache=jcache, positions=jnp.full((B, 1), S - 1))
    t, f = torch.as_tensor(toks), torch.as_tensor(frames)
    with torch.inference_mode():
        full, _, _ = P_w.whisper_forward(model, pcfg, f, t)
        _, cache = engine.prefill(model, pcfg, t[:, : S - 1], max_len=S + 8, frames=f)
        last, _ = engine.decode_step(model, pcfg, t[:, S - 1 :], torch.full((B, 1), S - 1), cache)
    dec = engine.Decoder(model, pcfg, B, S + 8)
    dec.start(t[:, : S - 1], frames=f)
    dec.step(t[:, S - 1 :])
    err = float((last - full[:, -1]).abs().max())
    assert err < 2e-3, f"decode/full mismatch {err}"
    assert torch.equal(dec.logits, last)
    _close(last, ref[:, 0], 1e-4)


def test_generate_matches_reference_greedy_tokens(family):
    """Twice with one decoder, then with other frames: the decoder's
    static encoder buffer takes them in place."""
    jcfg, pcfg, model = family["jcfg"], family["pcfg"], family["model"]
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 24))
    frames = [family["batch"]["frames"], _normal(family["batch"]["frames"].shape, 7, 0.1)]
    last_logits = []
    for f in (frames[0], frames[0], frames[1]):
        ref = J_engine.generate(family["params"], jcfg, jnp.asarray(prompt, jnp.int32),
                                max_new_tokens=8, frames=jnp.asarray(f))
        out = engine.generate(model, pcfg, prompt, max_new_tokens=8, frames=torch.as_tensor(f),
                              device="cpu")
        assert out.shape == (2, 8) and out.dtype == torch.int64
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        last_logits.append(engine.decoder_for(model, pcfg, 2, 24 + 8 + 1).logits.clone())
    assert torch.equal(last_logits[0], last_logits[1])
    assert not torch.equal(last_logits[1], last_logits[2])  # the other frames were read
    dec = engine.decoder_for(model, pcfg, 2, 24 + 8 + 1)
    assert dec.n_captures == 1
    with torch.inference_mode():
        _close(dec.cache["encoder_out"],
               J_w.encode(family["params"], jcfg, jnp.asarray(frames[1])))


def test_decoder_is_bitwise_the_eager_loop(family):
    model, pcfg = family["model"], family["pcfg"]
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, pcfg.vocab_size, (2, 10)))
    frames = torch.as_tensor(family["batch"]["frames"])
    new = 6
    with torch.inference_mode():
        logits, cache = engine.prefill(model, pcfg, prompt, max_len=10 + new + 1, frames=frames)
        eager = [logits]
        tok = logits.argmax(-1, keepdim=True)
        for pos in range(10, 10 + new - 1):
            logits, cache = engine.decode_step(model, pcfg, tok, torch.full((2, 1), pos), cache)
            eager.append(logits)
            tok = logits.argmax(-1, keepdim=True)
    dec = engine.Decoder(model, pcfg, 2, 10 + new + 1)
    buffer = dec.cache["encoder_out"]
    dec.start(prompt, frames=frames)
    graph = [dec.logits.clone()]
    for _ in range(new - 1):
        dec.step()
        graph.append(dec.logits.clone())
    assert dec.n_captures == 1 and dec.cache["encoder_out"] is buffer
    assert all(torch.equal(a, b) for a, b in zip(graph, eager))


def test_prefill_needs_frames_and_positions_stay_in_the_table(family):
    model, pcfg = family["model"], family["pcfg"]
    prompt = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="frames"):
        engine.prefill(model, pcfg, prompt, max_len=8)
    with pytest.raises(ValueError, match="position table"):
        engine.Decoder(model, pcfg, 2, P_w.MAX_POSITIONS + 1)


def test_make_inputs_caps_the_decoder_length():
    pcfg = get_smoke_config(NAME)
    batch = registry.make_inputs(pcfg, 2, 500, seed=3, device="cpu")
    assert batch["tokens"].shape == batch["labels"].shape == (2, 448)
    assert batch["frames"].shape == (2, pcfg.encoder.num_frames, pcfg.d_model)
    assert batch["frames"].dtype == torch.float32 and float(batch["frames"].abs().max()) == 0.0
    assert registry.make_inputs(pcfg, 2, 40, device="cpu")["tokens"].shape == (2, 40)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_round_trip_bitwise(dtype):
    jcfg = dataclasses.replace(J_get_smoke(NAME), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config(NAME), dtype=dtype)
    tree = perturbed(np_tree(J_w.init_whisper(jax.random.PRNGKey(4), jcfg)), 5)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    back = convert.lm_params_to_numpy(model)
    flat, flat_back = jax.tree_util.tree_flatten_with_path(tree), \
        jax.tree_util.tree_flatten_with_path(back)
    assert flat[1] == flat_back[1]
    for (path, leaf), (_, leaf_back) in zip(flat[0], flat_back[0]):
        assert leaf.dtype == leaf_back.dtype and leaf.shape == leaf_back.shape, path
        np.testing.assert_array_equal(leaf.view(np.uint8), leaf_back.view(np.uint8))
    np.testing.assert_array_equal(
        model.get_parameter("dec_layers.1.cross_attn.wk").float().numpy(),
        tree["dec_layers"][1]["cross_attn"]["wk"].astype(np.float32))
    assert model.positions.dtype == model.token_embed.dtype


def test_full_config_matches_reference_and_counts_its_parameters():
    assert "whisper_small" in PORTED
    assert reference_dict(get_config(NAME)) == dataclasses.asdict(J_get_config(NAME))
    assert reference_dict(get_smoke_config(NAME)) == dataclasses.asdict(J_get_smoke(NAME))
    abstract = jax.eval_shape(lambda k: J_w.init_whisper(k, J_get_config(NAME)),
                              jax.random.PRNGKey(0))
    n = param_count(P_w.Whisper(get_config(NAME), "meta"))  # shapes only, nothing allocated
    assert n == J_param_count(abstract) == 238_108_416
