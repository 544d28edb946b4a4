"""The port's xLSTM (``repro_torch.models.xlstm``) against the reference.

Blocks, in float32 on the same numpy inputs with the reference's weights
(every constant leaf -- norm scales, ``b_if`` / ``b_in`` -- perturbed, as
in ``test_torch_dense_families.py``), each port function against the
reference's at 1e-5: the causal conv (``layers.causal_conv1d``, shared
with the RG-LRU block) with and without state, the
parallel, chunkwise (chunk 64, both packages) and recurrent mLSTM, the
prefill's closed-form state, the sLSTM step and block with and without
state, and the mLSTM block through its chunkwise branch (S = 2560).

The sLSTM time loop: the captured bodies (run eagerly on the CPU, counted
as the card would capture them) are bitwise the eager step-by-step loop;
one set of bodies per shape, so a second call captures nothing new.

xlstm-350m end to end at its smoke config (mLSTM then sLSTM): logits on
both paths within 1e-4 of the reference's, the loss within 1e-5, decode
against the full forward at ``test_decode_consistency.py``'s shape within
2e-3, greedy ``generate`` the reference's tokens -- twice through one
decoder, whose ``start`` resets the sLSTM's ``m`` to -1e30 rather than 0
-- the ``Decoder`` bitwise a ``decode_step`` loop, the weights round trip
bitwise, ``get_config`` field for field and the full config's 0.440 B
parameters.
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
from repro.models import init_model as J_init_model  # noqa: E402
from repro.models import param_count as J_param_count  # noqa: E402
from repro.models import registry as J_registry  # noqa: E402
from repro.models import transformer as J_transformer  # noqa: E402
from repro.models import xlstm as J_x  # noqa: E402
from repro.serve import engine as J_engine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.common import reference_dict  # noqa: E402
from repro_torch.configs import PORTED, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import layers as P_layers  # noqa: E402
from repro_torch.models import param_count, registry, transformer  # noqa: E402
from repro_torch.models import xlstm as P_x  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

NAME = "xlstm-350m"
TOL = 1e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(tree, seed: int):
    """The reference's weights with every constant leaf (norm scales, gate
    biases) moved off its constant by N(0, 0.1) noise, as numpy."""
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


def _blocks(kind: str, seed: int = 0):
    """The reference's block params (perturbed) and the port's block holding them."""
    jcfg, pcfg = _cfgs()
    init = J_x.init_mlstm_block if kind == "mlstm" else J_x.init_slstm_block
    tree = perturbed(np_tree(init(jax.random.PRNGKey(seed), jcfg)), seed + 1)
    cls = P_x.MLSTMBlock if kind == "mlstm" else P_x.SLSTMBlock
    block = convert.module_params_from_numpy(cls(pcfg, "cpu"), tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), block, jcfg, pcfg


def _state(ref_state: dict) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in ref_state.items()}


def _qkv_gates(B, H, S, Dh, seed):
    """q / k at the block's scale (~0.3: the conv path's projections), v and
    the input gate ~N(0, 1), the forget gate ~N(1, 1)."""
    q, k = (_normal((B, H, S, Dh), seed + i, 0.3) for i in range(2))
    v = _normal((B, H, S, Dh), seed + 2)
    i_t = _normal((B, H, S), seed + 3)
    f_t = _normal((B, H, S), seed + 4) + 1.0
    return q, k, v, i_t, f_t


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    x, w = _normal((2, 9, 16), 0), _normal((4, 16), 1, 0.1)
    state = _normal((2, 3, 16), 2) if with_state else None
    ref_y, ref_state = J_x._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                          None if state is None else jnp.asarray(state))
    y, new_state = P_layers.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                                          None if state is None else torch.as_tensor(state))
    _close(y, ref_y)
    _close(new_state, ref_state)


def test_mlstm_parallel_matches_reference():
    args = _qkv_gates(2, 2, 40, 16, 10)
    ref = J_x._mlstm_parallel(*map(jnp.asarray, args))
    _close(P_x._mlstm_parallel(*map(torch.as_tensor, args)), ref)


def test_mlstm_chunkwise_matches_reference_and_the_parallel_form():
    """chunk 64 on both packages (S = 256: four chunks carry the state)."""
    args = _qkv_gates(2, 2, 256, 16, 20)
    ref = J_x._mlstm_chunkwise(*map(jnp.asarray, args), chunk=64)
    out = P_x._mlstm_chunkwise(*map(torch.as_tensor, args), chunk=64)
    _close(out, ref)
    _close(out, P_x._mlstm_parallel(*map(torch.as_tensor, args)), 1e-4)
    with pytest.raises(ValueError):
        P_x._mlstm_chunkwise(*map(torch.as_tensor, args), chunk=100)


def test_mlstm_recurrent_step_matches_reference():
    q, k, v = (_normal((2, 2, 16), 30 + i) for i in range(3))
    i_t, f_t = _normal((2, 2), 33), _normal((2, 2), 34)
    state = {"C": _normal((2, 2, 16, 16), 35, 0.3), "n": _normal((2, 2, 16), 36, 0.3),
             "m": _normal((2, 2), 37)}
    ref_h, ref_state = J_x._mlstm_recurrent_step(
        *map(jnp.asarray, (q, k, v, i_t, f_t)), {kk: jnp.asarray(vv) for kk, vv in state.items()})
    h, new = P_x._mlstm_recurrent_step(*map(torch.as_tensor, (q, k, v, i_t, f_t)),
                                       _state(state))
    _close(h, ref_h)
    for name in ("C", "n", "m"):
        _close(new[name], ref_state[name])


@pytest.mark.parametrize("S", [1, 12])
def test_mlstm_block_with_state_matches_reference(S):
    """S = 12: the prefill (parallel output + the closed-form final state);
    S = 1: the recurrent step. The state is written in place."""
    params, block, jcfg, pcfg = _blocks("mlstm")
    x = _normal((2, S, jcfg.d_model), 40)
    ref_state = J_x.init_mlstm_state(jcfg, 2)
    ref_y, ref_new = J_x.mlstm_block(params, jcfg, jnp.asarray(x), ref_state)
    state = P_x.init_mlstm_state(pcfg, 2, "cpu")
    tensors = dict(state)
    with torch.inference_mode():
        y, new = P_x.mlstm_block(block, pcfg, torch.as_tensor(x), state)
    assert new is state and all(new[k] is tensors[k] for k in tensors)
    _close(y, ref_y)
    for name in ("C", "n", "m", "conv"):
        _close(new[name], ref_new[name])


@pytest.mark.parametrize("S,tol", [(40, TOL), (2560, 1e-4)])
def test_mlstm_block_full_sequence_matches_reference(S, tol):
    """S = 40: the parallel form; S = 2560: the chunkwise branch (> 2048,
    a multiple of 512), at 1e-4: over 2560 positions the reference's own
    chunkwise and parallel forms of this block differ by 1.2e-4 in float32
    (the port's chunkwise is 3.8e-5 from the reference's)."""
    params, block, jcfg, pcfg = _blocks("mlstm", seed=2)
    x = _normal((1, S, jcfg.d_model), 41)
    ref_y, _ = J_x.mlstm_block(params, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        y, state = P_x.mlstm_block(block, pcfg, torch.as_tensor(x))
    assert state is None
    _close(y, ref_y, tol)


def test_slstm_step_matches_reference():
    params, block, jcfg, pcfg = _blocks("slstm")
    d = jcfg.d_model
    shape = (2, jcfg.num_heads, d // jcfg.num_heads)
    state = {"c": _normal(shape, 50), "n": np.abs(_normal(shape, 51)) + 0.5,
             "h": _normal(shape, 52, 0.5), "m": _normal(shape, 53)}
    x_t = _normal((2, 4 * d), 54)
    ref = J_x._slstm_step(params, jcfg, {k: jnp.asarray(v) for k, v in state.items()},
                          jnp.asarray(x_t))
    with torch.inference_mode():
        new = P_x._slstm_step(block, pcfg, _state(state), torch.as_tensor(x_t))
    for name in ("c", "n", "h", "m"):
        _close(new[name], ref[name])


@pytest.mark.parametrize("S,with_state", [(30, False), (70, False), (30, True), (1, True)])
def test_slstm_block_matches_reference(S, with_state):
    """Without state (S = 70 runs a 64-step body and a 6-step one), and
    from a non-fresh state: a prefill (S = 30) and one step (S = 1)."""
    params, block, jcfg, pcfg = _blocks("slstm", seed=3)
    x = _normal((2, S, jcfg.d_model), 60)
    if with_state:
        shape = (2, jcfg.num_heads, jcfg.d_model // jcfg.num_heads)
        init = {"c": _normal(shape, 61), "n": np.abs(_normal(shape, 62)) + 0.5,
                "h": _normal(shape, 63, 0.5), "m": _normal(shape, 64)}
        ref_y, ref_new = J_x.slstm_block(params, jcfg, jnp.asarray(x),
                                         {k: jnp.asarray(v) for k, v in init.items()})
        state = _state(init)
    else:
        ref_y, _ = J_x.slstm_block(params, jcfg, jnp.asarray(x))
        state = None
    with torch.inference_mode():
        y, new = P_x.slstm_block(block, pcfg, torch.as_tensor(x), state)
    _close(y, ref_y)
    if with_state:
        assert new is state
        for name in ("c", "n", "h", "m"):
            _close(new[name], ref_new[name])
    else:
        assert new is None


def test_fresh_states_are_the_references_and_not_aliased():
    """The sLSTM's c, n and h are three tensors (the reference shares one
    zeros array); written in place, aliases would corrupt one another."""
    jcfg, pcfg = _cfgs()
    for port, ref in ((P_x.init_mlstm_state(pcfg, 2, "cpu"), J_x.init_mlstm_state(jcfg, 2)),
                      (P_x.init_slstm_state(pcfg, 2, "cpu"), J_x.init_slstm_state(jcfg, 2))):
        assert set(port) == set(ref)
        for name, t in port.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(ref[name]))
        ptrs = [t.data_ptr() for t in port.values()]
        assert len(set(ptrs)) == len(ptrs)
    state = P_x.init_slstm_state(pcfg, 2, "cpu")
    state["c"].fill_(3.0)
    assert float(state["n"].abs().max()) == 0.0 and float(state["h"].abs().max()) == 0.0
    P_x.reset_state_(state)
    assert float(state["c"].abs().max()) == 0.0 and float(state["m"].max()) == float(torch.tensor(-1e30))


# ---------------------------------------------------------------------------
# The sLSTM time loop
# ---------------------------------------------------------------------------

def test_captured_loop_is_bitwise_the_eager_loop_and_captures_once():
    """Bodies of 64 steps and a tail (S = 150: 64, 64, 22): the captured
    loop (eager on the CPU) gives the eager loop's outputs and state bit
    for bit; each body length captures at its second run, and a second
    call at the same shape captures nothing new."""
    _, block, jcfg, pcfg = _blocks("slstm", seed=4)
    x = torch.as_tensor(_normal((3, 150, jcfg.d_model), 70))
    outs = {}
    with torch.inference_mode():
        for mode in ("eager", "captured"):
            state = P_x.init_slstm_state(pcfg, 3, "cpu")
            with P_x.slstm_loop(mode):
                before = P_x.loop_captures()
                y, _ = P_x.slstm_block(block, pcfg, x, state)
                outs[mode] = (y, state, P_x.loop_captures() - before)
        assert torch.equal(outs["eager"][0], outs["captured"][0])
        for name in ("c", "n", "h", "m"):
            assert torch.equal(outs["eager"][1][name], outs["captured"][1][name])
        assert outs["eager"][2] == 0
        assert outs["captured"][2] == 1  # the 64-step body ran twice, the 22-step once
        before = P_x.loop_captures()
        y2, _ = P_x.slstm_block(block, pcfg, x)
        assert P_x.loop_captures() - before == 1  # the 22-step body's second run
        y3, _ = P_x.slstm_block(block, pcfg, x)
        assert P_x.loop_captures() - before == 1
    assert torch.equal(y2, y3)
    with pytest.raises(ValueError):
        with P_x.slstm_loop("scan"):
            pass


# ---------------------------------------------------------------------------
# xlstm-350m end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def family():
    """Perturbed reference weights in both packages, and both packages'
    logits and losses on both paths (B = 2, S = 128)."""
    jcfg, pcfg = _cfgs()
    tree = perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(0), jcfg)), 1)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 128)),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 128))}
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    scored = {}
    for jimpl, pimpl in (("xla", "plain"), ("pallas", "kernel")):
        ref_logits, _, _ = J_registry.model_forward(params, jcfg, jbatch, impl=jimpl)
        ref_loss, _ = J_registry.loss_fn(params, jcfg, jbatch, impl=jimpl)
        with torch.inference_mode():
            logits, cache, aux = registry.model_forward(model, pcfg, tbatch, impl=pimpl)
            loss, metrics = registry.loss_fn(model, pcfg, tbatch, impl=pimpl)
        scored[pimpl] = dict(ref_logits=ref_logits, ref_loss=ref_loss, logits=logits,
                             cache=cache, aux=aux, loss=loss, metrics=metrics)
    return dict(jcfg=jcfg, pcfg=pcfg, tree=tree, params=params, model=model, scored=scored)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_logits_match_reference(family, impl):
    s = family["scored"][impl]
    assert s["logits"].shape == (2, 128, family["pcfg"].vocab_size)
    assert s["cache"] is None and float(s["aux"]) == 0.0
    _close(s["logits"], s["ref_logits"], 1e-4)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_loss_matches_reference(family, impl):
    s = family["scored"][impl]
    loss = float(s["loss"])
    assert np.isfinite(loss) and loss > np.log(family["pcfg"].vocab_size) - 1.0
    assert float(s["metrics"]["nll"]) == loss
    np.testing.assert_allclose(loss, float(s["ref_loss"]), atol=1e-5, rtol=1e-5)


def test_layers_are_the_pattern_and_have_no_mlp(family):
    model = family["model"]
    assert [layer.kind for layer in model.layers] == ["mlstm", "slstm"]
    assert isinstance(model.layers[0].block, P_x.MLSTMBlock)
    assert isinstance(model.layers[1].block, P_x.SLSTMBlock)
    assert not any(hasattr(layer, "mlp") or hasattr(layer, "ln2") for layer in model.layers)


def test_decode_matches_full_forward():
    """The reference's decode-consistency check on the port, with the
    reference's weights and draws: prefill 23 tokens, decode the 24th."""
    jcfg, pcfg = _cfgs()
    S, B = 24, 2
    params = J_init_model(jax.random.PRNGKey(1), jcfg)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(3), (B, S), 0, jcfg.vocab_size))
    model = convert.lm_params_from_numpy(np_tree(params), pcfg, "cpu")
    jcache = J_transformer.init_cache(jcfg, B, S + 8)
    pos = jnp.broadcast_to(jnp.arange(S - 1)[None], (B, S - 1))
    _, jcache, _ = J_transformer.forward(params, jcfg, jnp.asarray(toks[:, : S - 1]),
                                         cache=jcache, positions=pos)
    ref, _, _ = J_transformer.forward(params, jcfg, jnp.asarray(toks[:, S - 1 :]), cache=jcache,
                                      positions=jnp.full((B, 1), S - 1))
    t = torch.as_tensor(toks)
    with torch.inference_mode():
        full, _, _ = model(t)
        cache = transformer.init_cache(pcfg, B, S + 8, device="cpu")
        _, cache, _ = model(t[:, : S - 1], cache=cache,
                            positions=torch.arange(S - 1)[None].expand(B, S - 1))
        last, _ = engine.decode_step(model, pcfg, t[:, S - 1 :], torch.full((B, 1), S - 1), cache)
    dec = engine.Decoder(model, pcfg, B, S + 8)
    dec.start(t[:, : S - 1])
    dec.step(t[:, S - 1 :])
    err = float((last - full[:, -1]).abs().max())
    assert err < 2e-3, f"decode/full mismatch {err}"
    assert torch.equal(dec.logits, last)
    _close(last, ref[:, 0], 1e-4)


def test_generate_twice_through_one_decoder_gives_the_reference_tokens(family):
    """Both calls reuse one decoder; its ``start`` puts the xLSTM states'
    ``m`` back to -1e30 (a zero-fill would leave the sLSTM's prefill
    loop starting from m = 0 and change the tokens)."""
    jcfg, pcfg, model = family["jcfg"], family["pcfg"], family["model"]
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 24))
    ref = np.asarray(J_engine.generate(family["params"], jcfg, jnp.asarray(prompt, jnp.int32),
                                       max_new_tokens=8))
    first = engine.generate(model, pcfg, prompt, max_new_tokens=8, device="cpu")
    second = engine.generate(model, pcfg, prompt, max_new_tokens=8, device="cpu")
    dec = engine.decoder_for(model, pcfg, 2, 24 + 8 + 1)
    assert first.shape == (2, 8) and first.dtype == torch.int64
    np.testing.assert_array_equal(first.numpy(), ref)
    np.testing.assert_array_equal(second.numpy(), ref)
    assert dec.n_captures == 1
    ms = [t for i, layer in enumerate(dec.cache) for name, t in layer.items() if name == "m"]
    assert len(ms) == 2


def test_start_resets_the_xlstm_states(family):
    """After a run, ``reset_cache_`` puts every state back to
    ``init_cache``'s values, in the same tensors."""
    pcfg, model = family["pcfg"], family["model"]
    cache = transformer.init_cache(pcfg, 2, 16, device="cpu")
    fresh = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    ptrs = [{k: t.data_ptr() for k, t in layer.items()} for layer in cache]
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, pcfg.vocab_size, (2, 10)))
    with torch.inference_mode():
        model(toks, cache=cache, positions=torch.arange(10)[None].expand(2, 10))
    assert not torch.equal(cache[1]["m"], fresh[1]["m"])
    transformer.reset_cache_(pcfg, cache)
    for layer, want, ptr in zip(cache, fresh, ptrs):
        for name, t in layer.items():
            assert t.data_ptr() == ptr[name] and torch.equal(t, want[name]), name


def test_decoder_is_bitwise_the_eager_loop(family):
    model, pcfg = family["model"], family["pcfg"]
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, pcfg.vocab_size, (2, 10)))
    new = 6
    with torch.inference_mode():
        logits, cache = engine.prefill(model, pcfg, prompt, max_len=10 + new + 1)
        eager = [logits]
        tok = logits.argmax(-1, keepdim=True)
        for pos in range(10, 10 + new - 1):
            logits, cache = engine.decode_step(model, pcfg, tok, torch.full((2, 1), pos), cache)
            eager.append(logits)
            tok = logits.argmax(-1, keepdim=True)
    dec = engine.Decoder(model, pcfg, 2, 10 + new + 1)
    dec.start(prompt)
    graph = [dec.logits.clone()]
    for _ in range(new - 1):
        dec.step()
        graph.append(dec.logits.clone())
    assert dec.n_captures == 1
    assert all(torch.equal(a, b) for a, b in zip(graph, eager))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [2, 8])
def test_weights_round_trip_bitwise(num_layers, dtype):
    """Two layers (one group) and the full pattern twice (eight layers in
    two groups of mlstm, slstm ...); the recurrent ``r`` and the gate
    biases land per layer, by name."""
    jcfg = dataclasses.replace(J_get_smoke(NAME), num_layers=num_layers, dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config(NAME), num_layers=num_layers, dtype=dtype)
    tree = perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(4), jcfg)), 5)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    back = convert.lm_params_to_numpy(model)
    flat, flat_back = jax.tree_util.tree_flatten_with_path(tree), \
        jax.tree_util.tree_flatten_with_path(back)
    assert flat[1] == flat_back[1]
    for (path, leaf), (_, leaf_back) in zip(flat[0], flat_back[0]):
        assert leaf.dtype == leaf_back.dtype and leaf.shape == leaf_back.shape, path
        np.testing.assert_array_equal(leaf.view(np.uint8), leaf_back.view(np.uint8))
    plen = len(pcfg.layer_pattern)
    for g in range(num_layers // plen):
        r = model.get_parameter(f"layers.{g * plen + 1}.block.r")
        assert tuple(r.shape) == (4, pcfg.num_heads, 32, 32)
        np.testing.assert_array_equal(r.float().numpy(),
                                      tree["stages"][1]["block"]["r"][g].astype(np.float32))
        np.testing.assert_array_equal(
            model.get_parameter(f"layers.{g * plen}.block.b_if").float().numpy(),
            tree["stages"][0]["block"]["b_if"][g].astype(np.float32))


def test_full_config_matches_reference_and_counts_its_parameters():
    assert "xlstm_350m" in PORTED
    assert reference_dict(get_config(NAME)) == dataclasses.asdict(J_get_config(NAME))
    assert reference_dict(get_smoke_config(NAME)) == dataclasses.asdict(J_get_smoke(NAME))
    cfg = get_config(NAME)
    abstract = jax.eval_shape(lambda k: J_transformer.init_lm(k, J_get_config(NAME)),
                              jax.random.PRNGKey(0))
    n = param_count(transformer.LM(cfg, "meta"))  # shapes only, nothing allocated
    assert n == J_param_count(abstract) == 440_022_160
    assert [cfg.kind(i) for i in range(cfg.num_layers)].count("slstm") == 6
