"""The port's MoE families against the reference, end to end.

qwen3-moe-30b-a3b (capacity-dispatch MoE after GQA attention with
qk-norm) and deepseek-v2-236b (MLA attention, MoE with a shared expert),
each at its smoke config. The reference's ``init_lm`` weights -- every
constant leaf (norm scales) perturbed with numpy noise, as in
``test_torch_dense_families.py`` -- go into the port's ``LM`` through
``convert.lm_params_from_numpy``; both packages then score the same numpy
tokens:

* ``model_forward`` / ``loss_fn`` on the plain path (the reference's
  ``impl="xla"``) and the kernel path (its ``impl="pallas"``: the Pallas
  flash attention in interpret mode for qwen3-moe; MLA is plain on both
  paths), float32, B = 2, S = 128: logits within 1e-4, the loss (the NLL
  plus ``router_aux_coef * aux``) within 1e-5, the aux itself within
  1e-5;
* decode against the full forward at the reference's
  ``test_decode_consistency.py`` shape (S = 24, its draws) within 2e-3;
* greedy ``generate`` (a 24-token prompt, 8 new tokens): the reference's
  tokens;
* the ``Decoder`` (run eagerly on the CPU, captures counted as the card
  would) bitwise a ``decode_step`` loop, over steps whose routing differs;
* the weights round trip bitwise, ``get_config`` field for field, and
  the full configs' parameter counts against the reference's abstract
  ones (30.53 B and 244.19 B).
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
from repro.serve import engine as J_engine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.common import reference_dict  # noqa: E402
from repro_torch.configs import PORTED, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import moe as P_moe  # noqa: E402
from repro_torch.models import param_count, registry, transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

FAMILIES = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]
IMPLS = [("xla", "plain"), ("pallas", "kernel")]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(tree, seed: int):
    """The reference's weights with every constant leaf (norm scales) moved
    off its constant by N(0, 0.1) noise, as numpy."""
    rng = np.random.default_rng(seed)

    def move(leaf):
        leaf = np.asarray(leaf)
        if leaf.size > 1 and np.all(leaf == leaf.flat[0]):
            noise = rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
            return (leaf.astype(np.float32) + noise).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map(move, tree)


def _batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """One family's perturbed reference weights, both models, and both
    packages' logits, aux and losses on both paths (B = 2, S = 128)."""
    name = request.param
    jcfg, pcfg = J_get_smoke(name), get_smoke_config(name)
    tree = perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(0), jcfg)), 1)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    batch = _batch(jcfg, 2, 128)
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    scored = {}
    for jimpl, pimpl in IMPLS:
        ref_logits, _, ref_aux = J_registry.model_forward(params, jcfg, jbatch, impl=jimpl)
        ref_loss, ref_metrics = J_registry.loss_fn(params, jcfg, jbatch, impl=jimpl)
        fa_ops.reset_launch_counts()
        with torch.inference_mode():
            logits, cache, aux = registry.model_forward(model, pcfg, tbatch, impl=pimpl)
            loss, metrics = registry.loss_fn(model, pcfg, tbatch, impl=pimpl)
        scored[pimpl] = dict(ref_logits=ref_logits, ref_aux=ref_aux, ref_loss=ref_loss,
                             ref_metrics=ref_metrics, logits=logits, cache=cache, aux=aux,
                             loss=loss, metrics=metrics,
                             launches=fa_ops.launch_counts["flash_attention"])
    return dict(name=name, jcfg=jcfg, pcfg=pcfg, tree=tree, params=params, model=model,
                scored=scored)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_logits_match_reference(family, impl):
    s = family["scored"][impl]
    assert s["logits"].shape == (2, 128, family["pcfg"].vocab_size)
    assert s["logits"].dtype == torch.float32 and s["cache"] is None
    assert s["launches"] == 0  # the CPU runs the wrapper's plain version
    _close(s["logits"], s["ref_logits"], 1e-4)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_aux_matches_reference(family, impl):
    """The router losses summed over the layers, as the reference's scan
    carry sums them; > 0, and the same from the forward and the loss."""
    s = family["scored"][impl]
    assert s["aux"].dtype == torch.float32 and s["aux"].shape == ()
    assert float(s["aux"]) > 0.0
    np.testing.assert_allclose(float(s["aux"]), float(s["ref_aux"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(s["metrics"]["aux"]), float(s["ref_metrics"]["aux"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_loss_matches_reference(family, impl):
    """The loss is the NLL plus ``router_aux_coef * aux``, as the reference's."""
    s = family["scored"][impl]
    loss, nll = float(s["loss"]), float(s["metrics"]["nll"])
    vocab = family["pcfg"].vocab_size
    assert np.isfinite(loss) and nll > np.log(vocab) - 1.0  # random labels
    np.testing.assert_allclose(loss, float(s["ref_loss"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(nll, float(s["ref_metrics"]["nll"]), atol=1e-5, rtol=1e-5)
    coef = family["pcfg"].moe.router_aux_coef
    np.testing.assert_allclose(loss - nll, coef * float(s["metrics"]["aux"]), rtol=1e-4)


def test_loss_adds_the_router_loss_at_its_coefficient():
    """qwen3-moe's smoke model with ``router_aux_coef`` 0.5: loss - nll =
    0.5 aux (the NLL alone was returned before the MoE families)."""
    name = "qwen3-moe-30b-a3b"
    jcfg = J_get_smoke(name)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, router_aux_coef=0.5))
    pcfg = get_smoke_config(name)
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, router_aux_coef=0.5))
    tree = perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(2), jcfg)), 3)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    batch = _batch(pcfg, 2, 64, seed=4)
    with torch.inference_mode():
        loss, metrics = registry.loss_fn(model, pcfg, {k: torch.as_tensor(v)
                                                       for k, v in batch.items()})
    aux = float(metrics["aux"])
    assert aux > 0.5  # E * sum f P is ~1 per layer at random init
    np.testing.assert_allclose(float(loss) - float(metrics["nll"]), 0.5 * aux, rtol=1e-5)
    ref, _ = J_registry.loss_fn(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref), atol=1e-5, rtol=1e-5)


def test_decode_matches_full_forward(family):
    """The reference's decode-consistency check on the port, with the
    reference's weights and draws: prefill 23 tokens, decode the 24th
    (the smoke configs' capacity factor 8 drops nothing at S = 24)."""
    name, jcfg, pcfg = family["name"], family["jcfg"], family["pcfg"]
    S, B = 24, 2
    assert P_moe.capacity(S, pcfg) >= S
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
        pos = torch.arange(S - 1)[None].expand(B, S - 1)
        _, cache, _ = model(t[:, : S - 1], cache=cache, positions=pos)
        last, _ = engine.decode_step(model, pcfg, t[:, S - 1 :], torch.full((B, 1), S - 1), cache)
    dec = engine.Decoder(model, pcfg, B, S + 8)
    dec.start(t[:, : S - 1])
    dec.step(t[:, S - 1 :])
    err = float((last - full[:, -1]).abs().max())
    assert err < 2e-3, f"{name}: decode/full mismatch {err}"
    assert torch.equal(dec.logits, last)
    _close(last, ref[:, 0], 1e-4)


def test_mla_cache_holds_latents_only():
    """deepseek's caches are MLA's (c_kv, k_rope, a 0-d int64 index), not
    GQA caches of its unused ``num_kv_heads``."""
    pcfg = get_smoke_config("deepseek-v2-236b")
    cache = transformer.init_cache(pcfg, 2, 16, device="cpu")
    assert len(cache) == pcfg.num_layers
    for layer in cache:
        assert set(layer) == {"c_kv", "k_rope", "index"}
        assert tuple(layer["c_kv"].shape) == (2, 16, pcfg.mla.kv_lora_rank)
        assert tuple(layer["k_rope"].shape) == (2, 16, pcfg.mla.qk_rope_head_dim)
        assert layer["index"].dtype == torch.int64 and layer["index"].shape == ()


def test_generate_matches_reference_greedy_tokens(family):
    jcfg, pcfg = family["jcfg"], family["pcfg"]
    prompt = _batch(jcfg, 2, 24, seed=2)["tokens"]
    ref = J_engine.generate(family["params"], jcfg, jnp.asarray(prompt, jnp.int32),
                            max_new_tokens=8)
    out = engine.generate(family["model"], pcfg, prompt, max_new_tokens=8, device="cpu")
    assert out.shape == (2, 8) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decoder_is_bitwise_the_eager_loop_over_changing_routes(family, monkeypatch):
    """Six steps through the ``Decoder`` (eager on the CPU: a warm-up, the
    step the card captures, replays) give the logits of a ``decode_step``
    loop bit for bit, and the first layer's routing differs between
    steps (a captured step must not freeze one step's routes)."""
    model, pcfg = family["model"], family["pcfg"]
    prompt = torch.as_tensor(_batch(pcfg, 2, 10, seed=5)["tokens"])
    routes = []
    route = P_moe.route

    def recording(params, cfg, x):
        out = route(params, cfg, x)
        if params is model.layers[0].mlp and x.shape[1] == 1:
            routes.append(out[2].clone())
        return out

    monkeypatch.setattr(P_moe, "route", recording)
    new = 6
    with torch.inference_mode():
        logits, cache = engine.prefill(model, pcfg, prompt, max_len=10 + new + 1)
        eager = [logits]
        tok = logits.argmax(-1, keepdim=True)
        for pos in range(10, 10 + new - 1):
            logits, cache = engine.decode_step(model, pcfg, tok, torch.full((2, 1), pos), cache)
            eager.append(logits)
            tok = logits.argmax(-1, keepdim=True)
    eager_routes = routes[:]
    dec = engine.Decoder(model, pcfg, 2, 10 + new + 1)
    dec.start(prompt)
    graph = [dec.logits.clone()]
    for _ in range(new - 1):
        dec.step()
        graph.append(dec.logits.clone())
    assert dec.n_captures == 1
    assert all(torch.equal(a, b) for a, b in zip(graph, eager))
    assert len({tuple(r.flatten().tolist()) for r in eager_routes}) > 1
    assert all(torch.equal(a, b) for a, b in zip(routes[len(eager_routes):], eager_routes))


def _round_trip(tree, pcfg) -> None:
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(tree, pcfg, "cpu"))
    flat, flat_back = jax.tree_util.tree_flatten_with_path(tree), \
        jax.tree_util.tree_flatten_with_path(back)
    assert flat[1] == flat_back[1]
    for (path, leaf), (_, leaf_back) in zip(flat[0], flat_back[0]):
        assert leaf.dtype == leaf_back.dtype and leaf.shape == leaf_back.shape, path
        np.testing.assert_array_equal(leaf.view(np.uint8), leaf_back.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_weights_round_trip_bitwise(name, dtype):
    jcfg = dataclasses.replace(J_get_smoke(name), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    tree = perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(4), jcfg)), 5)
    _round_trip(tree, pcfg)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    # the stacked expert weights land per layer, by name
    for g in range(pcfg.num_layers):
        for leaf in ("w_gate", "w_up", "w_down"):
            ref = tree["stages"][0]["mlp"]["routed"][leaf][g]
            param = model.get_parameter(f"layers.{g}.mlp.routed.{leaf}")
            assert param.shape[0] == pcfg.moe.num_experts
            np.testing.assert_array_equal(param.float().numpy(), ref.astype(np.float32))
        if pcfg.mla is not None:
            np.testing.assert_array_equal(
                model.get_parameter(f"layers.{g}.attn.kv_norm.scale").float().numpy(),
                tree["stages"][0]["attn"]["kv_norm"]["scale"][g].astype(np.float32))


@pytest.mark.parametrize("name", FAMILIES)
def test_configs_match_reference(name):
    assert name.replace("-", "_").replace(".", "_") in PORTED
    assert reference_dict(get_config(name)) == dataclasses.asdict(J_get_config(name))
    assert reference_dict(get_smoke_config(name)) == dataclasses.asdict(J_get_smoke(name))


_PARAMS = {"qwen3-moe-30b-a3b": 30_532_122_624, "deepseek-v2-236b": 244_188_441_600}


@pytest.mark.parametrize("name", FAMILIES)
def test_full_config_counts_the_reference_parameters(name):
    cfg = get_config(name)
    abstract = jax.eval_shape(lambda k: J_transformer.init_lm(k, J_get_config(name)),
                              jax.random.PRNGKey(0))
    n = param_count(transformer.LM(cfg, "meta"))  # shapes only, nothing allocated
    assert n == J_param_count(abstract) == _PARAMS[name]
