"""The port's dense GQA families against the reference, end to end.

qwen3-0.6b (qk-norm, 2-way GQA), gemma-2b (MQA, GeGLU, the embedding
scale), gemma2-2b (local / global layers, attention and final softcaps,
post-block norms) and qwen2.5-14b (QKV bias, untied unembedding), each at
its smoke config. The reference's ``init_lm`` weights -- every leaf the
reference initialises to a constant (norm scales, QKV biases) perturbed
with numpy noise, so those paths carry information -- go into the port's
``LM`` through ``convert.lm_params_from_numpy``; both packages then score
the same numpy tokens:

* ``model_forward`` / ``loss_fn`` on the plain path (the reference's
  ``impl="xla"``) and the kernel path (its ``impl="pallas"``, the Pallas
  flash attention in interpret mode, against the port's ``"kernel"``,
  whose wrapper runs its plain version on the CPU), float32, B = 2, S =
  128 (the reference's kernel takes S >= 128): logits within 1e-4, the
  loss within 1e-5;
* decode against the full forward at the reference's
  ``test_decode_consistency.py`` shape (S = 24, its draws) within 2e-3,
  through ``decode_step`` and through the ``Decoder`` (for gemma2's
  8-slot window the 23-token prefill wraps the ring);
* greedy ``generate`` (a 24-token prompt, 8 new tokens): the
  reference's tokens;
* the weights round trip bitwise (float32 and bfloat16, the stacked
  groups and the tail; gemma2 at 26 layers, its 13 groups);
* ``get_config`` / ``get_smoke_config`` field for field, and the full
  config's parameter count against the reference's abstract one.
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
from repro_torch.models import param_count, registry, transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

FAMILIES = ["qwen3-0.6b", "gemma-2b", "gemma2-2b", "qwen2.5-14b"]
IMPLS = [("xla", "plain"), ("pallas", "kernel")]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(tree, seed: int):
    """The reference's weights with every constant leaf (norm scales, QKV
    biases) moved off its constant by N(0, 0.1) noise, as numpy."""
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
    packages' logits and losses on both paths (B = 2, S = 128)."""
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
        ref_logits, _, _ = J_registry.model_forward(params, jcfg, jbatch, impl=jimpl)
        ref_loss, _ = J_registry.loss_fn(params, jcfg, jbatch, impl=jimpl)
        fa_ops.reset_launch_counts()
        with torch.inference_mode():
            logits, cache, aux = registry.model_forward(model, pcfg, tbatch, impl=pimpl)
            loss, metrics = registry.loss_fn(model, pcfg, tbatch, impl=pimpl)
        scored[pimpl] = dict(ref_logits=ref_logits, ref_loss=ref_loss, logits=logits,
                             cache=cache, aux=aux, loss=loss, metrics=metrics,
                             launches=fa_ops.launch_counts["flash_attention"])
    return dict(name=name, jcfg=jcfg, pcfg=pcfg, tree=tree, params=params, model=model,
                scored=scored)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_logits_match_reference(family, impl):
    s = family["scored"][impl]
    assert s["logits"].shape == (2, 128, family["pcfg"].vocab_size)
    assert s["logits"].dtype == torch.float32
    assert s["cache"] is None and float(s["aux"]) == 0.0
    assert s["launches"] == 0  # the CPU runs the wrapper's plain version
    _close(s["logits"], s["ref_logits"], 1e-4)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_loss_matches_reference(family, impl):
    s = family["scored"][impl]
    loss = float(s["loss"])
    vocab = family["pcfg"].vocab_size
    assert np.isfinite(loss) and loss > np.log(vocab) - 1.0  # random labels
    assert float(s["metrics"]["nll"]) == loss
    np.testing.assert_allclose(loss, float(s["ref_loss"]), atol=1e-5, rtol=1e-5)


def test_decode_matches_full_forward(family):
    """The reference's decode-consistency check on the port, with the
    reference's weights and draws: prefill 23 tokens, decode the 24th."""
    name, jcfg, pcfg = family["name"], family["jcfg"], family["pcfg"]
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


def test_generate_matches_reference_greedy_tokens(family):
    jcfg, pcfg = family["jcfg"], family["pcfg"]
    prompt = _batch(jcfg, 2, 24, seed=2)["tokens"]
    ref = J_engine.generate(family["params"], jcfg, jnp.asarray(prompt, jnp.int32),
                            max_new_tokens=8)
    out = engine.generate(family["model"], pcfg, prompt, max_new_tokens=8, device="cpu")
    assert out.shape == (2, 8) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _round_trip(tree, pcfg) -> None:
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(tree, pcfg, "cpu"))
    flat, flat_back = jax.tree_util.tree_flatten_with_path(tree), \
        jax.tree_util.tree_flatten_with_path(back)
    assert flat[1] == flat_back[1]  # same structure, stages None where no whole group
    for (path, leaf), (_, leaf_back) in zip(flat[0], flat_back[0]):
        assert leaf.dtype == leaf_back.dtype and leaf.shape == leaf_back.shape, path
        np.testing.assert_array_equal(leaf.view(np.uint8), leaf_back.view(np.uint8))


@pytest.mark.parametrize("num_layers", [None, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_weights_round_trip_bitwise(name, dtype, num_layers):
    """The smoke depth (whole groups only) and 5 layers (a tail too)."""
    jcfg, pcfg = J_get_smoke(name), get_smoke_config(name)
    layers = num_layers or jcfg.num_layers
    jcfg = dataclasses.replace(jcfg, num_layers=layers, dtype=dtype)
    pcfg = dataclasses.replace(pcfg, num_layers=layers, dtype=dtype)
    _round_trip(perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(4), jcfg)), 5), pcfg)


def test_gemma2_thirteen_groups_round_trip_bitwise():
    """gemma2-2b's depth, 26 layers of ("local_attn", "attn"): 13 groups
    per pattern position, no tail, at the smoke widths."""
    jcfg = dataclasses.replace(J_get_smoke("gemma2-2b"), num_layers=26, dtype="bfloat16")
    pcfg = dataclasses.replace(get_smoke_config("gemma2-2b"), num_layers=26, dtype="bfloat16")
    tree = perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(6), jcfg)), 7)
    assert [s["attn"]["wq"].shape[0] for s in tree["stages"]] == [13, 13] and tree["tail"] == []
    _round_trip(tree, pcfg)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    # group g, pattern position j is layer 2 g + j; post-block norms carried
    for g in (0, 12):
        for j, kind in enumerate(("local_attn", "attn")):
            layer = model.layers[2 * g + j]
            assert layer.kind == kind
            for name, leaf in (("attn.wk", tree["stages"][j]["attn"]["wk"]),
                               ("post_ln2.scale", tree["stages"][j]["post_ln2"]["scale"])):
                param = layer.get_parameter(name)
                np.testing.assert_array_equal(
                    param.view(torch.int16).numpy(), leaf[g].view(np.int16))


# the leaves that set each family apart, as (reference path, port name)
_FAMILY_LEAVES = {
    "qwen3-0.6b": [(("stages", 0, "attn", "q_norm", "scale"), "layers.{i}.attn.q_norm.scale"),
                   (("stages", 0, "attn", "k_norm", "scale"), "layers.{i}.attn.k_norm.scale")],
    "gemma-2b": [(("embed", "table"), "embed.table")],
    "gemma2-2b": [(("stages", 0, "post_ln1", "scale"), "layers.{i}.post_ln1.scale"),
                  (("stages", 1, "post_ln2", "scale"), "layers.{i}.post_ln2.scale")],
    "qwen2.5-14b": [(("embed", "unembed"), "embed.unembed"),
                    (("stages", 0, "attn", "bq"), "layers.{i}.attn.bq"),
                    (("stages", 0, "attn", "bk"), "layers.{i}.attn.bk"),
                    (("stages", 0, "attn", "bv"), "layers.{i}.attn.bv")],
}


@pytest.mark.parametrize("name", FAMILIES)
def test_family_leaves_are_carried(name):
    """qwen2.5's untied unembedding and QKV biases, qwen3's q / k norms,
    gemma2's post-block norms: each reference leaf lands, bitwise, in the
    port's parameter of that name (layer i of stage j is layer
    i * len(pattern) + j)."""
    jcfg, pcfg = J_get_smoke(name), get_smoke_config(name)
    tree = perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(8), jcfg)), 9)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    plen = len(pcfg.layer_pattern)
    for path, port_name in _FAMILY_LEAVES[name]:
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if path[0] == "stages":
            for g in range(leaf.shape[0]):
                param = model.get_parameter(port_name.format(i=g * plen + path[1]))
                np.testing.assert_array_equal(param.numpy(), leaf[g])
                assert len(np.unique(leaf[g])) > 1  # not a constant: perturbed
        else:
            np.testing.assert_array_equal(model.get_parameter(port_name).numpy(), leaf)
    assert (hasattr(model.embed, "unembed")) == (not pcfg.tie_embeddings)


@pytest.mark.parametrize("name", FAMILIES)
def test_configs_match_reference(name):
    assert name.replace("-", "_").replace(".", "_") in PORTED
    assert reference_dict(get_config(name)) == dataclasses.asdict(J_get_config(name))
    assert reference_dict(get_smoke_config(name)) == dataclasses.asdict(J_get_smoke(name))


_PARAMS = {"qwen3-0.6b": (0.5e9, 0.8e9), "gemma-2b": (2.4e9, 2.7e9),
           "gemma2-2b": (2.5e9, 2.8e9), "qwen2.5-14b": (14.0e9, 15.5e9)}


@pytest.mark.parametrize("name", FAMILIES)
def test_full_config_counts_the_reference_parameters(name):
    cfg = get_config(name)
    abstract = jax.eval_shape(lambda k: J_transformer.init_lm(k, J_get_config(name)),
                              jax.random.PRNGKey(0))
    n = param_count(transformer.LM(cfg, "meta"))  # shapes only, nothing allocated
    assert n == J_param_count(abstract)
    lo, hi = _PARAMS[name]
    assert lo < n < hi
