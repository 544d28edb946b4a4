"""The port's VLM (llava-next-mistral-7b) against the reference.

The stub patch embeddings go in front of the token embeddings
(``LM.forward(image_embeds=)``); the loss drops the image positions
(``lm_loss(image_embeds=)``); ``prefill`` / ``generate`` take
``image_embeds`` and count the patches' positions first. At the smoke
config (16 patches), with the reference's ``init_lm`` weights (every
constant leaf perturbed, as in ``test_torch_dense_families.py``) carried
over by ``convert``, and embeddings N(0, 0.1) as the reference's
``test_decode_consistency.py`` draws them, both packages score the same
numpy inputs (B = 2, 16 patches + 112 tokens = 128 positions, the
reference's Pallas flash attention in interpret mode on the kernel path):
logits within 1e-4 on both paths, the loss within 1e-5; decode against
the full forward within 2e-3 at that test's shape; greedy ``generate``
the reference's tokens (twice through one decoder); the ``Decoder``
bitwise a ``decode_step`` loop; the weights round trip bitwise;
``get_config`` field for field and the full config's 7.242 B parameters.
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

NAME = "llava-next-mistral-7b"
P = 16  # the smoke config's patches


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


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _images(cfg, B: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, cfg.vision.num_patches, cfg.d_model)) * 0.1).astype(np.float32)


def _cfgs():
    return J_get_smoke(NAME), get_smoke_config(NAME)


@pytest.fixture(scope="module")
def family():
    """Perturbed reference weights in both packages, and both packages'
    logits and losses on both paths (B = 2, 16 patches + 112 tokens)."""
    jcfg, pcfg = _cfgs()
    assert pcfg.vision.num_patches == P
    tree = perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(0), jcfg)), 1)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    rng = np.random.default_rng(0)
    batch = {"image_embeds": _images(jcfg, 2, 100),
             "tokens": rng.integers(0, jcfg.vocab_size, (2, 128 - P)),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 128 - P))}
    jbatch = {k: jnp.asarray(v, jnp.float32 if k == "image_embeds" else jnp.int32)
              for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    scored = {}
    for jimpl, pimpl in (("xla", "plain"), ("pallas", "kernel")):
        ref_logits, _, _ = J_registry.model_forward(params, jcfg, jbatch, impl=jimpl)
        ref_loss, _ = J_registry.loss_fn(params, jcfg, jbatch, impl=jimpl)
        fa_ops.reset_launch_counts()
        with torch.inference_mode():
            logits, cache, aux = registry.model_forward(model, pcfg, tbatch, impl=pimpl)
            loss, metrics = registry.loss_fn(model, pcfg, tbatch, impl=pimpl)
        scored[pimpl] = dict(ref_logits=ref_logits, ref_loss=ref_loss, logits=logits,
                             cache=cache, aux=aux, loss=loss, metrics=metrics,
                             launches=fa_ops.launch_counts["flash_attention"])
    return dict(jcfg=jcfg, pcfg=pcfg, tree=tree, params=params, model=model, batch=batch,
                tbatch=tbatch, scored=scored)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_logits_match_reference(family, impl):
    """Logits at every position, the image's included, as the reference's."""
    s = family["scored"][impl]
    assert s["logits"].shape == (2, 128, family["pcfg"].vocab_size)
    assert s["cache"] is None and float(s["aux"]) == 0.0
    assert s["launches"] == 0  # the CPU runs the wrapper's plain version
    _close(s["logits"], s["ref_logits"], 1e-4)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_loss_matches_reference(family, impl):
    s = family["scored"][impl]
    loss = float(s["loss"])
    assert np.isfinite(loss) and loss > np.log(family["pcfg"].vocab_size) - 1.0
    assert float(s["metrics"]["nll"]) == loss
    np.testing.assert_allclose(loss, float(s["ref_loss"]), atol=1e-5, rtol=1e-5)


def test_loss_drops_the_image_positions(family):
    """The loss is the text positions' cross entropy: the forward's logits
    after the 16 patches against the labels."""
    s, pcfg = family["scored"]["plain"], family["pcfg"]
    text = s["logits"][:, P:]
    want = transformer.softmax_xent(text, family["tbatch"]["labels"])
    np.testing.assert_allclose(float(s["loss"]), float(want), rtol=1e-6)
    with torch.inference_mode():
        no_image, _ = transformer.lm_loss(family["model"], pcfg, family["tbatch"]["tokens"],
                                          family["tbatch"]["labels"], impl="plain")
    assert float(no_image) != float(s["loss"])


def test_decode_matches_full_forward():
    """The reference's decode-consistency check on the port, with the
    reference's weights and draws: the 16 patches and 23 tokens prefilled,
    the 24th decoded at position 39."""
    jcfg, pcfg = _cfgs()
    S, B = 24, 2
    params = J_init_model(jax.random.PRNGKey(1), jcfg)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(3), (B, S), 0, jcfg.vocab_size))
    img = np.array(jax.random.normal(jax.random.PRNGKey(4), (B, P, jcfg.d_model)) * 0.1)
    model = convert.lm_params_from_numpy(np_tree(params), pcfg, "cpu")
    total = S + P
    jcache = J_transformer.init_cache(jcfg, B, total + 8)
    pos = jnp.broadcast_to(jnp.arange(total - 1)[None], (B, total - 1))
    _, jcache, _ = J_transformer.forward(params, jcfg, jnp.asarray(toks[:, : S - 1]),
                                         image_embeds=jnp.asarray(img), cache=jcache,
                                         positions=pos)
    ref, _, _ = J_transformer.forward(params, jcfg, jnp.asarray(toks[:, S - 1 :]), cache=jcache,
                                      positions=jnp.full((B, 1), total - 1))
    t, im = torch.as_tensor(toks), torch.as_tensor(img)
    with torch.inference_mode():
        full, _, _ = model(t, image_embeds=im)
        _, cache = engine.prefill(model, pcfg, t[:, : S - 1], max_len=total + 8, image_embeds=im)
        last, _ = engine.decode_step(model, pcfg, t[:, S - 1 :], torch.full((B, 1), total - 1),
                                     cache)
    dec = engine.Decoder(model, pcfg, B, total + 8)
    dec.start(t[:, : S - 1], image_embeds=im)
    assert int(dec.position[0, 0]) == total - 1  # the greedy token's position after the prompt
    dec.step(t[:, S - 1 :])
    err = float((last - full[:, -1]).abs().max())
    assert err < 2e-3, f"decode/full mismatch {err}"
    assert torch.equal(dec.logits, last)
    _close(last, ref[:, 0], 1e-4)


def test_generate_twice_matches_reference_greedy_tokens(family):
    jcfg, pcfg, model = family["jcfg"], family["pcfg"], family["model"]
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 24))
    img = _images(jcfg, 2, 101)
    ref = np.asarray(J_engine.generate(family["params"], jcfg, jnp.asarray(prompt, jnp.int32),
                                       max_new_tokens=8, image_embeds=jnp.asarray(img)))
    for _ in range(2):
        out = engine.generate(model, pcfg, prompt, max_new_tokens=8,
                              image_embeds=torch.as_tensor(img), device="cpu")
        assert out.shape == (2, 8) and out.dtype == torch.int64
        np.testing.assert_array_equal(out.numpy(), ref)
    dec = engine.decoder_for(model, pcfg, 2, P + 24 + 8 + 1)  # the cache holds the patches
    assert dec.n_captures == 1
    assert torch.equal(dec.tokens[:, P + 24 : P + 32], out)
    assert int(dec.tokens[:, : P + 24].abs().sum()) == 0


def test_decoder_is_bitwise_the_eager_loop(family):
    model, pcfg = family["model"], family["pcfg"]
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, pcfg.vocab_size, (2, 10)))
    img = torch.as_tensor(_images(pcfg, 2, 102))
    new, total = 6, P + 10
    with torch.inference_mode():
        logits, cache = engine.prefill(model, pcfg, prompt, max_len=total + new + 1,
                                       image_embeds=img)
        eager = [logits]
        tok = logits.argmax(-1, keepdim=True)
        for pos in range(total, total + new - 1):
            logits, cache = engine.decode_step(model, pcfg, tok, torch.full((2, 1), pos), cache)
            eager.append(logits)
            tok = logits.argmax(-1, keepdim=True)
    dec = engine.Decoder(model, pcfg, 2, total + new + 1)
    dec.start(prompt, image_embeds=img)
    graph = [dec.logits.clone()]
    for _ in range(new - 1):
        dec.step()
        graph.append(dec.logits.clone())
    assert dec.n_captures == 1
    assert all(torch.equal(a, b) for a, b in zip(graph, eager))


def test_the_cache_must_hold_the_patches(family):
    model, pcfg = family["model"], family["pcfg"]
    prompt = torch.zeros((2, 10), dtype=torch.int64)
    img = torch.as_tensor(_images(pcfg, 2, 103))
    with pytest.raises(ValueError, match="cannot take"):
        engine.prefill(model, pcfg, prompt, max_len=P + 9, image_embeds=img)
    dec = engine.Decoder(model, pcfg, 2, P + 10)
    dec.start(prompt, image_embeds=img)  # fills it exactly
    with pytest.raises(ValueError, match="cannot take"):
        dec.step()


def test_make_inputs_leaves_room_for_the_patches():
    pcfg = get_smoke_config(NAME)
    batch = registry.make_inputs(pcfg, 2, 128, seed=3, device="cpu")
    assert batch["tokens"].shape == batch["labels"].shape == (2, 128 - P)
    assert batch["image_embeds"].shape == (2, P, pcfg.d_model)
    assert float(batch["image_embeds"].abs().max()) == 0.0
    assert registry.make_inputs(pcfg, 2, 20, device="cpu")["tokens"].shape == (2, 16)
    full = get_config(NAME)
    assert full.vision.num_patches == 2880 and 4096 - 2880 == 1216


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_round_trip_bitwise(dtype):
    jcfg = dataclasses.replace(J_get_smoke(NAME), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config(NAME), dtype=dtype)
    tree = perturbed(np_tree(J_transformer.init_lm(jax.random.PRNGKey(4), jcfg)), 5)
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(tree, pcfg, "cpu"))
    flat, flat_back = jax.tree_util.tree_flatten_with_path(tree), \
        jax.tree_util.tree_flatten_with_path(back)
    assert flat[1] == flat_back[1]
    for (path, leaf), (_, leaf_back) in zip(flat[0], flat_back[0]):
        assert leaf.dtype == leaf_back.dtype and leaf.shape == leaf_back.shape, path
        np.testing.assert_array_equal(leaf.view(np.uint8), leaf_back.view(np.uint8))


def test_full_config_matches_reference_and_counts_its_parameters():
    assert "llava_next_mistral_7b" in PORTED
    assert reference_dict(get_config(NAME)) == dataclasses.asdict(J_get_config(NAME))
    assert reference_dict(get_smoke_config(NAME)) == dataclasses.asdict(J_get_smoke(NAME))
    abstract = jax.eval_shape(lambda k: J_transformer.init_lm(k, J_get_config(NAME)),
                              jax.random.PRNGKey(0))
    n = param_count(transformer.LM(get_config(NAME), "meta"))  # shapes only, nothing allocated
    assert n == J_param_count(abstract) == 7_241_732_096
