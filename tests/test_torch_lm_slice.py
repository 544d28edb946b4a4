"""The port's recurrentgemma slice against the reference, end to end.

The reference's ``init_lm`` weights (smoke config, ``num_layers = 5`` so
both the stacked groups and the tail are carried) go into the port's
``LM`` through ``convert.lm_params_from_numpy``; both packages then score
the same numpy tokens:

* ``model_forward`` / ``loss_fn`` with the kernels (the reference's
  ``impl="pallas"``, its Pallas flash attention in interpret mode, against
  the port's ``impl="kernel"``, whose wrappers run their plain versions on
  the CPU): float32 within 1e-4, bfloat16 within 3e-2;
* the plain path at S = 512, where the loss takes the fused 512-chunk
  cross entropy;
* greedy ``generate`` (a 24-token prompt, a ring of 8, so it wraps):
  identical tokens in float32.

The reference's forward runs once per dtype, in a module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as J_get_config  # noqa: E402
from repro.configs import get_smoke_config as J_get_smoke  # noqa: E402
from repro.models import param_count as J_param_count  # noqa: E402
from repro.models import registry as J_registry  # noqa: E402
from repro.models import transformer as J_transformer  # noqa: E402
from repro.serve import engine as J_engine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.common import reference_dict  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.models import param_count, registry, transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

NAME = "recurrentgemma-2b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(num_layers: int = 5, dtype: str = "float32"):
    jcfg = dataclasses.replace(J_get_smoke(NAME), num_layers=num_layers, dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config(NAME), num_layers=num_layers, dtype=dtype)
    return jcfg, pcfg


def _batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def scored(request):
    """Both packages' kernel-path logits and loss on the same weights and
    tokens (B = 2, S = 256)."""
    dtype = request.param
    jcfg, pcfg = _cfgs(dtype=dtype)
    params = J_transformer.init_lm(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg, 2, 256)
    ref_logits, _, _ = J_registry.model_forward(params, jcfg, _jax(batch), impl="pallas")
    ref_loss, _ = J_registry.loss_fn(params, jcfg, _jax(batch), impl="pallas")
    model = convert.lm_params_from_numpy(np_tree(params), pcfg, "cpu")
    fa_ops.reset_launch_counts()
    scan_ops.reset_launch_counts()
    with torch.inference_mode():
        logits, cache, aux = registry.model_forward(model, pcfg, _torch(batch), impl="kernel")
        loss, metrics = registry.loss_fn(model, pcfg, _torch(batch), impl="kernel")
        plain_loss, _ = registry.loss_fn(model, pcfg, _torch(batch), impl="plain")
    return dict(dtype=dtype, ref_logits=ref_logits, ref_loss=ref_loss, logits=logits,
                cache=cache, aux=aux, loss=loss, metrics=metrics, plain_loss=plain_loss,
                launches=(fa_ops.launch_counts["flash_attention"],
                          scan_ops.launch_counts["rglru_scan"]))


def test_kernel_path_logits_match_reference(scored):
    assert scored["logits"].shape == (2, 256, 512)
    assert scored["logits"].dtype == (torch.float32 if scored["dtype"] == "float32"
                                      else torch.bfloat16)
    assert scored["cache"] is None and float(scored["aux"]) == 0.0
    _close(scored["logits"], scored["ref_logits"], TOL[scored["dtype"]])


def test_kernel_path_loss_matches_reference(scored):
    loss = float(scored["loss"])
    assert np.isfinite(loss) and abs(loss - np.log(512)) < 1.0  # random init
    assert float(scored["metrics"]["nll"]) == loss
    np.testing.assert_allclose(loss, float(scored["ref_loss"]), atol=TOL[scored["dtype"]],
                               rtol=TOL[scored["dtype"]])
    # the CPU runs the plain versions: kernel and plain paths agree closely
    np.testing.assert_allclose(float(scored["plain_loss"]), loss, atol=TOL[scored["dtype"]])
    assert scored["launches"] == (0, 0)


def test_plain_path_with_fused_xent_chunks_matches_reference():
    """S = 512: the loss runs the fused 512-chunk cross entropy."""
    jcfg, pcfg = _cfgs(num_layers=3)
    params = J_transformer.init_lm(jax.random.PRNGKey(2), jcfg)
    batch = _batch(jcfg, 2, 512, seed=1)
    ref_logits, _, _ = J_registry.model_forward(params, jcfg, _jax(batch), impl="xla")
    ref_loss, _ = J_registry.loss_fn(params, jcfg, _jax(batch), impl="xla")
    model = convert.lm_params_from_numpy(np_tree(params), pcfg, "cpu")
    with torch.inference_mode():
        logits, _, _ = registry.model_forward(model, pcfg, _torch(batch), impl="plain")
        loss, _ = registry.loss_fn(model, pcfg, _torch(batch), impl="plain")
        unfused = transformer.softmax_xent(logits, _torch(batch)["labels"])
    _close(logits, ref_logits, 1e-4)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(unfused), atol=1e-5)


def test_generate_matches_reference_greedy_tokens():
    """B = 2, a 24-token prompt through an 8-slot ring, 8 new tokens."""
    jcfg, pcfg = _cfgs()
    params = J_transformer.init_lm(jax.random.PRNGKey(3), jcfg)
    prompt = _batch(jcfg, 2, 24, seed=2)["tokens"]
    ref = J_engine.generate(params, jcfg, jnp.asarray(prompt, jnp.int32), max_new_tokens=8)
    model = convert.lm_params_from_numpy(np_tree(params), pcfg, "cpu")
    out = engine.generate(model, pcfg, prompt, max_new_tokens=8, device="cpu")
    assert out.shape == (2, 8) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("num_layers,S", [(3, 24), (5, 24), (5, 7)])
def test_decode_matches_full_forward(num_layers, S):
    """The reference's decode-consistency check (tests/test_decode_consistency.py)
    on the port: prefill S - 1 tokens, decode the last, compare its logits
    with the full forward's last position at the reference's 2e-3."""
    _, pcfg = _cfgs(num_layers=num_layers)
    model = registry.init_model(pcfg, seed=1, device="cpu")
    B = 2
    toks = torch.as_tensor(_batch(pcfg, B, S, seed=3)["tokens"])
    with torch.inference_mode():
        full, _, _ = model(toks)
        cache = transformer.init_cache(pcfg, B, S + 8, device="cpu")
        pos = torch.arange(S - 1)[None].expand(B, S - 1)
        _, cache, _ = model(toks[:, : S - 1], cache=cache, positions=pos)
        last, _ = engine.decode_step(model, pcfg, toks[:, S - 1 :],
                                     torch.full((B, 1), S - 1), cache)
    assert float((last - full[:, -1]).abs().max()) < 2e-3


def test_caches_default_to_cuda(monkeypatch):
    """Like ``init_model``, every cache initialiser sends device=None to
    CUDA: without CUDA it raises at the call, never builds host caches."""
    from repro_torch.models import attention, kvcache, rglru

    _, pcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: transformer.init_cache(pcfg, 2, 16),
                 lambda: attention.init_attention_cache(pcfg, 2, 16, local=True),
                 lambda: rglru.init_rglru_state(pcfg, 2),
                 lambda: kvcache.init_full_cache(2, 16, 1, 4, torch.float32),
                 lambda: kvcache.init_window_cache(2, 8, 1, 4, torch.float32)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    cache = transformer.init_cache(pcfg, 2, 16, device="cpu")
    assert all(t.device.type == "cpu" for layer in cache for t in layer.values()
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("num_layers", [2, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_round_trip_bitwise(num_layers, dtype):
    jcfg, pcfg = _cfgs(num_layers=num_layers, dtype=dtype)
    tree = np_tree(J_transformer.init_lm(jax.random.PRNGKey(4), jcfg))
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(tree, pcfg, "cpu"))
    flat, flat_back = jax.tree_util.tree_flatten_with_path(tree), \
        jax.tree_util.tree_flatten_with_path(back)
    assert flat[1] == flat_back[1]  # same structure, stages None where no whole group
    for (path, leaf), (_, leaf_back) in zip(flat[0], flat_back[0]):
        assert leaf.dtype == leaf_back.dtype and leaf.shape == leaf_back.shape, path
        np.testing.assert_array_equal(leaf.view(np.uint8), leaf_back.view(np.uint8))


def test_weights_with_another_layout_are_refused():
    jcfg, pcfg = _cfgs(num_layers=5)
    tree = np_tree(J_transformer.init_lm(jax.random.PRNGKey(5), jcfg))
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(tree, dataclasses.replace(pcfg, num_layers=4), "cpu")
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(tree, dataclasses.replace(pcfg, d_ff=128), "cpu")


def test_full_config_matches_reference_and_counts_its_parameters():
    cfg = get_config(NAME)
    assert reference_dict(cfg) == dataclasses.asdict(J_get_config(NAME))
    abstract = jax.eval_shape(lambda k: J_transformer.init_lm(k, J_get_config(NAME)),
                              jax.random.PRNGKey(0))
    n = param_count(transformer.LM(cfg, "meta"))  # shapes only, nothing allocated
    assert n == J_param_count(abstract)
    assert 2.6e9 < n < 3.0e9  # ~2.9 B parameters, ~5.8 GB in bfloat16


def test_get_config_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("gpt-2")
    with pytest.raises(ValueError, match="unknown architecture"):
        get_smoke_config("gpt_2")


@pytest.mark.parametrize("name", list(J_ARCH_IDS))
def test_get_config_builds_every_reference_architecture(name):
    """Each of the reference's ten architectures: the full config field for
    field (by id and by module name), and its smoke model built and run."""
    assert list(ARCH_IDS) == list(J_ARCH_IDS)
    assert reference_dict(get_config(name)) == dataclasses.asdict(J_get_config(name))
    assert get_config(ARCH_IDS[name]) == get_config(name)
    cfg = get_smoke_config(name)
    model = registry.init_model(cfg, seed=0, device="cpu")
    batch = registry.make_inputs(cfg, 1, 24, device="cpu")
    with torch.inference_mode():
        loss, metrics = registry.loss_fn(model, cfg, batch, impl="plain")
    assert np.isfinite(float(loss)) and float(metrics["nll"]) > 0.0


def test_make_inputs_is_seeded_numpy():
    _, pcfg = _cfgs()
    a = registry.make_inputs(pcfg, 2, 16, seed=7, device="cpu")
    b = registry.make_inputs(pcfg, 2, 16, seed=7, device="cpu")
    assert a["tokens"].shape == (2, 16) and a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert int(a["tokens"].max()) < pcfg.vocab_size and int(a["tokens"].min()) >= 0


def test_all_configs_match_reference():
    """``configs.all_configs`` gives every architecture's full config, field
    for field the reference's."""
    from repro.configs import all_configs as J_all_configs
    from repro_torch.configs import all_configs

    ours, ref = all_configs(), J_all_configs()
    assert list(ours) == list(ref)
    for name in ref:
        assert reference_dict(ours[name]) == dataclasses.asdict(ref[name]), name


@pytest.mark.parametrize("name", list(J_ARCH_IDS))
def test_layer_kind_matches_reference(name):
    from repro.models.common import layer_kind as J_layer_kind
    from repro_torch.models.common import layer_kind

    cfg, jcfg = get_config(name), J_get_config(name)
    kinds = [layer_kind(cfg, i) for i in range(cfg.num_layers + 3)]
    assert kinds == [J_layer_kind(jcfg, i) for i in range(jcfg.num_layers + 3)]
