"""The port's multi-head latent attention against the reference's
``repro.models.attention.mla_attention``.

The reference's ``init_mla_attention`` weights (``kv_norm.scale``
perturbed off its ones) go into the port's ``MLAAttention`` by name; both
packages run the same numpy activations at deepseek-v2's smoke widths.
Float32 at 1e-5 (bfloat16 at 3e-2):

* the full-sequence attend, unchunked (S 24, with and without a window);
* the chunked attend (S 2560 > 2048, a multiple of 512), whose numerics
  differ from the unchunked form's (p cast to v's dtype before the PV
  product, normalised after it);
* prefill into a cache, then decode steps (the ``abs_pos`` mask read
  from the cache's device index), and the cache's latents themselves;
* the host refusal of a write past ``max_len``, where the reference's
  ring would wrap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_smoke_config as J_get_smoke  # noqa: E402
from repro.models import attention as J_attn  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import module_params_from_numpy  # noqa: E402
from repro_torch.models import attention as P_attn  # noqa: E402
from repro_torch.models import kvcache as P_kv  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

NAME = "deepseek-v2-236b"
J_mla = jax.jit(J_attn.mla_attention, static_argnums=1, static_argnames="window")


def _pair(dtype: str = "float32", seed: int = 0):
    jcfg = dataclasses.replace(J_get_smoke(NAME), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config(NAME), dtype=dtype)
    params = J_attn.init_mla_attention(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed + 10)
    scale = tree["kv_norm"]["scale"]
    tree["kv_norm"]["scale"] = (scale.astype(np.float32)
                                + rng.normal(0, 0.1, scale.shape)).astype(scale.dtype)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, pcfg, params, module_params_from_numpy(P_attn.MLAAttention(pcfg, "cpu"), tree)


def _x(B: int, S: int, D: int, dtype: str, seed: int = 1) -> np.ndarray:
    x = (np.random.default_rng(seed).normal(size=(B, S, D)) * 0.5).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _t(x) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(x)


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _positions(B: int, S: int, start: int = 0) -> np.ndarray:
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).copy()


@pytest.mark.parametrize("B,S,window,dtype,tol", [
    (2, 24, None, "float32", 1e-5),
    (2, 24, 7, "float32", 1e-5),
    (2, 24, None, "bfloat16", 3e-2),
    (1, 2560, None, "float32", 1e-5),  # chunked: S > 2048 and S % 512 == 0
    (1, 2560, 300, "float32", 1e-5),
    (1, 2560, None, "bfloat16", 3e-2),
])
def test_full_sequence_matches_reference(B, S, window, dtype, tol):
    jcfg, pcfg, params, module = _pair(dtype)
    x, pos = _x(B, S, pcfg.d_model, dtype), _positions(B, S)
    ref, ref_cache = J_mla(params, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
                           window=window)
    with torch.inference_mode():
        out, cache = P_attn.mla_attention(module, pcfg, _t(x), positions=torch.tensor(pos),
                                          window=window)
    assert ref_cache is None and cache is None
    assert out.shape == (B, S, pcfg.d_model) and out.dtype == module.wq.dtype
    _close(out, ref, tol)


def test_chunked_and_unchunked_forms_differ_only_by_the_p_cast():
    """At S 2560 the chunked form runs (the reference's branch); forcing
    the unchunked one on both packages, they agree again, and in float32
    the two forms agree with each other."""
    jcfg, pcfg, params, module = _pair()
    x, pos = _x(1, 2560, pcfg.d_model, "float32", seed=2), _positions(1, 2560)
    saved = J_attn._CHUNK_THRESHOLD, P_attn._CHUNK_THRESHOLD
    try:
        J_attn._CHUNK_THRESHOLD = P_attn._CHUNK_THRESHOLD = 10**9
        ref = J_attn.mla_attention(params, jcfg, jnp.asarray(x), positions=jnp.asarray(pos))[0]
        with torch.inference_mode():
            dense = P_attn.mla_attention(module, pcfg, _t(x), positions=torch.tensor(pos))[0]
    finally:
        J_attn._CHUNK_THRESHOLD, P_attn._CHUNK_THRESHOLD = saved
    _close(dense, ref, 1e-5)
    with torch.inference_mode():
        chunked = P_attn.mla_attention(module, pcfg, _t(x), positions=torch.tensor(pos))[0]
    _close(chunked, dense.numpy(), 2e-4)


@pytest.mark.parametrize("prefill_len,steps", [(9, 4), (20, 3)])
def test_prefill_then_decode_matches_reference(prefill_len, steps):
    jcfg, pcfg, params, module = _pair(seed=4)
    B, max_len = 2, 24
    x = _x(B, prefill_len + steps, pcfg.d_model, "float32", seed=5)
    jcache = J_attn.init_mla_cache(jcfg, B, max_len)
    cache = P_attn.init_mla_attention_cache(pcfg, B, max_len, device="cpu")
    assert set(cache) == set(jcache) and cache["index"].dtype == torch.int64
    assert cache["index"].shape == () and cache["c_kv"].shape == jcache["c_kv"].shape
    pos = _positions(B, prefill_len)
    ref, jcache = J_mla(params, jcfg, jnp.asarray(x[:, :prefill_len]),
                        positions=jnp.asarray(pos), cache=jcache)
    with torch.inference_mode():
        out, cache = P_attn.mla_attention(module, pcfg, _t(x[:, :prefill_len]),
                                          positions=torch.tensor(pos), cache=cache)
    _close(out, ref, 1e-5)
    for i in range(steps):
        p = prefill_len + i
        step_pos = np.full((B, 1), p)
        ref, jcache = J_mla(params, jcfg, jnp.asarray(x[:, p : p + 1]),
                            positions=jnp.asarray(step_pos), cache=jcache)
        with torch.inference_mode():
            out, cache = P_attn.mla_attention(module, pcfg, _t(x[:, p : p + 1]),
                                              positions=torch.tensor(step_pos), cache=cache)
        _close(out, ref, 1e-5)
    assert int(cache["index"]) == int(jcache["index"]) == prefill_len + steps
    _close(cache["c_kv"], jcache["c_kv"], 1e-5)
    _close(cache["k_rope"], jcache["k_rope"], 1e-5)


def test_decode_equals_the_full_sequence():
    """The last of 12 positions decoded from a cache equals the full
    sequence's last position (both float32 attends)."""
    _, pcfg, _, module = _pair(seed=6)
    B, S = 2, 12
    x = _t(_x(B, S, pcfg.d_model, "float32", seed=7))
    pos = torch.tensor(_positions(B, S))
    with torch.inference_mode():
        full, _ = P_attn.mla_attention(module, pcfg, x, positions=pos)
        cache = P_attn.init_mla_attention_cache(pcfg, B, 16, device="cpu")
        P_attn.mla_attention(module, pcfg, x[:, : S - 1], positions=pos[:, : S - 1], cache=cache)
        last, _ = P_attn.mla_attention(module, pcfg, x[:, S - 1 :], positions=pos[:, S - 1 :],
                                       cache=cache)
    torch.testing.assert_close(last[:, 0], full[:, -1], atol=1e-5, rtol=1e-5)


def test_writes_past_max_len_are_refused_on_the_host():
    """The reference's MLA cache is a ring: a prefill longer than the cache
    keeps its tail and decode wraps. The port refuses such writes on the
    host before they run: ``check_fits`` from ``prefill`` and the
    ``Decoder``, and the cache update itself for a write longer than the
    cache."""
    pcfg = get_smoke_config(NAME)
    cache = P_attn.init_mla_attention_cache(pcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="cannot take 9"):
        P_kv.update_mla_cache(cache, torch.zeros(1, 9, 32), torch.zeros(1, 9, 8))
    assert int(cache["index"]) == 0
    model = registry.init_model(pcfg, seed=0, device="cpu")
    prompt = torch.randint(0, pcfg.vocab_size, (1, 9), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cannot take 9 more at 0"):
        engine.prefill(model, pcfg, prompt, max_len=8)
    dec = engine.Decoder(model, pcfg, 1, 8)
    dec.start(prompt[:, :7])
    dec.step()  # position 7, the last slot
    assert int(dec.cache[0]["index"]) == 8
    with pytest.raises(ValueError, match="cannot take 1 more at 8"):
        dec.step()
    assert int(dec.cache[0]["index"]) == 8  # nothing was written
