"""The port's LM modules against the reference's JAX functions.

Each test draws the reference's parameters with ``jax.random``, carries
them into the port's module as numpy arrays
(``convert.module_params_from_numpy``), feeds both the same numpy inputs
and compares. Float32 at 1e-5 unless a test states otherwise: both sides
compute the same float32 operations, in another summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import attention as J_attn  # noqa: E402
from repro.models import kvcache as J_kv  # noqa: E402
from repro.models import layers as J_layers  # noqa: E402
from repro.models import rglru as J_rglru  # noqa: E402
from repro.models.common import ModelConfig as JConfig  # noqa: E402
from repro_torch.convert import module_params_from_numpy  # noqa: E402
from repro_torch.models import attention as P_attn  # noqa: E402
from repro_torch.models import kvcache as P_kv  # noqa: E402
from repro_torch.models import layers as P_layers  # noqa: E402
from repro_torch.models import rglru as P_rglru  # noqa: E402
from repro_torch.models.common import ModelConfig as PConfig  # noqa: E402

TOL = 1e-5
# the eager associative_scan takes seconds a call; jitted, a fraction
J_rglru_block = jax.jit(J_rglru.rglru_block, static_argnums=1)


def port_cfg(cfg: JConfig) -> PConfig:
    return PConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x) -> torch.Tensor:
    """A tensor with the values (and the float dtype) of a jax / numpy array."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def close(port: torch.Tensor, ref, tol: float = TOL) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _cfg(**kw) -> JConfig:
    base = dict(name="t", arch_type="dense", num_layers=1, d_model=64, num_heads=4,
                num_kv_heads=2, head_dim=32, d_ff=96, vocab_size=97)
    base.update(kw)
    return JConfig(**base)


def _x(shape, seed=0, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 3e-2)])
def test_rms_norm(dtype, tol):
    jd = jnp.dtype(dtype)
    x = jnp.asarray(_x((2, 5, 48), 1, 3.0), jd)
    scale = jnp.asarray(_x((48,), 2) + 1.0, jd)
    norm = module_params_from_numpy(P_layers.RMSNorm(48, t(scale).dtype, "cpu"),
                                    {"scale": np.asarray(scale)})
    out = P_layers.rms_norm(norm, t(x), 1e-6)
    assert out.dtype == t(x).dtype
    close(out, J_layers.rms_norm({"scale": scale}, x, 1e-6), tol)


def test_rotary_embedding_and_apply_rope():
    pos = np.arange(300).reshape(2, 150)
    cos, sin = P_layers.rotary_embedding(torch.tensor(pos), 32, 10000.0)
    jcos, jsin = J_layers.rotary_embedding(jnp.asarray(pos), 32, 10000.0)
    close(cos, jcos)
    close(sin, jsin)
    x = _x((2, 150, 3, 32), 3)
    close(P_layers.apply_rope(t(x), cos, sin), J_layers.apply_rope(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp(mlp_type):
    cfg = _cfg(mlp_type=mlp_type)
    params = J_layers.init_mlp(jax.random.PRNGKey(0), cfg)
    mlp = module_params_from_numpy(P_layers.MLP(port_cfg(cfg), "cpu"), np_tree(params))
    x = _x((2, 7, 64), 4)
    close(P_layers.mlp_forward(mlp, t(x), mlp_type),
          J_layers.mlp_forward(params, jnp.asarray(x), mlp_type))


def test_embed_rounds_the_scale_to_bfloat16():
    cfg = _cfg(d_model=2560, vocab_size=11, embedding_scale=True, dtype="bfloat16")
    params = J_layers.init_embedding(jax.random.PRNGKey(1), cfg)
    params["table"] = params["table"].at[3].set(1.0)
    emb = module_params_from_numpy(P_layers.Embedding(port_cfg(cfg), "cpu"), np_tree(params))
    tokens = np.array([[3, 0, 10], [5, 3, 7]])
    out = P_layers.embed(emb, torch.tensor(tokens), port_cfg(cfg))
    ref = J_layers.embed(params, jnp.asarray(tokens), cfg)
    assert out.dtype == torch.bfloat16
    assert float(out[0, 0, 0]) == 50.5  # sqrt(2560) = 50.596 rounds to 50.5 in bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("tie,softcap", [(True, 0.0), (False, 30.0)])
def test_unembed(tie, softcap):
    cfg = _cfg(tie_embeddings=tie, final_logit_softcap=softcap)
    params = J_layers.init_embedding(jax.random.PRNGKey(2), cfg)
    emb = module_params_from_numpy(P_layers.Embedding(port_cfg(cfg), "cpu"), np_tree(params))
    x = _x((2, 5, 64), 5, 20.0)
    close(P_layers.unembed(emb, t(x), port_cfg(cfg)),
          J_layers.unembed(params, jnp.asarray(x), cfg), 1e-4)  # |logits| ~ 10: 1e-5 relative


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

FLAGS = [
    dict(),
    dict(attn_bias=True),
    dict(qk_norm=True),
    dict(attn_logit_softcap=30.0),
    dict(attn_bias=True, qk_norm=True, attn_logit_softcap=20.0, num_kv_heads=1),
]


def _attn_params(cfg: JConfig, seed: int):
    """The reference's params with its zero biases and unit norms made random."""
    params = J_attn.init_attention(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in params:
            params[name] = jnp.asarray(rng.normal(size=params[name].shape) * 0.3, jnp.float32)
    for name in ("q_norm", "k_norm"):
        if name in params:
            params[name] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, (cfg.head_dim,)),
                                                 jnp.float32)}
    port = module_params_from_numpy(P_attn.Attention(port_cfg(cfg), "cpu"), np_tree(params))
    return params, port


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("impl", [("xla", "plain"), ("pallas", "kernel")])
def test_attention_full_sequence(flags, local, impl):
    cfg = _cfg(sliding_window=16, **flags)
    params, port = _attn_params(cfg, 7)
    B, S = 2, 128
    x = _x((B, S, 64), 8)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    ref, _ = J_attn.attention(params, cfg, jnp.asarray(x), positions=jnp.asarray(pos),
                              local=local, impl=impl[0])
    out, cache = P_attn.attention(port, port_cfg(cfg), t(x), positions=torch.tensor(pos),
                                  local=local, impl=impl[1])
    assert cache is None
    close(out, ref)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("window", [None, 24])
def test_sdpa_chunked(dtype, tol, window):
    cfg = _cfg(attn_logit_softcap=30.0)
    jd = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(_x((2, 64, n, 32), s), jd) for s, n in ((1, 4), (2, 2), (3, 2)))
    ref = J_attn._sdpa_chunked(q, k, v, cfg, window, chunk_q=16)
    out = P_attn._sdpa_chunked(t(q), t(k), t(v), port_cfg(cfg), window, chunk_q=16)
    close(out, ref, tol)


@pytest.mark.parametrize("flags", FLAGS[:1] + FLAGS[-1:])
@pytest.mark.parametrize("local", [False, True])
def test_attention_cached_prefill_and_decode(flags, local):
    """Prefill 20 positions (longer than the 8-slot ring), then 6 decode
    steps: outputs, cache buffers and indices match the reference's."""
    cfg = _cfg(sliding_window=8, **flags)
    params, port = _attn_params(cfg, 9)
    B, S, steps = 2, 20, 6
    x = _x((B, S + steps, 64), 10)
    jc = J_attn.init_attention_cache(cfg, B, S + steps, local=local)
    pc = P_attn.init_attention_cache(port_cfg(cfg), B, S + steps, local=local, device="cpu")
    for lo, hi in [(0, S)] + [(S + i, S + i + 1) for i in range(steps)]:
        pos = np.broadcast_to(np.arange(lo, hi)[None], (B, hi - lo))
        ref, jc = J_attn.attention(params, cfg, jnp.asarray(x[:, lo:hi]),
                                   positions=jnp.asarray(pos), local=local, cache=jc)
        out, pc = P_attn.attention(port, port_cfg(cfg), t(x[:, lo:hi]),
                                   positions=torch.tensor(pos), local=local, cache=pc)
        close(out, ref)
        close(pc["k"], jc["k"])
        close(pc["v"], jc["v"])
        assert pc["index"] == int(jc["index"]) == hi


@pytest.mark.parametrize("first", [3, 8, 13])
def test_ring_and_full_cache_writes(first):
    """A first write of ``first`` positions into an 8-slot ring (clamped to
    the last 8 when longer), then single-position writes that wrap."""
    rng = np.random.default_rng(first)
    jc, pc = J_kv.init_window_cache(2, 8, 1, 4, jnp.float32), P_kv.init_window_cache(
        2, 8, 1, 4, torch.float32, "cpu")
    jf, pf = J_kv.init_full_cache(2, 24, 1, 4, jnp.float32), P_kv.init_full_cache(
        2, 24, 1, 4, torch.float32, "cpu")
    for n in (first, 1, 1, 1, 1, 1):
        k = rng.normal(size=(2, n, 1, 4)).astype(np.float32)
        v = k + 1.0
        jc = J_kv.update_window_cache(jc, jnp.asarray(k), jnp.asarray(v))
        pc = P_kv.update_window_cache(pc, t(k), t(v))
        jf = J_kv.update_full_cache(jf, jnp.asarray(k), jnp.asarray(v))
        pf = P_kv.update_full_cache(pf, t(k), t(v))
        for port, ref in ((pc, jc), (pf, jf)):
            np.testing.assert_array_equal(port["k"].numpy(), np.asarray(ref["k"]))
            np.testing.assert_array_equal(port["v"].numpy(), np.asarray(ref["v"]))
            assert port["index"] == int(ref["index"])
    with pytest.raises(ValueError):  # the reference clamps the write silently
        P_kv.update_full_cache(pf, t(np.zeros((2, 30, 1, 4), np.float32)),
                               t(np.zeros((2, 30, 1, 4), np.float32)))


# ---------------------------------------------------------------------------
# RG-LRU block: first with the plain scan, then wired to the kernel wrapper
# ---------------------------------------------------------------------------

def _rglru(seed=11):
    cfg = _cfg(arch_type="hybrid", d_model=64, rnn_width=96, layer_pattern=("rglru",))
    params = J_rglru.init_rglru_block(jax.random.PRNGKey(seed), cfg)
    port = module_params_from_numpy(P_rglru.RGLRUBlock(port_cfg(cfg), "cpu"), np_tree(params))
    return cfg, params, port


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_rglru_block_full_sequence(impl):
    cfg, params, port = _rglru()
    x = _x((2, 40, 64), 12, 0.5)
    ref, state = J_rglru_block(params, cfg, jnp.asarray(x), None)
    out, pstate = P_rglru.rglru_block(port, port_cfg(cfg), t(x), None, impl=impl)
    assert state is None and pstate is None
    close(out, ref)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_rglru_block_with_state_and_decode(impl):
    """A prefill from a carried state (folded into b[:, 0]), then three
    one-token decode steps: outputs and states match."""
    cfg, params, port = _rglru(13)
    rng = np.random.default_rng(14)
    x = _x((2, 23, 64), 15, 0.5)
    jstate = {"h": jnp.asarray(rng.normal(size=(2, 96)), jnp.float32),
              "conv": jnp.asarray(rng.normal(size=(2, 3, 96)), jnp.float32)}
    pstate = {"h": t(jstate["h"]), "conv": t(jstate["conv"])}
    for lo, hi in ((0, 20), (20, 21), (21, 22), (22, 23)):
        ref, jstate = J_rglru_block(params, cfg, jnp.asarray(x[:, lo:hi]), jstate)
        out, pstate = P_rglru.rglru_block(port, port_cfg(cfg), t(x[:, lo:hi]), pstate, impl=impl)
        close(out, ref)
        close(pstate["h"], jstate["h"])
        close(pstate["conv"], jstate["conv"])


def test_rglru_state_init_matches_reference():
    cfg, _, _ = _rglru()
    ref = J_rglru.init_rglru_state(cfg, 3)
    port = P_rglru.init_rglru_state(port_cfg(cfg), 3, device="cpu")
    for key in ("h", "conv"):
        assert tuple(port[key].shape) == ref[key].shape
        assert str(port[key].dtype).replace("torch.", "") == str(ref[key].dtype)
