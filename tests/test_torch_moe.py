"""The port's MoE block against the reference's ``repro.models.moe``.

The reference's ``init_moe`` weights go into the port's ``MoE`` by name
(``convert.module_params_from_numpy``); both packages run the same numpy
activations. Float32 at 1e-5, bfloat16 at 3e-2:

* qwen3-moe's smoke config (E 4, top-2, capacity factor 8: no drops);
* forced drops: E 4, top-2, capacity factor 1.0, S 16 at the smoke width,
  so the slot order (token-major, ranked per expert and sequence) decides
  which choices drop -- the test checks that some do;
* deepseek-v2's smoke config (the shared expert);
* a one-token step (S = 1, C = 1: the decode shape);
* the top-k expert order, ``router_aux_loss`` and the capacity over a
  sweep of S, against the reference's own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_smoke_config as J_get_smoke  # noqa: E402
from repro.models import moe as J_moe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import module_params_from_numpy  # noqa: E402
from repro_torch.models import moe as P_moe  # noqa: E402

J_moe_forward = jax.jit(J_moe.moe_forward, static_argnums=1)


def _cfgs(name: str, dtype: str = "float32", **moe):
    jcfg, pcfg = J_get_smoke(name), get_smoke_config(name)
    jcfg = dataclasses.replace(jcfg, dtype=dtype, moe=dataclasses.replace(jcfg.moe, **moe))
    pcfg = dataclasses.replace(pcfg, dtype=dtype, moe=dataclasses.replace(pcfg.moe, **moe))
    return jcfg, pcfg


def _pair(name: str, dtype: str = "float32", seed: int = 0, **moe):
    jcfg, pcfg = _cfgs(name, dtype, **moe)
    params = J_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, pcfg, params, module_params_from_numpy(P_moe.MoE(pcfg, "cpu"), tree)


def _x(B: int, S: int, D: int, dtype: str, seed: int = 1) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _t(x: np.ndarray) -> torch.Tensor:
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(x)


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _dropped(expert_ids: np.ndarray, E: int, C: int) -> int:
    """Token-choices past their expert's capacity, counted per sequence in
    the reference's token-major order."""
    n = 0
    for seq in expert_ids.reshape(expert_ids.shape[0], -1):
        n += sum(max(0, int((seq == e).sum()) - C) for e in range(E))
    return n


CASES = [
    # (family, dtype, tol, B, S, moe overrides)
    ("qwen3-moe-30b-a3b", "float32", 1e-5, 2, 24, {}),
    ("qwen3-moe-30b-a3b", "float32", 1e-5, 2, 16, {"capacity_factor": 1.0}),
    ("deepseek-v2-236b", "float32", 1e-5, 2, 24, {}),
    ("deepseek-v2-236b", "float32", 1e-5, 2, 16, {"capacity_factor": 1.0}),
    ("qwen3-moe-30b-a3b", "float32", 1e-5, 3, 1, {}),
    ("qwen3-moe-30b-a3b", "bfloat16", 3e-2, 2, 16, {"capacity_factor": 1.0}),
    ("deepseek-v2-236b", "bfloat16", 3e-2, 2, 24, {}),
]


@pytest.mark.parametrize("name,dtype,tol,B,S,moe", CASES)
def test_moe_forward_matches_reference(name, dtype, tol, B, S, moe):
    jcfg, pcfg, params, module = _pair(name, dtype, **moe)
    x = _x(B, S, pcfg.d_model, dtype)
    ref_out, ref_aux = J_moe_forward(params, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        out, aux = P_moe.moe_forward(module, pcfg, _t(x))
    assert out.shape == (B, S, pcfg.d_model) and out.dtype == module.router.dtype
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(out, ref_out, tol)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-5, rtol=1e-5)
    if moe.get("capacity_factor") == 1.0:  # the forced-drop cases do drop
        with torch.inference_mode():
            _, _, ids = P_moe.route(module, pcfg, _t(x))
        assert _dropped(ids.numpy(), pcfg.moe.num_experts, P_moe.capacity(S, pcfg)) > 0


def test_drops_change_the_output():
    """The forced-drop output is not the no-drop one: the dropped choices
    contribute nothing, exactly as in the reference."""
    jcfg, pcfg, params, module = _pair("qwen3-moe-30b-a3b", capacity_factor=1.0)
    x = _x(2, 16, pcfg.d_model, "float32")
    roomy = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, capacity_factor=8.0))
    with torch.inference_mode():
        tight, _ = P_moe.moe_forward(module, pcfg, _t(x))
        full, _ = P_moe.moe_forward(module, roomy, _t(x))
    rows = (tight - full).abs().amax(dim=-1)  # (B, S): tokens that lost a choice
    assert 0 < int((rows > 1e-6).sum()) < rows.numel()


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_top_k_order_matches_reference(name):
    jcfg, pcfg, params, module = _pair(name, seed=3)
    x = _x(2, 32, pcfg.d_model, "float32", seed=4)
    logits = jnp.asarray(x) @ params["router"]
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    ref_vals, ref_ids = jax.lax.top_k(probs, jcfg.moe.top_k)
    ref_vals = ref_vals / jnp.sum(ref_vals, axis=-1, keepdims=True)
    with torch.inference_mode():
        port_probs, vals, ids = P_moe.route(module, pcfg, _t(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    _close(vals, ref_vals, 1e-6)
    _close(port_probs, probs, 1e-6)


def test_slots_rank_choices_token_major_per_sequence():
    ids = torch.tensor([[[0, 1], [1, 0], [0, 2]], [[2, 1], [2, 0], [1, 2]]])
    # sequence 0, rows t K + j: 0 1 1 0 0 2 -> ranks 0 0 1 1 2 0
    np.testing.assert_array_equal(P_moe.slots(ids, 3).numpy(),
                                  [[0, 0, 1, 1, 2, 0], [0, 0, 1, 0, 1, 2]])


@pytest.mark.parametrize("B,S,K,E", [(2, 100, 3, 7), (3, 1, 2, 4), (1, 500, 8, 128)])
def test_slots_are_the_reference_one_hot_cumsum(B, S, K, E):
    """The flat scan gives the reference's ``cumsum(one_hot) * one_hot - 1``
    maxed over experts (``moe.py:96-99``), per sequence."""
    ids = np.random.default_rng(S).integers(0, E, (B, S, K))
    flat = jnp.asarray(ids.reshape(B, S * K))
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    ref = jnp.max(jnp.cumsum(onehot, axis=1) * onehot - 1, axis=2)
    np.testing.assert_array_equal(P_moe.slots(torch.tensor(ids), E).numpy(), np.asarray(ref))


def test_router_aux_loss_matches_reference():
    rng = np.random.default_rng(5)
    E, K, N = 6, 2, 40
    logits = rng.normal(size=(N, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1)[:, :K]
    ref = J_moe.router_aux_loss(jnp.asarray(probs), jnp.asarray(ids), E)
    port = P_moe.router_aux_loss(torch.tensor(probs), torch.tensor(ids), E)
    np.testing.assert_allclose(float(port), float(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_capacity_matches_reference(name, cf):
    """``C`` against the reference's expression over S = 1 .. 5000 (the
    full configs' E and K)."""
    from repro.configs import get_config as J_get_config
    from repro_torch.configs import get_config

    jm = dataclasses.replace(J_get_config(name).moe, capacity_factor=cf)
    pcfg = get_config(name)
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, capacity_factor=cf))
    for S in list(range(1, 300)) + [511, 512, 1000, 2560, 4096, 4097, 5000]:
        ref = max(1, int(-(-S * jm.top_k * jm.capacity_factor // jm.num_experts)))
        assert P_moe.capacity(S, pcfg) == ref, S


def test_shared_expert_width_and_init_stds():
    """deepseek's shared MLP is ``d_ff_shared`` wide (``d_ff_expert *
    num_shared_experts`` when that is 0); the drawn weights have the
    reference's standard deviations (truncated normals of std s * 0.88)."""
    _, pcfg = _cfgs("deepseek-v2-236b")
    moe = P_moe.init_moe(pcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu").requires_grad_(False)
    assert tuple(moe.shared.w_up.shape) == (pcfg.d_model, pcfg.moe.d_ff_shared)
    no_width = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, d_ff_shared=0,
                                                                 num_shared_experts=2))
    assert P_moe.MoE(no_width, "meta").shared.w_up.shape[1] == 2 * pcfg.moe.d_ff_expert
    _, qcfg = _cfgs("qwen3-moe-30b-a3b")
    assert not hasattr(P_moe.MoE(qcfg, "meta"), "shared")
    d, f = pcfg.d_model, pcfg.moe.d_ff_expert
    trunc = 0.8796  # std of N(0, 1) truncated to [-2, 2]
    for w, std in ((moe.router, d**-0.5), (moe.routed.w_gate, d**-0.5),
                   (moe.routed.w_up, d**-0.5), (moe.routed.w_down, f**-0.5)):
        assert abs(float(w.std()) / (std * trunc) - 1.0) < 0.1
        assert float(w.abs().max()) <= 2 * std + 1e-6


def test_moe_gradients_match_reference():
    """Under autograd the block runs its products out of place: the loss of
    its output and its gradients (input, router, experts) are the
    reference's (float32, forced drops)."""
    jcfg, pcfg, jparams, module = _pair("qwen3-moe-30b-a3b", capacity_factor=1.0)
    x = _x(2, 16, pcfg.d_model, "float32")
    proj = np.random.default_rng(3).normal(size=(pcfg.d_model,)).astype(np.float32)

    def j_loss(p, xx):
        out, aux = J_moe.moe_forward(p, jcfg, xx)
        return jnp.sum(out * proj) + aux

    j_gp, j_gx = jax.grad(j_loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    module.requires_grad_(True)
    out, aux = P_moe.moe_forward(module, pcfg, xt)
    (torch.sum(out * torch.tensor(proj)) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(module.router.grad.numpy(), np.asarray(j_gp["router"]),
                               rtol=1e-4, atol=1e-5)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(module.routed, name).grad.numpy(),
                                   np.asarray(j_gp["routed"][name]), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        again, _ = P_moe.moe_forward(module, pcfg, _t(x))
    assert torch.equal(again, out.detach())
