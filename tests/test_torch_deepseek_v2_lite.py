"""DeepSeek-V2-Lite in the port (``configs/deepseek_v2_lite.py``) on the CPU
at its smoke size, against the benchmark's plain reference
(``perfbench/reference/deepseek_v2_lite_dsgd.py``, plain torch, neither the
port nor JAX): one D-SGD step's logits, loss with the balance loss,
gradients and update; the expert share against the uncut layer; the
router's form and the sequence-wise balance loss by hand; no dropped
choice where the capacity path drops; YaRN's frequencies at the published
sizes; the padded flash path against the plain MLA math.

Tolerances: float32 on both sides, the same operations in another order
(the port's flash path zero-pads and sums in its own order, its experts
run as grouped products): 1e-5 relative for logits and losses, 1e-4 of
each gradient's largest magnitude.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from perfbench.reference import deepseek_v2_lite_dsgd as ref  # noqa: E402
from repro_torch.configs import PORT_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.core.mixing import schedule_from_result  # noqa: E402
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.models import attention, layers, moe, transformer  # noqa: E402
from repro_torch.models.common import YarnConfig, reference_dict, yarn_mscale  # noqa: E402
from repro_torch.train.lm_trainer import make_train_setup  # noqa: E402

CPU = torch.device("cpu")
SMOKE = get_smoke_config("deepseek-v2-lite")


def ref_cfg(cfg) -> dict:
    """The reference's configuration dict (the benchmark file's keys) of a
    port config."""
    m, a, y = cfg.moe, cfg.mla, cfg.rope_scaling
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads,
        "kv_lora_rank": a.kv_lora_rank, "qk_nope_head_dim": a.qk_nope_head_dim,
        "qk_rope_head_dim": a.qk_rope_head_dim, "v_head_dim": a.v_head_dim,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "rope_scaling": dict(dataclasses.asdict(y), type="yarn"),
        "first_k_dense_replace": cfg.first_dense_layers, "num_hidden_layers": cfg.num_layers,
        "n_routed_experts": m.held_experts, "n_routed_experts_published": m.num_experts,
        "first_expert": m.first_expert, "num_experts_per_tok": m.top_k,
        "routed_scaling_factor": m.routed_scaling_factor, "aux_loss_alpha": m.router_aux_coef,
    }


def _params(cfg, n: int, seed: int = 0) -> dict:
    """A model drawn from ``seed``, its norm scales and the routed experts'
    weights perturbed (so that every weight matters), stacked over n."""
    model = transformer.LM(cfg, CPU)
    model.init_weights(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    out = {}
    for k, p in model.named_parameters():
        v = p.detach()
        if k.endswith("scale"):
            v = v + 0.1 * torch.randn(v.shape, generator=gen)
        out[k] = v[None].expand((n,) + tuple(v.shape)).clone()
    return out


def _batch(cfg, n: int, B: int = 2, S: int = 24, seed: int = 3) -> dict:
    toks = torch.randint(0, cfg.vocab_size, (n, B, S + 1),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}


def _close(got, want, tol):
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= tol * scale, (float((got - want).abs().max()), scale)


def test_registered_beside_the_reference_architectures():
    assert PORT_IDS == {"deepseek-v2-lite": "deepseek_v2_lite"}
    cfg = get_config("deepseek-v2-lite")
    assert get_config("deepseek_v2_lite") == cfg
    total = sum(p.numel() for p in transformer.LM(cfg, "meta").parameters())
    assert round(total / 1e9, 2) == 15.71  # the published 15.7B
    assert (cfg.first_dense_layers, cfg.dense_d_ff, cfg.moe.held_experts) == (1, 10944, 64)
    # the port's own fields, set, keep it from reading as a reference config
    assert set(reference_dict(cfg)) > {"first_dense_layers", "rope_scaling"}
    assert "flash" not in reference_dict(get_config("deepseek-v2-236b"))["mla"]


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_one_dsgd_step_matches_the_plain_reference(impl):
    """Two stacked nodes, one step: every node's logits, its loss (cross
    entropy plus 0.001 times the balance losses), every gradient, and the
    mixed update; routed as the port routed, where the reference's own
    float32 top-k agrees."""
    cfg, n = SMOKE, 2
    sched = schedule_from_result(learn_topology(np.eye(n), 1))
    setup = make_train_setup(cfg, n_nodes=n, schedule=sched, device=CPU, impl=impl)
    params, batch = _params(cfg, n), _batch(cfg, n)
    L = cfg.num_layers - cfg.first_dense_layers
    slots = torch.zeros((n * L, 2 * 24 * cfg.moe.top_k), dtype=torch.uint8)
    with moe.route_log(slots):
        losses, grads = setup.grad_fn(params, batch)
    routes = slots.view(1, n, L, 2, 24, cfg.moe.top_k)
    rc = ref_cfg(cfg)
    model = transformer.LM(cfg, CPU)
    for i in range(n):
        with torch.no_grad():
            torch.nn.utils.vector_to_parameters(
                torch.cat([params[k][i].reshape(-1) for k, _ in model.named_parameters()]),
                model.parameters())
            logits, _, aux = model(batch["tokens"][i], impl=impl)
            want, want_aux, flips, _ = ref.forward({k: v[i] for k, v in params.items()},
                                                   batch["tokens"][i], rc, "float32", routes[0, i])
        _close(logits, want, 1e-5)
        assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
        assert float(flips) == 0
    W = torch.as_tensor(sched.to_matrix(), dtype=torch.float32)
    new, loss, rgrads, flips, _ = ref.step(params, batch["tokens"], batch["labels"], W, rc, 1e-3,
                                           "float32", routes=routes[0])
    assert flips == 0
    assert abs(float(losses.mean()) - float(loss)) <= 1e-5 * float(loss)
    for k in params:
        _close(grads[k], rgrads[k], 1e-4)
    stepped, _, _ = setup.train_step(params, None, batch)
    for k in params:
        _close(stepped[k], new[k], 1e-5)


def _moe_module(cfg, held: int, first: int, whole=None):
    """An expert layer holding experts [first, first + held), its weights
    the ``whole`` layer's (or drawn)."""
    c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, held_experts=held,
                                                         first_expert=first))
    block = moe.MoE(c, CPU)
    block.init_weights(torch.Generator().manual_seed(5))
    if whole is not None:
        with torch.no_grad():
            block.router.copy_(whole.router)
            for name in ("w_gate", "w_up", "w_down"):
                getattr(block.routed, name).copy_(getattr(whole.routed, name)[first:first + held])
            for name in ("w_gate", "w_up", "w_down"):
                getattr(block.shared, name).copy_(getattr(whole.shared, name))
    return c, block.requires_grad_(False)


def test_two_expert_shares_add_up_to_the_whole_layer():
    """Experts 0-3 on one chip, 4-7 on another: their outputs, with the
    shared experts and the balance loss (which every chip computes alike)
    counted once, add up to the reference's uncut layer."""
    cfg = SMOKE
    whole_cfg, whole = _moe_module(cfg, 8, 0)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(7))
    (ca, a), (cb, b) = _moe_module(cfg, 4, 0, whole), _moe_module(cfg, 4, 4, whole)
    out_a, aux_a = moe.moe_forward(a, ca, x)
    out_b, aux_b = moe.moe_forward(b, cb, x)
    shared = layers.mlp_forward(whole.shared, x, cfg.mlp_type)
    assert float(aux_a) == float(aux_b)
    params = {f"layers.1.mlp.{k}": v for k, v in whole.named_parameters()}
    rc = ref_cfg(whole_cfg)
    routed, aux, _, _ = ref._moe(x, lambda k: params[f"layers.1.{k}"], rc, "float32", None)
    ref_shared = ref._swiglu(x, whole.shared.w_gate, whole.shared.w_up, whole.shared.w_down,
                             "float32")
    _close(out_a + out_b - shared, routed + ref_shared, 1e-5)
    assert abs(float(aux_a) - float(aux)) <= 1e-6


def test_router_form_and_the_sequence_balance_loss_by_hand():
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16", moe=dataclasses.replace(
        SMOKE.moe, routed_scaling_factor=2.5))
    block = moe.MoE(cfg, CPU)
    block.init_weights(torch.Generator().manual_seed(2))
    block.requires_grad_(False)
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(3)).bfloat16()
    probs, gates, ids = moe.route(block, cfg, x)
    want = torch.softmax(x.float() @ block.router.float(), dim=-1)  # float32 logits
    assert torch.equal(probs, want)
    assert torch.equal(ids, torch.topk(want, cfg.moe.top_k, dim=-1).indices)
    assert torch.equal(gates, want.gather(-1, ids) * 2.5)  # not renormalised
    assert not torch.allclose(gates.sum(-1), torch.full((2, 5), 2.5))
    bf16 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_f32=False))
    assert torch.equal(moe.route(block, bf16, x)[0],
                       torch.softmax((x @ block.router).float(), dim=-1))
    # the balance loss: E / (K S) times each sequence's choices, times the
    # sequence's mean probability, summed, averaged over the sequences
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    by_hand = 0.0
    for b in range(2):
        for e in range(E):
            f = sum(int(ids[b, t, j]) == e for t in range(5) for j in range(K)) * E / (K * 5)
            by_hand += f * float(probs[b, :, e].mean()) / 2
    assert abs(float(moe.seq_aux_loss(probs, ids, E)) - by_hand) <= 1e-6


def test_no_choice_is_dropped_where_the_capacity_path_drops():
    """A router skewed so that every token picks experts 0-2: the capacity
    path (every expert, capacity factor 1) drops choices, the held path
    drops none and equals each token's own sum."""
    cfg = SMOKE
    c, block = _moe_module(cfg, 8, 0)
    with torch.no_grad():
        block.router.zero_()
        block.router[:, :3] = 1.0
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(9)).abs()
    probs, gates, ids = moe.route(block, c, x)
    assert set(ids.unique().tolist()) == {0, 1, 2}
    out, _ = moe.moe_forward(block, c, x)
    r = block.routed
    want = torch.zeros_like(x)
    for b in range(2):
        for t in range(16):
            for j in range(c.moe.top_k):
                e = int(ids[b, t, j])
                h = torch.nn.functional.silu(x[b, t] @ r.w_gate[e]) * (x[b, t] @ r.w_up[e])
                want[b, t] += gates[b, t, j] * (h @ r.w_down[e])
    want += layers.mlp_forward(block.shared, x, c.mlp_type)
    _close(out, want, 1e-5)
    cap = dataclasses.replace(c, moe=dataclasses.replace(c.moe, held_experts=0,
                                                         capacity_factor=1.0))
    assert moe.capacity(16, cap) < 16  # 16 tokens a sequence pick each of three experts
    dropped, _ = moe.moe_forward(block, cap, x)
    assert float((dropped - want).abs().max()) > 0.1 * float(want.abs().max())


def test_yarn_inverse_frequencies_at_the_published_sizes():
    y = YarnConfig()
    assert layers.yarn_correction_range(64, 10000.0, y) == (10, 23)
    got = layers.yarn_inv_freq(64, 10000.0, y)
    for i in range(32):
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        m = 1.0 - ramp
        want = 10000.0 ** (-2 * i / 64) * (m + (1 - m) / 40.0)
        assert abs(float(got[i]) - want) <= 1e-6 * want, i
    assert torch.allclose(got, ref.yarn_freqs({"rope_scaling": dataclasses.asdict(y),
                                               "qk_rope_head_dim": 64, "rope_theta": 10000},
                                              "cpu"))
    cos, sin = layers.rotary_embedding(torch.arange(5), 64, 10000.0, y)
    assert torch.allclose(cos, torch.cos(torch.arange(5.0)[:, None] * got))  # mscale ratio 1
    assert abs(attention.mla_scale(get_config("deepseek-v2-lite")) - 0.114721) < 1e-6
    assert abs(yarn_mscale(40.0, 0.707) - (0.1 * 0.707 * math.log(40) + 1)) < 1e-12


def test_the_padded_flash_path_equals_the_plain_mla_math():
    """Full-sequence MLA through the flash kernels' plain version (q, k, v
    padded to 32 from 24 / 16, the explicit scale) against the plain path,
    in float32; the padding is exact, the sums' order differs."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = SMOKE
    attn = attention.init_mla_attention(cfg, generator=torch.Generator().manual_seed(4),
                                        device=CPU)
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(6))
    pos = torch.arange(40)[None].expand(2, 40)
    calls = []
    orig = fa_ops.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    fa_ops.flash_attention = counting
    try:
        flash, _ = attention.mla_attention(attn, cfg, x, positions=pos, impl="kernel")
    finally:
        fa_ops.flash_attention = orig
    plain, _ = attention.mla_attention(attn, cfg, x, positions=pos, impl="plain")
    assert calls == [torch.Size((2, 40, cfg.num_heads, 32))]
    _close(flash, plain, 1e-5)
    q, k, v = (torch.randn((1, 9, 2, 32), generator=torch.Generator().manual_seed(s))
               for s in (1, 2, 3))
    assert torch.allclose(flash_attention_ref(q, k, v, scale=0.3),
                          flash_attention_ref(q * (0.3 * 32 ** 0.5), k, v), atol=1e-6)
