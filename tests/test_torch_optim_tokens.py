"""The port's optimizers, schedules and LM token pipeline against the
reference's (``repro.optim``, ``repro.data.tokens``).

Optimizers (``sgd`` plain / heavy-ball / Nesterov / weight decay,
``adamw``), ``apply_updates``, ``global_norm`` and ``clip_by_global_norm``
run on the same random float32 trees made by numpy, for a few steps of
the same random gradients, with a float learning rate and with a
schedule: every leaf within 1e-6 (``TOL``, relative and absolute). The
four schedules match at steps 0-40 to 1e-6. ``DomainSkewCorpus`` and
``TokenBatcher`` are a numpy copy: their draws are bitwise the
reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as J_optim  # noqa: E402
from repro.data import tokens as J_tokens  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.data import DomainSkewCorpus, TokenBatcher  # noqa: E402

TOL = 1e-6


def _tree(rng, scale: float = 1.0) -> dict:
    return {"w": (rng.normal(size=(5, 7)) * scale).astype(np.float32),
            "b": (rng.normal(size=(7,)) * scale).astype(np.float32),
            "block": {"u": (rng.normal(size=(3, 2, 4)) * scale).astype(np.float32)}}


def _torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.as_tensor(np.asarray(x)), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(port, ref) -> None:
    flat_p = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), port, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    flat_r = jax.tree_util.tree_leaves(ref)
    assert len(flat_p) == len(flat_r)
    for a, b in zip(flat_p, flat_r):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


OPTIMIZERS = {
    "sgd": lambda m, lr: m.sgd(lr),
    "momentum": lambda m, lr: m.sgd(lr, momentum=0.9),
    "nesterov": lambda m, lr: m.sgd(lr, momentum=0.9, nesterov=True),
    "sgd_wd": lambda m, lr: m.sgd(lr, momentum=0.5, weight_decay=1e-2),
    "adamw": lambda m, lr: m.adamw(lr),
    "adamw_wd": lambda m, lr: m.adamw(lr, b1=0.8, b2=0.99, weight_decay=1e-2),
}


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_reference(name, schedule):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(4)]
    j_lr = J_optim.linear_warmup_cosine(0.05, 2, 4) if schedule else 0.05
    p_lr = optim.linear_warmup_cosine(0.05, 2, 4) if schedule else 0.05
    j_opt, p_opt = OPTIMIZERS[name](J_optim, j_lr), OPTIMIZERS[name](optim, p_lr)
    jp, pp = _jax(params), _torch(params)
    js, ps = j_opt.init(jp), p_opt.init(pp)
    for g in grads:
        ju, js = j_opt.update(_jax(g), js, jp)
        pu, ps = p_opt.update(_torch(g), ps, pp)
        _close(pu, ju)
        jp, pp = J_optim.apply_updates(jp, ju), optim.apply_updates(pp, pu)
        _close(pp, jp)
    assert int(ps.step) == int(js.step) == 4 and ps.step.dtype == torch.int32
    if js.mu is not None:
        _close(ps.mu, js.mu)
    if js.nu is not None:
        _close(ps.nu, js.nu)


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(1)
    g = _tree(rng)
    j_clipped, j_norm = J_optim.clip_by_global_norm(_jax(g), max_norm)
    p_clipped, p_norm = optim.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(float(p_norm), float(j_norm), rtol=TOL)
    np.testing.assert_allclose(float(optim.global_norm(_torch(g))),
                               float(J_optim.global_norm(_jax(g))), rtol=TOL)
    _close(p_clipped, j_clipped)


def test_apply_updates_casts_to_the_parameter_dtype():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    out = optim.apply_updates(p, {"w": torch.full((3,), 0.5, dtype=torch.float32)})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], torch.full((3,), 1.5,
                                                                                  dtype=torch.bfloat16))


SCHEDULES = {
    "constant": lambda m: m.constant(0.3),
    "warmup_constant": lambda m: m.warmup_constant(0.3, 7),
    "cosine_decay": lambda m: m.cosine_decay(0.3, 25, alpha=0.1),
    "linear_warmup_cosine": lambda m: m.linear_warmup_cosine(0.3, 5, 30, final_frac=0.2),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    j_fn, p_fn = SCHEDULES[name](J_optim), SCHEDULES[name](optim)
    for step in range(41):
        want = float(j_fn(jnp.asarray(step, jnp.int32)))
        got = p_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("vocab,domains", [(97, 3), (1000, 10)])
def test_corpus_draws_bitwise_reference(vocab, domains):
    a = DomainSkewCorpus(vocab, n_domains=domains, zipf_a=1.1, seed=4)
    b = J_tokens.DomainSkewCorpus(vocab, n_domains=domains, zipf_a=1.1, seed=4)
    for k in range(domains):
        assert np.array_equal(a.domain_probs(k), b.domain_probs(k))
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    assert np.array_equal(a.sample_tokens(1, (3, 17), ra), b.sample_tokens(1, (3, 17), rb))


def test_token_batcher_bitwise_reference():
    pi = np.eye(4)[[0, 1, 2, 3]] * 0.7 + 0.075
    ours = TokenBatcher(DomainSkewCorpus(211, n_domains=4, seed=2), pi, 3, 12, seed=5)
    ref = J_tokens.TokenBatcher(J_tokens.DomainSkewCorpus(211, n_domains=4, seed=2), pi, 3, 12,
                                seed=5)
    for step in (0, 1, 7):
        x, y = ours.next_batch(step)
        rx, ry = ref.next_batch(step)
        assert x.shape == (4, 3, 12) and x.dtype == np.int32
        assert np.array_equal(x, rx) and np.array_equal(y, ry)
        assert np.array_equal(x[:, :, 1:], y[:, :, :-1])  # next-token labels
    with pytest.raises(ValueError, match="domains"):
        TokenBatcher(DomainSkewCorpus(211, n_domains=3), pi, 3, 12)
