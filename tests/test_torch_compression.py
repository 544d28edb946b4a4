"""EF-compressed gossip (``repro_torch.core.compression``) against the
reference's ``repro.core.compression``.

Top-k must keep exactly k entries with the reference's order (float32
magnitudes, NaN last, +/-inf first, ties to the lowest index): the masks
are compared exactly. The EF operators are held to the reference at 1e-6
relative with float32 wires and 3e-2 with the bf16 wire (a sum that lands
a float32 ulp apart can round to the next bfloat16). The identity wire is
bitwise the uncompressed transport, in the operators and the drivers.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core.compression as J_comp  # noqa: E402
import repro.core.mixing as J_mix  # noqa: E402
from repro.core.dsgd import dsgd_init as j_dsgd_init, dsgd_step_stacked as j_dsgd_step  # noqa: E402
from repro.data.synthetic import mean_estimation_clusters as j_mec  # noqa: E402
from repro.train import metrics as J_metrics  # noqa: E402
from repro.train import trainer as J_tr  # noqa: E402

import repro_torch.core.compression as T_comp  # noqa: E402
from repro_torch.core import dsgd as T_dsgd  # noqa: E402
from repro_torch.core import mixing as T_mix  # noqa: E402
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import cluster_partition  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs, mean_estimation_clusters  # noqa: E402
from repro_torch.train import metrics as T_metrics  # noqa: E402
from repro_torch.train import trainer as T_tr  # noqa: E402

TOL = {"f32": 1e-6, "bf16": 3e-2}


def _cases():
    rng = np.random.default_rng(0)
    ties = np.array([1.0, -1.0, 0.5, 1.0, -0.5, 1.0, 0.0, 0.0], np.float32)
    zeros = np.zeros(16, np.float32)
    nonfinite = np.array([np.nan, 1.0, -np.inf, 0.0, np.inf, -2.0, np.nan, 2.0], np.float32)
    many_zeros = np.where(rng.random(64) < 0.8, 0.0, rng.normal(size=64)).astype(np.float32)
    return {"ties": ties, "zeros": zeros, "nonfinite": nonfinite, "many_zeros": many_zeros,
            "normal": rng.normal(size=(5, 7)).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(_cases()))
@pytest.mark.parametrize("frac", [0.01, 0.25, 0.5, 1.0])
def test_topk_mask_is_exactly_the_reference(case, frac):
    x = _cases()[case]
    port = T_comp.topk_mask(torch.from_numpy(x), frac).numpy()
    ref = np.asarray(J_comp.topk_mask(jnp.asarray(x), frac))
    assert np.array_equal(port, ref)
    assert port.sum() == T_comp.topk_keep_count(x.size, frac) == J_comp.topk_keep_count(x.size, frac)
    comp = T_comp.topk_compress(frac)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(comp, np.asarray(J_comp.topk_compress(frac)(jnp.asarray(x))))


def test_wire_formats_and_specs():
    x = np.random.default_rng(1).normal(size=(4, 9)).astype(np.float32) * 1e3
    np.testing.assert_array_equal(T_comp.bf16_compress(torch.from_numpy(x)).numpy(),
                                  np.asarray(J_comp.bf16_compress(jnp.asarray(x))))
    for spec in ("none", "identity", "bf16", "topk", "topk:0.1", "topk:0.1:g0.25", "bf16:g0.5"):
        port, ref = T_comp.make_compressor(spec), J_comp.make_compressor(spec)
        assert (port.kind, port.frac, port.gamma, port.label) == (ref.kind, ref.frac, ref.gamma,
                                                                   ref.label)
        assert port.routes_to_plain == ref.routes_to_plain
        for P in (1, 10, 50890):
            assert port.wire_layout(P) == ref.wire_layout(P)
            assert port.wire_bytes(P) == ref.wire_bytes(P)
    assert T_comp.make_compressor(None) is None
    for bad, exc in (("topk:x", ValueError), ("lz4", ValueError), (lambda x: x, TypeError)):
        with pytest.raises(exc):
            T_comp.make_compressor(bad)
    with pytest.raises(ValueError, match="frac"):
        T_comp.Compressor("topk", 0.0)


@pytest.mark.parametrize("P", [1, 10, 50890])
@pytest.mark.parametrize("spec", [None, "identity", "bf16", "topk:0.1", "topk:0.25:g0.5"])
def test_bytes_match_reference(spec, P):
    for transport, extra in (("allgather", {}), ("ppermute", {"n_comm_atoms": 3}),
                             ("pool", {"n_comm_atoms": 4}), ("dense", {})):
        kw = dict(n_nodes=100, p_total=P, compression=spec, alive_frac=0.75, **extra)
        assert (T_metrics.mix_bytes_per_step(transport, **kw)
                == J_metrics.mix_bytes_per_step(transport, **kw))
    f32 = T_metrics.mix_bytes_per_step("allgather", n_nodes=100, p_total=P)
    if spec == "bf16":
        assert 2 * T_metrics.mix_bytes_per_step("allgather", n_nodes=100, p_total=P,
                                                compression=spec) == f32
    if spec is not None and spec.startswith("topk"):
        k = T_comp.topk_keep_count(P, T_comp.make_compressor(spec).frac)
        assert T_metrics.mix_bytes_per_step("allgather", n_nodes=100, p_total=P,
                                            compression=spec) == 99 * k * 8
    if spec not in (None, "identity"):
        with pytest.raises(ValueError, match="allreduce"):
            T_metrics.mix_bytes_per_step("allreduce", n_nodes=4, p_total=P, compression=spec)


def _atoms(n, L, seed):
    rng = np.random.default_rng(seed)
    g = rng.dirichlet(np.ones(L)).astype(np.float32)
    p = np.stack([np.arange(n)] + [rng.permutation(n) for _ in range(L - 1)]).astype(np.int32)
    return (T_mix.ScheduleArrays(torch.from_numpy(g), torch.from_numpy(p)),
            J_mix.ScheduleArrays(jnp.asarray(g), jnp.asarray(p)))


def _close(port, ref, wire):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=TOL[wire], atol=TOL[wire])


@pytest.mark.parametrize("spec", ["bf16", "topk:0.2", "topk:0.3:g0.5", "bf16:g0.25"])
def test_ef_operators_match_reference(spec):
    wire = "bf16" if spec.startswith("bf16") else "f32"
    n, L = 8, 4
    rng = np.random.default_rng(2)
    t_sa, j_sa = _atoms(n, L, 3)
    W = T_mix.arrays_to_matrix(t_sa).astype(np.float32)
    theta = rng.normal(size=(n, 6)).astype(np.float32)
    ef = (0.1 * rng.normal(size=(n, 6))).astype(np.float32)
    t_comp, j_comp = T_comp.make_compressor(spec), J_comp.make_compressor(spec)
    # dense
    pm, pe = T_comp.ef_gossip_step(torch.from_numpy(theta), torch.from_numpy(ef),
                                   torch.from_numpy(W), t_comp)
    rm, re = J_comp.ef_gossip_step(jnp.asarray(theta), jnp.asarray(ef), jnp.asarray(W), j_comp)
    _close(pm, rm, wire)
    _close(pe, re, wire)
    # ScheduleArrays, per leaf, in both of the port's numerics
    tree = {"a": theta, "b": rng.normal(size=(n, 3, 5)).astype(np.float32)}
    etree = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32) for k, v in tree.items()}
    rm, re = J_comp.ef_mix_schedule_arrays({k: jnp.asarray(v) for k, v in tree.items()},
                                           {k: jnp.asarray(v) for k, v in etree.items()},
                                           j_sa, j_comp)
    for use_kernel in (False, True):
        pm, pe = T_comp.ef_mix_schedule_arrays({k: torch.from_numpy(v) for k, v in tree.items()},
                                               {k: torch.from_numpy(v) for k, v in etree.items()},
                                               t_sa, t_comp, use_kernel=use_kernel)
        for k in tree:
            _close(pm[k], rm[k], wire)
            _close(pe[k], re[k], wire)
    # the stale ring, over a few pushes with delays
    delays = [np.zeros(n, np.int32), rng.integers(0, 3, n).astype(np.int32),
              rng.integers(0, 3, n).astype(np.int32)]
    t_buf = T_mix.stale_buffer_init(torch.from_numpy(theta), 3)
    j_buf = J_mix.stale_buffer_init(jnp.asarray(theta), 3)
    t_ef, j_ef = torch.from_numpy(ef), jnp.asarray(ef)
    for d in delays:
        half = rng.normal(size=(n, 6)).astype(np.float32)
        pm, t_ef, t_buf = T_comp.ef_stale_mix_flat(torch.from_numpy(half), t_ef, t_buf, t_sa,
                                                   torch.from_numpy(d), t_comp)
        rm, j_ef, j_buf = J_comp.ef_stale_mix_flat(jnp.asarray(half), j_ef, j_buf, j_sa,
                                                   jnp.asarray(d), j_comp)
        _close(pm, rm, wire)
        _close(t_ef, j_ef, wire)
        _close(t_buf.buf, j_buf.buf, wire)
        assert int(t_buf.head) == int(j_buf.head)


def test_stale_topk_sees_the_whole_row_and_skips_the_padding():
    """ef_stale_mix_flat compresses each node's flat row: with ``payload``
    the padding columns pass through and k counts the payload only."""
    n, P = 4, 10
    rng = np.random.default_rng(4)
    t_sa, _ = _atoms(n, 3, 5)
    half = rng.normal(size=(n, P)).astype(np.float32)
    padded = np.concatenate([half, np.zeros((n, 6), np.float32)], axis=1)
    comp = T_comp.make_compressor("topk:0.3")
    outs = []
    for x, payload in ((half, None), (padded, P)):
        buf = T_mix.stale_buffer_init(torch.from_numpy(x), 2)
        m, e, _ = T_comp.ef_stale_mix_flat(torch.from_numpy(x), torch.zeros_like(torch.from_numpy(x)),
                                           buf, t_sa, torch.zeros(n, dtype=torch.int32), comp,
                                           payload=payload)
        outs.append((m[:, :P], e[:, :P]))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    kept = (outs[0][1] == 0).sum(dim=1)  # kept entries leave no error behind
    assert kept.tolist() == [T_comp.topk_keep_count(P, 0.3)] * n


def test_identity_wire_is_the_uncompressed_transport_bitwise():
    n = 8
    rng = np.random.default_rng(6)
    t_sa, _ = _atoms(n, 4, 7)
    tree = {"a": torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(n, 2, 3)).astype(np.float32))}
    ef = T_comp.ef_init(tree)
    ident = T_comp.make_compressor("identity")
    mixed, new_ef = T_comp.ef_mix_schedule_arrays(tree, ef, t_sa, ident)
    plain = T_mix.mix_schedule_arrays(tree, t_sa)
    assert all(torch.equal(mixed[k], plain[k]) for k in tree) and new_ef is ef
    W = torch.from_numpy(T_mix.arrays_to_matrix(t_sa).astype(np.float32))
    m, e = T_comp.ef_gossip_step(tree["a"], ef["a"], W, ident)
    assert torch.equal(m, T_mix.mix_dense(tree["a"], W)) and e is ef["a"]
    # the damped identity wire is exact gossip through the generic combine
    m, _ = T_comp.ef_gossip_step(tree["a"], ef["a"], W, T_comp.make_compressor("identity:g0.5"))
    np.testing.assert_allclose(m.numpy(), (0.5 * tree["a"] + 0.5 * (W @ tree["a"])).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_dsgd_step_with_ef_matches_reference():
    n = 6
    rng = np.random.default_rng(8)
    t_sa, j_sa = _atoms(n, 3, 9)
    theta = rng.normal(size=(n, 4)).astype(np.float32)
    grads = rng.normal(size=(n, 4)).astype(np.float32)
    t_theta = torch.from_numpy(theta)
    p, st, e = T_dsgd.dsgd_step_stacked(t_theta, torch.from_numpy(grads),
                                        T_dsgd.dsgd_init(t_theta), None, 0.1, schedule=t_sa,
                                        ef=T_comp.ef_init(t_theta), compression="topk:0.5")
    rp, rst, re = j_dsgd_step(jnp.asarray(theta), jnp.asarray(grads),
                              j_dsgd_init(jnp.asarray(theta)), None, 0.1, schedule=j_sa,
                              ef=J_comp.ef_init(jnp.asarray(theta)), compression="topk:0.5")
    _close(p, rp, "f32")
    _close(e, re, "f32")
    assert st.step == 1
    with pytest.raises(ValueError, match="compression without ef"):
        T_dsgd.dsgd_step_stacked(t_theta, t_theta, T_dsgd.dsgd_init(t_theta), None, 0.1,
                                 schedule=t_sa, compression="bf16")


def _arrays(Pi, budget, l_max):
    res = learn_topology(Pi, budget=budget, lam=0.5)
    return T_mix.schedule_to_arrays(T_mix.schedule_from_result(res), l_max=l_max, device="cpu")


def _j(sa):
    return J_mix.ScheduleArrays(jnp.asarray(sa.gammas.numpy()), jnp.asarray(sa.perms.numpy()))


@pytest.mark.parametrize("spec", ["bf16", "topk:0.5:g0.5"])
def test_mean_estimation_with_compression_matches_reference(spec):
    n, K, steps, seg = 12, 4, 30, 5
    wire = "bf16" if spec == "bf16" else "f32"
    task = mean_estimation_clusters(n_nodes=n, K=K, m=3.0)
    Pi = np.eye(K)[np.arange(n) % K]
    sa, sa2 = _arrays(Pi, 4, 8), _arrays(Pi[::-1].copy(), 4, 8)
    kw = dict(steps=steps, lr=0.2, seed=1, segment_len=seg, compression=spec)
    outs = {r: T_tr.run_mean_estimation(task, None, schedule=sa, rollout=r, device="cpu",
                                        on_segment=lambda t: sa2 if t == 14 else None, **kw)
            for r in ("scan", "loop")}
    ref = J_tr.run_mean_estimation(j_mec(n_nodes=n, K=K, m=3.0), None, schedule=_j(sa),
                                   on_segment=lambda t: _j(sa2) if t == 14 else None, **kw)
    port = outs["scan"]
    _close(port["mean_sq_error"], ref["mean_sq_error"], wire)
    _close(port["theta"], ref["theta"], wire)
    assert port["comm"] == ref["comm"] and port["compression"] == ref["compression"] == \
        T_comp.make_compressor(spec).label
    assert port["swaps"] == ref["swaps"] == [14] and port["n_traces"] == 1
    for key in ("mean_sq_error", "theta"):
        assert np.array_equal(outs["loop"][key], port[key])


def test_identity_compression_is_bitwise_no_compression_in_the_drivers():
    n, K = 12, 4
    task = mean_estimation_clusters(n_nodes=n, K=K, m=3.0)
    Pi = np.eye(K)[np.arange(n) % K]
    sa, sa2 = _arrays(Pi, 4, 8), _arrays(Pi[::-1].copy(), 4, 8)
    kw = dict(steps=20, lr=0.2, seed=1, segment_len=5, device="cpu",
              on_segment=lambda t: sa2 if t == 9 else None)
    none = T_tr.run_mean_estimation(task, None, schedule=sa, **kw)
    ident = T_tr.run_mean_estimation(task, None, schedule=sa, compression="identity", **kw)
    assert np.array_equal(none["mean_sq_error"], ident["mean_sq_error"])
    assert np.array_equal(none["theta"], ident["theta"])
    assert none["comm"] == ident["comm"] and ident["compression"] == "identity"
    X, y = gaussian_blobs(n_samples=300, num_classes=4, dim=8, seed=0)
    idx, Pi8 = cluster_partition(y, 8)
    ckw = dict(model="mlp", hidden=8, steps=15, batch_size=8, lr=0.3, eval_every=5,
               X_test=X[:50], y_test=y[:50], seed=3, device="cpu", schedule=_arrays(Pi8, 3, 6))
    logs = {c: T_tr.run_classification(X, y, idx, None, compression=c, **ckw)
            for c in (None, "identity")}
    assert logs[None].history == logs["identity"].history
    assert logs[None].aux["comm"] == logs["identity"].aux["comm"]


def test_classification_with_topk_matches_reference_on_its_draws():
    import jax

    X, y = gaussian_blobs(n_samples=480, num_classes=4, dim=8, seed=0)
    X_tr, y_tr, X_te, y_te = X[:400], y[:400], X[400:], y[400:]
    n, steps, batch = 8, 11, 8
    idx, Pi = cluster_partition(y_tr, n)
    sa = _arrays(Pi, 3, 6)
    params0 = J_tr.init_linear_classifier(jax.random.PRNGKey(0), X.shape[1], 4)
    lengths = J_tr._stack_node_data(X_tr, y_tr, idx).lengths
    draw = jax.vmap(lambda k, length: jax.random.randint(k, (batch,), 0, jnp.maximum(length, 1)))
    key, batches = jax.random.PRNGKey(1), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        batches.append(np.asarray(draw(jax.random.split(sub, n), lengths)))
    kw = dict(steps=steps, batch_size=batch, lr=0.3, eval_every=5, X_test=X_te, y_test=y_te,
              seed=0, compression="topk:0.25")
    port = T_tr.run_classification(X_tr, y_tr, idx, None, schedule=sa, device="cpu",
                                   params0={k: np.asarray(v) for k, v in params0.items()},
                                   batch_indices=np.stack(batches), **kw)
    ref = J_tr.run_classification(X_tr, y_tr, idx, None, schedule=_j(sa), **kw)
    # float32 reductions in another order than XLA's (as in test_torch_trainer.py)
    np.testing.assert_allclose(port.column("loss"), ref.column("loss"), rtol=1e-4, atol=1e-5)
    assert port.aux["comm"] == ref.aux["comm"] and port.aux["compression"] == "topk:0.25"


def test_compression_arguments_are_checked():
    task = mean_estimation_clusters(n_nodes=4, K=2, m=1.0)
    with pytest.raises(ValueError, match="data plane"):
        T_tr.run_mean_estimation(task, np.eye(4), steps=2, device="cpu", compression="bf16")
    with pytest.raises(TypeError, match="compression must be"):
        T_tr.run_mean_estimation(task, np.eye(4), steps=2, device="cpu", compression=3)
