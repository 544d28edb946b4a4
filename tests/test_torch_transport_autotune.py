"""The port's measured transport table against the reference's.

``repro_torch.core.mixing`` keeps the reference's autotune table
(``mixing.py:1705-1913``) with its own file and hardware tags: the same
power-of-two buckets and measurement cap, the same lookup rules in
``mix_stacked`` (``"auto"`` looks up and never measures, ``"autotune"``
measures on a miss, a stored ``"dense"`` never wins without a W), and
records with the reference's fields plus the card's name and power
limit. Every test points both packages at tables of their own under
``tmp_path``, so neither committed table is read or written here.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import mixing as J_mix  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.core import mixing as T_mix  # noqa: E402
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.synthetic import mean_estimation_clusters  # noqa: E402
from repro_torch.train.trainer import run_mean_estimation  # noqa: E402

CPU = torch.device("cpu")
REFERENCE_FIELDS = {"n_nodes", "n_atoms", "p", "p_measured", "schedule_us", "dense_us",
                    "winner", "backend", "hw"}


@pytest.fixture
def tables(tmp_path, monkeypatch):
    """Both packages' tables at paths of their own (empty at first)."""
    port, ref = tmp_path / "port.json", tmp_path / "reference.json"
    monkeypatch.setenv("REPRO_TORCH_TRANSPORT_AUTOTUNE", str(port))
    monkeypatch.setenv("REPRO_TRANSPORT_AUTOTUNE", str(ref))
    return port, ref


def _schedule(n: int, L: int, seed: int = 0):
    """A ``BirkhoffSchedule`` of L atoms (the identity and L - 1 random
    permutations) in both packages, and its dense W."""
    rng = np.random.default_rng(seed)
    perms = [tuple(range(n))] + [tuple(int(x) for x in rng.permutation(n)) for _ in range(L - 1)]
    g = rng.random(L) + 0.1
    coeffs = tuple(float(c) for c in g / g.sum())
    ts = T_mix.BirkhoffSchedule(coeffs=coeffs, perms=tuple(perms))
    js = J_mix.BirkhoffSchedule(coeffs=coeffs, perms=tuple(perms))
    return ts, js, ts.to_matrix().astype(np.float32)


def test_autotune_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TRANSPORT_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_TRANSPORT_AUTOTUNE", raising=False)
    path = T_mix.transport_autotune_path()
    assert path.endswith("experiments/torch/transport_autotune.json")
    assert path != J_mix.transport_autotune_path()


def test_committed_table_holds_only_card_entries(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TRANSPORT_AUTOTUNE", raising=False)
    with open(T_mix.transport_autotune_path()) as f:
        table = json.load(f)
    assert table
    for key, rec in table.items():
        assert rec["backend"] == "cuda" and rec["card"] and rec["power_limit"].endswith(" W")
        assert REFERENCE_FIELDS <= set(rec) and rec["leaf_sizes"]
        assert key == (f"{rec['hw']}_n{rec['n_nodes']}_L{rec['n_atoms']}_P{rec['p']}")
        fastest = "schedule" if rec["schedule_us"] <= rec["dense_us"] else "dense"
        assert rec["winner"] == fastest
    # keyed by the card's name: no entry applies on this host's CPU tag
    assert not any(k.startswith(T_mix._hw_tag(CPU)) for k in table)


@pytest.mark.parametrize("x", [0, 1, 2, 3, 5, 64, 100, 128, 129, 50890, 2 ** 20 + 1])
def test_pow2_up_as_the_reference(x):
    assert T_mix._pow2_up(x) == J_mix._pow2_up(x)


@pytest.mark.parametrize("n", [2, 16, 100, 512, 4096, 2 ** 16])
@pytest.mark.parametrize("p", [1, 4096, 50890, 2 ** 20, 2 ** 30])
def test_bucket_key_and_measured_width_as_the_reference(n, p):
    assert T_mix._bucket_key(n, 11, p, CPU) == J_mix._bucket_key(n, 11, p)
    assert T_mix._MEASURE_MAX_ELEMENTS == J_mix._MEASURE_MAX_ELEMENTS
    ref = min(int(p), max(4096, J_mix._MEASURE_MAX_ELEMENTS // max(1, n)))
    assert T_mix._p_measured(n, p) == ref


def test_empty_table_falls_back_to_the_closed_form(tables):
    for n in (4, 33, 100, 512):
        for L in (1, 2, 9, 25, 26, 100):
            for p in (1, 50890):
                want = J_mix.autotune_transport(n, L, p)
                assert T_mix.autotune_transport(n, L, p, device=CPU) == want
                assert want == T_mix.preferred_transport(n, L)
    assert not tables[0].exists() and not tables[1].exists()  # lookups never measure


def test_table_entry_is_obeyed_by_auto_except_without_w(tables, monkeypatch):
    n, L = 33, 3
    ts, js, W = _schedule(n, L)
    theta = np.random.default_rng(1).normal(size=(n, 6)).astype(np.float32)
    # the closed form picks "schedule" here; the stored entry says "dense"
    assert T_mix.preferred_transport(n, ts.n_communication_atoms) == "schedule"
    key = T_mix._bucket_key(n, ts.n_communication_atoms, 6, CPU)
    assert key == J_mix._bucket_key(n, js.n_communication_atoms, 6)
    entry = {key: {"winner": "dense", "hw": key.split("_n")[0]}}
    for path in tables:
        path.write_text(json.dumps(entry))
    t = torch.from_numpy(theta)
    assert T_mix.select_transport("auto", t, W, ts) == "dense"
    assert T_mix.select_transport("auto", t, None, ts) == "schedule"
    assert J_mix.autotune_transport(n, js.n_communication_atoms, 6) == "dense"
    ran = []
    real = T_mix.mix_dense
    monkeypatch.setattr(T_mix, "mix_dense", lambda *a, **k: ran.append("dense") or real(*a, **k))
    port = T_mix.mix_stacked(t, W=torch.from_numpy(W), schedule=ts)
    ref = J_mix.mix_stacked(jnp.asarray(theta), W=jnp.asarray(W), schedule=js)
    assert ran == ["dense"]
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    T_mix.mix_stacked(t, W=None, schedule=ts)
    assert ran == ["dense"]  # without a W the stored "dense" does not win


def test_measure_true_writes_a_record_with_the_reference_fields(tables, tmp_path):
    winner = T_mix.autotune_transport(16, 2, 4096, measure=True, device=CPU)
    table = json.loads(tables[0].read_text())
    (key, rec), = table.items()
    assert key == T_mix._bucket_key(16, 2, 4096, CPU)
    assert REFERENCE_FIELDS <= set(rec) and {"card", "power_limit", "timing"} <= set(rec)
    assert rec["winner"] == winner and rec["backend"] == "cpu"
    assert (rec["n_nodes"], rec["n_atoms"], rec["p"], rec["p_measured"]) == (16, 2, 4096, 4096)
    assert rec["schedule_us"] > 0 and rec["dense_us"] > 0
    # a second request hits the table and measures nothing
    assert T_mix.autotune_transport(16, 2, 4096, measure=True, device=CPU) == winner
    # into a directory that does not exist, nothing is written
    missing = tmp_path / "no" / "such" / "dir" / "t.json"
    T_mix.autotune_transport(8, 2, 4096, measure=True, device=CPU, path=str(missing))
    assert not missing.parent.exists()


@pytest.mark.parametrize("sizes,width", [((50176, 64, 640, 10), 65536),
                                         ((50176, 64, 640, 10), 8192), ((7,), 4096),
                                         ((1, 1, 1), 4096), ((3, 5), 7)])
def test_timed_leaves_keep_the_proportions_and_the_width(sizes, width):
    timed = T_mix._timed_leaves(sizes, width)
    assert sum(timed) == width and min(timed) >= 1 and len(timed) == len(sizes)
    share = np.array(timed) / width - np.array(sizes) / sum(sizes)
    assert np.abs(share).max() <= 16 * len(sizes) / width
    # every leaf but the smallest keeps its alignment (up to 16 elements)
    small = int(np.argmin(sizes))
    assert all(t % min(16, s & -s) == 0 for i, (s, t) in enumerate(zip(sizes, timed))
               if i != small)


def test_measurement_times_the_callers_pytree(tables, monkeypatch):
    n, L = 16, 3
    ts, _, W = _schedule(n, L)
    rng = np.random.default_rng(4)
    tree = {"w": torch.from_numpy(rng.normal(size=(n, 40, 3)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))}
    seen = []
    real = T_mix.mix_stacked

    def spy(params_stack, *a, **k):
        seen.append(sorted(T_mix.tree_leaves(params_stack)[i].shape[1]
                           for i in range(len(T_mix.tree_leaves(params_stack)))))
        return real(params_stack, *a, **k)

    monkeypatch.setattr(T_mix, "mix_stacked", spy)
    winner = T_mix.select_transport("autotune", tree, W, ts)
    (rec,), = [list(json.loads(tables[0].read_text()).values())]
    assert rec["winner"] == winner and rec["leaf_sizes"] == [3, 120]  # sorted keys: b, w
    assert rec["p"] == T_mix._pow2_up(123) and rec["p_measured"] == 128
    # both transports timed on a two-leaf pytree of the bucket's width
    assert seen and all(s == sorted(T_mix._timed_leaves((3, 120), 128)) for s in seen)


def test_mix_stacked_autotune_as_the_reference(tables):
    n, L = 24, 5
    ts, js, W = _schedule(n, L, seed=2)
    theta = np.random.default_rng(3).normal(size=(n, 300)).astype(np.float32)
    ref = J_mix.mix_stacked(jnp.asarray(theta), W=jnp.asarray(W), schedule=js,
                            transport="autotune")
    port = T_mix.mix_stacked(torch.from_numpy(theta), W=torch.from_numpy(W), schedule=ts,
                             transport="autotune")
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert tables[0].exists()


def test_trainers_resolve_autotune_once_before_the_rollout(tables):
    task = mean_estimation_clusters(16, K=4, m=2.0)
    res = learn_topology(task.Pi, budget=3, lam=0.5)
    sched = T_mix.schedule_from_result(res)
    out = run_mean_estimation(task, res.W, schedule=sched, steps=6, lr=0.2, device="cpu",
                              transport="autotune")
    table = json.loads(tables[0].read_text())
    (rec,), = [list(table.values())]
    fixed = run_mean_estimation(task, res.W, schedule=sched, steps=6, lr=0.2, device="cpu",
                                transport=rec["winner"])
    np.testing.assert_array_equal(out["mean_sq_error"], fixed["mean_sq_error"])


def test_device_work_refuses_to_run_inside_a_capture():
    graphs._this_thread.capturing = True
    try:
        with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
            with graphs.device_work():
                pass
    finally:
        graphs._this_thread.capturing = False
    with graphs.device_work():  # outside a capture it runs
        pass


def test_measuring_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T_mix.measure_transport(16, 2, 4096)
