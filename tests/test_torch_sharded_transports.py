"""The port's rank transports (``repro_torch.core.mixing`` /
``compression``, one node per rank) against the reference's ``shard_map``
transports.

The reference runs in ONE module-scoped subprocess with 8 forced host
devices: for n = 4 (the first four devices) and n = 8 it draws the inputs
with numpy from a seed -- two parameter states ``p0`` / ``p1`` (float32
leaves ``a`` (5, 3) and ``b`` (7,), a bfloat16 leaf ``h`` (4, 2)), an EF
memory, a staged pool of three random permutations (one with fixed points)
and the identity, its gammas, W and the ``ScheduleArrays`` twin, a delay
vector in {0, 1}, a corruption (node 1 sign-flipped, node 2 a mantissa
bit flipped) -- runs every transport inside ``shard_map`` over ``data``
and writes inputs and outputs to an ``.npz`` under ``tmp_path``. The
port then runs the same transports on n gloo ranks of the CPU
(``tests/_torch_ranks.py``), each rank on its row.

Tolerances: float32 within 1e-6 (absolute and relative); the bfloat16
leaf within one bfloat16 rounding at the scale of what is summed: 2^-7
times the largest magnitude any node's input states hold at that entry,
plus 1e-6 (a convex combination of entries of mixed sign cancels, so a
rounding of the terms is not a rounding of the sum; the reference also
rounds some of its bf16 sums more than once). The EF memories are float32. Port-only,
bitwise: ``mix_arrays_sharded`` = ``mix_ppermute_pool``; zero delays =
the fresh transports; the identity wire = no compression; EF all-gather
= EF pool. Also the bytes counted, the sharded autotune table, and the
pool's straggler repair against the reference's host functions.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import mixing as J_mixing  # noqa: E402
from repro_torch.core import mixing as M  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ranks  # noqa: E402

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SIZES = (4, 8)

_REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core.compression import (
    make_compressor, mix_arrays_sharded_ef, mix_arrays_sharded_stale_ef,
    mix_dense_sharded_ef, mix_ppermute_pool_ef, mix_ppermute_pool_stale_ef)
from repro.core.dsgd import DSGDState, dsgd_step_sharded
from repro.core.mixing import (
    BirkhoffSchedule, PermPool, WireCorruption, mix_allreduce, mix_arrays_sharded,
    mix_arrays_sharded_stale, mix_dense_sharded, mix_ppermute, mix_ppermute_pool,
    mix_ppermute_pool_stale, shard_stale_init)

out = {}
for n in (4, 8):
    rng = np.random.default_rng(n)
    def state():
        return {"a": rng.normal(size=(n, 5, 3)).astype(np.float32),
                "b": rng.normal(size=(n, 7)).astype(np.float32),
                "h": np.asarray(jnp.asarray(rng.normal(size=(n, 4, 2)), jnp.bfloat16)
                                .astype(jnp.float32))}
    p0, p1 = state(), state()
    e0 = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32) for k, v in p0.items()}
    fixed = np.arange(n)
    fixed[[1, 2]] = fixed[[2, 1]]
    perms = [tuple(int(x) for x in rng.permutation(n)) for _ in range(2)]
    perms += [tuple(int(x) for x in fixed), tuple(range(n))]
    pool = PermPool(perms=tuple(perms))
    gammas = np.asarray([0.3, 0.25, 0.15, 0.3], np.float32)
    arrays = pool.arrays_for(gammas)
    W = np.asarray(pool.to_matrix(gammas), np.float32)
    sched = BirkhoffSchedule(coeffs=tuple(float(g) for g in gammas), perms=pool.perms)
    delays = (np.arange(n) % 2).astype(np.int32)
    mult = np.ones(n, np.float32); mult[1] = -1.0
    xor = np.zeros(n, np.int32); xor[2] = 1 << 20
    for name, tree in (("p0", p0), ("p1", p1), ("e0", e0)):
        for k, v in tree.items():
            out[f"{n}/{name}/{k}"] = v
    out.update({f"{n}/pool_perms": np.asarray(pool.perms, np.int32), f"{n}/gammas": gammas,
                f"{n}/W": W, f"{n}/delays": delays, f"{n}/mult": mult, f"{n}/xor": xor})

    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    cast = lambda t: {k: jnp.asarray(v, jnp.bfloat16 if k == "h" else jnp.float32)
                      for k, v in t.items()}
    jp0, jp1, je0 = cast(p0), cast(p1), {k: jnp.asarray(v) for k, v in e0.items()}
    corrupt = WireCorruption(mult=jnp.asarray(mult), xor=jnp.asarray(xor))
    g = jnp.asarray(gammas)
    d = jnp.asarray(delays)
    z = jnp.zeros_like(d)

    def per_node(q0, q1, e):
        st = lambda: shard_stale_init(q0, 2)
        r = {}
        r["dense"] = mix_dense_sharded(q1, jnp.asarray(W), "data")
        r["arrays"] = mix_arrays_sharded(q1, arrays, "data")
        r["pool"] = mix_ppermute_pool(q1, g, pool, "data")
        r["ppermute"] = mix_ppermute(q1, sched, "data")
        r["allreduce"] = mix_allreduce(q1, "data")
        r["dense_corrupt"] = mix_dense_sharded(q1, jnp.asarray(W), "data", corrupt=corrupt)
        r["arrays_corrupt"] = mix_arrays_sharded(q1, arrays, "data", corrupt=corrupt)
        r["pool_corrupt"] = mix_ppermute_pool(q1, g, pool, "data", corrupt=corrupt)
        r["arrays_stale"] = mix_arrays_sharded_stale(q1, st(), arrays, d, "data")[0]
        r["pool_stale"] = mix_ppermute_pool_stale(q1, st(), g, pool, d, "data")[0]
        r["arrays_stale_corrupt"] = mix_arrays_sharded_stale(q1, st(), arrays, d, "data",
                                                             corrupt=corrupt)[0]
        r["pool_stale_corrupt"] = mix_ppermute_pool_stale(q1, st(), g, pool, d, "data",
                                                          corrupt=corrupt)[0]
        for wire in ("bf16", "topk:0.5", "identity"):
            w, c = wire.split(":")[0], make_compressor(wire)
            r[f"ef_{w}_arrays"], r[f"ef_{w}_arrays_e"] = mix_arrays_sharded_ef(
                q1, e, arrays, "data", c)
            r[f"ef_{w}_dense"], r[f"ef_{w}_dense_e"] = mix_dense_sharded_ef(
                q1, e, jnp.asarray(W), "data", c)
            r[f"ef_{w}_pool"], r[f"ef_{w}_pool_e"] = mix_ppermute_pool_ef(
                q1, e, g, pool, "data", c)
            r[f"ef_{w}_arrays_stale"], r[f"ef_{w}_arrays_stale_e"], _ = \
                mix_arrays_sharded_stale_ef(q1, e, st(), arrays, d, "data", c)
            r[f"ef_{w}_pool_stale"], r[f"ef_{w}_pool_stale_e"], _ = \
                mix_ppermute_pool_stale_ef(q1, e, st(), g, pool, d, "data", c)
        c = make_compressor("bf16")
        r["ef_bf16_arrays_corrupt"] = mix_arrays_sharded_ef(q1, e, arrays, "data", c,
                                                           corrupt=corrupt)[0]
        r["ef_bf16_pool_corrupt"] = mix_ppermute_pool_ef(q1, e, g, pool, "data", c,
                                                         corrupt=corrupt)[0]
        s = DSGDState(step=0, momentum=None)
        r["dsgd_schedule"] = dsgd_step_sharded(q1, q0, s, sched, "data", 0.1)[0]
        r["dsgd_complete"] = dsgd_step_sharded(q1, q0, s, None, "data", 0.1)[0]
        return r

    spec = P("data")
    run = jax.jit(shard_map(per_node, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                            axis_names={"data"}, check_vma=False))
    res = run(jp0, jp1, je0)
    for name, tree in res.items():
        for k, v in tree.items():
            out[f"{n}/out/{name}/{k}"] = np.asarray(jnp.asarray(v, jnp.float32))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded") / "reference.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE), path],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(path) as f:
        return path, {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    path, _ = reference
    tmp = tmp_path_factory.mktemp("ranks")
    return {n: _torch_ranks.spawn_ranks(n, _torch_ranks.transports_job, tmp, path,
                                        str(tmp / f"table{n}.json"))
            for n in SIZES}


NAMES = (["dense", "arrays", "pool", "ppermute", "allreduce", "dense_corrupt",
          "arrays_corrupt", "pool_corrupt", "arrays_stale", "pool_stale",
          "arrays_stale_corrupt", "pool_stale_corrupt", "ef_bf16_arrays_corrupt",
          "ef_bf16_pool_corrupt", "dsgd_schedule", "dsgd_complete"]
         + [f"ef_{w}_{t}{e}" for w in ("bf16", "topk", "identity")
            for t in ("arrays", "dense", "pool", "arrays_stale", "pool_stale")
            for e in ("", "_e")])


def _close(port_rows: np.ndarray, want: np.ndarray, scale: np.ndarray | None,
           what: str) -> None:
    if scale is not None:  # one bfloat16 rounding of the terms
        excess = np.abs(port_rows - want) / (2.0 ** -7 * scale + 1e-6)
        assert excess.max() <= 1.0, f"{what}: bf16 leaf off by {excess.max()} roundings"
    else:
        np.testing.assert_allclose(port_rows, want, rtol=1e-6, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_transport_matches_reference_shard_map(reference, port, name, n):
    _, ref = reference
    rows = port[n]
    for leaf in ("a", "b", "h"):
        got = np.stack([r[name][leaf] for r in rows])
        scale = None
        if leaf == "h" and not name.endswith("_e"):
            states = np.abs(np.stack([ref[f"{n}/{s}/h"] for s in ("p0", "p1")]))
            scale = np.broadcast_to(states.max(axis=(0, 1)), got.shape)
        _close(got, ref[f"{n}/out/{name}/{leaf}"], scale, f"{name} n={n} leaf {leaf}")


def _bitwise(rows, a: str, b: str) -> bool:
    return all(np.array_equal(r[a][k], r[b][k]) for r in rows for k in r[a])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("a,b", [
    ("arrays", "pool"), ("arrays_stale0", "arrays"), ("pool_stale0", "pool"),
    ("ef_bf16_arrays", "ef_bf16_pool"), ("ef_topk_arrays", "ef_topk_pool"),
    ("ef_bf16_arrays_stale0", "ef_bf16_arrays"), ("ef_bf16_pool_stale0", "ef_bf16_pool"),
    ("ef_topk_arrays_stale0", "ef_topk_arrays"), ("ef_identity_arrays", "arrays"),
    ("ef_identity_dense", "dense"), ("ef_identity_pool", "pool"),
    ("ef_identity_arrays_stale", "arrays_stale"), ("ef_identity_pool_stale", "pool_stale"),
    ("ef_identity_arrays_e", "ef_identity_pool_e"),
    ("ring_bf16_arrays", "ring_f32_arrays"), ("ring_bf16_pool", "ring_f32_pool"),
    ("ring_bf16_ef_arrays", "ring_f32_ef_arrays"), ("ring_bf16_ef_pool", "ring_f32_ef_pool"),
])
def test_bitwise_claims(port, n, a, b):
    """allgather = pool on one schedule; zero delays = fresh; the identity
    wire = no compression (its EF memory untouched): bitwise."""
    assert _bitwise(port[n], a, b)


@pytest.mark.parametrize("n", SIZES)
def test_identity_wire_leaves_the_memory_and_the_ring_head_advances(reference, port, n):
    _, ref = reference
    for r, row in enumerate(port[n]):
        for k in ("a", "b", "h"):
            assert np.array_equal(row["ef_identity_arrays_e"][k], ref[f"{n}/e0/{k}"][r])
        assert row["stale_ring_head"]["head"].tolist() == [1]


@pytest.mark.parametrize("n", SIZES)
def test_bytes_counted_per_rank(reference, port, n):
    """An all-gather receives (n - 1) payloads a leaf, the pool one payload
    a slot that moves bytes to this rank (not its fixed points); a payload
    moves in its leaf's dtype (the bfloat16 leaf at 2 bytes an entry)."""
    _, ref = reference
    payload = sum(int(np.prod(ref[f"{n}/p0/{k}"].shape[1:])) * (2 if k == "h" else 4)
                  for k in ("a", "b", "h"))
    perms = ref[f"{n}/pool_perms"]
    for r, row in enumerate(port[n]):
        assert row["_bytes"]["all_gather"] == (n - 1) * payload
        moving = sum(1 for p in perms if p[r] != r)
        assert row["_bytes"]["ppermute"] == moving * payload
        assert row["_bytes"]["dsgd_step"] == 1
        assert not row["_jax_loaded"]  # rank processes import no jax


@pytest.mark.parametrize("n", SIZES)
def test_sharded_autotune_table(port, tmp_path_factory, n):
    """Every rank reads the same measured winner, and a lookup in the same
    bucket (p 60 rounds up to 64) hits the record the measurement wrote."""
    picks = {row["_autotune"] for row in port[n]}
    assert len(picks) == 1 and picks <= {"pool", "allgather"}
    assert {row["_lookup"] for row in port[n]} == picks


def test_stale_ring_dtype():
    """A bfloat16 ring only where every payload it holds is a bf16 value."""
    bf, f32 = torch.zeros(2, dtype=torch.bfloat16), torch.zeros(2)
    assert M.stale_ring_dtype({"a": bf}) == torch.bfloat16
    from repro_torch.core.compression import make_compressor

    assert M.stale_ring_dtype({"a": bf}, make_compressor("bf16")) == torch.bfloat16
    assert M.stale_ring_dtype({"a": bf}, make_compressor("identity")) == torch.bfloat16
    assert M.stale_ring_dtype({"a": bf}, make_compressor("topk:0.5")) == torch.float32
    assert M.stale_ring_dtype({"a": bf, "b": f32}) == torch.float32


def test_sharded_bucket_key_carries_the_layout():
    cpu = torch.device("cpu")
    key = M._sharded_bucket_key(4, 3, 1000, cpu, "gloo", "shared")
    assert key.startswith("sh_cpu") and "_gloo_ranks4_shared_" in key and key.endswith(
        "_n4_K4_P1024")
    assert M._sharded_bucket_key(4, 3, 1000, cpu, "nccl", "distinct") != key


@pytest.mark.parametrize("n", [2, 4, 8, 16, 100])
@pytest.mark.parametrize("k", [1, 2, 3, 7, 50])
@pytest.mark.parametrize("speedup", [1.0, 2.0, 3.5])
def test_preferred_sharded_transport_matches_reference(n, k, speedup):
    assert M.preferred_sharded_transport(n, k, speedup) == \
        J_mixing.preferred_sharded_transport(n, k, speedup)


def _pool(n: int, seed: int):
    rng = np.random.default_rng(seed)
    perms = tuple(tuple(int(x) for x in rng.permutation(n)) for _ in range(3)) + \
        (tuple(range(n)),)
    gammas = rng.dirichlet(np.ones(4)).astype(np.float32)
    return M.PermPool(perms=perms), J_mixing.PermPool(perms=perms), gammas


@pytest.mark.parametrize("seed", range(4))
def test_degrade_pool_gammas_matches_reference(seed):
    pool, jpool, gammas = _pool(8, seed)
    off = np.random.default_rng(seed + 10).random(8) < 0.3
    got = M.degrade_pool_gammas(pool, gammas, off)
    want = np.asarray(J_mixing.degrade_pool_gammas(jpool, gammas, off))
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["wait", "degrade"])
def test_straggler_pool_stream_matches_reference(mode):
    pool, jpool, gammas = _pool(6, 3)
    delays = np.random.default_rng(4).integers(0, 4, size=(5, 6))
    g, eff = M.straggler_pool_stream(M.StragglerPolicy(mode, 1), gammas, pool, delays)
    jg, jeff = J_mixing.straggler_pool_stream(J_mixing.StragglerPolicy(mode, 1), gammas,
                                              jpool, delays)
    assert np.array_equal(g.numpy(), np.asarray(jg))
    assert np.array_equal(eff.numpy(), np.asarray(jeff))
    with pytest.raises(ValueError):
        M.straggler_pool_stream(M.StragglerPolicy(mode, 1), gammas, pool, delays[:, :3])
