"""The port's LM trainer on a ``(data, model)`` mesh of ranks
(``make_train_setup(cfg, mesh=...)``, ``mode="dsgd"``: a node's replica
split over ``model``, tensor-parallel) against the reference's mesh
trainer on the same ``(2, 2)`` mesh (``tests/_torch_mesh.py``: the
reference in one subprocess of 4 host devices, the port on 4 gloo ranks).

Arms (qwen3-0.6b's smoke config, float32, 2 nodes x 2 sequences x 16
tokens a step, lr 2e-2): a static schedule (``mix_ppermute`` over
``data``), the complete graph (``pmean``), ``online_w`` on a dense W
(all-gather), EF (bf16) plus bounded delay (wait, tau_max 1) on the
staged pool, probes (``consensus``, ``grad_dev``) on a ``ScheduleArrays``,
``run_segments`` on the pool transport (an in-pool swap after step 1, a
restage after step 3; with probes: the health series) and, under the
degrade policy with raw delays and a quarantine (node 1 isolated: the
meter's quarantined bytes), on the all-gather transport fed pool gammas
(their ``ScheduleArrays`` twin). Port-only: the tensor-parallel pass gathers no
parameter (no all-gather at all in the dense model); a replicated leaf
summed over ``model`` as if split fails the probe comparison (a planted
fault); a checkpoint resume on the mesh is bitwise the uninterrupted run,
the checkpoint holding whole leaves stacked over nodes.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_mesh as TM  # noqa: E402
import _torch_ranks  # noqa: E402

ARMS = {
    "schedule": dict(mesh=(2, 2), schedule=True),
    "complete": dict(mesh=(2, 2)),
    "online_dense": dict(mesh=(2, 2), online_w="dense"),
    "pool_ef_stale": dict(mesh=(2, 2), online_w="pool", sharded_transport="pool",
                          compression="bf16", staleness=("wait", 1)),
    "probes": dict(mesh=(2, 2), online_w="arrays", probes=True),
    "seg_pool": dict(mesh=(2, 2), online_w="pool", sharded_transport="pool", probes=True,
                     run="segments"),
    "seg_arrays_degrade": dict(mesh=(2, 2), online_w="pool", sharded_transport="allgather",
                               staleness=("degrade", 1), quarantine=True, run="segments"),
}
OWN = {"no_param_gather": ["schedule"], "planted_probe_fault": True, "resume": "seg_pool"}
STEP_ARMS = [a for a, kw in ARMS.items() if kw.get("run") is None]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return TM.run_reference(str(tmp_path_factory.mktemp("lm_mesh") / "reference.npz"), ARMS)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh_port")
    path = str(tmp / "reference.npz")
    np.savez(path, **reference)
    return _torch_ranks.spawn_ranks(4, _torch_ranks.lm_mesh_job, tmp, path, ARMS, TM.LR,
                                    str(tmp / "ckpt"), OWN)


@pytest.mark.parametrize("arm", STEP_ARMS)
def test_three_steps_match_reference_mesh(reference, port, arm):
    TM.assert_series(port, arm, reference)
    if ARMS[arm].get("compression") == "bf16":
        for key in ("final", "ef", "ring"):
            TM.assert_wire_blocks(port, arm, key, reference)
        assert all(r[arm]["head"] == int(reference[f"{arm}/head"]) for r in port)
    else:
        TM.assert_blocks(port, arm, "final", reference, stacked=True)
        assert "ef" not in port[0][arm] and "ring" not in port[0][arm]
    out = port[0][arm]
    assert (-1 if out["comm_bytes"] is None else out["comm_bytes"]) == \
        int(reference[f"{arm}/comm_bytes"])
    assert str(out["transport"]) == str(reference[f"{arm}/transport"])


def test_every_rank_holds_a_block_of_its_node(port):
    """A node's two ranks hold different halves of each split leaf."""
    specs = port[0]["schedule"]["specs"]
    assert specs["layers.0.attn.wq"] == (None, "model")
    assert specs["layers.0.ln1.scale"] == (None,)
    for r in port:
        assert r["schedule"]["coords"] == {"data": r["_rank"] // 2, "model": r["_rank"] % 2}
    a, b = port[0]["schedule"]["final"], port[1]["schedule"]["final"]
    assert a["layers.0.attn.wq"].shape == (128, 64)
    assert not np.array_equal(a["layers.0.attn.wq"], b["layers.0.attn.wq"])
    np.testing.assert_array_equal(a["layers.0.ln1.scale"], b["layers.0.ln1.scale"])


@pytest.mark.parametrize("arm", ["seg_pool", "seg_arrays_degrade"])
def test_run_segments_swap_and_restage_match_reference(reference, port, arm):
    for r in port:
        out = r[arm]
        np.testing.assert_allclose(out["losses"], reference[f"{arm}/losses"], rtol=TM.RTOL)
        assert out["recompiles"] == int(reference[f"{arm}/recompiles"])
        assert out["swaps"] == reference[f"{arm}/swaps"].tolist() == [1, 3]
        for key in ("total_bytes", "deferred_bytes", "quarantined_bytes"):
            assert out["comm"][key] == pytest.approx(float(reference[f"{arm}/{key}"])), key
        for name, series in out["health"].items():
            np.testing.assert_allclose(series, reference[f"{arm}/health/{name}"], rtol=TM.RTOL,
                                       err_msg=f"{arm} {name} rank {r['_rank']}")
        assert set(out["health"]) == {k.split("/")[-1] for k in reference
                                      if k.startswith(f"{arm}/health/")}
    TM.assert_blocks(port, arm, "final", reference, stacked=True)
    if arm == "seg_pool":
        assert port[0][arm]["recompiles"] == 1  # the restage on the pool transport
        assert set(port[0][arm]["health"]) == {"consensus", "grad_dev"}
    else:
        assert port[0][arm]["recompiles"] == 0  # a restage is a value change here
        assert port[0][arm]["quarantine"] == {"isolated": [1]}
        assert port[0][arm]["comm"]["quarantined_bytes"] > 0
        assert port[0][arm]["comm"]["deferred_bytes"] > 0


def test_tensor_parallel_pass_gathers_no_parameter(port):
    for r in port:
        got = r["_own"]["no_param_gather"]["schedule"]
        assert not any(is_param for _, is_param, _ in got["gathers"]), got["gathers"]
        # the dense model's pass all-reduces partial sums only
        assert got["gathers"] == []
        assert got["calls"]["tp_all_gather"] == 0 and got["calls"]["fsdp_all_gather"] == 0
        assert got["calls"]["tp_all_reduce"] > 0


def test_replicated_leaf_counted_per_rank_fails_the_probe_check(reference, port):
    """Summing a replicated leaf (a norm scale) over ``model`` as if it were
    split counts it twice: the probe series leave the reference's, while
    the loss does not move."""
    for r in port:
        bad = r["_own"]["planted_probe_fault"]
        np.testing.assert_allclose([s["loss"] for s in bad], reference["probes/series/loss"],
                                   rtol=TM.RTOL)
        for name in ("consensus", "grad_dev"):
            got = np.asarray([s[name] for s in bad])
            want = reference[f"probes/series/{name}"]
            assert not np.allclose(got, want, rtol=TM.RTOL), name


def test_checkpoint_resume_on_the_mesh_is_bitwise(port):
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("qwen3-0.6b")
    for r in port:
        res = r["_own"]["resume"]
        assert res["stopped_at"] == 4 and res["resumed_from"] == 4
        assert res["losses"] and res["params"]
        # whole leaves, stacked over the nodes; a rank holds its vocabulary half
        assert res["ckpt_shape"] == [2, cfg.vocab_size, cfg.d_model]
        assert res["local_shape"] == [cfg.vocab_size // 2, cfg.d_model]


def test_rank_processes_load_no_jax(port):
    assert all(not r["_jax_loaded"] for r in port)


def test_shards_of_the_reference_tree():
    """``lm_shard_from_numpy`` gives each rank of a (2, 2) mesh its block of
    its node's row: the parameters and EF memory (``lead=0``) and the stale
    ring's ``(n, depth, ...)`` leaves (``lead=1``), bitwise the block of
    ``lm_node_from_numpy``'s row."""
    import types

    import jax

    from repro.configs import get_smoke_config as J_get_smoke
    from repro.models import registry as J_registry
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.train import sharding

    jcfg, cfg = J_get_smoke("qwen3-0.6b"), get_smoke_config("qwen3-0.6b")
    single = jax.tree_util.tree_map(np.asarray, J_registry.init_model(jax.random.PRNGKey(0),
                                                                      jcfg))
    tree = jax.tree_util.tree_map(lambda x: np.stack([x, 2 * x]), single)
    ring = jax.tree_util.tree_map(lambda x: np.stack([x, 3 * x], axis=1), tree)
    shapes = {k: tuple(p.shape) for k, p in transformer.LM(cfg, "meta").named_parameters()}
    sizes = {"data": 2, "model": 2}
    specs = sharding.make_param_specs(shapes, sizes, cfg=cfg)
    split = 0
    for d in range(2):
        rows = convert.lm_node_from_numpy(tree, cfg, d, device="cpu")
        ring_rows = convert.lm_node_from_numpy(ring, cfg, d, lead=1, device="cpu")
        for m in range(2):
            mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2),
                                         get_coordinate=lambda d=d, m=m: [d, m])
            coords = {"data": d, "model": m}
            got = convert.lm_shard_from_numpy(tree, cfg, mesh, specs, node=d, device="cpu")
            got_ring = convert.lm_shard_from_numpy(ring, cfg, mesh, specs, node=d, lead=1,
                                                   device="cpu")
            for k in shapes:
                assert torch.equal(got[k], sharding.shard(rows[k], specs[k], sizes, coords))
                assert torch.equal(got_ring[k], sharding.shard(ring_rows[k], specs[k], sizes,
                                                               coords, offset=1))
                assert torch.equal(got_ring[k][1], 3 * got[k])
                split += got[k].shape != rows[k].shape
    assert split > 0
