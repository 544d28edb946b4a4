"""The port's mesh modes against the reference's mesh trainer
(``tests/_torch_mesh.py``: the reference in one subprocess of 4 host
devices, the port on 4 gloo ranks): ``fsdp`` on ``(data 2, model 2)``
(one model split over every rank at rest, the 4 sequences one a rank, the
gradient's mean over the ranks), ``dsgd_pod`` on ``(pod 2, data 2, model
1)`` (a pod's 2 sequences one a ``data`` rank) and on ``(pod 2, data 1,
model 2)`` (a pod's replica split over ``model``) with a static schedule,
and ``dsgd_pod`` with ``online_w`` through ``run_segments`` (a dense W
swapped after step 1); and qwen3-moe's smoke config (the expert-parallel
rule: routed experts and the router split by experts over ``model``) in
``dsgd`` on ``(2, 2)``, ``fsdp``, and ``dsgd_pod`` on ``(2, 1, 2)`` and
``(2, 2, 1)`` (where a node's batch is split over ranks the aux loss takes
whole-batch statistics, as the reference's).
Float32, 1e-5 relative on losses, parameters within 1e-5 relative plus
1e-5 of the leaf's largest magnitude. Port-only: an fsdp rank holds a
quarter of the model at rest; the MoE pass gathers no parameter (the
router's logits, one all-gather a layer); the reference's refusals of
``fsdp`` / ``dsgd_pod`` options, in its words.
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

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.train.lm_trainer import make_train_setup  # noqa: E402

MOE = "qwen3-moe-30b-a3b"
ARMS = {
    "fsdp": dict(mesh=(2, 2), mode="fsdp"),
    "pod_221": dict(mesh=(2, 2, 1), mode="dsgd_pod"),
    "pod_212": dict(mesh=(2, 1, 2), mode="dsgd_pod", schedule=True),
    "pod_seg_dense": dict(mesh=(2, 1, 2), mode="dsgd_pod", online_w="dense", run="segments"),
    "moe_schedule": dict(cfg=MOE, mesh=(2, 2), schedule=True),
    "moe_fsdp": dict(cfg=MOE, mesh=(2, 2), mode="fsdp"),
    "moe_pod_212": dict(cfg=MOE, mesh=(2, 1, 2), mode="dsgd_pod"),
    "moe_pod_221": dict(cfg=MOE, mesh=(2, 2, 1), mode="dsgd_pod"),
}
OWN = {"no_param_gather": ["moe_schedule"], "refusals": "pod_221",
       "dtensor_blocks": ["fsdp", "pod_221", "pod_212", "moe_schedule"]}
STEP_ARMS = [a for a, kw in ARMS.items() if kw.get("run") is None]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return TM.run_reference(str(tmp_path_factory.mktemp("lm_mesh_modes") / "reference.npz"),
                            ARMS)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh_modes_port")
    path = str(tmp / "reference.npz")
    np.savez(path, **reference)
    return _torch_ranks.spawn_ranks(4, _torch_ranks.lm_mesh_job, tmp, path, ARMS, TM.LR,
                                    str(tmp / "ckpt"), OWN)


@pytest.mark.parametrize("arm", STEP_ARMS)
def test_three_steps_match_reference_mesh(reference, port, arm):
    TM.assert_series(port, arm, reference)
    TM.assert_blocks(port, arm, "final", reference, stacked=ARMS[arm].get("mode") != "fsdp")
    out = port[0][arm]
    assert (-1 if out["comm_bytes"] is None else out["comm_bytes"]) == \
        int(reference[f"{arm}/comm_bytes"])


def test_dsgd_pod_run_segments_swaps_w_as_the_reference(reference, port):
    arm = "pod_seg_dense"
    for r in port:
        out = r[arm]
        np.testing.assert_allclose(out["losses"], reference[f"{arm}/losses"], rtol=TM.RTOL)
        assert out["swaps"] == reference[f"{arm}/swaps"].tolist() == [1]
        assert out["recompiles"] == 0
    TM.assert_blocks(port, arm, "final", reference, stacked=True)


def test_fsdp_rank_holds_a_quarter_of_the_model_at_rest(port):
    from repro_torch.models import transformer

    for arm, name in (("fsdp", "qwen3-0.6b"), ("moe_fsdp", MOE)):
        meta = transformer.LM(get_smoke_config(name), "meta")
        total = sum(p.numel() for p in meta.parameters())
        for r in port:
            held = sum(v.size for v in r[arm]["final"].values())
            # the norm scales stay whole on every rank
            assert held <= 1.1 * total / 4, (arm, held, total)
        specs = port[0][arm]["specs"]
        assert specs["layers.0.attn.wq"] == ("data", "model")


def test_pod_layouts_split_as_the_reference(port):
    assert port[0]["pod_221"]["specs"]["layers.0.mlp.w_down"] == ("model", "data")
    for r in port:
        assert r["pod_221"]["node"] == r["_rank"] // 2
        assert r["pod_212"]["coords"] == {"pod": r["_rank"] // 2, "data": 0,
                                          "model": r["_rank"] % 2}


def test_moe_pass_gathers_router_logits_and_no_parameter(port):
    cfg = get_smoke_config(MOE)
    for r in port:
        got = r["_own"]["no_param_gather"]["moe_schedule"]
        assert not any(is_param for _, is_param, _ in got["gathers"]), got["gathers"]
        # one all-gather of each MoE layer's router logits (B, S, E / 2) a rank
        assert [shape for _, _, shape in got["gathers"]] == \
            [(2 * 16 * cfg.moe.num_experts // 2,)] * cfg.num_layers
        assert got["calls"]["tp_all_gather"] == cfg.num_layers


def test_dsgd_pod_refuses_a_schedule_arrays_operand(port):
    for r in port:
        assert "dense (n, n) W" in r["_own"]["refusals"]["pod_arrays"]
        assert "gloo" in r["_own"]["refusals"]["scan"]


@pytest.mark.parametrize("mode,kw,match", [
    ("fsdp", dict(online_w=True), "online_w needs a node axis"),
    ("fsdp", dict(compression="bf16", online_w=True), "incompatible with mode='fsdp'"),
    ("fsdp", dict(probes="consensus"), "health probes are incompatible with mode='fsdp'"),
    ("fsdp", dict(staleness="wait"), "staleness is incompatible with mode='fsdp'"),
    ("fsdp", dict(pool=object()), "a PermPool requires"),
    ("dsgd_pod", dict(compression="bf16", online_w=True), "incompatible with mode='dsgd_pod'"),
    ("dsgd_pod", dict(probes="consensus", online_w=True),
     "health probes are incompatible with mode='dsgd_pod'"),
    ("dsgd_pod", dict(staleness="wait", online_w=True),
     "staleness is incompatible with mode='dsgd_pod'"),
    ("dsgd_pod", dict(pool=object(), online_w=True), "a PermPool requires"),
], ids=["fsdp-online_w", "fsdp-compression", "fsdp-probes", "fsdp-staleness", "fsdp-pool",
        "pod-compression", "pod-probes", "pod-staleness", "pod-pool"])
def test_mesh_modes_refuse_what_the_reference_refuses(mode, kw, match):
    """Refused before the mesh is read (no ranks needed)."""
    from repro_torch.core.mixing import StragglerPolicy
    from repro_torch.obs import HealthProbes

    kw = dict(kw)
    if kw.get("probes"):
        kw["probes"] = HealthProbes(consensus=True)
    if kw.get("staleness"):
        kw["staleness"] = StragglerPolicy("wait", 1)
    with pytest.raises(ValueError, match=match):
        make_train_setup(get_smoke_config("qwen3-0.6b"), mesh=object(), mode=mode,
                         device="cpu", **kw)


def test_mesh_argument_checks():
    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(ValueError, match="'pod' mesh axis"):
        make_train_setup(cfg, mode="dsgd_pod", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        make_train_setup(cfg, mesh=object(), group=object(), device="cpu")
    with pytest.raises(ValueError, match="fsdp over ranks takes mesh="):
        make_train_setup(cfg, mode="fsdp", group=object(), device="cpu")


def test_blocks_are_dtensor_local_shards(port):
    """A rank's block of each leaf (``sharding.shard`` at its coordinates)
    is what DTensor gives it under ``placements(spec)``: fsdp's two split
    dimensions, dsgd_pod's (2, 2, 1) and (2, 1, 2) meshes, the experts."""
    for r in port:
        assert r["_own"]["dtensor_blocks"] == dict.fromkeys(
            ["fsdp", "pod_221", "pod_212", "moe_schedule"], True)


def test_rank_processes_load_no_jax(port):
    assert all(not r["_jax_loaded"] for r in port)
