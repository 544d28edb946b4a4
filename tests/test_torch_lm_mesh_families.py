"""Tensor parallelism of every family (``train/tensor_parallel.py``) on a
``(1, 4)`` mesh, and the placements the smoke widths reach only in
variants: the port's mesh trainer (``make_train_setup(cfg, mesh=...)``,
``mode="dsgd"``, one node split over four ranks) against the reference's
(``tests/_torch_families.py``: the reference in one subprocess of 4 host
devices, the port on 4 gloo ranks). ``test_torch_lm_mesh_families_2x2.py``
runs the same families on ``(2, 2)``.

Arms (smoke configs, float32): recurrentgemma-2b (the RG-LRU blocks, MQA
keys gathered), xlstm-350m (mLSTM and sLSTM), whisper-small (encoder,
decoder self- and cross-attention, layer norms with bias) and
deepseek-v2-236b (MLA beside the expert-parallel MoE); recurrentgemma with
6 query heads (heads split inside a head: its 4 heads divide 4), and
whisper with vocab 16411 and d_model 1024 (past the rules' 2^24-element
fallback, which splits the tied table by features).

Tolerance (float32): losses within 1e-5 relative; gradients and
parameters within 1e-5 relative plus 1e-5 of the leaf's largest
magnitude. Also: no all-gather reads a parameter's storage; the plan's
placements; planted faults -- MLA's split latent normalised per rank, the
RG-LRU gates reading only the rank's block of the branch -- fail the
comparison.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_families as TF  # noqa: E402

ARMS = {k: v for k, v in TF.ALL_ARMS.items() if tuple(v["mesh"]) == (1, 4)}
FAULTS = {"deepseek_1x4": ["latent_per_rank"], "recurrentgemma_1x4": ["gates_cut_per_rank"]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lm_mesh_families") / "reference.npz")
    return out, TF.run_reference(out, ARMS)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    path, _ = reference
    return TF.run_port(path, ARMS, tmp_path_factory.mktemp("lm_mesh_families_port"), FAULTS)


@pytest.mark.parametrize("arm", list(ARMS))
def test_loss_gradients_and_steps_match_reference(reference, port, arm):
    TF.check_arm(reference[1], port, arm)


def test_the_plans_odd_placements(port):
    """The placements the smoke widths reach only in the variants: query
    heads split inside a head (6 on model 4: gathered, every touched head
    computed, keys gathered); the tied table split by features (vocab
    16411); the RG-LRU and mLSTM branches split; MLA's latent split and
    gathered; the collectives counted under their kinds."""
    r = port[0]
    attn = [lp["attn"] for lp in r["heads_inside_1x4"]["layers"] if "attn" in lp]
    assert attn and all(a["q"] and not a["aligned"] and a["kv"] == "gather" for a in attn)
    assert r["vocab_features_1x4"]["vocab"] == "features"
    assert tuple(r["vocab_features_1x4"]["specs"]["token_embed"]) == (None, "model")
    assert r["whisper_1x4"]["vocab"] == "rows" and r["deepseek_1x4"]["vocab"] == "rows"
    blocks = [lp["block"] for lp in r["recurrentgemma_1x4"]["layers"] + r["xlstm_1x4"]["layers"]
              if "block" in lp]
    assert blocks and all(b.get("split", True) for b in blocks)
    assert all(a["q"] and a["dkv"] for a in (lp["attn"] for lp in r["deepseek_1x4"]["layers"]))
    assert r["recurrentgemma_1x4"]["calls"]["tp_all_gather"] > 0
    assert r["xlstm_1x4"]["calls"]["tp_all_reduce"] > 0


@pytest.mark.parametrize("arm,fault", [(a, f) for a, fs in FAULTS.items() for f in fs])
def test_planted_faults_fail(reference, port, arm, fault):
    """A split latent normalised per rank (MLA), or the gates reading only
    the rank's block of the branch (RG-LRU): the loss or the gradients
    leave the tolerance."""
    _, ref = reference
    key = f"fault/{fault}"
    loss_off = any(not np.isclose(r[arm][key]["loss"], ref[f"{arm}/grad_losses"][r[arm]["node"]],
                                  rtol=TF.RTOL, atol=0) for r in port)
    rows = [{**r, arm: {**r[arm], "faulty": r[arm][key]["grads"]}} for r in port]
    assert loss_off or TF.mismatch(rows, arm, "grads", ref, got_key="faulty")
