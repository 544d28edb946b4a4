"""Tensor parallelism of every family on a ``(2, 2)`` mesh: two nodes, each
split over two ranks (``tests/_torch_families.py``: the reference's mesh
trainer in one subprocess of 4 host devices, the port on 4 gloo ranks).
The same families as ``test_torch_lm_mesh_families.py``'s ``(1, 4)``
arms: recurrentgemma-2b, xlstm-350m (sLSTM's ``r`` split over its 2
heads), whisper-small and deepseek-v2-236b, smoke configs, float32; the
complete graph mixes the two nodes over ``data``. Tolerances are the
helper module's."""

import os
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_families as TF  # noqa: E402

ARMS = {k: v for k, v in TF.ALL_ARMS.items() if tuple(v["mesh"]) == (2, 2)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lm_mesh_families_2x2") / "reference.npz")
    return out, TF.run_reference(out, ARMS)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    path, _ = reference
    return TF.run_port(path, ARMS, tmp_path_factory.mktemp("lm_mesh_families_2x2_port"))


@pytest.mark.parametrize("arm", list(ARMS))
def test_loss_gradients_and_steps_match_reference(reference, port, arm):
    TF.check_arm(reference[1], port, arm)


def test_split_heads_and_blocks(port):
    """On a model of 2 every family splits whole heads; the sLSTM's ``r``
    is split over its heads, the recurrent branches by features."""
    r = port[0]
    for arm in ARMS:
        assert all(lp["attn"].get("aligned", True) for lp in r[arm]["layers"] if "attn" in lp)
    assert any(lp.get("block", {}).get("heads") for lp in r["xlstm_2x2"]["layers"])
    assert all(lp["block"]["split"] for lp in r["recurrentgemma_2x2"]["layers"]
               if "block" in lp)
