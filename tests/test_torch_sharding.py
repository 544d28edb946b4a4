"""The port's partition rules (``repro_torch.train.sharding``) against the
reference's (``repro/train/sharding.py``).

For every leaf of all ten full configs, the port's ``make_param_specs``
(keyed by ``LM.named_parameters()`` / ``Whisper``'s names, no layer group
axis) must equal the reference's spec of the counterpart leaf with the
group axis's None taken out, on fake meshes of the production shapes
(16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod", "data",
"model")``, in every combination of ``node_axis`` and ``fsdp_axis`` the
modes use. No ranks: the meshes are their sizes; ``placements`` runs on
a 1-rank gloo group.
"""

import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as J_get_config  # noqa: E402
from repro.models import registry as J_registry  # noqa: E402
from repro.train import sharding as J_sharding  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import transformer, whisper  # noqa: E402
from repro_torch.train import sharding  # noqa: E402

MESHES = {
    "2d": ({"data": 16, "model": 16}, [(None, None), ("data", None), (None, "data")]),
    "3d": ({"pod": 2, "data": 16, "model": 16},
           [(None, None), ("pod", None), (None, "data"), ("pod", "data")]),
}


def _port_shapes(cfg) -> dict:
    meta = whisper.Whisper(cfg, "meta") if cfg.arch_type == "audio" else \
        transformer.LM(cfg, "meta")
    return {name: tuple(p.shape) for name, p in meta.named_parameters()}


@pytest.fixture(scope="module")
def reference_leaves():
    out = {}
    for name in J_ARCH_IDS:
        cfg = J_get_config(name)
        tree = jax.eval_shape(lambda r, c=cfg: J_registry.init_model(r, c), jax.random.PRNGKey(0))
        out[name] = tree
    return out


def _entry(e):
    return tuple(e) if isinstance(e, (tuple, list)) else e


@pytest.mark.parametrize("arch", list(ARCH_IDS))
@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_param_specs_equal_the_reference_leaf_for_leaf(reference_leaves, arch, mesh_kind):
    sizes, combos = MESHES[mesh_kind]
    fake = types.SimpleNamespace(shape=sizes)
    cfg = get_config(arch)
    shapes = _port_shapes(cfg)
    ref_tree = reference_leaves[arch]
    ref_paths = {jax.tree_util.keystr(p): leaf for p, leaf in
                 jax.tree_util.tree_leaves_with_path(ref_tree)}
    assert {sharding.reference_path(n, cfg)[0] for n in shapes} == set(ref_paths)
    for node_axis, fsdp_axis in combos:
        tree = ref_tree
        if node_axis is not None:
            n = sizes[node_axis]
            tree = jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct((n,) + tuple(x.shape), x.dtype), ref_tree)
        want = {jax.tree_util.keystr(p): s for p, s in jax.tree_util.tree_leaves_with_path(
            J_sharding.make_param_specs(tree, fake, node_axis=node_axis, fsdp_axis=fsdp_axis),
            is_leaf=lambda x: isinstance(x, P))}
        got = sharding.make_param_specs(shapes, sizes, cfg=cfg, node_axis=node_axis,
                                        fsdp_axis=fsdp_axis)
        for name, spec in got.items():
            path, groups = sharding.reference_path(name, cfg)
            ref_spec = [_entry(e) for e in want[path]]
            if groups > 1 or "['stages']" in path:
                del ref_spec[1 if node_axis is not None else 0]  # the group axis
            ref_shape = tuple(ref_paths[path].shape)
            assert ref_shape[1:] == shapes[name] if "['stages']" in path else \
                ref_shape == shapes[name], name
            assert tuple(ref_spec) == spec, (arch, mesh_kind, node_axis, fsdp_axis, name)


def test_every_mode_combination_splits_something():
    """The rules are not vacuous: qwen3-0.6b's attention and MLP split over
    model, and the fsdp axis splits their other dimension."""
    cfg = get_config("qwen3-0.6b")
    shapes = _port_shapes(cfg)
    sizes = {"data": 16, "model": 16}
    tp = sharding.make_param_specs(shapes, sizes, cfg=cfg)
    fs = sharding.make_param_specs(shapes, sizes, cfg=cfg, fsdp_axis="data")
    assert tp["layers.0.attn.wq"] == (None, "model")
    assert tp["layers.0.attn.wo"] == ("model", None)
    assert tp["embed.table"] == ("model", None)
    assert tp["layers.0.ln1.scale"] == (None,)
    assert fs["layers.0.mlp.w_up"] == ("data", "model")
    assert fs["layers.0.mlp.w_down"] == ("model", "data")


@pytest.mark.parametrize("shape,spec,want", [
    ((6, 8), ("data", "model"), (None, "model")),
    ((8, 6), ("data", "model"), ("data", None)),
    ((8, 12), (("data", "model"), None), (None, None)),
    ((16, 3), (("data", "model"), None), (("data", "model"), None)),
    ((4, 4, 4), ("model",), ("model", None, None)),
])
def test_sanitize_spec_drops_non_dividing_axes(shape, spec, want):
    sizes = {"data": 4, "model": 4}
    assert sharding.sanitize_spec(spec, shape, sizes) == want
    ref = J_sharding.sanitize_spec(P(*spec), shape, types.SimpleNamespace(shape=sizes))
    assert tuple(_entry(e) for e in ref) == want


def test_large_leaf_fallback_matches_the_reference():
    """An odd vocabulary sanitizes the vocabulary rule away; above 32 MB the
    table is still split over model on its last dividing dimension, below
    it stays whole (whisper-small's table, and a small vocabulary)."""
    cfg = get_config("whisper-small")
    sizes = {"data": 16, "model": 16}
    fake = types.SimpleNamespace(shape=sizes)
    for vocab in (cfg.vocab_size, 1001):
        shapes = {"token_embed": (vocab, cfg.d_model)}
        got = sharding.make_param_specs(shapes, sizes, cfg=cfg)["token_embed"]
        ref = J_sharding.make_param_specs(
            {"token_embed": jax.ShapeDtypeStruct((vocab, cfg.d_model), np.float32)}, fake)
        assert got == tuple(_entry(e) for e in ref["token_embed"])
        assert got == ((None, "model") if vocab * cfg.d_model * 2 > 32 * 2**20 else (None, None))


def test_shard_cuts_row_major_blocks():
    full = torch.arange(4 * 6).reshape(4, 6)
    sizes = {"data": 2, "model": 3}
    for d, m in itertools.product(range(2), range(3)):
        got = sharding.shard(full, ("data", "model"), sizes, {"data": d, "model": m})
        assert torch.equal(got, full[2 * d:2 * d + 2, 2 * m:2 * m + 2])
        got = sharding.shard(full, (None, ("data", "model")), sizes, {"data": d, "model": m})
        assert torch.equal(got, full[:, d * 3 + m:d * 3 + m + 1])
    ring = torch.arange(2 * 4 * 6).reshape(2, 4, 6)
    got = sharding.shard(ring, ("data", None), sizes, {"data": 1, "model": 0}, offset=1)
    assert torch.equal(got, ring[:, 2:])


def test_placements_on_a_one_rank_gloo_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh((1, 1), ("data", "model"))
        assert mesh.mesh_dim_names == ("data", "model")
        assert sharding.mesh_sizes(mesh) == {"data": 1, "model": 1}
        assert sharding.mesh_coords(mesh) == {"data": 0, "model": 0}
        assert sharding.placements(("data", "model"), mesh) == (Shard(0), Shard(1))
        assert sharding.placements(("model", None), mesh) == (Replicate(), Shard(0))
        assert sharding.placements((None,), mesh) == (Replicate(), Replicate())
        cfg = get_config("qwen3-0.6b")
        specs = sharding.make_param_specs({"layers.0.attn.wq": (1024, 2048)}, mesh, cfg=cfg,
                                          fsdp_axis="data")
        assert sharding.make_param_shardings(specs, mesh) == {
            "layers.0.attn.wq": (Shard(0), Shard(1))}
        with pytest.raises(ValueError, match="needs 4 ranks"):
            sharding.make_mesh((2, 2), ("data", "model"))
        mesh3 = sharding.make_mesh((1, 1, 1), ("pod", "data", "model"))
        assert sharding.placements(("pod", "data", None), mesh3) == (
            Shard(0), Shard(1), Replicate())
    finally:
        dist.destroy_process_group()
