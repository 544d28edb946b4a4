"""Partition rules: the reference's ``repro/train/sharding.py`` for the
port's parameter names, and the device mesh of ranks that are already
joined.

A spec is a tuple with one entry per tensor dimension: a mesh dimension's
name (``"data"``, ``"model"``, ``"pod"``), a tuple of names (one tensor
dimension split over several mesh dimensions, the outer first), or None
(not split). It is the reference's ``PartitionSpec``.

The rules are the reference's, table for table (``_COL_PARALLEL``,
``_ROW_PARALLEL``, ``_EXPERT``, ``_VOCAB_PARALLEL``, the sLSTM ``r`` and
the RG-LRU ``lam`` rules): tensor parallelism over ``model``
(Megatron-style column / row / expert / vocabulary splits), with
``fsdp_axis`` splitting the complementary matrix dimension of the weights
at rest. The rules match the reference's path strings
(``"['stages'][0]['attn']['wq']"``), which ``reference_path`` builds from
a port name (``layers.3.attn.wq``) through ``convert``'s name map, so
every substring test reads what it reads there. The reference stacks the
layers of each pattern position on a group axis (``"stages"``); the port
has no such axis, so a port leaf's spec is the reference's without that
axis's None, and the >32 MB fallback weighs the stacked leaf the
reference weighs (the leaf times its group count, times the node count
with ``node_axis``).

``sanitize_spec`` drops a mesh dimension whose size does not divide the
tensor dimension, so the rules fit every architecture. ``placements``
turns a spec into DTensor ``Shard`` / ``Replicate`` placements on a
``DeviceMesh`` whose dimensions carry the reference's axis names;
``make_mesh`` builds that mesh over the ranks of the default group
(``launch/mesh.py``'s ``make_host_mesh``; the reference's TPU hardware
table has no counterpart here). ``shard`` and ``shard_coords`` cut a
rank's block out of a full tensor.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch

__all__ = [
    "Spec",
    "reference_path",
    "sanitize_spec",
    "tp_spec_for_path",
    "make_param_specs",
    "make_param_shardings",
    "placements",
    "make_mesh",
    "mesh_sizes",
    "mesh_coords",
    "shard",
    "sharded_dims",
]

Spec = tuple

# keyword -> axis to shard over model; indices refer to the unstacked
# parameter (no node axis), as in the reference
_COL_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up", "w_uk", "w_uv",
                 "w_in", "w_rnn_in", "w_a", "w_x", "w_ff_up", "w_dkv",
                 "router")
_ROW_PARALLEL = ("wo", "w_down", "w_out", "w_ff_down")
_EXPERT = ("routed",)
_VOCAB_PARALLEL = ("table", "token_embed", "unembed")

# a leaf the rules leave whole is still split over model above this size
# (bytes of bfloat16, as the reference weighs it)
_FALLBACK_BYTES = 32 * 2**20


def mesh_sizes(mesh) -> dict[str, int]:
    """``{dimension name: size}`` of a ``DeviceMesh``, or of a mapping /
    an object with a ``shape`` mapping (a fake mesh of the given sizes)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(mesh.shape)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_spec(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """Drop mesh dimensions whose size does not divide the tensor
    dimension; pad the spec with None to the tensor's rank."""
    sizes = mesh_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        size = math.prod(sizes[a] for a in _axes(entry))
        out.append(entry if shape[i] % size == 0 else None)
    while len(out) < len(shape):
        out.append(None)
    return tuple(out)


def tp_spec_for_path(path: str, shape: tuple[int, ...], *, fsdp_axis: str | None = None) -> Spec:
    """The tensor-parallel spec of an unstacked parameter at the
    reference's ``path``; ``fsdp_axis`` also splits the complementary
    matrix dimension (weights at rest)."""
    rank = len(shape)
    d = fsdp_axis

    def spec(*entries):
        ent = list(entries) + [None] * (rank - len(entries))
        return tuple(ent[:rank])

    if any(k in path for k in _EXPERT):
        return spec("model", d, None)  # stacked experts (E, d, f): expert-parallel
    if any(path.endswith(k) or f"'{k}'" in path for k in _VOCAB_PARALLEL):
        if "unembed" in path:
            return spec(d, "model")  # (d, V)
        return spec("model", d)  # (V, d)
    if any(f"'{k}'" in path for k in _COL_PARALLEL):
        return spec(d, "model")  # (d, X): output features
    if any(f"'{k}'" in path for k in _ROW_PARALLEL):
        return spec("model", d)  # (X, d): input features
    if "'r'" in path and rank == 4:  # sLSTM recurrent (4, h, dh, dh)
        return spec(None, "model", None, None)
    if "'lam'" in path and rank == 1:
        return spec("model")
    return (None,) * rank


def reference_path(name: str, cfg) -> tuple[str, int]:
    """The reference's path string of the port parameter ``name`` and the
    number of layers its stacked leaf holds (1 where it is not stacked):
    ``layers.<i>.<rest>`` is ``['stages'][j]<rest>`` (group ``i // len(pattern)``)
    for the whole groups of the layer pattern, ``['tail'][t]<rest>`` after
    them; whisper's names map one to one."""
    parts = name.split(".")
    groups = 1
    if cfg.arch_type != "audio" and parts[0] == "layers":
        from repro_torch.convert import _layer_slots

        reps, plen = _layer_slots(cfg)
        i = int(parts[1])
        if i < reps * plen:
            parts[:2] = ["stages", str(i % plen)]
            groups = reps
        else:
            parts[:2] = ["tail", str(i - reps * plen)]
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in parts), groups


def make_param_specs(params: Mapping[str, Any], mesh, *, cfg, node_axis: str | None = None,
                     fsdp_axis: str | None = None) -> dict[str, Spec]:
    """The spec of every parameter (a mapping name -> tensor or shape, as
    ``LM.named_parameters()`` names them, without a node axis), as the
    reference's ``make_param_specs`` gives it for the counterpart leaf,
    less the group axis. ``node_axis``: the mesh dimension of the D-SGD
    node axis the reference's ``dsgd`` modes stack in front; the spec then
    starts with it. ``fsdp_axis``: the dimension of weights-at-rest
    sharding (``fsdp`` / ``dsgd_pod``)."""
    sizes = mesh_sizes(mesh)
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf if isinstance(leaf, (tuple, list, torch.Size)) else leaf.shape)
        path, groups = reference_path(name, cfg)
        prefix: list = []
        numel = math.prod(shape) * groups
        if node_axis is not None:
            prefix.append(node_axis)
            numel *= sizes[node_axis]
            shape = (sizes[node_axis],) + shape
        inner = tp_spec_for_path(path, shape[len(prefix):], fsdp_axis=fsdp_axis)
        spec = sanitize_spec(tuple(prefix) + inner, shape, sizes)
        body = spec[len(prefix):]
        # a big leaf whose rule was sanitized away (an odd vocabulary) is
        # still split over model on its last dimension that model divides
        if all(e is None for e in body) and numel * 2 > _FALLBACK_BYTES:
            for i in reversed(range(len(prefix), len(shape))):
                if shape[i] % sizes["model"] == 0:
                    spec = spec[:i] + ("model",) + spec[i + 1:]
                    break
        out[name] = spec
    return out


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: for
    each mesh dimension, ``Shard(d)`` where the spec splits tensor
    dimension d over it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if entry is not None and name in _axes(entry)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} splits {len(dims)} dimensions over {name!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def make_param_shardings(param_specs: Mapping[str, Spec], mesh) -> dict[str, tuple]:
    """Every spec's placements on ``mesh`` (the reference's
    ``NamedSharding`` tree)."""
    return {name: placements(spec, mesh) for name, spec in param_specs.items()}


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str | None = None):
    """A ``DeviceMesh`` of the given shape and dimension names (the
    reference's axes: ``("data", "model")`` or ``("pod", "data",
    "model")``) over the ranks of the default process group, which must
    be joined already and hold ``prod(shape)`` ranks, in row-major order.
    ``device_type`` defaults to ``"cuda"`` on an NCCL group, else
    ``"cpu"``. Every rank calls it (it creates a group per mesh
    dimension)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks, the group has {world}")
    if device_type is None:
        device_type = "cuda" if str(dist.get_backend()) == "nccl" else "cpu"
    ranks = torch.arange(world).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's coordinate on each mesh dimension."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _block(entry, sizes: Mapping[str, int], coords: Mapping[str, int]) -> tuple[int, int]:
    """(block index, block count) of a spec entry: row-major over its axes."""
    index, count = 0, 1
    for a in _axes(entry):
        index, count = index * sizes[a] + coords[a], count * sizes[a]
    return index, count


def shard(full: torch.Tensor, spec: Spec, mesh, coords: Mapping[str, int] | None = None,
          offset: int = 0) -> torch.Tensor:
    """The block of ``full`` a rank at ``coords`` (default: this rank's)
    holds under ``spec``, a contiguous copy; ``offset`` leading dimensions
    of ``full`` come before the ones the spec names (a ring's depth)."""
    sizes = mesh_sizes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    out = full
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        index, count = _block(entry, sizes, coords)
        width = full.shape[d + offset] // count
        out = out.narrow(d + offset, index * width, width)
    # a copy even where the block is contiguous already (a split of the
    # first dimension): a view would keep all of ``full`` alive
    return out.clone(memory_format=torch.contiguous_format)


def sharded_dims(spec: Spec, axes: tuple[str, ...]) -> list[tuple[int, tuple]]:
    """``(tensor dimension, the entry's axes among ``axes``)`` for every
    dimension the spec splits over any of ``axes``."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        hit = tuple(a for a in _axes(entry) if a in axes)
        if hit:
            out.append((d, hit))
    return out
