"""Where the LM trainer's leaves live on a ``(data, model)`` or ``(pod,
data, model)`` mesh of ranks, per mode (the reference's
``make_train_setup(cfg, mesh, mode=...)``):

* ``dsgd`` -- every ``data`` coordinate is a node; its replica is split
  over ``model`` by ``make_param_specs(node_axis=None)``; a node's ranks
  run its batch (tensor parallelism, ``train/tensor_parallel.py``) and it
  mixes with the nodes of its ``data`` group, shard k with shard k.
* ``dsgd_pod`` -- every ``pod`` coordinate is a node; weights at rest are
  split by ``make_param_specs(node_axis=None, fsdp_axis="data")``; a rank
  gathers its ``data`` group's blocks (weights at rest, gathered for the
  step), runs its ``data`` slice of the pod's batch split over ``model``,
  and the gradient is the pod's mean over ``data``; the pods mix.
* ``fsdp`` -- one global model split as ``dsgd_pod``'s over every mesh
  dimension; a rank gathers every block, runs its slice of the global
  batch whole, and the gradient is the mean over every rank.

``MeshLayout`` cuts a rank's blocks out of full leaves, gathers them back
(for the step, and every mesh dimension for a checkpoint), reduces the
gradients, and gives a rank its slice of a batch and the group of each
mesh dimension. Its collectives count in ``core.mixing``'s counters
(``fsdp_all_gather``; ``grad_all_reduce``: the gradients' reduce-scatters
and all-reduces).
"""

from __future__ import annotations

import torch

from repro_torch.core import mixing as _M

from . import sharding

__all__ = ["MeshLayout"]

# per mode: the node axis, the axes weights at rest are gathered over for
# the step, the axes a node's batch (and its gradient's mean) is split over
MODE_AXES = {
    "dsgd": ("data", (), ()),
    "dsgd_pod": ("pod", ("data",), ("data",)),
    "fsdp": (None, ("pod", "data", "model"), ("pod", "data", "model")),
}


class MeshLayout:
    """One rank's view of ``mesh`` (a ``DeviceMesh`` with the reference's
    axis names) in ``mode``, for the parameters of ``cfg``."""

    def __init__(self, cfg, mesh, mode: str, shapes: dict[str, tuple]):
        names = tuple(mesh.mesh_dim_names or ())
        want = {"dsgd": ("data", "model"), "dsgd_pod": ("pod", "data", "model"),
                "fsdp": ("data", "model")}[mode]
        missing = [a for a in want if a not in names]
        if missing:
            raise ValueError(f"mode={mode!r} needs mesh dimensions {want}, the mesh has "
                             f"{names} (dsgd_pod requires a 'pod' mesh axis)")
        self.cfg, self.mesh, self.mode = cfg, mesh, mode
        self.sizes = sharding.mesh_sizes(mesh)
        self.coords = sharding.mesh_coords(mesh)
        node, gather, batch = MODE_AXES[mode]
        self.node_axis = node
        self.gather_axes = tuple(a for a in gather if a in names)
        self.batch_axes = tuple(a for a in batch if a in names)
        self.shapes = dict(shapes)
        self.specs = sharding.make_param_specs(shapes, mesh, cfg=cfg,
                                               fsdp_axis=None if mode == "dsgd" else "data")
        # what a rank computes on: the specs less the gathered axes
        self.compute_specs = {k: tuple(None if e is not None and any(
            a in self.gather_axes for a in sharding._axes(e)) else e for e in s)
            for k, s in self.specs.items()}
        self._groups: dict[str, object] = {}

    # -- groups ----------------------------------------------------------------

    def group(self, axis: str):
        if axis not in self._groups:
            self._groups[axis] = self.mesh.get_group(axis)
        return self._groups[axis]

    @property
    def node_group(self):
        return None if self.node_axis is None else self.group(self.node_axis)

    @property
    def n_nodes(self) -> int:
        return 1 if self.node_axis is None else self.sizes[self.node_axis]

    @property
    def node(self) -> int:
        return 0 if self.node_axis is None else self.coords[self.node_axis]

    @property
    def tp_group(self):
        """The ``model`` group a node's replica is split over (none in fsdp,
        where every rank runs its own slice of the batch on whole weights)."""
        return None if self.mode == "fsdp" else self.group("model")

    def all_groups(self) -> list:
        return [self.group(a) for a in self.mesh.mesh_dim_names]

    def model_split(self, name: str) -> bool:
        """Whether this rank holds only a block of ``name`` over ``model``
        in the compute layout (a probe sums such a leaf over ``model``)."""
        return "model" in self.compute_specs[name]

    # -- blocks ----------------------------------------------------------------

    def shard(self, full: torch.Tensor, name: str, offset: int = 0) -> torch.Tensor:
        """This rank's block at rest of the full leaf ``name`` (``offset``
        leading dimensions before the parameter's: a ring's depth)."""
        return sharding.shard(full, self.specs[name], self.sizes, self.coords, offset)

    def full_shape(self, name: str, offset_shape: tuple = ()) -> tuple:
        return tuple(offset_shape) + tuple(self.shapes[name])

    def _gather_dim(self, x: torch.Tensor, dim: int, axis: str, kind: str) -> torch.Tensor:
        import torch.distributed as dist

        n = self.sizes[axis]
        if n == 1:
            return x
        flat = x.contiguous().reshape(-1)
        out = torch.empty((n * flat.numel(),), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, flat, group=self.group(axis))
        _M.collective_bytes[kind] += (n - 1) * flat.numel() * flat.element_size()
        _M.collective_calls[kind] += 1
        return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=dim)

    def gather(self, x: torch.Tensor, name: str, axes: tuple | None = None,
               offset: int = 0) -> torch.Tensor:
        """``x`` (this rank's block of ``name``) gathered over ``axes``
        (default: the step's gathered axes) on every rank of those groups."""
        axes = self.gather_axes if axes is None else axes
        for d, hit in sharding.sharded_dims(self.specs[name], axes):
            for axis in reversed(hit):  # the inner axis first: row-major blocks
                x = self._gather_dim(x, d + offset, axis, "fsdp_all_gather")
        return x

    def reduce_grad(self, g: torch.Tensor, name: str) -> torch.Tensor:
        """A compute-layout gradient's mean over the batch axes, cut to this
        rank's block at rest: a reduce-scatter along the dimension a batch
        axis splits the leaf on, an all-reduce over an axis it is whole on;
        summed in the leaf's dtype (a bfloat16 leaf moves as bfloat16)."""
        if not self.batch_axes:
            return g
        import torch.distributed as dist

        split = {hit[0]: d for d, hit in sharding.sharded_dims(self.specs[name], self.batch_axes)}
        y, count = g.contiguous(), 1
        for axis in self.batch_axes:
            n = self.sizes[axis]
            count *= n
            if n == 1:
                continue
            group = self.group(axis)
            if axis in split:
                d = split[axis]
                x = y.movedim(d, 0).contiguous()
                out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                                  device=x.device)
                dist.reduce_scatter_tensor(out, x, group=group)
                nbytes = (n - 1) * out.numel() * out.element_size()
                y = out.movedim(0, d)
            else:
                y = y.clone()
                dist.all_reduce(y, group=group)
                nbytes = 2 * (n - 1) * y.numel() * y.element_size() // n
            _M.collective_bytes["grad_all_reduce"] += nbytes
            _M.collective_calls["grad_all_reduce"] += 1
        return (y / count).contiguous()

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The step's loss: the mean over the batch axes, then over nodes
        (float32; the same on every rank)."""
        out = loss.to(torch.float32)
        for axis in self.batch_axes + ((self.node_axis,) if self.node_axis else ()):
            if self.sizes[axis] > 1:
                out = _M._psum(out, self.group(axis)) / self.sizes[axis]
        return out

    # -- batches ---------------------------------------------------------------

    def local_batch(self, batch: dict, lead: int = 0) -> dict:
        """This rank's slice of a batch in the reference's layout (after
        ``lead`` leading axes, e.g. a time axis): dsgd ``(n_nodes,
        per_node, ...)`` -> this node's row; dsgd_pod ``(n_pods, per_pod,
        ...)`` -> this pod's row, split over ``data``; fsdp ``(batch, ...)``
        split over every mesh dimension (row-major)."""
        def cut(v):
            v = torch.as_tensor(v)
            if self.node_axis is not None:
                v = v.select(lead, self.node)
            index, count = sharding._block(self.batch_axes, self.sizes, self.coords) \
                if self.batch_axes else (0, 1)
            if count > 1:
                rows = v.shape[lead]
                if rows % count:
                    raise ValueError(f"a batch of {rows} does not split over {count} ranks")
                v = v.narrow(lead, index * (rows // count), rows // count)
            return v.contiguous()

        return {k: cut(v) for k, v in batch.items()}

    # -- checkpoints -------------------------------------------------------------

    def writes_node_row(self) -> bool:
        """Whether this rank joins its node group's checkpoint gather: the
        ranks at coordinate 0 of every other axis."""
        return all(c == 0 for a, c in self.coords.items() if a != self.node_axis)

    def full_leaf(self, x: torch.Tensor, name: str, offset: int = 0):
        """The node-stacked full leaf on the mesh's first rank (None on the
        others): gathered over every non-node axis, then over nodes."""
        axes = tuple(a for a in self.mesh.mesh_dim_names if a != self.node_axis)
        x = self.gather(x, name, axes, offset)
        if not self.writes_node_row():
            return None
        if self.node_axis is None:
            return x
        return _M._gather_first(x, self.node_group)
