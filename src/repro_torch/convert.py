"""Carry weights and schedules between numpy and the port's tensors.

The reference's classifier parameters leave JAX as a dict of numpy arrays
(stacked on a node axis or not); ``params_from_numpy`` puts them on a
device so both packages compute on the same weights, and
``params_to_numpy`` brings them back. ``schedule_arrays_from_numpy``
builds a ``ScheduleArrays`` from a (gammas, perms) pair.

``lm_params_from_numpy`` carries the reference's ``init_lm`` pytree (as
numpy arrays) into the port's ``LM`` and ``lm_params_to_numpy`` back. The
reference stacks the layers of pattern position j on a group axis,
``params["stages"][j][...][g]``, and keeps the leftover layers in
``params["tail"][t]`` (``repro/models/transformer.py:173-197``): group g,
position j is layer ``g * len(pattern) + j`` of the port, tail t is layer
``reps * len(pattern) + t``. Leaf names map onto parameter names
(``attn/wq`` -> ``layers.<i>.attn.wq``). The xLSTM blocks' leaves
(``block/r``, ``block/b_if`` ...) travel the same way. Whisper's pytree
(``init_whisper``) is flat: its layer lists ``enc_layers`` /
``dec_layers`` map onto the ``Whisper`` module's ``ModuleList``s by
index; both functions take it where the config's ``arch_type`` is
``"audio"``. bfloat16 leaves travel as their bits, so a round trip is
bitwise.

``lm_node_from_numpy`` gives one rank of the LM trainer's one-node-per-rank
layout its row of the reference's node-stacked pytree: the parameters,
the EF memory (the same tree in float32) or, with ``lead=1``, the stale
ring (``(n, depth, ...)`` leaves, the ring's depth after the node axis).

``lm_shard_from_numpy`` gives a rank of the LM trainer's mesh layout
(``make_train_setup(cfg, mesh=...)``) its block of the reference's tree:
its node's row of a node-stacked tree (``dsgd``, ``dsgd_pod``: the
parameters, the EF memory, with ``lead=1`` the stale ring) or the
unstacked tree (``fsdp``), cut by the setup's specs
(``train.sharding``) at its mesh coordinates. The checkpoint's gather is
its inverse (``TrainSetup.run_segments``).

``lm_cache_from_numpy`` carries the reference's decode cache (its
``init_cache`` / ``prefill`` pytree, as numpy arrays: ``stages`` leaves
stacked on the group axis, ``tail`` after them; whisper's flat dict) into
the port's layout, one dict per layer (``transformer.init_cache``), the
``index`` as int64.

``lm_stacked_from_numpy`` / ``lm_stacked_to_numpy`` carry the LM
trainer's parameters: the reference's ``make_train_setup(...).init_params``
pytree has a leading node axis on every leaf, before the ``stages``
group axis (none in ``fsdp`` mode); the port's trainer keeps a dict of
tensors named as ``LM.named_parameters()``, each with that node axis
first (``train/lm_trainer.py``). These are plain tensors: the trainer
owns its leaves and their gradients, where ``lm_params_from_numpy``
gives a serving model with gradients off.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "params_from_numpy",
    "params_to_numpy",
    "schedule_arrays_from_numpy",
    "lm_params_from_numpy",
    "lm_params_to_numpy",
    "module_params_from_numpy",
    "lm_cache_from_numpy",
    "lm_stacked_from_numpy",
    "lm_stacked_to_numpy",
    "lm_node_from_numpy",
    "lm_shard_from_numpy",
]


def params_from_numpy(
    tree: dict[str, np.ndarray], device: torch.device | str | None = None
) -> dict[str, torch.Tensor]:
    """A dict of numpy arrays as a dict of tensors on ``device`` (dtypes kept)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in tree.items()}  # copies


def params_to_numpy(tree: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A dict of tensors as a dict of numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def schedule_arrays_from_numpy(gammas, perms, device: torch.device | str | None = None):
    """``ScheduleArrays`` on ``device`` from (L,) weights and an (L, n)
    permutation table; checks that every row is a permutation of ``0..n-1``."""
    from repro_torch.core.mixing import ScheduleArrays

    device = resolve_device(device)
    gammas = np.asarray(gammas, dtype=np.float32)
    perms = np.asarray(perms, dtype=np.int32)
    if perms.ndim != 2 or gammas.shape != (perms.shape[0],):
        raise ValueError(
            f"need gammas (L,) and perms (L, n), got {gammas.shape} and {perms.shape}"
        )
    ref = np.arange(perms.shape[1])
    for row in perms:
        if not np.array_equal(np.sort(row), ref):
            raise ValueError(f"perms row is not a permutation of {perms.shape[1]} nodes")
    return ScheduleArrays(
        gammas=torch.as_tensor(gammas, device=device),
        perms=torch.as_tensor(perms, device=device),
    )


def _tensor(arr) -> torch.Tensor:
    """A host copy of ``arr`` as a tensor; bfloat16 (ml_dtypes) by its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as the reference's arrays carry it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _flatten(prefix: str, node, out: dict) -> None:
    if isinstance(node, (dict, list)):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, child in items:
            _flatten(f"{prefix}.{key}" if prefix else str(key), child, out)
    else:
        out[prefix] = node


def _nest(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _stack(trees: list[dict], axis: int = 0) -> dict:
    return {k: _stack([t[k] for t in trees], axis) if isinstance(trees[0][k], dict)
            else np.stack([t[k] for t in trees], axis) for k in trees[0]}


def _layer_slots(cfg) -> tuple[int, int]:
    """(groups, pattern length) of the reference's stacked layout."""
    plen = len(cfg.layer_pattern)
    return cfg.num_layers // plen, plen


def _load_flat(module: torch.nn.Module, flat: dict[str, np.ndarray]) -> torch.nn.Module:
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"parameter names differ: missing {sorted(set(params) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(params))}")
    with torch.no_grad():
        for name, leaf in flat.items():
            src = _tensor(leaf)
            dst = params[name]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"{name}: got {tuple(src.shape)} {src.dtype}, the module "
                                 f"holds {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)
    return module.requires_grad_(False).eval()


def module_params_from_numpy(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Fill ``module``'s parameters from a nested dict of numpy arrays named
    as the reference's params of that block (``{"wq": ..., "q_norm":
    {"scale": ...}}``); gradients off, eval mode. Returns the module."""
    flat: dict[str, np.ndarray] = {}
    _flatten("", tree, flat)
    return _load_flat(module, flat)


def _lm_flat(tree: dict, cfg, node_axis: bool, lead: int = 0) -> dict[str, np.ndarray]:
    """The reference's LM pytree (leaves with a leading node axis when
    ``node_axis``, then ``lead`` more axes) as a flat dict named as
    ``LM.named_parameters()``."""
    flat: dict[str, np.ndarray] = {}
    if cfg.arch_type == "audio":
        _flatten("", tree, flat)
        return flat
    reps, plen = _layer_slots(cfg)
    _flatten("embed", tree["embed"], flat)
    _flatten("final_norm", tree["final_norm"], flat)
    for j in range(plen if reps else 0):
        stage: dict = {}
        _flatten("", tree["stages"][j], stage)
        for g in range(reps):
            for name, leaf in stage.items():
                leaf = np.asarray(leaf)
                flat[f"layers.{g * plen + j}.{name}"] = np.take(leaf, g,
                                                                axis=int(node_axis) + lead)
    for t, layer in enumerate(tree["tail"]):
        _flatten(f"layers.{reps * plen + t}", layer, flat)
    return flat


def lm_params_from_numpy(tree: dict, cfg, device: torch.device | str | None = None):
    """The port's ``LM`` for ``cfg`` on ``device`` (None = CUDA), with the
    reference's ``init_lm`` weights ``tree`` (leaves as numpy arrays), or
    its ``Whisper`` with the ``init_whisper`` weights for an audio config;
    gradients off, eval mode. Names, shapes and dtypes must all match."""
    from repro_torch.models.transformer import LM
    from repro_torch.models.whisper import Whisper

    device = resolve_device(device)
    module = Whisper(cfg, device) if cfg.arch_type == "audio" else LM(cfg, device)
    return _load_flat(module, _lm_flat(tree, cfg, node_axis=False))


def lm_stacked_from_numpy(tree: dict, cfg, *, node_axis: bool = True,
                          device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """The LM trainer's parameters from the reference's
    ``make_train_setup(...).init_params`` pytree (numpy leaves): a dict
    ``LM.named_parameters()`` name -> tensor on ``device`` (None = CUDA),
    with the leading node axis when ``node_axis`` (the ``dsgd`` modes),
    without it (``fsdp``). Names are checked against the model's; the
    tensors do not require gradients."""
    from repro_torch.models.transformer import LM
    from repro_torch.models.whisper import Whisper

    device = resolve_device(device)
    flat = _lm_flat(tree, cfg, node_axis)
    meta = Whisper(cfg, "meta") if cfg.arch_type == "audio" else LM(cfg, "meta")
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    if set(flat) != set(shapes):
        raise ValueError(f"parameter names differ: missing {sorted(set(shapes) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(shapes))}")
    out = {}
    for name, leaf in flat.items():
        t = _tensor(leaf)
        if tuple(t.shape[1:] if node_axis else t.shape) != shapes[name]:
            raise ValueError(f"{name}: got {tuple(t.shape)}, the model holds {shapes[name]}")
        out[name] = t.to(device)
    return out


def lm_node_from_numpy(tree: dict, cfg, i: int, *, lead: int = 0,
                       device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """Rank ``i``'s row of the reference's node-stacked LM pytree (numpy
    leaves with the node axis first, then ``lead`` axes before the layer
    group axis): a dict ``LM.named_parameters()`` name -> tensor on
    ``device`` (None = CUDA), dtypes kept (bfloat16 by its bits). The
    parameters and the EF memory take ``lead=0``; the stale ring's
    ``(n, depth, ...)`` leaves take ``lead=1``."""
    device = resolve_device(device)
    flat = _lm_flat(tree, cfg, node_axis=True, lead=lead)
    return {name: _tensor(np.asarray(leaf)[i]).to(device) for name, leaf in flat.items()}


def lm_shard_from_numpy(tree: dict, cfg, mesh, specs: dict, *, node: int | None = None,
                        lead: int = 0,
                        device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """This rank's block of the reference's LM pytree (numpy leaves): with
    ``node``, that row of a node-stacked tree (the node axis first, then
    ``lead`` axes: 1 for the stale ring's depth); without, the unstacked
    tree. Each leaf is cut by ``specs[name]`` (``TrainSetup.param_specs``)
    at this rank's coordinates on the ``DeviceMesh`` ``mesh``, a
    contiguous tensor on ``device`` (None = CUDA), dtypes kept."""
    from repro_torch.train import sharding

    device = resolve_device(device)
    flat = _lm_flat(tree, cfg, node_axis=node is not None, lead=lead)
    out = {}
    for name, leaf in flat.items():
        arr = np.asarray(leaf)
        t = _tensor(arr[node] if node is not None else arr)
        out[name] = sharding.shard(t, specs[name], mesh, offset=lead).to(device)
    return out


def lm_stacked_to_numpy(params: dict[str, torch.Tensor], cfg, *, node_axis: bool = True) -> dict:
    """The reference's ``init_params`` pytree of the trainer's parameters
    (``lm_stacked_from_numpy``'s inverse), as numpy arrays: ``stages``
    leaves stacked on the group axis after the node axis."""
    flat = {name: _array(t) for name, t in params.items()}
    if cfg.arch_type == "audio":
        tree = _nest(flat)
        for key in ("enc_layers", "dec_layers"):
            tree[key] = [tree[key][str(i)] for i in range(len(tree[key]))]
        return tree
    reps, plen = _layer_slots(cfg)
    axis = 1 if node_axis else 0
    layers = [_nest({n[len(f"layers.{i}."):]: v for n, v in flat.items()
                     if n.startswith(f"layers.{i}.")}) for i in range(cfg.num_layers)]
    return {
        "embed": _nest({n[len("embed."):]: v for n, v in flat.items() if n.startswith("embed.")}),
        "stages": [_stack(layers[j : reps * plen : plen], axis) if reps else None
                   for j in range(plen)],
        "tail": layers[reps * plen :],
        "final_norm": _nest({n[len("final_norm."):]: v for n, v in flat.items()
                             if n.startswith("final_norm.")}),
    }


def lm_params_to_numpy(model) -> dict:
    """The reference's ``init_lm`` pytree of ``model``'s weights, as numpy
    arrays: ``embed``, ``stages`` (stacked per pattern position; None
    where there is no whole group), ``tail`` and ``final_norm``; for a
    ``Whisper``, the ``init_whisper`` pytree (layer lists as lists)."""
    cfg = model.cfg
    if cfg.arch_type == "audio":
        def tree(module):
            return _nest({n: _array(p) for n, p in module.named_parameters()})

        return {"token_embed": _array(model.token_embed),
                "enc_layers": [tree(layer) for layer in model.enc_layers],
                "enc_final_ln": tree(model.enc_final_ln),
                "dec_layers": [tree(layer) for layer in model.dec_layers],
                "dec_final_ln": tree(model.dec_final_ln)}
    reps, plen = _layer_slots(cfg)
    layers = [_nest({n: _array(p) for n, p in layer.named_parameters()})
              for layer in model.layers]
    return {
        "embed": _nest({n: _array(p) for n, p in model.embed.named_parameters()}),
        "stages": [_stack(layers[j : reps * plen : plen]) if reps else None
                   for j in range(plen)],
        "tail": layers[reps * plen :],
        "final_norm": _nest({n: _array(p) for n, p in model.final_norm.named_parameters()}),
    }


def lm_cache_from_numpy(tree: dict, cfg, *, device: torch.device | str | None = None):
    """The port's cache of the reference's cache pytree (numpy leaves) on
    ``device`` (None = CUDA): a list of per-layer dicts, or whisper's
    ``{"encoder_out", "self": [...]}``; indices int64."""
    device = resolve_device(device)

    def leaf(name, arr):
        t = _tensor(np.asarray(arr))
        return (t.to(torch.int64) if name == "index" else t).to(device)

    def layer(d: dict, g: int | None = None) -> dict:
        return {k: leaf(k, v if g is None else np.asarray(v)[g]) for k, v in d.items()}

    if cfg.arch_type == "audio":
        return {"encoder_out": leaf("encoder_out", tree["encoder_out"]),
                "self": [layer(d) for d in tree["self"]]}
    reps, plen = _layer_slots(cfg)
    return [layer(tree["stages"][i % plen], i // plen) if i < reps * plen
            else layer(tree["tail"][i - reps * plen]) for i in range(cfg.num_layers)]
