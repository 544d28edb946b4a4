"""Serving engine: batched prefill + single-token greedy decode with caches.

``prefill`` runs the prompt through the model and builds the decode
caches (full caches and window rings for attention, MLA's latent caches,
RG-LRU and xLSTM states; for whisper the encoder's states and its
decoder's self-attention caches); ``decode_step`` takes one new token
against them. Both are the eager counterparts of the reference's
functions. The VLM's prompt follows its ``image_embeds`` (the positions
count the patches first); whisper's decoder reads the encoder's states of
``frames``. Under ``impl="kernel"`` (the model's default) a prefill's
causal attention runs in the flash kernel, with each layer's window (the
reference's prefill is plain XLA); MLA, whisper's attention and decode
are plain PyTorch, as they are plain XLA in the reference. The RG-LRU
recurrence of the prefill goes through ``kernels.rglru_scan``, the
sLSTM's through its captured time loop (``models/xlstm.py``).

``generate`` is greedy decoding through a :class:`Decoder`, the port's
counterpart of the reference's jitted decode step: the decoder owns
static buffers (the cache at ``(B, max_len)``, with whisper's encoder
states, the current token and position, the logits, the generated
tokens), and its step -- one ``decode_step`` into those buffers, the
greedy argmax, the position advanced, all on the device -- runs through
``repro_torch.graphs``: an eager warm-up on a side stream, a CUDA-graph
capture at its second run, replays after that. The cache's ``index`` is
a device tensor (``models/kvcache.py``), so a replay writes the slot of
the step it replays. Nothing reads the device between two steps; lengths
are checked on the host before a step runs. Each model keeps at most one
decoder, for the ``(B, max_len)`` of its last ``generate``, so repeated
calls at that shape capture once. On the CPU the step runs eagerly,
counted as on the card. A failed capture raises; nothing falls back to
the eager step.

``long_context=True`` (``prefill``, ``decode_step``, ``Decoder``,
``generate``) is the reference's sub-quadratic mode: the caches of
``transformer.init_cache(long_context=True)`` (a window ring on every
attention layer, a latent ring of ``long_context_window`` slots on an MLA
layer, recurrent states as they are) and ``window_override =
cfg.long_context_window`` on every forward; its prefill attention runs
in the flash kernel with that window. An MLA layer's cache says whether
it is a ring (``kvcache.init_mla_cache(ring=True)``), so its write never
depends on the window a forward is given. A decoder serves one mode: a
``generate`` in the other mode builds a new decoder, captured anew.
Whisper takes the flag and ignores it, as the reference does.

``make_serve_setup(cfg, mesh, batch=, seq_len=)`` is the reference's
sharded serve setup on a ``(data, model)`` or ``(pod, data, model)``
``DeviceMesh`` of joined ranks: parameters split over ``model`` by the
reference's rules (``train.sharding.make_param_specs`` without node or
fsdp axis) and run tensor-parallel (``train/tensor_parallel.py``, the
model's own blocks with their ``tp`` hooks), requests and caches split
over ``data`` (and ``pod``), each cache leaf over ``model`` as the
reference's ``_cache_specs_for`` places it (``cache_specs_for``). Its
``serve_step`` decodes one token on a rank's blocks and returns the
logits whole over the vocabulary; its ``prefill`` is the dry run's
sharded prefill (flash on the rank's heads under ``impl="kernel"``, the
RG-LRU scan on its features); ``ServeSetup.decoder`` captures the step
with its collectives as a CUDA graph (``MeshDecoder``). The production
meshes' specs come from a mesh on the ``"fake"`` process group
(``launch/dryrun.py``'s ``join_fake``), no cards needed.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Callable

import torch

from repro_torch.device import resolve_device, shapes_only
from repro_torch.graphs import Body, GraphRunner
from repro_torch.models import parallel, transformer, whisper
from repro_torch.models.common import ModelConfig, dtype_of
from repro_torch.models.kvcache import check_fits
from repro_torch.models.layers import sinusoidal_positions, unembed

__all__ = ["prefill", "decode_step", "generate", "Decoder", "decoder_for", "ServeSetup",
           "make_serve_setup", "cache_specs_for", "MeshDecoder"]


def _offset(image_embeds: torch.Tensor | None) -> int:
    """Positions the image patches take before the prompt (0 without)."""
    return 0 if image_embeds is None else image_embeds.shape[1]


def _check_positions(cfg: ModelConfig, max_len: int) -> None:
    """Whisper's decoder positions index a table of ``MAX_POSITIONS`` rows:
    refuse a cache that would reach past it, on the host."""
    if cfg.arch_type == "audio" and max_len > whisper.MAX_POSITIONS:
        raise ValueError(f"whisper's position table has {whisper.MAX_POSITIONS} rows, "
                         f"a cache of {max_len} positions would index past it")


def _long_context(cfg: ModelConfig, long_context: bool) -> bool:
    """Whether the long-context mode applies: whisper ignores the flag."""
    return long_context and cfg.arch_type != "audio"


def _window(cfg: ModelConfig, long_context: bool) -> int | None:
    return cfg.long_context_window if long_context else None


def _init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                long_context: bool = False) -> list | dict:
    if cfg.arch_type == "audio":
        return whisper.init_whisper_cache(cfg, batch, max_len, device=device)
    return transformer.init_cache(cfg, batch, max_len, long_context=long_context, device=device)


def _reset_cache_(cfg: ModelConfig, cache: list | dict) -> None:
    """The cache back to its initial values in place (whisper's encoder
    states are overwritten by the next prefill)."""
    if cfg.arch_type == "audio":
        for layer in cache["self"]:
            for t in layer.values():
                t.zero_()
    else:
        transformer.reset_cache_(cfg, cache)


def _prefill_into(
    model, cfg: ModelConfig, tokens: torch.Tensor, cache: list | dict, *,
    image_embeds: torch.Tensor | None = None, frames: torch.Tensor | None = None,
    long_context: bool = False,
) -> torch.Tensor:
    """Run the prompt (B, S) -- after the image patches, or against the
    encoder's states of ``frames`` -- into the fresh ``cache``; the last
    position's logits."""
    B, S = tokens.shape
    total = _offset(image_embeds) + S
    pos = torch.arange(total, device=tokens.device)[None].expand(B, total)
    if cfg.arch_type == "audio":
        if frames is None:
            raise ValueError("whisper's prefill needs frames")
        cache["encoder_out"].copy_(whisper.encode(model, cfg, frames))
        hidden, _, _ = whisper.whisper_forward(model, cfg, None, tokens, cache=cache,
                                               positions=pos, return_hidden=True)
        return whisper.unembed(model, hidden[:, -1:])[:, 0]
    # impl="kernel" (the default): the RG-LRU recurrence in its kernel, the
    # prefill's causal attention in the flash kernel
    hidden, _, _ = model(tokens, image_embeds=image_embeds, cache=cache, positions=pos,
                         window_override=_window(cfg, long_context), return_hidden=True)
    return unembed(model.embed, hidden[:, -1:], cfg)[:, 0]


def prefill(
    model,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    max_len: int,
    image_embeds: torch.Tensor | None = None,
    frames: torch.Tensor | None = None,
    long_context: bool = False,
) -> tuple[torch.Tensor, list | dict]:
    """Run the prompt (B, S) through the model, building the decode cache
    of ``max_len`` positions (the VLM's image patches come first and take
    positions too; whisper encodes ``frames`` into the cache), or with
    ``long_context`` the long-context mode's rings, which take a prompt
    of any length.

    Returns (last-position logits (B, V), cache). Only the last position
    is unembedded (the reference unembeds all S and keeps the last).
    """
    B, S = tokens.shape
    long_context = _long_context(cfg, long_context)
    if not long_context:
        check_fits(max_len, 0, _offset(image_embeds) + S)
    _check_positions(cfg, max_len)
    cache = _init_cache(cfg, B, max_len, tokens.device, long_context)
    logits = _prefill_into(model, cfg, tokens, cache, image_embeds=image_embeds, frames=frames,
                           long_context=long_context)
    return logits, cache


def decode_step(
    model,
    cfg: ModelConfig,
    token: torch.Tensor,  # (B, 1)
    position: torch.Tensor,  # (B, 1) absolute position of the new token
    cache: list | dict,
    *,
    long_context: bool = False,
) -> tuple[torch.Tensor, list | dict]:
    """One new token against the cache (of the same mode as
    ``long_context``). Returns (logits (B, V), new cache)."""
    if cfg.arch_type == "audio":
        logits, cache, _ = whisper.whisper_forward(model, cfg, None, token, cache=cache,
                                                   positions=position)
    else:
        logits, cache, _ = model(token, cache=cache, positions=position,
                                 window_override=_window(cfg, long_context))
    return logits[:, 0], cache


def _same_config(model, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"model was built for {model.cfg.name!r}, not for this config")


def _param_ptrs(model) -> tuple[int, ...]:
    return tuple(p.data_ptr() for p in model.parameters())


class Decoder:
    """Greedy decoding of ``model`` for ``batch`` sequences of at most
    ``max_len`` positions (the VLM's image patches included), on the
    model's device; with ``long_context``, in the long-context mode (its
    rings; ``max_len`` then bounds only ``tokens``).

    Static buffers, read and written in place by every step:
      ``cache``     the per-layer caches (``transformer.init_cache``), or
                    whisper's (``whisper.init_whisper_cache``: the
                    encoder's states, filled by :meth:`start`, and the
                    self-attention caches);
      ``token``     (B, 1) int64, the token the next step feeds;
      ``position``  (B, 1) int64, its absolute position;
      ``logits``    (B, V) in the model's dtype, the last logits;
      ``tokens``    (B, max_len + 1) int64, each greedy token at the
                    position it takes (the image's and the prompt's
                    columns stay 0).

    :meth:`start` resets the cache and prefills a prompt; :meth:`step` decodes ``token`` (the
    last greedy token, or one the caller gives) -- eagerly at its first
    run, by capture and replay after (``n_captures``).
    """

    def __init__(self, model, cfg: ModelConfig, batch: int, max_len: int, *,
                 long_context: bool = False):
        _same_config(model, cfg)
        _check_positions(cfg, max_len)
        device = next(model.parameters()).device
        self._model = weakref.ref(model)  # weak: the registry keyed on the model keeps the decoder
        self._ptrs = _param_ptrs(model)
        self.cfg = cfg
        self.batch, self.max_len = batch, max_len
        self.long_context = _long_context(cfg, long_context)
        with torch.inference_mode():
            self.cache = _init_cache(cfg, batch, max_len, device, self.long_context)
            self.token = torch.zeros((batch, 1), dtype=torch.int64, device=device)
            self.position = torch.zeros((batch, 1), dtype=torch.int64, device=device)
            self.logits = torch.zeros((batch, cfg.vocab_size), dtype=dtype_of(cfg), device=device)
            self.tokens = torch.zeros((batch, max_len + 1), dtype=torch.int64, device=device)
        self._graphs = GraphRunner("serve.decode", device)
        self._body = Body(self._step)
        self._length = 0  # positions in the cache, known on the host

    @property
    def n_captures(self) -> int:
        """Captures of the step (on the CPU: the runs that would capture)."""
        return self._graphs.n_traces

    @property
    def capture_s(self) -> float | None:
        """Host seconds of the step's capture (None before it, or on the CPU)."""
        return self._body.capture_s

    def _serves(self, model, batch: int, max_len: int, long_context: bool) -> bool:
        """Whether this decoder decodes ``model``'s current weights at this
        shape, in this mode."""
        return (self._model() is model and (self.batch, self.max_len) == (batch, max_len)
                and self.long_context == _long_context(self.cfg, long_context)
                and self._ptrs == _param_ptrs(model))

    @torch.inference_mode()
    def start(self, prompt: torch.Tensor, *, image_embeds: torch.Tensor | None = None,
              frames: torch.Tensor | None = None) -> None:
        """Prefill ``prompt`` (B, S), after ``image_embeds`` (B, P, d) or
        against the encoder's states of ``frames``, into the cache reset to
        its initial values (``transformer.reset_cache_``); ``token`` becomes
        the greedy token at position P + S."""
        B, S = prompt.shape
        if B != self.batch:
            raise ValueError(f"the decoder serves batches of {self.batch}, got {B}")
        total = _offset(image_embeds) + S
        check_fits(self.max_len, 0, total)
        _reset_cache_(self.cfg, self.cache)
        logits = _prefill_into(self._model(), self.cfg, prompt, self.cache,
                               image_embeds=image_embeds, frames=frames,
                               long_context=self.long_context)
        self.position.fill_(total - 1)
        self._take(logits)
        self._length = total

    @torch.inference_mode()
    def step(self, token: torch.Tensor | None = None) -> None:
        """Decode ``token`` ((B, 1); None: the last greedy token) at
        ``position``; ``token`` becomes the next greedy token, at the next
        position."""
        check_fits(self.max_len, self._length, 1)
        if token is not None:
            self.token.copy_(token)
        self._length += 1
        self._graphs.run(self._body, "decode step")

    def _step(self) -> None:
        logits, _ = decode_step(self._model(), self.cfg, self.token, self.position, self.cache,
                                long_context=self.long_context)
        self._take(logits)

    def _take(self, logits: torch.Tensor) -> None:
        self.logits.copy_(logits)
        self.token.copy_(logits.argmax(dim=-1, keepdim=True))
        self.position.add_(1)
        self.tokens.scatter_(1, self.position, self.token)


_DECODERS: "weakref.WeakKeyDictionary[torch.nn.Module, Decoder]" = weakref.WeakKeyDictionary()


def decoder_for(model, cfg: ModelConfig, batch: int, max_len: int, *,
                long_context: bool = False) -> Decoder:
    """``model``'s decoder at ``(batch, max_len)`` in the mode of
    ``long_context``: the one it kept, if it serves that shape, that mode
    and the model's weights, else a new one (which replaces it)."""
    _same_config(model, cfg)
    dec = _DECODERS.get(model)
    if dec is None or not dec._serves(model, batch, max_len, long_context):
        dec = _DECODERS[model] = Decoder(model, cfg, batch, max_len, long_context=long_context)
    return dec


def generate(
    model,
    cfg: ModelConfig,
    prompt,
    *,
    max_new_tokens: int = 16,
    image_embeds: torch.Tensor | None = None,
    frames: torch.Tensor | None = None,
    long_context: bool = False,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Greedy generation: (B, max_new_tokens) int64 tokens on ``device``.

    ``prompt`` is a (B, S) integer array or tensor; ``device`` (None =
    CUDA) must be the model's device. The VLM's prompt follows its
    ``image_embeds`` (B, P, d); whisper's decoder reads the encoder's
    states of ``frames`` (B, num_frames, d). The decode steps run through
    the model's :class:`Decoder` at ``(B, P + S + max_new_tokens + 1)``;
    the tokens returned are those after the image and the prompt.
    ``long_context=True`` decodes in the long-context mode (a decoder of
    its own).
    """
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f"the model is on {model_device}, generate was asked for {device}")
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=model_device)
    B, S = prompt.shape
    total = _offset(image_embeds) + S
    dec = decoder_for(model, cfg, B, total + max_new_tokens + 1, long_context=long_context)
    dec.start(prompt, image_embeds=image_embeds, frames=frames)
    for _ in range(max_new_tokens - 1):
        dec.step()
    with torch.inference_mode():
        return dec.tokens[:, total : total + max(max_new_tokens, 1)].clone()



# ---------------------------------------------------------------------------
# The sharded serve setup (the reference's make_serve_setup)
# ---------------------------------------------------------------------------

def _cache_spec(name: str, shape: tuple, sizes: dict) -> tuple:
    """The reference's ``_cache_specs_for`` of one leaf (no group axis):
    the batch over ``data`` (with ``pod``, ``("pod", "data")``); keys and
    values over ``model`` on the kv heads, else head_dim, else the
    sequence; MLA's latents on their last dimension, else the sequence;
    whisper's ``encoder_out`` on its features; recurrent states and conv
    tails on their last dimension; a 0-d ``index`` whole."""
    from repro_torch.train.sharding import sanitize_spec

    rank = len(shape)
    if rank == 0:
        return ()
    dims: list = [None] * rank
    dims[0] = ("pod", "data") if "pod" in sizes else "data"
    msize = sizes["model"]

    def try_model(i: int) -> bool:
        if 0 < i < rank and shape[i] % msize == 0:
            dims[i] = "model"
            return True
        return False

    if name in ("k", "v") and rank == 4:  # (B, S, H, D)
        _ = try_model(2) or try_model(3) or try_model(1)
    elif name in ("c_kv", "k_rope"):  # (B, S, r)
        _ = try_model(2) or try_model(1)
    elif name == "encoder_out":  # (B, F, D)
        try_model(2)
    else:  # recurrent states / conv tails: the last (feature) dimension
        try_model(rank - 1)
    return sanitize_spec(tuple(dims), shape, sizes)


def _map_cache(fn, cache, flags: bool = True):
    """``fn(name, leaf)`` over every tensor of a cache (per-layer dicts, or
    whisper's ``{"encoder_out", "self"}``); non-tensor entries (an MLA
    ring's flag) kept as they are with ``flags``, else left out."""
    def layer(d: dict) -> dict:
        return {k: fn(k, v) if isinstance(v, torch.Tensor) else v for k, v in d.items()
                if flags or isinstance(v, torch.Tensor)}

    if isinstance(cache, dict):
        return {"encoder_out": fn("encoder_out", cache["encoder_out"]),
                "self": [layer(d) for d in cache["self"]]}
    return [layer(d) for d in cache]


def cache_specs_for(cache, mesh) -> list | dict:
    """The spec of every cache leaf on ``mesh`` (a ``DeviceMesh`` or its
    sizes), in the cache's structure: the reference's ``_cache_specs_for``
    without the group axis's None."""
    from repro_torch.train.sharding import mesh_sizes

    sizes = mesh_sizes(mesh)
    return _map_cache(lambda name, t: _cache_spec(name, tuple(t.shape), sizes), cache,
                      flags=False)


def _block_shape(shape: tuple, spec: tuple, sizes: dict) -> tuple:
    from repro_torch.train.sharding import _axes

    return tuple(s // (1 if e is None else math.prod(sizes[a] for a in _axes(e)))
                 for s, e in zip(shape, tuple(spec) + (None,) * len(shape)))


@dataclasses.dataclass
class ServeSetup:
    """The reference's ``ServeSetup`` for a rank of the mesh: ``serve_step``
    ``(params, token, position, cache) -> (logits, cache)`` (a rank's
    parameter blocks, its rows of the (B, 1) token and position, its cache
    block written in place; logits (B_rank, V) whole over the
    vocabulary), ``param_specs``, ``cache_specs`` (the cache's
    structure), ``abstract_cache`` (meta tensors of the whole cache),
    ``n_kv_shardable``; and what the port adds: ``prefill`` ``(params,
    tokens, cache, *, image_embeds=, frames=) -> logits`` (the sharded
    prefill into a fresh cache block), ``init_cache()`` (the rank's block,
    fresh, on the mesh's device), ``local_batch`` (a rank's rows of a
    (B, ...) tensor) and ``decoder`` (a captured ``MeshDecoder``)."""

    serve_step: Callable
    param_specs: dict
    cache_specs: list | dict
    abstract_cache: list | dict
    n_kv_shardable: bool
    prefill: Callable
    init_cache: Callable
    local_batch: Callable
    cfg: ModelConfig
    batch: int
    seq_len: int
    long_context: bool
    device: torch.device
    sizes: dict  # the mesh's
    shapes: dict  # name -> (shape, element size)

    def decoder(self, params: dict, cache) -> "MeshDecoder":
        """A decoder of ``params`` over the rank's ``cache`` block."""
        return MeshDecoder(self, params, cache)

    def param_bytes(self) -> int:
        """Bytes of a rank's parameter blocks at rest."""
        return sum(math.prod(_block_shape(self.shapes[k][0], spec, self.sizes))
                   * self.shapes[k][1] for k, spec in self.param_specs.items())

    def cache_bytes(self) -> int:
        """Bytes of a rank's cache block."""
        total = []
        _map_cache(lambda name, t: total.append(math.prod(_block_shape(
            tuple(t.shape), _cache_spec(name, tuple(t.shape), self.sizes), self.sizes))
            * t.element_size()), self.abstract_cache)
        return sum(total)


def make_serve_setup(
    cfg: ModelConfig,
    mesh,
    *,
    batch: int,
    seq_len: int,
    long_context: bool = False,
    device: torch.device | str | None = None,
) -> ServeSetup:
    """The decode step and placements for a ``(cfg, batch, cache length)``
    shape on ``mesh`` (a ``DeviceMesh`` with the reference's axis names,
    every rank calling). ``device`` (None = CUDA; ``"meta"`` inside
    ``device.shapes_only``, as the dry run runs) holds a rank's blocks. The prefill runs the kernels (``impl="kernel"``: flash, the
    RG-LRU scan), as the one-card ``prefill`` does."""
    from repro_torch.train import sharding
    from repro_torch.train import tensor_parallel as TP

    sizes = sharding.mesh_sizes(mesh)
    if "model" not in sizes or "data" not in sizes:
        raise ValueError(f"a serve mesh has data and model dimensions, got {tuple(sizes)}")
    audio = cfg.arch_type == "audio"
    long_context = _long_context(cfg, long_context)
    meta = whisper.Whisper(cfg, "meta") if audio else transformer.LM(cfg, "meta")
    shapes = {k: (tuple(p.shape), p.element_size()) for k, p in meta.named_parameters()}
    param_specs = sharding.make_param_specs({k: v[0] for k, v in shapes.items()}, sizes, cfg=cfg)
    with shapes_only():
        abstract = _init_cache(cfg, batch, seq_len, "meta", long_context)
    cache_specs = cache_specs_for(abstract, sizes)
    dp = ("pod", "data") if "pod" in sizes else ("data",)
    n_dp = math.prod(sizes[a] for a in dp)
    device = resolve_device(device)
    coords = sharding.mesh_coords(mesh)
    tp = TP.TPGroup.of(mesh.get_group("model") if sizes["model"] > 1 else None)
    plan = TP.make_plan(cfg, param_specs, tp.size)
    window = _window(cfg, long_context)
    split_batch = batch % n_dp == 0 and n_dp > 1
    row0, rows = (sharding._block(dp if len(dp) > 1 else dp[0], sizes, coords)[0] * (batch // n_dp),
                  batch // n_dp) if split_batch else (0, batch)
    table = sinusoidal_positions(whisper.MAX_POSITIONS, cfg.d_model, dtype_of(cfg), device) \
        if audio else None

    def local_batch(x: torch.Tensor) -> torch.Tensor:
        return x.narrow(0, row0, rows).contiguous()

    def init_cache():
        def leaf(name, t):
            spec = _cache_spec(name, tuple(t.shape), sizes)
            out = torch.zeros(_block_shape(tuple(t.shape), spec, sizes), dtype=t.dtype,
                              device=device)
            return out.fill_(-1e30) if name == "m" else out

        return _map_cache(leaf, abstract)

    def encoder_states(cache) -> torch.Tensor:
        enc = cache["encoder_out"]
        return enc if enc.shape[-1] == cfg.d_model else parallel.gather_dim(enc, tp, 2)

    @torch.no_grad()
    def serve_step(params: dict, token: torch.Tensor, position: torch.Tensor, cache):
        if audio:
            hidden = TP.whisper_serve_hidden(params, cfg, plan, tp, token, position, cache,
                                             encoder_states(cache), table)
        else:
            hidden = TP.serve_hidden(params, cfg, plan, tp, token, position, cache,
                                     window=window)
        return TP.logits(params, cfg, plan, tp, hidden[:, -1:])[:, 0], cache

    @torch.no_grad()
    def prefill_fn(params: dict, tokens: torch.Tensor, cache, *,
                   image_embeds: torch.Tensor | None = None,
                   frames: torch.Tensor | None = None) -> torch.Tensor:
        B, S = tokens.shape
        total = _offset(image_embeds) + S
        if not long_context:
            check_fits(seq_len, 0, total)
        pos = torch.arange(total, device=tokens.device)[None].expand(B, total)
        if audio:
            if frames is None:
                raise ValueError("whisper's prefill needs frames")
            enc = TP.whisper_encode(params, cfg, tp, frames)
            cache["encoder_out"].copy_(enc if cache["encoder_out"].shape[-1] == cfg.d_model
                                       else parallel.own_block(enc, tp, 2))
            hidden = TP.whisper_serve_hidden(params, cfg, plan, tp, tokens, pos, cache, enc,
                                             table)
        else:
            hidden = TP.serve_hidden(params, cfg, plan, tp, tokens, pos, cache, window=window,
                                     image_embeds=image_embeds)
        return TP.logits(params, cfg, plan, tp, hidden[:, -1:])[:, 0]

    return ServeSetup(serve_step=serve_step, param_specs=param_specs, cache_specs=cache_specs,
                      abstract_cache=abstract,
                      n_kv_shardable=cfg.num_kv_heads % sizes["model"] == 0,
                      prefill=prefill_fn, init_cache=init_cache, local_batch=local_batch, cfg=cfg,
                      batch=batch, seq_len=seq_len, long_context=long_context, device=device,
                      sizes=sizes, shapes=shapes)


class MeshDecoder:
    """Greedy decoding on a rank of a ``ServeSetup``'s mesh, the step
    captured: static ``token`` / ``position`` (B_rank, 1) int64 and
    ``logits`` (B_rank, V); :meth:`start` prefills a prompt into the
    rank's ``cache`` block (eagerly), :meth:`step` decodes ``token`` (the
    last greedy token, or one the caller gives) through
    ``repro_torch.graphs``: eagerly at its first run, a CUDA graph (the
    collectives inside it) captured at its second, replays after; on the
    CPU eagerly, counted as on the card. A failed capture raises."""

    def __init__(self, setup: ServeSetup, params: dict, cache):
        cfg, device = setup.cfg, setup.device
        self.setup, self.params, self.cache = setup, params, cache
        rows = setup.local_batch(torch.zeros((setup.batch, 1))).shape[0]
        self.token = torch.zeros((rows, 1), dtype=torch.int64, device=device)
        self.position = torch.zeros((rows, 1), dtype=torch.int64, device=device)
        self.logits = torch.zeros((rows, cfg.vocab_size), dtype=dtype_of(cfg), device=device)
        self._graphs = GraphRunner("serve.mesh_decode", device)
        self._body = Body(self._step)
        self._length = 0

    @property
    def n_captures(self) -> int:
        return self._graphs.n_traces

    def start(self, prompt: torch.Tensor, *, image_embeds: torch.Tensor | None = None,
              frames: torch.Tensor | None = None) -> torch.Tensor:
        """Prefill the rank's rows ``prompt`` (B_rank, S) into the cache
        (fresh: ``init_cache``'s values); returns the prefill's logits."""
        logits = self.setup.prefill(self.params, prompt, self.cache, image_embeds=image_embeds,
                                    frames=frames)
        total = _offset(image_embeds) + prompt.shape[1]
        self.position.fill_(total - 1)
        self._take(logits)
        self._length = total
        return logits

    def step(self, token: torch.Tensor | None = None) -> None:
        """Decode ``token`` ((B_rank, 1); None: the last greedy token) at
        ``position``; ``logits`` holds the step's."""
        if not self.setup.long_context:
            check_fits(self.setup.seq_len, self._length, 1)
        if token is not None:
            self.token.copy_(token)
        self._length += 1
        self._graphs.run(self._body, "mesh decode step")

    def _step(self) -> None:
        logits, _ = self.setup.serve_step(self.params, self.token, self.position, self.cache)
        self._take(logits)

    @torch.no_grad()
    def _take(self, logits: torch.Tensor) -> None:
        self.logits.copy_(logits)
        self.token.copy_(logits.argmax(dim=-1, keepdim=True))
        self.position.add_(1)
