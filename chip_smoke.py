#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--save-table PATH]

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels`` (one
nvcc per source, all at once) and then, on the card:

0. prints the card (``nvidia-smi``), the torch and CUDA versions and the
   kernels' build time;
1. holds each kernel against its plain PyTorch version on the same
   inputs, at the main paths' shapes, with the reference's tolerances
   (gossip: float32 1e-5; flash attention: float32 2e-3; RG-LRU scan:
   float32 1e-4; bfloat16 3e-2, but 1e-2 for flash attention, whose
   outputs over a 2048 window are ~0.04), and times the kernel, the plain
   version and one library call computing the same function (median of
   30 launches, CUDA events); it also prints which kernel design ran
   (gossip_schedule: a shared-memory tile in float32, the L2 gather in
   bfloat16 and for n = 4096; gossip_mix and flash_attention: by dtype
   and n; rglru_scan: its tiling, with a 32768-step case for a long
   look-back chain), and the headline rows of gossip_schedule, gossip_mix
   and flash_attention must be faster than the library call; two launches
   of rglru_scan on the same inputs must be bitwise equal (every scan
   case, and bfloat16 at (2, 4096, 2560) and (2, 32768, 2560)); the
   flash rows include phase 8's, 9's, 10's and 11's layers (qwen3-0.6b,
   qwen3-0.6b's long-context prefill at S = 8192, window 4096, qwen2.5-14b, qwen3-moe-30b-a3b, llava-next-mistral-7b, gemma-2b,
   gemma2-2b local at S = 8192 and global, softcap 50; SDPA has no
   softcap, so those rows time it without one, beside the row); the
   flash backward (``flash_attention_bwd``: the saving forward under
   autograd, then the dQ and dK / dV kernels) at the LM cell's layer
   (2, 1024, 16 / 8, 128, causal) and recurrentgemma-2b's: dq, dk and dv
   against autograd through the plain version in float32, each element
   within 2^-7 of its value plus 2^-9 of the largest, two backward calls
   bitwise equal, timed beside the plain backward and SDPA's (its bound
   10 D flops a kept pair and head); the
   device auction LMO on the cold and warm STL-FW gradients of phase 6b's
   label-shard Pi (n = 100), of a Dirichlet(0.1) label partition at n =
   128, 512 and 1024 (2048 cut for time), and on tied integers: its
   assignment, prices and counters identical to the plain version's (run on the host, in
   worker processes), its objective scipy's within 1e-9; the kernel's ms
   beside the whole call's, the plain version's, the numpy auction's and
   scipy's (host times the median of 3, taken with no worker running);
2. drives the D-SGD main path through the user's entry points -- Pi from
   a label-skew partition, ``learn_topology``, ``schedule_from_result``,
   ``run_classification`` / ``run_mean_estimation`` on ``cuda`` -- and
   checks accuracies, losses, errors and the kernels' launch counts;
   ``learn_topology(lmo="auction_jit")`` at n = 512, budget 64, against
   ``lmo="scipy"`` (the objective and step-size traces within 1e-9); 2d,
   the transport table: ``autotune_transport(measure=True)`` over n 64-
   2048 x L 2-64 into a temporary file (``--save-table`` copies it out),
   phase 2b's own bucket first at 2b's n 100 and 10 communication atoms,
   each bucket's two transport times (``mix_stacked`` on a pytree of
   phase 2b's leaf widths, then the update that reads its output) beside
   the closed form's pick; phase 6b holds the pick at phase 2b's bucket
   to the two arms' ms/step;
3. scores sequences with recurrentgemma-2b at its full width (random
   weights from seed 0, bfloat16, B = 2, S = 4096) through
   ``registry.loss_fn`` / ``model_forward``: 8 flash_attention and 18
   rglru_scan launches a forward, the loss against the plain path, against
   a float64 cross entropy of the forward's logits and above ln(vocab) - 1
   (random labels); then the same model in float32 at depth 3, kernel
   path against plain path; tokens/s and the device busy share;
4. serves it: ``serve.engine.generate`` (B = 2, a 2560-token prompt, 32
   new tokens: the prompt overruns the 2048 window, so the prefill's
   flash kernel runs with the window, the ring keeps the prompt's last
   2048 positions, and decode wraps the ring),
   whose decode step is a CUDA graph, against an eager loop over
   ``decode_step``: identical tokens, each step's logits bitwise equal,
   one capture; prefill launches (flash_attention on every attention
   layer but MLA's and whisper's); graph and eager decode ms/token (the
   decode steps alone, after an untimed prefill), device busy shares, device operations
   per token, the capture's ms; 4b, decode consistency in float32 at
   depth 3 through the decoder (three steps: warm-up, capture, replay);
5. runs the smoke configs' kernel paths on the card against their plain
   paths on the CPU (recurrentgemma-2b, xlstm-350m, whisper-small,
   llava-next-mistral-7b);
6. drives the captured D-SGD rollout (``rollout="scan"``: CUDA graphs)
   and online topology adaptation: both gossip kernels captured in a
   graph and swapped by ``copy_``; 6a, the reference's online acceptance
   run (abrupt label swap, frozen / oracle / online arms: log-space
   recovery >= 0.8, one capture per arm); 6b, phase 2b's MNIST-width MLP
   on a ``ScheduleArrays`` with an ``OnlineTopologyController`` (inline:
   graph against loop, equal losses and swaps, one capture; overlap:
   every swap collected without blocking, a final flush), and, printed,
   loop against graph ms/step and device busy share on phase 2b's arms
   (the transport phase 2d's table picks there must be within 5% of the
   faster arm's graph ms/step); 6c, a cold solve and a warm STL-FW refresh at n = 512 with the scipy
   and the device LMO (equal objectives), and 6b's controller with the
   device LMO, inline and in overlap mode (one capture an arm);
7. drives the robustness layer in the captured rollout: 7a, phase 6b's
   run with health probes (tau_bar at the controller's live Pi_hat)
   bitwise the probes-off run, and the probes' cost per step; 7b, phase
   2b's shape with a swap under the wires none / identity / bf16 /
   topk:0.1:g0.25 (identity bitwise none, bf16 half the bytes, top-k
   k * 8, graph bitwise loop); 7c, bounded-delay gossip there (zero
   delays bitwise fresh; wait, degrade, wait + bf16) and its ms per step;
   7d, ``run_faulty_mean_estimation`` at ``benchmarks/bench_faults.py``'s
   sizes: a fault-sweep cell, the straggler bars (wait 1.1x, degrade
   1.2x of fault-free), the corruption bar (1.2x, all four modes), the
   crash-recovery drill resumed bitwise; one capture an arm;
8. drives each dense GQA family (qwen3-0.6b, gemma-2b, gemma2-2b,
   qwen2.5-14b) at its published widths and full depth, one at a time,
   random bf16 weights from seed 0: scoring at B = 2, S = 4096 (one
   flash_attention launch per attention layer and forward: 28 / 18 / 26
   / 48; the loss within 1e-2 of the plain path and above ln(vocab) -
   1), f32 at depth 3 (kernel against plain path at 1e-4, decode through
   the decoder within 2e-3 of the full forward), serving as in phase 4
   (a 2560-token prompt, gemma2 4608 to overrun its 4096 window; 32 new
   tokens; graph against eager), and the phase's seconds;
9. drives the MoE families the same way, one at a time after phase 8
   has freed its models: qwen3-moe-30b-a3b at its published widths and
   full depth (48 flash_attention launches a scoring forward) and
   deepseek-v2-236b at its published widths cut to 4 layers (MLA is plain
   on every path: no flash_attention launch), random bf16 weights from
   seed 0, B = 2: scoring at S = 4096 (the loss within 1e-2 of the plain
   path, the NLL above ln(vocab) - 1, the router aux and the share of
   token-choices dropped at capacity factor 1.25), serving (a 2560-token
   prompt, 32 new tokens, the captured decode bitwise the eager loop, one
   capture; decode ms/token beside the weights' bound), f32 at depth 3
   (kernel against plain path at 1e-4, the kernel path routed to the plain
   path's experts; the unpinned error and its swapped routes printed) and
   decode through the decoder within 2e-3 of the full forward at capacity
   factor E / K (nothing drops: a listed cut), and the phase's seconds;
10. drives the last three families the same way, one at a time after
   phase 9 has freed its models, random bf16 weights from seed 0, B = 2,
   stub frames and patch embeddings N(0, 0.1) from seed 0:
   xlstm-350m (scoring at S = 4096: the chunkwise mLSTM and the sLSTM time
   loop as CUDA graphs, bitwise the eager loop over the whole forward,
   tokens/s for both loops, no kernel launch; serving a 2560-token prompt,
   32 new tokens; f32 at depth 4, where the pattern's sLSTM is layer 3:
   decode through the decoder within 2e-3 of the full forward);
   whisper-small (scoring 1500 frames and 448 decoder tokens, its
   attention plain; serving a 64-token prompt, 32 new tokens; f32 at full
   depth, decode within 2e-3); llava-next-mistral-7b at full depth
   (scoring 2880 patches and 1216 tokens with 32 flash_attention launches
   a forward; f32 at depth 3, kernel against plain path at 1e-4, decode
   within 2e-3; serving 2880 patches, a 512-token prompt, 32 new tokens);
   each family's captured decode bitwise its eager loop with one capture,
   decode ms/token beside the weight bound, and its seconds;
11. serves in the long-context mode (``generate(long_context=True)``: a
   window ring of ``long_context_window`` = 4096 slots on every attention
   layer, MLA's latent ring of 4096 that wraps), random bf16 weights from
   seed 0, B = 2, 32 new tokens: qwen3-0.6b at full width and depth (an
   8192-token prompt: 28 flash_attention launches with the window in the
   prefill) and deepseek-v2-236b at phase 9's 4 layers (a 4608-token
   prompt: the MLA ring wraps in the prefill and again while decoding).
   The captured long-context decode bitwise its eager loop, one capture;
   decode ms/token with the rings beside the full caches (8225 / 4641
   slots, a decoder of its own: its captures printed); prefill ms of both
   modes (both in the flash kernel, with and without the window). In float32 at depth 3 and B = 1 (deepseek at capacity factor
   E / K, so nothing drops, and at a window of 512 after a 1024-token
   prompt), the prefill and 8 long-context decode steps after the prompt
   within 2e-3 of the plain full forward (``impl="plain"``) with
   ``window_override`` at the same positions;
12. trains qwen3-0.6b at full width, 14 of its 28 layers (``TRAIN``), in
   bf16 with the LM trainer
   (``train.lm_trainer.make_train_setup``): 4 stacked nodes, per-node
   batch 2 x 1024 tokens (8192 a step), lr 1e-3, the STL-FW topology of
   a 4-domain, one-domain-per-node Pi at budget 2; batches drawn on the
   card from the ``DomainSkewCorpus`` domains (the host ``TokenBatcher``
   is timed once: ~0.3 G Gumbel draws a node-batch at this vocabulary).
   Arms, 6 steps in segments of 2 (a cut, from 12 in segments of 4,
   then 8: phases 13 and 14 need the time; the last segment still a
   replay;
   the forward keeps its activations, no recomputation): (a) dsgd, static schedule,
   ``rollout="scan"``; (b) the same with ``"loop"``, bitwise (a); (c)
   ``online_w`` on its ``ScheduleArrays`` through ``run_segments`` with
   one swap (no capture added); (d) fsdp on the same 8192 tokens, in 4
   microbatches of 2 sequences (``grad_accum``); (e)
   momentum 0.9, ``gossip_every`` 2; (f) the complete graph (the dense
   mix). Each arm's ms/step, training tokens/s, first and last losses
   (the last lower), peak memory, gossip launches, and the step's bound
   (6 x params x tokens at 989 TFLOP/s) with the share reached; one
   step's parameters bitwise the kernel mix (``gossip_schedule``,
   ``gossip_mix``) of its half-step; that half-step plus N(0, 0.02) noise
   per node through each kernel within one bfloat16 rounding (2^-7
   relative, plus 1e-6) of the plain version, where the unmixed input
   misses by more than 10 times that. Then the robustness options on the
   stacked nodes (``phase_lm_robust``, 4-6 steps an arm, a cut): (g) the
   staged pool (the schedule's atoms and an identity slot) through
   ``run_segments`` in segments of one step, an in-pool ``PoolSwap``
   after step 1 and a restage after step 2 (one rebuild), 5 steps
   captured and looped, bitwise equal; (h) the pool with the bf16 wire
   and bounded delay (wait, tau_max 1: the float32 EF memory and a bf16
   ring of 2 carried), 4 steps from raw delays in {0, 1, 2}, loop; (i)
   probes (``consensus``, ``grad_dev``) on the ``ScheduleArrays``, 6
   steps captured in segments of 2, bitwise its probes-off twin; (j) the
   degrade policy with raw delays and node 1 quarantined (the meter's
   quarantined bytes) on the all-gather transport, 6 steps captured.
   Each arm launches ``gossip_schedule`` and prints ms/step (the last
   segment), peak memory, losses and launches. In every arm of phases
   12-14 the flash calls are counted from just before the arm's steps:
   one backward (``flash_attention_bwd``) a layer, node and step, and as
   many forwards (twice as many where the backward recomputes the layers,
   phases 13 and 14, and one more a layer where a loss is read without
   gradient); phase 14's other families train no attention through the
   kernels;
13. trains phase 12's model (qwen3-0.6b at full width, 14 layers) in bf16
   with one node per
   rank (``make_train_setup(cfg, group=...)``): four rank processes
   (spawned) share the card, each with its own ``NCCL_HOSTID`` (NCCL
   refuses two ranks on one device otherwise, and then moves bytes over
   its socket transport on loopback), phase 12's per-node batch, seed
   and batches; each rank's allocator is held to a quarter of the card,
   and each recomputes its layers' activations in the backward pass
   (``remat=True``; the no-recomputation gradient pass in 2 microbatches
   is measured beside it, its peak printed). First the transports on qwen3-0.6b's
   distinct leaf widths (the embedding, one layer, the final norm; float32
   nodes from a seed): each rank's output against the stacked kernels'
   (``gossip_schedule`` / ``gossip_mix``) on the same four nodes within a
   float32 rounding of each summed term (3xTF32 for ``gossip_mix``),
   all-gather bitwise the pool, zero delays bitwise the fresh transports,
   the identity wire bitwise no compression, and the all-gather's peak
   within n gathered rows of the largest leaf, the outputs and four
   leaf-sized temporaries (+10%). Then the arms, a few steps each
   (``RANKS["steps"]``): (a) ``online_w`` on a ``ScheduleArrays``
   (all-gather), its per-node losses of steps 1-2 within 1e-2 of phase
   12's stacked run from the same initial parameters (checked by a
   float64 checksum) and batches, its step's peak within its gradient
   pass's plus n gathered rows of the largest leaf (+10%), then its
   parameters of the distinct widths checkpointed (rank 0 writes the
   stacked layout, node axis first; its peak within n rows of the largest
   bfloat16 leaf, another rank's within one, +10%); (b) the staged
   pool with an in-pool ``PoolSwap`` and then a restage from the hook (one
   rebuild); (c) the pool with the bf16 wire and bounded delay (tau_max 1,
   delays from ``straggler_pool_stream``); (d) a static schedule
   (``mix_ppermute``) captured (``rollout="scan"``) bitwise its loop, 2
   steps each, and the complete graph (``pmean``), 1 step. Arm (a)'s
   ranks draw phase 12's batches (their token sums checked). Arms (b)
   and (c) are phase 12's (g) and (h) over ranks (the same pool, hook,
   delays, seed and batches): their losses within 1e-2 of (g)'s and
   (h)'s at every step. Every arm's loss on its first batch falls. Printed: ms/step, the bytes a rank received a step
   beside ``mix_bytes_per_step``'s model (the reference's float32
   accounting: a bfloat16 leaf moves as bfloat16), each rank's peak memory, the
   backend, the time to spawn and initialise the ranks; the yardstick's
   kernel launches (in the ranks) count as the phase's;
14. trains phase 12's model in bf16 on a mesh of four NCCL ranks sharing
   the card (``make_train_setup(cfg, mesh=...)``; one spawn and one
   process group, a ``DeviceMesh`` an arm; phase 13's NCCL environment,
   memory cap and ``remat=True``; phase 12's seed, lr and batches, nodes
   0 and 1): (a) dsgd on ``(data 2, model 2)`` -- each node's replica
   split over ``model``, tensor-parallel -- with a static STL-FW schedule
   of 2 nodes, 2 steps captured (``rollout="scan"``; then one more
   replay, timed alone) bitwise the same
   steps' loop, each node's loss before each step within 1e-2 of a
   stacked 2-node run of the same batches through ``gossip_schedule``,
   and no all-gather in the step; (b) fsdp on ``(2, 2)``, 2 steps, the
   losses within 1e-2 of a one-card fsdp run on the same 4 sequences, a
   rank's parameters at rest at most 1.1 x a quarter of the model; (c)
   dsgd_pod on ``(pod 2, data 2, model 1)``, the complete graph, 2 steps,
   within 1e-2 of the stacked complete graph (``gossip_mix``) on each
   pod's sequences; (d)-(g) the other families tensor-parallel
   (``TP_FAMILIES``; published widths, depths cut): recurrentgemma-2b at
   3 layers (one of each kind) on (data 1, model 4) -- its 10 query heads
   split inside a head, the MQA keys gathered, the RG-LRU split --,
   xlstm-350m at 4 layers (one period) on (2, 2), whisper-small whole on
   (2, 2) -- its table split by features --, deepseek-v2-236b at 1 layer
   (~10 GB of bf16 a node: data 1, so only the tensor-parallel
   collectives cross the socket) on (1, 4); 2 steps each in the loop
   (keeping their activations: no recomputation), on
   uniform tokens from the seed (whisper's 448 decoder tokens and stub
   frames N(0, 0.1)), held to a one-card stacked run of the same nodes:
   the losses within 3e-3 (``TP_LOSS_TOL``); and a float32 pass at the
   initial parameters on the first batch's first sequence (its first 512
   tokens, ``float32_pass``), its loss within 1e-4 and its
   gradient, each rank's block of every leaf against the same block of
   the yardstick's, its norm and 4 Gaussian projections within 2e-2 of
   the block's norm (``grad_sketch``, ``TP_GRAD_RTOL``); a rank's
   parameters at rest within 1.1 x the node's over ``model``. Then the
   sharded serve setup on the same ranks (``SERVE``;
   ``engine.make_serve_setup``, each rank's blocks cut by its specs from
   the seed's weights): (h) qwen3-0.6b whole in bfloat16 on ``(2, 2)``,
   the sharded prefill of 4 prompts x 1024 tokens (2 a data rank; flash
   on each rank's 8 query and 4 kv heads: 28 launches a rank), 16 decode
   steps by ``serve_step`` and again through a captured ``MeshDecoder``
   (its NCCL collectives in the graph): every step's logits within 3e-2
   of the one-card ``prefill`` / ``decode_step`` yardstick's largest
   magnitude, the captured steps bitwise the eager ones, one capture a
   rank, a rank's cache at rest its specs' block in bytes, and its
   parameters, cache and inputs the dry run's ``argument_bytes`` for
   the same shape (``launch/dryrun.py`` on a fake (2, 2) group, in a
   process of its own); (i) recurrentgemma-2b at 3 layers and (j)
   deepseek-v2-236b at 1 layer in float32 on ``(1, 4)`` (the weights
   drawn in bfloat16 and cast), a prefill and 4 decode steps, within 1e-4
   -- (i): its single kv head's cache split by head_dim, the RG-LRU state
   by features, ``rglru_scan`` on a rank's features; (j): MLA's latent
   cache split by its last dimension and gathered a step. Printed per
   arm: decode ms/token (captured and eager), prefill seconds, the
   collectives and bytes a token by kind, each rank's peak memory and
   resident bytes. After the phase the training CLI (``python -m
   repro_torch.launch.train``, ``CLI_ARGS``: qwen3-0.6b whole, 4 stacked
   nodes) runs in a process of its own: it exits 0 with finite losses;
   its s/step.
   ``scripts/tp_fault_drill.py`` plants a fault in these arms and shows
   that the checks catch it. The yardsticks run in this process before
   the spawn; their launches count as the phase's. Printed: ms/step a rank (the
   captured leg's replay), bytes a rank receives a step by collective
   beside the model's bytes, collectives a step by kind, peak memory
   and parameters at rest a rank, spawn, init and mesh seconds;
15. prints one JSON line per kernel set, then the card's name and power
   limit, then ``{"ok": true, "device": ...}`` as the last line.

Every ``#`` result line ends with the card's name and power limit.
Any failed check raises, so the script exits non-zero and prints no
result; so it does without CUDA or outside a checkout of the repo.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.optimize import linear_sum_assignment  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.assignment import _quantize, auction_assignment  # noqa: E402
from repro_torch.core.assignment_jit import AuctionWorkspace, auction_assignment_jit  # noqa: E402
from repro_torch.core.mixing import (  # noqa: E402
    KERNEL_ROW_ALIGN,
    BirkhoffSchedule,
    PermPool,
    PoolSwap,
    ScheduleArrays,
    StragglerPolicy,
    _bucket_key,
    arrays_to_matrix,
    autotune_transport,
    mix_dense,
    mix_schedule_arrays,
    mix_stacked,
    preferred_transport,
    ravel_stack,
    schedule_from_result,
    schedule_to_arrays,
    unravel_stack,
)
from repro_torch.core.stl_fw import LMOSolver, learn_topology  # noqa: E402
from repro_torch.data.drift import AbruptLabelSwap, labels_stream  # noqa: E402
from repro_torch.data.tokens import DomainSkewCorpus, TokenBatcher  # noqa: E402
from repro_torch.data.partition import dirichlet_partition, shard_partition  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs, mean_estimation_clusters  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.auction import ops as auction_ops  # noqa: E402
from repro_torch.kernels.auction.ref import STATS as AUCTION_STATS  # noqa: E402
from repro_torch.kernels.auction.ref import auction_ref  # noqa: E402
from repro_torch.kernels.gossip_mix import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.gossip_mix.ref import gossip_mix_ref, gossip_schedule_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.models import whisper as whisper_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.common import dtype_of  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.faults import run_faulty_mean_estimation  # noqa: E402
from repro_torch.obs import HealthProbes, Tracer  # noqa: E402
from repro_torch.online import (  # noqa: E402
    OnlineTopologyController,
    RefreshConfig,
    StreamingPiEstimator,
    TopologyRefresher,
)
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import sharding  # noqa: E402
from repro_torch.train.lm_trainer import _sgd_update, gossip_fn, make_train_setup  # noqa: E402
from repro_torch.train.trainer import run_classification, run_mean_estimation  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32_OPS_PER_S = 495e12  # float32 inputs on the tensor cores
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# bf16 flash outputs over a 2048-key window are ~0.04: 3e-2 would hold
# nothing, 1e-2 is a few bf16 ulps of them
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-2}
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
TIMED_LAUNCHES = 30
WARMUP_LAUNCHES = 5

KERNELS = {
    "gossip_schedule": {
        "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_schedule.cu",
        "replaces": "src/repro/kernels/gossip_mix/gossip_schedule.py:58",
    },
    "gossip_mix": {
        "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix/gossip_mix.py:37",
    },
    "flash_attention": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:109",
    },
    # no Pallas counterpart: the reference trains through plain XLA
    "flash_attention_bwd": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
        "replaces": "none: flash_attention_pallas has no backward (the reference's training "
                    "differentiates plain XLA attention)",
    },
    "rglru_scan": {
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/rglru_scan.py:56",
    },
    # no Pallas counterpart: the reference's lax.while_loop auction
    "auction": {
        "source": "src/repro_torch/kernels/auction/csrc/auction.cu",
        "replaces": "src/repro/core/assignment_jit.py:184",
    },
}


@functools.cache
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def note(line: str) -> None:
    """Print a result line with the card's name and power limit beside it."""
    print(f"{line} | {card()}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def device_ms(fn, launches: int = TIMED_LAUNCHES, warmup: int = WARMUP_LAUNCHES) -> float:
    """Median device time of ``fn()`` in ms, one CUDA event pair per launch.

    A ~0.5 ms device sleep is queued before each timed launch, so the
    host has enqueued the launch before the device reaches it and the
    event pair brackets device work, not host overhead.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(launches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Data and topologies of the main path
# ---------------------------------------------------------------------------

def mnist_width_data(n_nodes: int = 100, n_samples: int = 70000, n_train: int = 60000,
                     dim: int = 784):
    """Phase 2b's data: an MNIST-shaped blob set, shard-partitioned."""
    X, y = gaussian_blobs(n_samples, 10, dim=dim, sep=2.5, seed=0)
    idx, Pi = shard_partition(y[:n_train], n_nodes, shards_per_node=2, seed=0)
    return X, y, idx, Pi


def dirichlet_pi(n_nodes: int = 512, samples_per_node: int = 100, alpha: float = 0.3):
    labels = np.random.default_rng(0).integers(0, 10, size=n_nodes * samples_per_node)
    return dirichlet_partition(labels, n_nodes, alpha=alpha, seed=0)[1]


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def schedule_bound(n: int, P: int, L: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time of ``out = sum_l g_l theta[perm_l]`` in ms, and what bounds it."""
    s = torch.finfo(dtype).bits // 8
    t_bytes = (2 * n * P * s + L * n * 4 + L * 4) / HBM_BYTES_PER_S
    t_ops = 2 * L * n * P / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def mix_bound(n: int, P: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time of ``out = W @ theta`` in ms, and what bounds it. float32
    at the 1e-5 parity needs three TF32 products on the tensor cores
    (3xTF32), whichever kernel runs; bfloat16 one bf16 product."""
    s = torch.finfo(dtype).bits // 8
    t_bytes = (2 * n * P + n * n) * s / HBM_BYTES_PER_S
    if dtype == torch.float32:
        t_ops = 3 * 2 * n * n * P / PEAK_TF32_OPS_PER_S
    else:
        t_ops = 2 * n * n * P / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _theta(n: int, P: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n, P), generator=gen, device="cuda").to(dtype)


def _compare(name: str, out: torch.Tensor, plain: torch.Tensor, dtype, tols=TOL) -> float:
    torch.cuda.synchronize()
    check(out.shape == plain.shape and out.dtype == plain.dtype, f"{name}: shape/dtype")
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    err = float((out.float() - plain.float()).abs().max())
    tol = tols[dtype]
    check(torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol),
          f"{name}: max |kernel - plain| = {err:.3e} exceeds atol = rtol = {tol}")
    return err


def schedule_case(label: str, theta: torch.Tensor, gammas: torch.Tensor,
                  perms: torch.Tensor) -> dict:
    n, P = theta.shape
    L = perms.shape[0]
    dtype = theta.dtype
    out = ops.gossip_schedule(theta, gammas, perms)
    plain = gossip_schedule_ref(theta, gammas, perms)
    err = _compare(f"gossip_schedule {label}", out, plain, dtype)
    W = torch.as_tensor(arrays_to_matrix(ScheduleArrays(gammas, perms)), dtype=dtype,
                        device="cuda")  # the densified W, for the library call
    bound, bound_by = schedule_bound(n, P, L, dtype)
    row = {
        "kernel": "gossip_schedule", "case": label, "n": n, "P": P, "L": L,
        "dtype": str(dtype).replace("torch.", ""),
        "design": ops.gossip_schedule_design(n, L, dtype), "max_abs_err": err,
        "kernel_ms": device_ms(lambda: ops.gossip_schedule(theta, gammas, perms)),
        "plain_ms": device_ms(lambda: gossip_schedule_ref(theta, gammas, perms)),
        "library_ms": device_ms(lambda: torch.matmul(W, theta)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    row["GB_per_s"] = (2 * n * P * theta.element_size() + L * n * 4) / row["kernel_ms"] / 1e6
    return row


def mix_case(label: str, theta: torch.Tensor, W: torch.Tensor) -> dict:
    n, P = theta.shape
    dtype = theta.dtype
    Wc = W.to(dtype)  # the wrapper's cast, given to the plain version too
    out = ops.gossip_mix(theta, W)
    plain = gossip_mix_ref(theta, Wc)
    err = _compare(f"gossip_mix {label}", out, plain, dtype)
    design = ops.gossip_mix_design(n, dtype)
    bound, bound_by = mix_bound(n, P, dtype)
    row = {
        "kernel": "gossip_mix", "case": label, "n": n, "P": P,
        "dtype": str(dtype).replace("torch.", ""), "design": design,
        "max_abs_err": err,
        "kernel_ms": device_ms(lambda: ops.gossip_mix(theta, W)),
        "plain_ms": device_ms(lambda: gossip_mix_ref(theta, Wc)),
        "library_ms": device_ms(lambda: torch.matmul(Wc, theta)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    row["TFLOP_per_s"] = 2 * n * n * P / row["kernel_ms"] / 1e9
    return row


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def kept_pairs(S: int, window: int | None) -> int:
    """(q, k) pairs a causal, optionally windowed attention keeps."""
    return int(np.minimum(np.arange(1, S + 1), window or S).sum())


def flash_bound(B: int, S: int, H: int, Hkv: int, D: int, window: int | None,
                dtype: torch.dtype) -> tuple[float, str]:
    """Least time of causal windowed GQA attention in ms, and what bounds it:
    q, k, v read once and out written once; 4 D flops per kept pair and head."""
    s = torch.finfo(dtype).bits // 8
    t_bytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * s / HBM_BYTES_PER_S
    t_ops = 4 * D * kept_pairs(S, window) * B * H / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scan_bound(B: int, S: int, D: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time of the linear scan in ms: a and b read once, h written once
    (2 flops an element, far below the bytes)."""
    s = torch.finfo(dtype).bits // 8
    t_bytes = 3 * B * S * D * s / HBM_BYTES_PER_S
    t_ops = 2 * B * S * D / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _randn(shape, dtype: torch.dtype, seed: int, scale: float = 1.0) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def flash_case(label: str, B: int, S: int, H: int, Hkv: int, D: int, window: int | None,
               dtype: torch.dtype, seed: int, softcap: float = 0.0) -> dict:
    q = _randn((B, S, H, D), dtype, seed)
    k = _randn((B, S, Hkv, D), dtype, seed + 1)
    v = _randn((B, S, Hkv, D), dtype, seed + 2)
    kw = dict(window=window, softcap=softcap)
    out = fa_ops.flash_attention(q, k, v, **kw)
    plain = flash_attention_ref(q, k, v, **kw)
    err = _compare(f"flash_attention {label}", out, plain, dtype, FLASH_TOL)
    # the library yardstick: SDPA with k / v expanded to H heads and an
    # explicit boolean band mask (timed only; the port never calls it). SDPA
    # has no softcap: with one it computes another function, so it is timed
    # beside the row and library_ms stays None
    g = H // Hkv
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1)
    pos = torch.arange(S, device="cuda")
    band = pos[None, :] <= pos[:, None]
    if window is not None:
        band = band & (pos[None, :] > pos[:, None] - window)
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band).transpose(1, 2)
    bound, bound_by = flash_bound(B, S, H, Hkv, D, window, dtype)
    sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band))
    row = {
        "kernel": "flash_attention", "case": label, "shape": [B, S, H, Hkv, D],
        "window": window, "softcap": softcap, "dtype": _name(dtype),
        "design": fa_ops.kernel_design(dtype), "max_abs_err": err,
        "library_max_abs_err":
            None if softcap else float((lib.float() - plain.float()).abs().max()),
        "kernel_ms": device_ms(lambda: fa_ops.flash_attention(q, k, v, **kw)),
        "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v, **kw)),
        "library_ms": None if softcap else sdpa_ms,
        "bound_ms": bound, "bound_by": bound_by,
    }
    if softcap:
        row["sdpa_without_softcap_ms"] = sdpa_ms
    row["TFLOP_per_s"] = 4 * D * kept_pairs(S, window) * B * H / row["kernel_ms"] / 1e9
    return row


# the backward against autograd through the plain version in float32: an
# element within 2^-7 of its value (twice dq / dk / dv's one bfloat16
# rounding) plus 2^-9 of the tensor's largest magnitude (a sum that
# cancels), plus 1e-6 (tests/test_torch_flash_bwd_cuda.py's bound)
FLASH_BWD_REL, FLASH_BWD_ABS, FLASH_BWD_FLOOR = 2.0 ** -7, 2.0 ** -9, 1e-6


def flash_bwd_bound(B: int, S: int, H: int, Hkv: int, D: int,
                    window: int | None) -> tuple[float, str]:
    """Least time of the causal windowed GQA backward in ms, and what bounds
    it: 10 D flops a kept pair and head (S, dP, dV, dK and dQ, five products
    of 2 D); q, k, v, dO, the saved float32 output and log-sum-exp read
    once, dq, dk and dv written once."""
    t_bytes = (2 * (4 * B * S * H * D + 4 * B * S * Hkv * D)
               + 4 * (B * S * H * D + B * H * S)) / HBM_BYTES_PER_S
    t_ops = 10 * D * kept_pairs(S, window) * B * H / PEAK_OPS_PER_S[torch.bfloat16]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_bwd_case(label: str, B: int, S: int, H: int, Hkv: int, D: int, window: int | None,
                   seed: int) -> dict:
    """The bfloat16 backward (``ops.flash_attention`` under autograd: the
    saving forward, then the dQ and dK / dV kernels) against autograd
    through ``flash_attention_ref`` in float32 on the same inputs; timed
    beside that plain backward and SDPA's (bfloat16, k / v expanded, the
    library's yardstick, never called by the port)."""
    bf16 = torch.bfloat16
    q, k, v = (_randn(shape, bf16, seed + i) for i, shape in
               enumerate(((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))))
    dout = _randn((B, S, H, D), bf16, seed + 3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, window=window)
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    plain_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    plain = flash_attention_ref(*plain_leaves, window=window)
    want = torch.autograd.grad(plain, plain_leaves, dout.float(), retain_graph=True)
    errs, excess = [], []
    for name, g, w in zip("qkv", got, want):
        e = (g.float() - w).abs()
        errs.append(float(e.max()))
        excess.append(float((e / (FLASH_BWD_REL * w.abs() + FLASH_BWD_ABS * w.abs().max()
                                  + FLASH_BWD_FLOOR)).max()))
        check(excess[-1] <= 1.0, f"flash_attention_bwd {label} d{name}: {excess[-1]:.3f} x the "
                                 f"bound (max |err| {errs[-1]:.3e})")
    check(all(torch.equal(a, b) for a, b in zip(
        got, torch.autograd.grad(out, leaves, dout, retain_graph=True))),
        f"flash_attention_bwd {label}: two backward calls differ")
    g = H // Hkv
    qt, kt, vt = (t.transpose(1, 2).repeat_interleave(H // t.shape[2], dim=1)
                  .detach().requires_grad_() for t in (q, k, v))
    pos = torch.arange(S, device="cuda")
    band = pos[None, :] <= pos[:, None]
    if window is not None:
        band = band & (pos[None, :] > pos[:, None] - window)
    # causal without a window: SDPA's own causal path, its fastest
    mask = dict(is_causal=True) if window is None else dict(attn_mask=band)
    lib = F.scaled_dot_product_attention(qt, kt, vt, **mask)
    dt = dout.transpose(1, 2)
    bound, bound_by = flash_bwd_bound(B, S, H, Hkv, D, window)
    row = {
        "kernel": "flash_attention_bwd", "case": label, "shape": [B, S, H, Hkv, D],
        "window": window, "dtype": "bfloat16", "group": g,
        "design": "dQ kernel (Q, dO stationary), then dK / dV kernel (K, V stationary, the "
                  "GQA group summed in registers); bf16 wgmma, P and dS as two bf16 parts, "
                  "no atomics",
        "max_abs_err": max(errs), "max_abs_err_qkv": errs, "bound_excess_qkv": excess,
        "bitwise_rerun": True,
        "kernel_ms": device_ms(lambda: torch.autograd.grad(out, leaves, dout,
                                                           retain_graph=True)),
        "plain_ms": device_ms(lambda: torch.autograd.grad(plain, plain_leaves, dout.float(),
                                                          retain_graph=True)),
        "library_ms": device_ms(lambda: torch.autograd.grad(lib, (qt, kt, vt), dt,
                                                            retain_graph=True)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    row["TFLOP_per_s"] = 10 * D * kept_pairs(S, window) * B * H / row["kernel_ms"] / 1e9
    return row


def scan_case(label: str, B: int, S: int, D: int, dtype: torch.dtype, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.rand((B, S, D), generator=gen, device="cuda") * 0.399 + 0.6).to(dtype)
    b = (torch.randn((B, S, D), generator=gen, device="cuda") * 0.2).to(dtype)
    out = scan_ops.rglru_scan(a, b)
    plain = rglru_scan_ref(a, b)
    err = _compare(f"rglru_scan {label}", out, plain, dtype, SCAN_TOL)
    check(torch.equal(scan_ops.rglru_scan(a, b), out),
          f"rglru_scan {label} {_name(dtype)}: two launches on the same inputs differ")
    bound, bound_by = scan_bound(B, S, D, dtype)
    row = {
        "kernel": "rglru_scan", "case": label, "shape": [B, S, D], "dtype": _name(dtype),
        "design": scan_ops.kernel_design(), "max_abs_err": err, "bitwise_rerun": True,
        "kernel_ms": device_ms(lambda: scan_ops.rglru_scan(a, b)),
        "plain_ms": device_ms(lambda: rglru_scan_ref(a, b)),
        "library_ms": None,  # no single PyTorch call computes a linear recurrence
        "bound_ms": bound, "bound_by": bound_by,
    }
    row["GB_per_s"] = 3 * B * S * D * a.element_size() / row["kernel_ms"] / 1e6
    return row


def scan_determinism(B: int, S: int, D: int, dtype: torch.dtype, seed: int) -> None:
    """Three launches of the scan on one input give the same bits (each
    ``scan_case`` checks two)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.rand((B, S, D), generator=gen, device="cuda") * 0.399 + 0.6).to(dtype)
    b = (torch.randn((B, S, D), generator=gen, device="cuda") * 0.2).to(dtype)
    first = scan_ops.rglru_scan(a, b)
    for _ in range(2):
        check(torch.equal(scan_ops.rglru_scan(a, b), first),
              f"rglru_scan ({B}, {S}, {D}) {_name(dtype)}: launches differ")
    note(f"# 1 rglru_scan ({B}, {S}, {D}) {_name(dtype)}: three launches bitwise equal")


def phase_lm_kernels() -> list[dict]:
    """The LM kernels' cases; the first row of each kernel is its headline
    (recurrentgemma-2b's full-width shapes)."""
    bf16, f32 = torch.bfloat16, torch.float32
    scan_determinism(2, 4096, 2560, bf16, 36)
    scan_determinism(2, 32768, 2560, bf16, 37)
    return [
        flash_case("recurrentgemma-2b layer", 2, 4096, 10, 1, 256, 2048, bf16, 20),
        # the dense families' layers (phase 8's scoring shapes)
        flash_case("qwen3-0.6b layer", 2, 4096, 16, 8, 128, None, bf16, 40),
        flash_case("qwen3-0.6b long-context prefill, S=8192", 2, 8192, 16, 8, 128, 4096, bf16,
                   61),
        flash_case("qwen2.5-14b layer", 2, 4096, 40, 8, 128, None, bf16, 43),
        # qwen3-moe-30b-a3b's layer (phase 9's scoring shape)
        flash_case("qwen3-moe-30b-a3b layer", 2, 4096, 32, 4, 128, None, bf16, 55),
        # llava-next-mistral-7b's layer (phase 10's scoring shape: 2880
        # patches + 1216 tokens)
        flash_case("llava-next-mistral-7b layer", 2, 4096, 32, 8, 128, None, bf16, 58),
        flash_case("gemma-2b layer", 2, 4096, 8, 1, 256, None, bf16, 46),
        flash_case("gemma2-2b local layer, S=8192", 2, 8192, 8, 4, 256, 4096, bf16, 49,
                   softcap=50.0),
        flash_case("gemma2-2b global layer", 2, 4096, 8, 4, 256, None, bf16, 52, softcap=50.0),
        flash_case("recurrentgemma-2b layer", 2, 4096, 10, 1, 256, 2048, f32, 21),
        flash_case("f32, S=1024", 1, 1024, 10, 1, 256, 2048, f32, 23),
        flash_case("S=100 ragged", 2, 100, 10, 1, 256, 2048, f32, 26),
        flash_case("S=100 ragged", 2, 100, 10, 1, 256, 2048, bf16, 29),
        # the backward: the LM cell's layer (qwen3-0.6b, causal) first, then
        # recurrentgemma-2b's layer
        flash_bwd_case("qwen3-0.6b training layer, S=1024", 2, 1024, 16, 8, 128, None, 62),
        flash_bwd_case("recurrentgemma-2b layer", 2, 4096, 10, 1, 256, 2048, 63),
        scan_case("recurrentgemma-2b layer", 2, 4096, 2560, f32, 32),
        scan_case("ragged S and D", 3, 1001, 2561, f32, 33),
        scan_case("ragged S and D", 3, 1001, 2561, bf16, 34),
        scan_case("long look-back", 2, 32768, 2560, f32, 35),
    ]


def random_atoms(n: int, L: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """L atoms on n nodes: the identity and L - 1 random permutations with
    positive weights summing to 1 (a schedule too large to learn here)."""
    rng = np.random.default_rng(seed)
    perms = np.stack([np.arange(n)] + [rng.permutation(n) for _ in range(L - 1)])
    g = rng.random(L) + 0.1
    return (torch.as_tensor(g / g.sum(), dtype=torch.float32, device="cuda"),
            torch.as_tensor(perms, dtype=torch.int32, device="cuda"))


def phase_kernels(Pi_mnist: np.ndarray) -> list[dict]:
    """Every kernel case; the first row of each kernel is its headline."""
    res100 = learn_topology(Pi_mnist, budget=10, lam=0.1)
    s100 = schedule_from_result(res100)
    g100, p100 = s100.operands("cuda")
    res512 = learn_topology(dirichlet_pi(512), budget=8, lam=0.1)
    s512 = schedule_from_result(res512)
    padded = schedule_to_arrays(s100, l_max=s100.n_atoms + 5, device="cuda")
    s64 = schedule_from_result(learn_topology(np.eye(8)[np.arange(64) % 8], budget=8, lam=0.5))
    W100 = torch.as_tensor(res100.W, dtype=torch.float32, device="cuda")
    W512 = torch.as_tensor(res512.W, dtype=torch.float32, device="cuda")
    P_mlp = 784 * 64 + 64 + 64 * 10 + 10  # 50890 parameters per node
    P_main = -(-P_mlp // 8) * 8  # the raveled width the main path passes (rows padded to 8)
    rows = [
        schedule_case("phase-2b main path", _theta(100, P_main, torch.float32, 1), g100, p100),
        schedule_case("P=50890 ragged", _theta(100, P_mlp, torch.float32, 2), g100, p100),
        schedule_case("P=50890 ragged", _theta(100, P_mlp, torch.bfloat16, 3), g100, p100),
        schedule_case("phase-2b main path", _theta(100, P_main, torch.bfloat16, 4), g100, p100),
        schedule_case("n=512 dirichlet", _theta(512, 2**20 + 37, torch.float32, 5),
                      *s512.operands("cuda")),
        schedule_case("zero-weight padding", _theta(100, P_main, torch.float32, 6),
                      padded.gammas, padded.perms),
        # phase 6a: n = 64 scalar parameters (rows padded to 8), l_max 17
        schedule_case("phase-6a mean estimation", _theta(64, 8, torch.float32, 12),
                      *schedule_to_arrays(s64, l_max=s64.n_atoms + 8, device="cuda")),
        # too many rows for a shared-memory tile: the l2-gather kernel
        schedule_case("n=4096 l2 gather", _theta(4096, 2**14 + 5, torch.float32, 11),
                      *random_atoms(4096, 9, 11)),
        mix_case("P=50890", _theta(100, P_mlp, torch.float32, 7), W100),
        mix_case("P=50890", _theta(100, P_mlp, torch.bfloat16, 8), W100),
        mix_case("n=512", _theta(512, 2**18 + 37, torch.float32, 9), W512),
    ]
    for leaf, size in (("w1", 784 * 64), ("b1", 64), ("w2", 640), ("b2", 10)):
        rows.append(mix_case(f"phase-2b leaf {leaf}", _theta(100, size, torch.float32, 10), W100))
    return rows


# ---------------------------------------------------------------------------
# Phase 1 (continued): the device auction LMO
# ---------------------------------------------------------------------------

# n = 100 is phase 6b's controller on its own label-shard Pi (not a
# multiple of 64: partial warps and lane loops); the others are
# Dirichlet(0.1) label partitions
AUCTION_SIZES = (100, 128, 512, 1024)  # n 2048 cut: ~35 s of host solves
AUCTION_LAUNCHES = 5  # a solve is one launch of up to ~0.5 s: fewer than 30 timed
AUCTION_REPEATS = 3  # host yardsticks: the median of 3, timed with no worker running
AUCTION_HEADLINE = 512  # the warm solve at n = 512 (phase 6c's and phase 2's n)


class _GradRecorder(LMOSolver):
    """The scipy LMO, keeping each STL-FW gradient it is given."""

    def __init__(self):
        super().__init__("scipy")
        self.grads = []

    def __call__(self, grad):
        self.grads.append(np.array(grad, dtype=np.float64))
        return super().__call__(grad)


def fw_gradients(n: int, Pi: np.ndarray | None = None,
                 steps: int = 3) -> tuple[np.ndarray, np.ndarray, float]:
    """Two consecutive STL-FW gradients of ``Pi`` (None:
    ``dirichlet_pi(n, alpha=0.1)``) and the contraction ``1 - gamma``
    between them: a cold and a warm LMO solve as ``learn_topology`` makes
    them."""
    rec = _GradRecorder()
    Pi = dirichlet_pi(n, alpha=0.1) if Pi is None else Pi
    res = learn_topology(Pi, budget=steps, lam=0.1, lmo=rec)
    k = steps - 2
    return rec.grads[k], rec.grads[k + 1], 1.0 - float(res.gamma_trace[k])


def auction_bound(n: int, phases: int) -> tuple[float, str]:
    """Least time of a solve in ms: one pass over the float64 cost matrix
    per phase (and the prepare pass) at the memory rate, beside the
    vectors read and written once; bytes bound it."""
    t_bytes = ((max(phases, 1) + 1) * n * n * 8 + 28 * n) / HBM_BYTES_PER_S
    return 1e3 * t_bytes, "bytes"


def _objective(cost: np.ndarray, col) -> float:
    col = np.asarray(col)
    return float(cost[np.arange(len(col)), col].sum())


def _auction_kw(n: int, scale: float, have_warm: bool) -> dict:
    """The LMO's solve on the card: validate=False, Jacobi above 64 bidders."""
    return dict(warm_scale=scale, have_warm=have_warm, rel_grid=1e-12, scaling=3000.0,
                forward_reverse=False, validate=False, gs_threshold=64,
                max_iters=500 * n + 200_000)


def plain_auction_job(cost: np.ndarray, warm, kw: dict) -> tuple:
    """The plain version on the host (a worker process: its branches read
    every scalar back, ~0.1 ms a bid on the host, ~0.3 ms on the card)."""
    torch.set_num_threads(1)
    n = cost.shape[0]
    if warm is None:
        warm = (np.zeros(n), np.full(n, -1, dtype=np.int32))
    t0 = time.perf_counter()
    out = auction_ref(torch.from_numpy(cost), torch.from_numpy(warm[0]),
                      torch.from_numpy(warm[1]), **kw)
    return tuple(x.numpy() for x in out) + (time.perf_counter() - t0,)


def _median_ms(fn, repeats: int = AUCTION_REPEATS):
    """``fn()``'s last result and the median of its host ms over ``repeats``."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, float(np.median(times))


def auction_case(n: int, Pi: np.ndarray | None) -> dict:
    """Cold and warm FW-gradient solves at n on the card: the kernel's
    results, the objective held to scipy's, and the host times -- a whole
    ``auction_assignment_jit`` (the pinned copy up, the launch, the
    read-back), scipy and the numpy auction (warm-started as the LMO
    does) -- each the median of ``AUCTION_REPEATS``, taken while no
    worker runs. Device times and the plain version come later."""
    g0, g1, scale = fw_gradients(n, Pi)
    c0 = torch.as_tensor(g0, dtype=torch.float64, device="cuda")
    c1 = torch.as_tensor(g1, dtype=torch.float64, device="cuda")
    ws = AuctionWorkspace(n, "cuda")
    unset = (torch.zeros(n, dtype=torch.float64, device="cuda"),
             torch.full((n,), -1, dtype=torch.int32, device="cuda"))
    kw0, kw1 = _auction_kw(n, 1.0, False), _auction_kw(n, scale, True)
    cold = tuple(x.clone() for x in auction_ops.auction(c0, *unset, **ws.buffers, **kw0))
    warm_in = (cold[1].clone(), cold[0].clone())
    warm = tuple(x.clone() for x in auction_ops.auction(c1, *warm_in, **ws.buffers, **kw1))
    torch.cuda.synchronize()
    # the warm state's prices stay on a workspace of their own, so every
    # timed warm solve starts from the same cold prices
    lmo, held = AuctionWorkspace(n, "cuda"), AuctionWorkspace(n, "cuda")
    (col_cold, _), solve_cold = _median_ms(
        lambda: auction_assignment_jit(g0, validate=False, workspace=lmo))
    _, state = auction_assignment_jit(g0, validate=False, workspace=held)
    (col_warm, _), solve_warm = _median_ms(
        lambda: auction_assignment_jit(g1, state.scaled(scale), validate=False, workspace=lmo))
    check(np.array_equal(col_cold, cold[0].cpu().numpy()) and
          np.array_equal(col_warm, warm[0].cpu().numpy()),
          f"1 auction n={n}: auction_assignment_jit does not return the kernel's assignment")
    q0, q1 = _quantize(g0, 1e-12)[0], _quantize(g1, 1e-12)[0]
    (_, np_state), np_cold = _median_ms(lambda: auction_assignment(q0))
    _, np_warm = _median_ms(lambda: auction_assignment(q1, np_state.scaled(scale)))
    pi_name = "Dirichlet(0.1)" if Pi is None else "phase 6b's label shards"
    rows = []
    for kind, cost, k, solve_ms, np_ms in (("cold", g0, cold, solve_cold, np_cold),
                                           ("warm", g1, warm, solve_warm, np_warm)):
        ref_col, scipy_ms = _median_ms(lambda: linear_sum_assignment(cost)[1])
        obj, ref_obj = _objective(cost, k[0].cpu().numpy()), _objective(cost, ref_col)
        check(abs(obj - ref_obj) <= 1e-9 * max(1.0, abs(ref_obj)),
              f"1 auction n={n} {kind}: objective {obj!r} is not scipy's {ref_obj!r}")
        stats = dict(zip(AUCTION_STATS, k[2].tolist()))
        bound, bound_by = auction_bound(n, stats["phases"])
        rows.append({
            "kernel": "auction", "case": f"n={n} {kind} FW-gradient solve, {pi_name} Pi",
            "n": n, "shape": [n, n], "dtype": "float64", "phases": stats["phases"],
            "rounds": stats["rounds"], "rebid_rows": stats["rebid"], "solve_ms": solve_ms,
            "scipy_ms": scipy_ms, "numpy_auction_ms": np_ms, "library_ms": None,
            "bound_ms": bound, "bound_by": bound_by, "objective_minus_scipy": obj - ref_obj,
            "kernel_out": tuple(x.cpu().numpy() for x in k),
        })
    timed = {"cold": (c0, unset, kw0), "warm": (c1, warm_in, kw1)}
    plain = {"cold": (g0, None, kw0), "warm": (g1, tuple(x.cpu().numpy() for x in warm_in), kw1)}
    return {"n": n, "rows": rows, "ws": ws, "timed": timed, "plain": plain}


def _time_kernel(case: dict) -> None:
    """The kernel's device ms (CUDA events) of each row of ``case``."""
    ws = case["ws"]
    for row, kind in zip(case["rows"], ("cold", "warm")):
        cost, warm, kw = case["timed"][kind]
        row["kernel_ms"] = device_ms(lambda: auction_ops.auction(cost, *warm, **ws.buffers, **kw),
                                     launches=AUCTION_LAUNCHES, warmup=1)


def _collect_auction(case: dict, jobs: list) -> None:
    """The plain version's results beside the kernel's: identical
    assignment, prices and counters."""
    for row, job in zip(case["rows"], jobs):
        plain = job.result()
        kernel = row.pop("kernel_out")
        for name, a, b in zip(("col_of_row", "prices", "stats"), kernel, plain[:3]):
            check(np.array_equal(a, b), f"1 auction {row['case']}: the kernel's {name} is not "
                  f"the plain version's (kernel stats {kernel[2].tolist()}, plain "
                  f"{plain[2].tolist()})")
        row.update({"max_abs_err": float(np.abs(kernel[1] - plain[1]).max()),
                    "plain_ms": 1e3 * plain[3], "plain_on": "host"})


def auction_tied_case(n: int = 128) -> tuple:
    """Small-integer costs (exact ties: the price wars the rescue ends),
    Jacobi rounds carrying the bidding: the kernel's results, checked
    against scipy's objective here and the plain version's later."""
    cost = np.random.default_rng(3).integers(0, 3, size=(n, n)).astype(np.float64)
    kw = _auction_kw(n, 1.0, False)
    ws = AuctionWorkspace(n, "cuda")
    k = auction_ops.auction(torch.as_tensor(cost, device="cuda"),
                            torch.zeros(n, dtype=torch.float64, device="cuda"),
                            torch.full((n,), -1, dtype=torch.int32, device="cuda"),
                            **ws.buffers, **kw)
    k = tuple(x.cpu().numpy() for x in k)
    check(_objective(cost, k[0]) == _objective(cost, linear_sum_assignment(cost)[1]),
          "1 auction tied integers: objective is not scipy's")
    return cost, kw, k


def phase_auction(Pi_mnist: np.ndarray) -> list[dict]:
    """Phase 1's auction rows (the headline first: the warm solve at
    n = 512). The host yardsticks are timed first, with no worker
    running; then the plain version runs in worker processes while the
    card is timed."""
    import concurrent.futures
    import multiprocessing

    cases = [auction_case(n, Pi_mnist if n == len(Pi_mnist) else None)
             for n in AUCTION_SIZES]
    tied_cost, tied_kw, tied = auction_tied_case()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=4, mp_context=ctx) as pool:
        jobs = [[pool.submit(plain_auction_job, *c["plain"][kind]) for kind in ("cold", "warm")]
                for c in cases]
        tied_job = pool.submit(plain_auction_job, tied_cost, None, tied_kw)
        for c in cases:
            _time_kernel(c)
        rows = []
        for c, case_jobs in zip(cases, jobs):
            _collect_auction(c, case_jobs)
            rows += c["rows"]
        plain = tied_job.result()
    for name, a, b in zip(("col_of_row", "prices", "stats"), tied, plain[:3]):
        check(np.array_equal(a, b),
              f"1 auction tied integers: the kernel's {name} is not the plain version's")
    note(f"# 1 auction n={len(tied_cost)} tied integer costs: identical to the plain version, "
         f"scipy's objective; stats {dict(zip(AUCTION_STATS, tied[2].tolist()))}, plain "
         f"version {plain[3]:.2f} s on the host")
    head = next(r for r in rows if r["n"] == AUCTION_HEADLINE and "warm" in r["case"])
    return [head] + [r for r in rows if r is not head]


# ---------------------------------------------------------------------------
# Phase 2: the main path through the user's entry points
# ---------------------------------------------------------------------------

def reset_launch_counts() -> None:
    for mod in (ops, fa_ops, scan_ops, auction_ops):
        mod.reset_launch_counts()


def launch_counts() -> dict:
    return {**ops.launch_counts, **fa_ops.launch_counts, **scan_ops.launch_counts,
            **auction_ops.launch_counts}


def counted(fn, *args, **kwargs):
    """``fn(...)`` with every launch count set to 0 just before it; returns
    (result, counts, wall seconds)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, launch_counts(), time.perf_counter() - t0


def _final(log) -> dict:
    return [r for r in log.history if "acc_mean" in r][-1]


def fig2_protocol(device="cuda", n=100, n_samples=12000, n_train=10000, steps=150) -> dict:
    """Phase 2a: the paper's Fig. 2 protocol, stl-fw(d2) against random(d2)."""
    X, y = gaussian_blobs(n_samples, 10, dim=48, sep=2.5, seed=0)
    idx, Pi = shard_partition(y[:n_train], n, shards_per_node=2, seed=0)
    kw = dict(model="linear", steps=steps, batch_size=64, lr=0.3, eval_every=steps - 1,
              X_test=X[n_train:], y_test=y[n_train:], seed=0, device=device)
    sched = schedule_from_result(learn_topology(Pi, budget=2, lam=0.1))
    stl, stl_counts, stl_s = counted(
        run_classification, X[:n_train], y[:n_train], idx, None, schedule=sched, **kw)
    rnd, rnd_counts, rnd_s = counted(
        run_classification, X[:n_train], y[:n_train], idx, T.random_d_regular(n, 2, seed=0), **kw)
    return {"stl": _final(stl), "random": _final(rnd), "stl_counts": stl_counts,
            "random_counts": rnd_counts, "stl_s": stl_s, "random_s": rnd_s}


def mnist_width(data, device="cuda", steps=200) -> dict:
    """Phase 2b: MLP (P = 50890 per node) at n = 100, schedule and dense W."""
    X, y, idx, Pi = data
    n_train = sum(len(i) for i in idx)
    res = learn_topology(Pi, budget=10, lam=0.1)
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2,
              eval_every=steps - 1, X_test=X[n_train:], y_test=y[n_train:], seed=0,
              device=device)
    out = {}
    for arm, W, sched in (("schedule", None, schedule_from_result(res)), ("dense", res.W, None)):
        log, counts, secs = counted(
            run_classification, X[:n_train], y[:n_train], idx, W, schedule=sched, **kw)
        out[arm] = {"final": _final(log), "loss": log.column("loss"), "counts": counts,
                    "seconds": secs, "steps_per_s": steps / secs}
    return out


def mean_estimation(device="cuda", n=100, steps=100) -> dict:
    """Phase 2c: Example 1 mean estimation on the STL-FW W and a random W."""
    task = mean_estimation_clusters(n)
    res = learn_topology(task.Pi, budget=9, lam=0.5)
    stl, stl_counts, _ = counted(run_mean_estimation, task, res.W, steps=steps, lr=0.1,
                                 device=device)
    rnd, rnd_counts, _ = counted(run_mean_estimation, task, T.random_d_regular(n, 9, seed=0),
                                 steps=steps, lr=0.1, device=device)
    return {"stl": stl["mean_sq_error"], "random": rnd["mean_sq_error"],
            "stl_counts": stl_counts, "random_counts": rnd_counts}


def fig2_reference_acc() -> float:
    """stl-fw(d2)'s acc_mean in the reference's experiments/bench/fig2.csv."""
    for line in (ROOT / "experiments" / "bench" / "fig2.csv").read_text().splitlines()[1:]:
        name, acc = line.split(",")[:2]
        if name == "stl-fw(d2)":
            return float(acc)
    raise RuntimeError("fig2.csv has no stl-fw(d2) row")


def phase_main_path(mnist) -> dict:
    launches = {"gossip_schedule": 0, "gossip_mix": 0}

    def expect(label, counts, schedule, mix):
        check(counts == {"gossip_schedule": schedule, "gossip_mix": mix,
                         "flash_attention": 0, "flash_attention_bwd": 0, "rglru_scan": 0,
                         "auction": 0},
              f"{label}: launches {counts}, expected schedule={schedule} mix={mix}")
        for k in launches:
            launches[k] += counts[k]
        note(f"# 2 {label}: launches {counts}")

    a = fig2_protocol()
    expect("2a stl-fw(d2) schedule, 150 steps", a["stl_counts"], 150, 0)
    expect("2a random(d2) dense, 150 steps x 2 leaves", a["random_counts"], 0, 300)
    ref_acc = fig2_reference_acc()
    note(f"# 2a acc_mean stl-fw(d2)={a['stl']['acc_mean']:.4f} "
          f"random(d2)={a['random']['acc_mean']:.4f} reference stl-fw(d2)={ref_acc:.4f} "
          f"({a['stl_s']:.2f} s, {a['random_s']:.2f} s)")
    check(a["stl"]["acc_mean"] >= a["random"]["acc_mean"] + 0.03,
          "2a: stl-fw(d2) does not beat random(d2) by 0.03")
    check(abs(a["stl"]["acc_mean"] - ref_acc) <= 0.03,
          f"2a: stl-fw(d2) acc_mean is not within 0.03 of the reference's {ref_acc:.4f}")

    b = mnist_width(mnist)
    expect("2b schedule, 200 steps", b["schedule"]["counts"], 200, 0)
    expect("2b dense W, 200 steps x 4 leaves", b["dense"]["counts"], 0, 800)
    for arm, r in b.items():
        loss = r["loss"]
        note(f"# 2b {arm}: acc_mean={r['final']['acc_mean']:.4f} "
              f"loss {loss[:10].mean():.4f} -> {loss[-10:].mean():.4f} "
              f"consensus={r['final']['consensus']:.4g} {r['steps_per_s']:.1f} steps/s "
              f"({r['seconds']:.2f} s with setup and 2 evals)")
        check(bool(np.isfinite(loss).all()), f"2b {arm}: non-finite loss")
        check(loss[-10:].mean() < loss[:10].mean(), f"2b {arm}: loss did not fall")
        check(r["final"]["acc_mean"] > 0.5, f"2b {arm}: acc_mean <= 0.5")

    c = mean_estimation()
    expect("2c mean estimation stl-fw W, 100 steps", c["stl_counts"], 0, 100)
    expect("2c mean estimation random(d9), 100 steps", c["random_counts"], 0, 100)
    note(f"# 2c mean_sq_error stl-fw {c['stl'][0]:.5f} -> {c['stl'][-1]:.5f}, "
          f"random(d9) final {c['random'][-1]:.5f}")
    check(bool(np.isfinite(c["stl"]).all()), "2c: non-finite error")
    check(c["stl"][-1] < c["stl"][0], "2c: final mean_sq_error is not below the first")
    check(c["stl"][-1] < 0.5 * c["random"][-1], "2c: stl-fw is not 2x below random(d9)")
    launches["auction"] = phase_device_lmo()
    return launches


def step_breakdown(data, short: int = 20, long: int = 120) -> dict:
    """Phase 2e: where a phase-2b step's time goes in the eager loop
    (``rollout="loop"``; phase 6b sets the graph beside it).

    Steady-state ms per step of both arms, as the wall-time difference of
    a ``long`` and a ``short`` run without evaluation (setup cancels
    out), and, from ``torch.profiler`` over one ``short`` schedule-arm
    run, the device time per step by kernel. Host-to-device copies (the
    node data, copied once at setup) are left out of the per-step sums.
    """
    X, y, idx, Pi = data
    n_train = sum(len(i) for i in idx)
    res = learn_topology(Pi, budget=10, lam=0.1)
    arms = {"schedule": (None, schedule_from_result(res)), "dense": (res.W, None)}
    kw = dict(model="mlp", hidden=64, batch_size=64, lr=0.2, seed=0, device="cuda",
              rollout="loop")
    out = {}
    for arm, (W, sched) in arms.items():
        secs = {}
        for steps in (short, long):
            secs[steps] = counted(run_classification, X[:n_train], y[:n_train], idx, W,
                                  schedule=sched, steps=steps, **kw)[2]
        out[arm] = {"ms_per_step": 1e3 * (secs[long] - secs[short]) / (long - short)}
    W, sched = arms["schedule"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        counted(run_classification, X[:n_train], y[:n_train], idx, W, schedule=sched,
                steps=short, **kw)
    per_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0 and "HtoD" not in e.key:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3 / short
    out["schedule"]["device_ms_per_step"] = sum(per_kernel.values())
    out["schedule"]["top_kernels_ms_per_step"] = dict(
        sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8])
    return out


def phase_cross_device() -> None:
    """The card against the CPU's plain path on a small input (n = 16)."""
    task = mean_estimation_clusters(16, K=4, m=2.0)
    res = learn_topology(task.Pi, budget=3, lam=0.5)
    sched = schedule_from_result(res)
    for kw in ({"W": res.W}, {"W": None, "schedule": sched}):
        gpu = run_mean_estimation(task, steps=20, lr=0.2, device="cuda", **kw)
        cpu = run_mean_estimation(task, steps=20, lr=0.2, device="cpu", **kw)
        err = float(np.abs(gpu["mean_sq_error"] - cpu["mean_sq_error"]).max())
        note(f"# 2d mean estimation cuda vs cpu ({'W' if kw['W'] is not None else 'schedule'})"
              f": max |diff| {err:.3e}")
        check(np.allclose(gpu["mean_sq_error"], cpu["mean_sq_error"], rtol=1e-5, atol=1e-6),
              "2d: cuda and cpu error traces disagree")


def phase_device_lmo() -> int:
    """Phase 2 (continued): ``learn_topology(lmo="auction_jit")`` at n = 512,
    budget 64, on a generic Pi (Dirichlet(0.1), K = 64), against
    ``lmo="scipy"``: the objective and step-size traces within 1e-9 (the
    reference test's bar; atoms may differ where the LMO has exact ties).
    Returns the auction's launches: one a FW step and the final gap."""
    n, K, budget = 512, 64, 64
    Pi = np.random.default_rng(0).dirichlet(0.1 * np.ones(K), size=n)
    ref, _, scipy_s = counted(learn_topology, Pi, budget=budget, lam=0.1, lmo="scipy")
    jit, counts, jit_s = counted(learn_topology, Pi, budget=budget, lam=0.1,
                                 lmo="auction_jit")
    same = sum(np.array_equal(a, b) for a, b in zip(jit.perms, ref.perms))
    obj_err = float(np.abs(jit.objective_trace - ref.objective_trace).max())
    gamma_err = float(np.abs(jit.gamma_trace - ref.gamma_trace).max())
    out = {"n": n, "budget": budget, "auction_jit_s": jit_s, "scipy_s": scipy_s,
           "launches": counts["auction"], "atoms": [len(jit.perms), len(ref.perms)],
           "atoms_identical": int(same), "objective_max_abs_diff": obj_err,
           "gamma_max_abs_diff": gamma_err, "objective_final": float(jit.objective_trace[-1]),
           "lmo_backend": jit.lmo_backend}
    note("# 2 learn_topology auction_jit against scipy " + json.dumps(out))
    check(jit.lmo_backend == "auction_jit", "2: learn_topology does not report auction_jit")
    check(counts["auction"] == len(jit.gap_trace),
          f"2: {counts['auction']} auction launches for {len(jit.gap_trace)} LMO solves")
    check(len(jit.objective_trace) == len(ref.objective_trace) and obj_err <= 1e-9
          and gamma_err <= 1e-9, "2: the auction_jit trajectory is not scipy's")
    return counts["auction"]


TABLE_NODES = (64, 128, 256, 512, 1024, 2048)
TABLE_ATOMS = (2, 4, 8, 16, 32, 64)
TABLE_LEAVES = (50176, 64, 640, 10)  # phase 2b's MLP leaves per node: w1, b1, w2, b2
TABLE_P = sum(TABLE_LEAVES)  # 50890; bucket 65536
END_TO_END_NOISE = 1.05  # the two arms of 6b's graph ms/step have differed by up to 4.5%


def phase_transport_table(Pi_2b: np.ndarray, save: str | None = None) -> dict:
    """Phase 2d: the transport table on the card. ``autotune_transport``
    measures phase 2b's own bucket at 2b's n and communication atoms (as
    a 2b run with ``transport="autotune"`` on an empty table would), then
    every other (n, L) bucket of the grid (L < n, P bucketed and capped
    as the reference caps it) into a temporary table -- never the
    committed one -- timing both transports through ``mix_stacked`` on a
    pytree of phase 2b's leaf widths, each followed by the update that
    reads its output, as the trainers run them; printed beside the
    closed form's pick. ``save`` copies the measured table there. Phase
    6b holds the pick at 2b's bucket to its ms/step."""
    t0 = time.perf_counter()
    sched_2b = schedule_from_result(learn_topology(Pi_2b, budget=10, lam=0.1))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "transport_autotune.json")
        autotune_transport(sched_2b.n_nodes, sched_2b.n_communication_atoms, TABLE_P,
                           measure=True, path=path, device="cuda", leaf_sizes=TABLE_LEAVES)
        for n in TABLE_NODES:
            for L in TABLE_ATOMS:
                if L < n:
                    autotune_transport(n, L, TABLE_P, measure=True, path=path, device="cuda",
                                       leaf_sizes=TABLE_LEAVES)
        with open(path) as f:
            table = json.load(f)
        if save:
            shutil.copyfile(path, save)
    seconds = time.perf_counter() - t0
    losses = []
    for key, r in sorted(table.items(), key=lambda kv: (kv[1]["n_nodes"], kv[1]["n_atoms"])):
        closed = preferred_transport(r["n_nodes"], r["n_atoms"])
        us = {"schedule": r["schedule_us"], "dense": r["dense_us"]}
        if closed != r["winner"]:
            losses.append(us[closed] / us[r["winner"]])
        note(f"# 2d n={r['n_nodes']} L={r['n_atoms']} P={r['p']} (timed {r['p_measured']}): "
             f"schedule {us['schedule']:.1f} us, dense {us['dense']:.1f} us, winner "
             f"{r['winner']}, closed form {closed}")
        check(r["card"] == torch.cuda.get_device_name(0) and r["power_limit"],
              f"2d {key}: the record does not name the card and its power limit")
    head = table[_bucket_key(sched_2b.n_nodes, sched_2b.n_communication_atoms, TABLE_P,
                             torch.device("cuda"))]
    out = {"buckets": len(table), "disagree": len(losses),
           "largest_closed_form_loss": max(losses, default=1.0), "seconds": seconds,
           "phase_2b_bucket": {k: head[k] for k in ("n_nodes", "n_atoms", "p", "winner")}}
    note("# 2d transport table " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 6: the captured rollout and online topology adaptation
# ---------------------------------------------------------------------------

def phase_capture_kernels() -> dict:
    """Both gossip kernels captured in one CUDA graph, their operands
    replaced by ``copy_`` and the graph replayed: equal to the plain
    versions (schedule bitwise, mix at 1e-5), as the captured rollout
    uses them, at phase 2b's shape. Launches made here are compared, not
    counted."""
    n, P, L = 100, 50896, 11
    theta = _theta(n, P, torch.float32, 40)
    g, p = random_atoms(n, L, 41)
    W = torch.as_tensor(arrays_to_matrix(ScheduleArrays(g, p)), dtype=torch.float32,
                        device="cuda")
    ops.gossip_schedule(theta, g, p)
    ops.gossip_mix(theta, W)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_s = ops.gossip_schedule(theta, g, p)
        out_m = ops.gossip_mix(theta, W)
    errs = {}
    for swap in (False, True):
        if swap:
            g2, p2 = random_atoms(n, L, 42)
            g.copy_(g2)
            p.copy_(p2)
            theta.copy_(_theta(n, P, torch.float32, 43))
            W.copy_(torch.as_tensor(arrays_to_matrix(ScheduleArrays(g2, p2)),
                                    dtype=torch.float32, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out_s, gossip_schedule_ref(theta, g, p)),
              f"6 captured gossip_schedule (swap={swap}) is not bitwise the plain version")
        errs[f"mix_swap={swap}"] = _compare(f"6 captured gossip_mix (swap={swap})", out_m,
                                            gossip_mix_ref(theta, W), torch.float32)
    note(f"# 6 capture: both gossip kernels in one graph, operands swapped by copy_, "
          f"gossip_mix max err {errs}")
    return errs


def _feed(ctl, labels):
    """``on_segment`` hook: stream the labels up to ``t`` in, then ask. It
    exposes the controller's estimator, so a tau_bar probe reads the live
    Pi_hat at each boundary."""
    fed = {"t": 0}

    def hook(t):
        while fed["t"] <= t:
            ctl.observe(labels[fed["t"]])
            fed["t"] += 1
        return ctl.on_segment(t)

    hook.estimator = ctl.estimator
    return hook


def phase_drift_recovery(launches: dict) -> dict:
    """Phase 6a: the reference's online acceptance configuration
    (``benchmarks/bench_online.py`` ``_bench_recovery_and_retrace``,
    non-smoke): abrupt label swap at t = 200 on Section 6.1 mean estimation
    (n = 64, K = 8), frozen / oracle / online arms on one observation
    stream, all ``rollout="scan"`` on the card."""
    n, K, steps, seg, t_drift, budget = 64, 8, 600, 20, 200, 8
    lam, lr, batch, beta = 0.5, 0.05, 4, 0.2
    task = mean_estimation_clusters(n_nodes=n, K=K, m=5.0, sigma_tilde2=1.0)
    Pi0 = np.eye(K)[np.arange(n) % K].astype(float)
    scenario = AbruptLabelSwap(Pi0, t_drift=t_drift,
                               node_perm=np.random.default_rng(11).permutation(n))
    labels = labels_stream(scenario, steps, batch, seed=0)
    zs = np.asarray(task.cluster_means)[labels] + np.sqrt(task.sigma_tilde2) * \
        np.random.default_rng(1).normal(size=labels.shape)
    res0 = learn_topology(Pi0, budget=budget, lam=lam)
    ref = TopologyRefresher(res0, RefreshConfig(budget=budget, lam=lam), device="cuda")
    sa0 = schedule_to_arrays(schedule_from_result(res0), ref.l_max, device="cuda")
    sa_oracle = schedule_to_arrays(
        schedule_from_result(learn_topology(scenario.Pi(t_drift), budget=budget, lam=lam)),
        ref.l_max, device="cuda")
    swapped = {"done": False}

    def oracle_hook(t):
        if not swapped["done"] and t >= t_drift - 1:
            swapped["done"] = True
            return sa_oracle
        return None

    ctl = OnlineTopologyController(
        ref, estimator=StreamingPiEstimator(n, K, beta=beta, init=Pi0))
    arms = {}
    for arm, hook in (("frozen", None), ("oracle", oracle_hook), ("online", _feed(ctl, labels))):
        out, counts, secs = counted(
            run_mean_estimation, task, None, steps=steps, lr=lr, batch=batch, seed=2,
            schedule=sa0, zs=zs, on_segment=hook, segment_len=seg, rollout="scan",
            device="cuda")
        check(counts["gossip_schedule"] == steps and counts["gossip_mix"] == 0,
              f"6a {arm}: launches {counts}, expected gossip_schedule={steps}")
        launches["gossip_schedule"] += counts["gossip_schedule"]
        check(out["n_traces"] == 1, f"6a {arm}: n_traces {out['n_traces']} != 1")
        check(bool(np.isfinite(out["mean_sq_error"]).all()), f"6a {arm}: non-finite error")
        arms[arm] = {"out": out, "seconds": secs}
    check(swapped["done"], "6a: the oracle arm never swapped")
    check(ref.n_refreshes >= 1 and len(arms["online"]["out"]["swaps"]) >= 1,
          "6a: the online arm never swapped")
    tail = slice(-max(10, steps // 12), None)
    err = {a: float(np.median(r["out"]["mean_sq_error"][tail])) for a, r in arms.items()}
    log_rec = (np.log(err["frozen"]) - np.log(err["online"])) / (
        np.log(err["frozen"]) - np.log(err["oracle"]))
    out = {"err": err, "recovery_log": float(log_rec),
           "recovery_linear": (err["frozen"] - err["online"]) / (err["frozen"] - err["oracle"]),
           "swaps": arms["online"]["out"]["swaps"], "n_refreshes": ref.n_refreshes,
           "n_traces": {a: r["out"]["n_traces"] for a, r in arms.items()},
           "seconds": {a: r["seconds"] for a, r in arms.items()}}
    note("# 6a " + json.dumps(out))
    check(log_rec >= 0.8, f"6a: log-space recovery {log_rec:.3f} < 0.8 of the frozen->oracle gap")
    return out


def _online_controller(Pi0: np.ndarray, res0, lmo: str = "auto", **kw):
    ref = TopologyRefresher(res0, RefreshConfig(budget=10, lam=0.1, l_max=11), lmo=lmo,
                            device="cuda")
    return OnlineTopologyController(ref, Pi0=Pi0, **kw)


def phase_online_full_width(data, launches: dict, steps: int = 200) -> dict:
    """Phase 6b: phase 2b's MNIST-width run (n = 100, MLP hidden 64, P =
    50890) on a ``ScheduleArrays`` (STL-FW budget 10, l_max 11), with an
    ``OnlineTopologyController`` observing a label stream that swaps at
    t = 100: inline in both rollouts (equal losses and swaps), then in
    overlap mode in the captured rollout."""
    X, y, idx, Pi0 = data
    n, n_train = len(idx), sum(len(i) for i in idx)
    res0 = learn_topology(Pi0, budget=10, lam=0.1)
    labels = labels_stream(
        AbruptLabelSwap(Pi0, t_drift=steps // 2,
                        node_perm=np.random.default_rng(11).permutation(n)),
        steps, 64, seed=0)
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2, eval_every=20,
              X_test=X[n_train:], y_test=y[n_train:], seed=0, device="cuda")
    runs = {}
    for rollout in ("loop", "scan"):
        ctl = _online_controller(Pi0, res0)
        sa0 = ctl.schedule_arrays()
        log, counts, secs = counted(run_classification, X[:n_train], y[:n_train], idx, None,
                                    schedule=sa0, on_segment=_feed(ctl, labels),
                                    rollout=rollout, **kw)
        check(counts["gossip_schedule"] == steps and counts["gossip_mix"] == 0,
              f"6b inline {rollout}: launches {counts}, expected gossip_schedule={steps}")
        launches["gossip_schedule"] += counts["gossip_schedule"]
        runs[rollout] = {"log": log, "seconds": secs, "refreshes": ctl.refresher.n_refreshes}
    loop, scan = runs["loop"]["log"], runs["scan"]["log"]
    l_loop, l_scan = loop.column("loss"), scan.column("loss")
    max_diff = float(np.abs(l_loop - l_scan).max())
    bitwise = bool(np.array_equal(l_loop, l_scan)) and loop.history == scan.history
    out = {"swaps": scan.aux["swaps"], "loop_swaps": loop.aux["swaps"],
           "n_traces": {"loop": loop.aux["n_traces"], "scan": scan.aux["n_traces"]},
           "bitwise_equal": bitwise, "loss_max_abs_diff": max_diff,
           "acc_mean": _final(scan)["acc_mean"],
           "seconds": {r: v["seconds"] for r, v in runs.items()},
           "refreshes": runs["scan"]["refreshes"]}
    note(f"# 6b inline: swaps scan {out['swaps']} loop {out['loop_swaps']}, captures "
          f"{out['n_traces']}, graph == loop bitwise: {bitwise} (max |loss diff| {max_diff:.3e}), "
          f"acc_mean {out['acc_mean']:.4f}")
    check(out["swaps"] == out["loop_swaps"] and len(out["swaps"]) >= 1,
          "6b: the rollouts swapped at different steps, or never")
    check(scan.aux["n_traces"] == 1, f"6b: {scan.aux['n_traces']} captures, expected 1")
    check(bitwise or np.allclose(l_scan, l_loop, rtol=1e-6, atol=0.0),
          f"6b: graph and loop losses differ by {max_diff:.3e} (bound 1e-6 relative)")
    check(bool(np.isfinite(l_scan).all()) and l_scan[-10:].mean() < l_scan[:10].mean(),
          "6b: the captured run's loss did not fall")

    # overlap mode: the solve runs on a worker while the graph replays
    ctl = _online_controller(Pi0, res0, overlap=True)
    try:
        log, counts, secs = counted(run_classification, X[:n_train], y[:n_train], idx, None,
                                    schedule=ctl.schedule_arrays(),
                                    on_segment=_feed(ctl, labels), rollout="scan", **kw)
        in_run = list(ctl.refresh_log)
        ctl.request_refresh("final flush")
        ctl.on_segment(steps - 1)
        final = ctl.flush(steps)
    finally:
        ctl.close()
    check(counts["gossip_schedule"] == steps, f"6b overlap: launches {counts}")
    launches["gossip_schedule"] += counts["gossip_schedule"]
    check(all(r["blocked_s"] == 0.0 and "error" not in r for r in in_run),
          f"6b overlap: a swap was not collected free: {in_run}")
    check(final is not None and ctl.refresh_log[-1]["t_collect"] == steps,
          "6b overlap: the final flush was not recorded")
    out["overlap"] = {
        "swaps": log.aux["swaps"], "n_traces": log.aux["n_traces"], "seconds": secs,
        "submitted": sum(1 for e in ctl.events if e.get("submitted")),
        "in_run": [{k: r[k] for k in ("t_submit", "t_collect", "solve_s", "pending_segments",
                                      "blocked_s")} for r in in_run],
        "final_flush": {k: ctl.refresh_log[-1][k] for k in ("t_submit", "t_collect", "solve_s",
                                                             "blocked_s")}}
    note("# 6b overlap " + json.dumps(out["overlap"]))
    check(log.aux["n_traces"] == 1, "6b overlap: captures grew")
    return out


def graph_step_times(data, steps: int = 256, every: int = 32) -> dict:
    """Phase 6b, printed and not checked: steady ms per step of phase 2b's
    schedule and dense arms, loop against graph, from the ``sim.segment``
    spans of a run evaluated every ``every`` steps on a 1000-sample test
    set (the evaluation runs outside the spans). Segments 3 on are timed:
    in the graph the first ``every``-step segment is the eager warm-up and
    the second captures, so the rest are replays. (The difference of two
    whole runs, as phase 2e takes, is dominated here by the run-to-run
    spread of the data setup.) The device busy share is the profiler's
    device time per step, in a run without evaluation, over that ms per
    step."""
    X, y, idx, Pi = data
    n_train = sum(len(i) for i in idx)
    res = learn_topology(Pi, budget=10, lam=0.1)
    arms = {"schedule": (None, schedule_from_result(res)), "dense": (res.W, None)}
    kw = dict(model="mlp", hidden=64, batch_size=64, lr=0.2, seed=0, device="cuda",
              steps=steps, eval_every=every, X_test=X[n_train:n_train + 1000],
              y_test=y[n_train:n_train + 1000])
    out = {}
    for arm, (W, sched) in arms.items():
        for rollout in ("loop", "scan"):
            tracer = Tracer()
            run_classification(X[:n_train], y[:n_train], idx, W, schedule=sched,
                               rollout=rollout, tracer=tracer, **kw)
            segs = [sp.duration_s for sp in tracer.spans("sim.segment")
                    if sp.attrs["k"] == every]
            ms = 1e3 * float(np.median(segs[2:])) / every
            # the device time of the steps alone: the same run without evaluation
            per_kernel, n_ops = device_profile(run_classification, X[:n_train], y[:n_train],
                                               idx, W, schedule=sched, rollout=rollout,
                                               **{**kw, "X_test": None, "y_test": None})
            dev = sum(v for k, v in per_kernel.items() if "HtoD" not in k) / steps
            out[f"{arm} {rollout}"] = {
                "ms_per_step": ms, "device_ms_per_step": dev, "device_busy_share": dev / ms,
                "device_ops_per_step": n_ops / steps,
                "segment_ms": [1e3 * t for t in segs],  # warm-up, capture (graph), steady
            }
    return out


def phase_warm_refresh() -> dict:
    """Phase 6c: a cold solve and a warm refresh at n = 512, budget 64 (the
    reference's ``bench_online`` claim 1), with the scipy LMO and with the
    device auction: equal cold objectives, the device LMO's warm refresh
    reaching the scipy refresh's objective; seconds and FW iterations of
    each, printed. Returns the auction's launches."""
    n, K, budget = 512, 64, 64
    rng = np.random.default_rng(0)
    Pi0 = rng.dirichlet(0.1 * np.ones(K), size=n)
    res0 = learn_topology(Pi0, budget=budget, lam=0.1)
    Pi1 = Pi0[rng.permutation(n)]
    out, launches = {}, 0
    for lmo in ("scipy", "auction_jit"):
        cold, counts_cold, cold_s = counted(learn_topology, Pi1, budget=budget, lam=0.1, lmo=lmo)
        ref = TopologyRefresher(res0, RefreshConfig(budget=budget // 4, lam=0.1), lmo=lmo,
                                device="cuda")
        warm, counts_warm, _ = counted(ref.refresh, Pi1)
        launches += counts_cold["auction"] + counts_warm["auction"]
        out[lmo] = {"cold_s": cold_s, "cold_iters": len(cold.gamma_trace),
                    "warm_s": ref.last_refresh_s, "warm_iters": ref.last_iters,
                    "objective_cold": float(cold.objective_trace[-1]),
                    "objective_warm": float(warm.objective_trace[-1]),
                    "lmo_solves": len(cold.gap_trace) + len(warm.gap_trace),
                    "auction_launches": counts_cold["auction"] + counts_warm["auction"]}
    note("# 6c " + json.dumps(out))
    s_, j_ = out["scipy"], out["auction_jit"]
    check(abs(j_["objective_cold"] - s_["objective_cold"]) <= 1e-9 * max(1.0, s_["objective_cold"]),
          "6c: the device LMO's cold objective is not scipy's")
    check(j_["objective_warm"] <= s_["objective_warm"] + 1e-9 * max(1.0, s_["objective_warm"]),
          "6c: the device LMO's warm refresh does not reach the scipy refresh's objective")
    check(j_["auction_launches"] == j_["lmo_solves"] and s_["auction_launches"] == 0,
          f"6c: {j_['auction_launches']} auction launches for {j_['lmo_solves']} LMO solves")
    return launches


def phase_online_device_lmo(data, launches: dict, steps: int = 200) -> int:
    """Phase 6c (continued): phase 6b's controller with ``lmo="auction_jit"``
    (its LMO on the card, its prices kept there across refreshes), inline
    and in overlap mode -- the worker's solves next to the trainer's
    captures -- in the captured rollout: one capture per arm, every swap
    collected, no failed refresh. Returns the auction's launches."""
    X, y, idx, Pi0 = data
    n, n_train = len(idx), sum(len(i) for i in idx)
    res0 = learn_topology(Pi0, budget=10, lam=0.1)
    labels = labels_stream(
        AbruptLabelSwap(Pi0, t_drift=steps // 2,
                        node_perm=np.random.default_rng(11).permutation(n)),
        steps, 64, seed=0)
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2, eval_every=20,
              X_test=X[n_train:], y_test=y[n_train:], seed=0, device="cuda")
    out, auction = {}, 0
    for overlap in (False, True):
        ctl = _online_controller(Pi0, res0, lmo="auction_jit", overlap=overlap)
        try:
            log, counts, secs = counted(run_classification, X[:n_train], y[:n_train], idx, None,
                                        schedule=ctl.schedule_arrays(),
                                        on_segment=_feed(ctl, labels), rollout="scan", **kw)
            final = ctl.flush(steps) if ctl.refresh_pending else None
        finally:
            ctl.close()
        arm = "overlap" if overlap else "inline"
        check(counts["gossip_schedule"] == steps, f"6c {arm} auction_jit: launches {counts}")
        launches["gossip_schedule"] += counts["gossip_schedule"]
        auction += counts["auction"]
        check(log.aux["n_traces"] == 1, f"6c {arm} auction_jit: {log.aux['n_traces']} captures")
        # inline a refresh swaps at its boundary; in overlap mode it lands
        # at the first boundary after the solve, or at the final flush
        in_run = [r for r in ctl.refresh_log if r["t_collect"] < steps]
        check(ctl.failed_refreshes == 0 and counts["auction"] >= 1
              and len(log.aux["swaps"]) == len(in_run) and (in_run or final is not None)
              and all(r["blocked_s"] == 0.0 for r in in_run),
              f"6c {arm} auction_jit: refreshes {ctl.refresh_log}, swaps {log.aux['swaps']}")
        out[arm] = {"swaps": log.aux["swaps"], "n_traces": log.aux["n_traces"],
                    "refreshes": ctl.refresher.n_refreshes, "auction_launches": counts["auction"],
                    "seconds": secs, "acc_mean": _final(log)["acc_mean"],
                    "refresh_log": [{k: r[k] for k in ("t_submit", "t_collect", "solve_s",
                                                       "pending_segments", "blocked_s")}
                                    for r in ctl.refresh_log]}
    note("# 6c online auction_jit " + json.dumps(out))
    return auction


def check_table_pick(pick: str, timing: dict) -> None:
    """Phase 2b's learned topology (n 100, 10 communication atoms, P
    50890) runs under the graph as a schedule arm and a dense arm: the
    transport phase 2d's table picks for that bucket must not be slower
    end to end than the other beyond the arms' run-to-run noise."""
    ms = {arm: timing[f"{arm} scan"]["ms_per_step"] for arm in ("schedule", "dense")}
    other = "dense" if pick == "schedule" else "schedule"
    note(f"# 6b table pick at phase 2b's bucket: {pick} ({ms[pick]:.4f} ms/step under the "
         f"graph), {other} {ms[other]:.4f}")
    check(ms[pick] <= END_TO_END_NOISE * ms[other],
          f"6b: the table picks {pick} at phase 2b's bucket, {ms[pick]:.4f} ms/step against "
          f"{other}'s {ms[other]:.4f}")


def phase_online(mnist, table_pick: str) -> dict:
    """Phase 6; returns the gossip kernels' launches over its counted runs."""
    launches = {"gossip_schedule": 0, "gossip_mix": 0, "auction": 0}
    phase_capture_kernels()
    phase_drift_recovery(launches)
    phase_online_full_width(mnist, launches)
    timing = graph_step_times(mnist)
    for label, r in timing.items():
        note(f"# 6b timing {label} " + json.dumps(r))
    check_table_pick(table_pick, timing)
    launches["auction"] += phase_warm_refresh()
    launches["auction"] += phase_online_device_lmo(mnist, launches)
    note(f"# 6 launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: the robustness layer inside the captured rollout
# ---------------------------------------------------------------------------

def _span_ms(tracer, k: int) -> float:
    """Steady ms per step from the ``sim.segment`` spans of ``k``-step
    segments: the first is the eager warm-up and the second captures, so
    the rest are replays."""
    segs = [sp.duration_s for sp in tracer.spans("sim.segment") if sp.attrs["k"] == k]
    return 1e3 * float(np.median(segs[2:])) / k


def _expect_schedule(label: str, counts: dict, want: int, launches: dict) -> None:
    check(counts["gossip_schedule"] == want and counts["gossip_mix"] == 0,
          f"{label}: launches {counts}, expected gossip_schedule={want}")
    launches["gossip_schedule"] += counts["gossip_schedule"]


def _robust_setup(data, steps: int):
    """Phase 2b's shape on the data plane: n = 100, the MLP (P = 50890),
    STL-FW budget 10 at l_max 11, and a second schedule (the topology of
    the label-swapped fleet) the hook swaps in at ``steps // 2 - 1``."""
    X, y, idx, Pi0 = data
    n, n_train = len(idx), sum(len(i) for i in idx)
    perm = np.random.default_rng(11).permutation(n)
    sa = schedule_to_arrays(schedule_from_result(learn_topology(Pi0, budget=10, lam=0.1)),
                            l_max=11, device="cuda")
    sa2 = schedule_to_arrays(schedule_from_result(learn_topology(Pi0[perm], budget=10, lam=0.1)),
                             l_max=11, device="cuda")
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2, eval_every=20,
              X_test=X[n_train:n_train + 1000], y_test=y[n_train:n_train + 1000], seed=0,
              device="cuda", schedule=sa)
    return (X[:n_train], y[:n_train], idx, None), kw, (lambda t: sa2 if t == steps // 2 - 1
                                                        else None)


def phase_probes(data, launches: dict, steps: int = 200, timed: int = 256) -> dict:
    """7a: phase 6b's online run with health probes (consensus, grad_dev,
    tau_bar at the controller's live Pi_hat): losses bitwise the probes-off
    run, one capture each; then the per-step probe cost from the
    ``sim.segment`` spans of ``timed``-step runs."""
    X, y, idx, Pi0 = data
    n, n_train = len(idx), sum(len(i) for i in idx)
    res0 = learn_topology(Pi0, budget=10, lam=0.1)
    labels = labels_stream(
        AbruptLabelSwap(Pi0, t_drift=steps // 2,
                        node_perm=np.random.default_rng(11).permutation(n)),
        steps, 64, seed=0)
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2, eval_every=20,
              X_test=X[n_train:], y_test=y[n_train:], seed=0, device="cuda")
    logs = {}
    for arm, probes in (("off", None), ("on", HealthProbes(tau_bar=True))):
        ctl = _online_controller(Pi0, res0)
        extra = dict(probes=probes, pi_hat=Pi0) if probes is not None else {}
        log, counts, _ = counted(run_classification, X[:n_train], y[:n_train], idx, None,
                                 schedule=ctl.schedule_arrays(), on_segment=_feed(ctl, labels),
                                 rollout="scan", **extra, **kw)
        # the tau_bar probe mixes pi_hat through gossip_schedule: one more a step
        _expect_schedule(f"7a probes {arm}", counts, steps * (2 if probes else 1), launches)
        logs[arm] = log
    on, off = logs["on"], logs["off"]
    bitwise = bool(np.array_equal(on.column("loss"), off.column("loss"))) and \
        on.history == off.history
    health = on.aux["health"]
    out = {"bitwise_equal": bitwise, "swaps": on.aux["swaps"],
           "n_traces": {"off": off.aux["n_traces"], "on": on.aux["n_traces"]},
           "health_last": {k: float(v[-1]) for k, v in health.items()}}
    check(bitwise, "7a: the probes-on run is not bitwise the probes-off run")
    check(on.aux["swaps"] == off.aux["swaps"] and len(on.aux["swaps"]) >= 1,
          f"7a: swaps {on.aux['swaps']} / {off.aux['swaps']}")
    check(out["n_traces"] == {"off": 1, "on": 1}, f"7a: captures {out['n_traces']}")
    check(all(np.isfinite(v).all() and v.shape == (steps,) for v in health.values()),
          "7a: non-finite or missing probe values")
    # the cost: timed-step runs evaluated every 32 steps (outside the spans)
    sa = schedule_to_arrays(schedule_from_result(res0), l_max=11, device="cuda")
    tkw = {**kw, "steps": timed, "eval_every": 32, "X_test": X[n_train:n_train + 1000],
           "y_test": y[n_train:n_train + 1000]}
    ms = {}
    for arm, extra in (("off", {}), ("default", dict(probes=HealthProbes())),
                       ("tau_bar", dict(probes=HealthProbes(tau_bar=True), pi_hat=Pi0))):
        tracer = Tracer()
        run_classification(X[:n_train], y[:n_train], idx, None, schedule=sa, rollout="scan",
                           tracer=tracer, **extra, **tkw)
        ms[arm] = _span_ms(tracer, 32)
    out["ms_per_step"] = ms
    out["probe_ms_per_step"] = {arm: ms[arm] - ms["off"] for arm in ("default", "tau_bar")}
    note("# 7a probes " + json.dumps(out))
    return out


def phase_compression(data, launches: dict, steps: int = 200) -> dict:
    """7b: phase 2b's shape on the schedule transport with a swap, under
    the wires none, identity, bf16 and topk:0.1:g0.25: identity bitwise
    none (losses and bytes), bf16 0.5x the bytes, top-k k * 8 a node,
    graph bitwise the loop for bf16 and top-k, one capture an arm;
    printed: ms per step of each wire."""
    args, kw, hook = _robust_setup(data, steps)
    n = len(args[2])
    P = 784 * 64 + 64 + 64 * 10 + 10
    runs = {}
    for wire in (None, "identity", "bf16", "topk:0.1:g0.25"):
        rollouts = ("scan", "loop") if wire in ("bf16", "topk:0.1:g0.25") else ("scan",)
        for rollout in rollouts:
            tracer = Tracer()
            log, counts, secs = counted(run_classification, *args, on_segment=hook,
                                        compression=wire, rollout=rollout, tracer=tracer, **kw)
            _expect_schedule(f"7b {wire} {rollout}", counts, steps, launches)
            runs[wire, rollout] = {"log": log, "ms": _span_ms(tracer, 20), "seconds": secs}
    none, ident = runs[None, "scan"]["log"], runs["identity", "scan"]["log"]
    f32_bytes = none.aux["comm"]["per_step_bytes"]
    out = {"ms_per_step": {str(w): r["ms"] for (w, ro), r in runs.items() if ro == "scan"},
           "loop_ms_per_step": {str(w): r["ms"] for (w, ro), r in runs.items() if ro == "loop"},
           "per_step_bytes": {str(w): r["log"].aux["comm"]["per_step_bytes"]
                              for (w, ro), r in runs.items() if ro == "scan"},
           "n_traces": {str(w): r["log"].aux["n_traces"] for (w, ro), r in runs.items()
                        if ro == "scan"},
           "final_loss": {str(w): float(r["log"].column("loss")[-10:].mean())
                          for (w, ro), r in runs.items() if ro == "scan"}}
    check(none.history == ident.history and none.aux["comm"] == ident.aux["comm"],
          "7b: the identity wire is not bitwise the uncompressed run")
    check(2 * runs["bf16", "scan"]["log"].aux["comm"]["per_step_bytes"] == f32_bytes,
          "7b: the bf16 wire does not move exactly half the bytes")
    k = max(1, int(P * 0.1))
    check(runs["topk:0.1:g0.25", "scan"]["log"].aux["comm"]["per_step_bytes"] == (n - 1) * k * 8,
          "7b: the top-k wire does not cost k * 8 bytes a node")
    for wire in ("bf16", "topk:0.1:g0.25"):
        scan, loop = runs[wire, "scan"]["log"], runs[wire, "loop"]["log"]
        check(scan.history == loop.history, f"7b {wire}: graph and loop differ")
    check(all(v == 1 for v in out["n_traces"].values()), f"7b: captures {out['n_traces']}")
    check(all(np.isfinite(v) for v in out["final_loss"].values()), "7b: non-finite loss")
    note("# 7b compression " + json.dumps(out))
    return out


def phase_staleness(data, launches: dict, steps: int = 200) -> dict:
    """7c: phase 2b's shape under bounded-delay gossip: a zero-delay arm
    bitwise the fresh run (losses and bytes), ``wait`` and ``degrade`` at
    tau_max 4 on a FaultPlan's straggler trace (rate 0.3, tau_max 4, plus
    1% hard stragglers past the deadline), and wait with the bf16 wire;
    one capture an arm; printed: ms per step and the ring's bytes."""
    from repro_torch.faults import FaultPlan

    args, kw, hook = _robust_setup(data, steps)
    n = len(args[2])
    plan = FaultPlan(n_nodes=n, steps=steps, seed=8, straggler_rate=0.3, tau_max=4)
    plan.delays[np.random.default_rng([8, 99]).random((steps, n)) < 0.01] = 6
    arms = {"fresh": {}, "zero": dict(staleness=StragglerPolicy("wait", 4)),
            "wait": dict(staleness=StragglerPolicy("wait", 4), delays=plan.delays),
            "degrade": dict(staleness=StragglerPolicy("degrade", 4), delays=plan.delays),
            "wait+bf16": dict(staleness=StragglerPolicy("wait", 4), delays=plan.delays,
                              compression="bf16")}
    runs = {}
    for arm, extra in arms.items():
        tracer = Tracer()
        log, counts, _ = counted(run_classification, *args, on_segment=hook, rollout="scan",
                                 tracer=tracer, **extra, **kw)
        _expect_schedule(f"7c {arm}", counts, steps, launches)
        runs[arm] = {"log": log, "ms": _span_ms(tracer, 20)}
    fresh, zero = runs["fresh"]["log"], runs["zero"]["log"]
    P_pad = -(-(784 * 64 + 64 + 64 * 10 + 10) // 8) * 8
    out = {"ms_per_step": {a: r["ms"] for a, r in runs.items()},
           "n_traces": {a: r["log"].aux["n_traces"] for a, r in runs.items()},
           "comm": {a: r["log"].aux["comm"] for a, r in runs.items() if a != "fresh"},
           "final_loss": {a: float(r["log"].column("loss")[-10:].mean())
                          for a, r in runs.items()},
           "ring_bytes": 5 * n * P_pad * 4}
    check(zero.history == fresh.history, "7c: zero delays are not bitwise the fresh run")
    check(zero.aux["comm"]["total_bytes"] == fresh.aux["comm"]["total_bytes"]
          and zero.aux["comm"]["deferred_bytes"] == 0, "7c: zero-delay bytes differ")
    check(all(v == 1 for v in out["n_traces"].values()), f"7c: captures {out['n_traces']}")
    check(all(np.isfinite(v) for v in out["final_loss"].values()), "7c: non-finite loss")
    note("# 7c staleness " + json.dumps(out))
    return out


def _faulty(label: str, launches: dict, task, plan, arrays, **kw) -> dict:
    out, counts, _ = counted(run_faulty_mean_estimation, task, plan, arrays, device="cuda", **kw)
    _expect_schedule(f"7d {label}", counts,
                     plan.steps - (out["resumed_from"] or 0) if out["stopped_at"] is None
                     else out["stopped_at"], launches)
    check(out["n_traces"] == 1, f"7d {label}: {out['n_traces']} captures")
    return out


def phase_faults(launches: dict, smoke: bool = False) -> dict:
    """7d: ``run_faulty_mean_estimation`` at ``benchmarks/bench_faults.py``'s
    non-smoke sizes: a fault-sweep cell, the straggler bars, the
    corruption bar, the crash-recovery drill; one capture an arm."""
    from repro_torch.data.drift import NodeChurn
    from repro_torch.faults import FaultPlan, QuarantineController, ScreenPolicy

    lam, out = 0.1, {}

    def setup(n, K, steps, zs_seed, batch=2):
        task = mean_estimation_clusters(n_nodes=n, K=K, m=5.0, sigma_tilde2=1.0)
        res0 = learn_topology(task.Pi, budget=8, lam=lam)
        sched0 = schedule_from_result(res0)
        arrays = schedule_to_arrays(sched0, sched0.n_atoms + 2, device="cuda")
        rng = np.random.default_rng(zs_seed)
        zs = np.stack([task.sample(batch, rng) for _ in range(steps)]).astype(np.float32)
        return task, res0, arrays, zs

    # a fault-sweep cell: crash 0.05, stragglers at tau 4, 15% edge drops
    n, K, steps, seg = (8, 4, 120, 20) if smoke else (32, 8, 600, 50)
    task, _, arrays, zs = setup(n, K, steps, 1)
    tail = slice(-max(10, steps // 10), None)
    kw = dict(lr=0.05, seed=2, zs=zs, segment_len=seg)
    base = _faulty("sweep base", launches, task, FaultPlan(n_nodes=n, steps=steps, seed=0),
                   arrays, **kw)
    cell = _faulty("sweep cell", launches, task,
                   FaultPlan(n_nodes=n, steps=steps, seed=3, crash_rate=0.05, mean_outage=6.0,
                             straggler_rate=0.3, tau_max=4, edge_drop_rate=0.15), arrays, **kw)
    base_err = float(np.median(base["mean_sq_error"][tail]))
    out["sweep_cell"] = {"gap_ratio": float(np.median(cell["mean_sq_error"][tail])) / base_err,
                         "alive_frac": cell["alive_frac"], "comm": cell["comm"]}
    check(np.isfinite(cell["mean_sq_error"]).all(), "7d sweep cell: non-finite error")

    # the straggler bars: tau_max <= 4, <= 25% stragglers -> wait within
    # 10% of fault-free, degrade within 20%
    task, _, arrays, zs = setup(n, K, steps, 6)
    tail = slice(-max(10, steps // 3), None)
    kw = dict(lr=0.02, seed=2, zs=zs, segment_len=seg)
    plan0 = FaultPlan(n_nodes=n, steps=steps, seed=0)
    base = _faulty("straggler base", launches, task, plan0, arrays, **kw)
    base_err = float(np.median(base["mean_sq_error"][tail]))
    for mode in ("wait", "degrade"):  # the delays=0 control arms
        ctrl = _faulty(f"delays=0 {mode}", launches, task, plan0, arrays,
                       staleness=StragglerPolicy(mode, 4), **kw)
        check(np.array_equal(ctrl["mean_sq_error"], base["mean_sq_error"])
              and ctrl["comm"]["total_bytes"] == base["comm"]["total_bytes"],
              f"7d: the delays=0 {mode} arm is not bitwise the fresh run")
    hard = 0.02 if smoke else 0.01
    ratios = {}
    for tau in (2, 4):
        for rate in (0.1, 0.25):
            plan = FaultPlan(n_nodes=n, steps=steps, seed=8, straggler_rate=rate, tau_max=tau)
            late = np.random.default_rng([8, 99, tau, int(rate * 100)]).random((steps, n)) < hard
            plan.delays[late] = tau + 2
            for mode in ("wait", "degrade"):
                r = _faulty(f"straggler {mode} tau={tau} rate={rate}", launches, task, plan,
                            arrays, staleness=StragglerPolicy(mode, tau), **kw)
                ratio = float(np.median(r["mean_sq_error"][tail])) / base_err
                ratios[f"{mode} tau={tau} rate={rate}"] = ratio
                bar = 1.10 if mode == "wait" else 1.20
                check(ratio <= bar, f"7d straggler {mode} tau={tau} rate={rate}: "
                                    f"{ratio:.3f} > {bar}")
    out["straggler_ratios"] = ratios

    # corruption at 10% lying nodes, every mode: screen on within 1.2x of
    # the oracle (the liars offline from t_start), corruption-off bitwise
    n, K, steps, seg = (8, 4, 120, 20) if smoke else (16, 4, 300, 30)
    task, _, arrays, zs = setup(n, K, steps, 12)
    tail = slice(-max(10, steps // 10), None)
    kw = dict(lr=0.05, seed=2, zs=zs, segment_len=seg)
    policy = ScreenPolicy(confirm_streak=2, cooldown_steps=2 * steps, probation_steps=8)
    plan0 = FaultPlan(n_nodes=n, steps=steps, seed=0)
    plain = _faulty("corruption plain", launches, task, plan0, arrays, **kw)
    q0 = QuarantineController(n, policy, lr=0.05)
    clean = _faulty("corruption clean screen", launches, task, plan0, arrays, quarantine=q0,
                    **kw)
    check(np.array_equal(clean["mean_sq_error"], plain["mean_sq_error"])
          and q0.n_quarantines == 0, "7d: the clean screened run is not bitwise the plain one")
    h, t_start = max(1, round(0.1 * n)), 5
    liars, honest = list(range(h)), list(range(h, n))
    oracle_plan = FaultPlan(n_nodes=n, steps=steps, seed=0)
    oracle_plan.alive[t_start:, liars] = False
    oracle = _faulty("corruption oracle", launches, task, oracle_plan, arrays,
                     quarantine=QuarantineController(n, policy, lr=0.05), **kw)

    def honest_tail(r):
        return float(np.median(np.mean(r["sq_error_nodes"][:, honest], axis=1)[tail]))

    corrupt = {}
    for mode, (mult, xor) in {"nan": (np.nan, 0), "sign_flip": (-1.0, 0), "scale:8": (8.0, 0),
                              "bitflip": (1.0, 1 << 25)}.items():
        plan = FaultPlan(n_nodes=n, steps=steps, seed=0)
        plan.corrupt_mult[t_start:, liars] = mult
        plan.corrupt_xor[t_start:, liars] = xor
        q = QuarantineController(n, policy, lr=0.05)
        on = _faulty(f"corruption {mode} screen on", launches, task, plan, arrays, quarantine=q,
                     **kw)
        ratio = honest_tail(on) / honest_tail(oracle)
        corrupt[mode] = {"ratio": ratio, "n_quarantines": q.n_quarantines}
        check(ratio <= 1.2, f"7d corruption {mode}: honest tail {ratio:.3f}x > 1.2x")
    out["corruption"] = corrupt

    # the crash-recovery drill: n = 8, a crash and rejoin of node 3, one
    # warm refresh under the faults, killed at a boundary and resumed
    n, K, steps, seg = 8, 4, 120, 20
    task, res0, _, zs = setup(n, K, steps, 4)
    plan = FaultPlan.from_node_churn(NodeChurn(Pi0=task.Pi, events=((30, 3, 25),), seed=0),
                                     steps=steps, seed=5, straggler_rate=0.3, tau_max=2,
                                     edge_drop_rate=0.05)

    def drill():
        ref = TopologyRefresher(res0, RefreshConfig(budget=4, lam=lam), device="cuda")
        done = {"swapped": False}

        def hook(t):
            if not done["swapped"] and t >= 39:
                done["swapped"] = True
                ref.refresh(task.Pi)
                return ref.schedule_arrays()
            return None

        return ref.schedule_arrays(), hook

    kw = dict(lr=0.05, seed=2, zs=zs, segment_len=seg)
    arrays, hook = drill()
    full = _faulty("recovery full", launches, task, plan, arrays, on_segment=hook, **kw)
    with tempfile.TemporaryDirectory(prefix="faults_recovery_") as ckpt:
        arrays, hook = drill()
        head = _faulty("recovery head", launches, task, plan, arrays, on_segment=hook,
                       checkpoint_dir=ckpt, stop_after_segments=3, **kw)
        tail_run = _faulty("recovery tail", launches, task, plan, arrays, checkpoint_dir=ckpt,
                           resume=True, **kw)
    glued = np.concatenate([head["mean_sq_error"], tail_run["mean_sq_error"]])
    bitwise = bool(np.array_equal(glued, full["mean_sq_error"])) and \
        bool(np.array_equal(tail_run["theta"], full["theta"]))
    out["recovery"] = {"swaps": full["swaps"], "stopped_at": head["stopped_at"],
                       "resumed_from": tail_run["resumed_from"], "bitwise": bitwise}
    check(full["swaps"] == [39] and head["stopped_at"] == 60 and
          tail_run["resumed_from"] == 60, f"7d recovery: {out['recovery']}")
    check(bitwise, "7d: the resumed run is not bitwise the uninterrupted run")
    note("# 7d faults " + json.dumps(out))
    return out


def phase_robustness(mnist) -> dict:
    """Phase 7; returns the gossip kernels' launches over its counted runs."""
    launches = {"gossip_schedule": 0, "gossip_mix": 0}
    t0 = time.perf_counter()
    phase_probes(mnist, launches)
    phase_compression(mnist, launches)
    phase_staleness(mnist, launches)
    phase_faults(launches)
    note(f"# 7 launches {launches}, {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phases 3-5: the LM slice (recurrentgemma-2b) through the user's entry points
# ---------------------------------------------------------------------------

def layer_counts(cfg) -> tuple[int, int]:
    """(flash_attention layers, RG-LRU layers) of ``cfg``: every attention
    layer, but none with MLA or in whisper (plain PyTorch, as they are
    plain XLA in the reference: no Pallas kernel is on their path)."""
    kinds = [cfg.kind(i) for i in range(cfg.num_layers)]
    plain = cfg.mla is not None or cfg.arch_type == "audio"
    n_attn = 0 if plain else sum(k in ("attn", "local_attn") for k in kinds)
    return n_attn, kinds.count("rglru")


def expect_lm(label: str, counts: dict, flash: int, scan: int, device: torch.device) -> None:
    """The LM kernels' launches of one counted run (none on the CPU)."""
    if device.type != "cuda":
        flash = scan = 0
    want = {"gossip_schedule": 0, "gossip_mix": 0, "flash_attention": flash,
            "flash_attention_bwd": 0, "rglru_scan": scan, "auction": 0}
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    note(f"# {label}: launches flash_attention={flash} rglru_scan={scan}")


def _median_s(fn, *args, repeats: int = 3, **kwargs) -> float:
    return float(np.median([counted(fn, *args, **kwargs)[2] for _ in range(repeats)]))


def device_profile(fn, *args, **kwargs) -> tuple[dict, int]:
    """Device ms of one ``fn(...)`` by kernel (and copy) from
    ``torch.profiler``, and the number of device operations it ran. Reads
    the profiler's raw events: building ``key_averages()``'s event tree
    costs ~0.1 ms an event on the host, minutes for a forward of the
    xLSTM's ~580k small kernels."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        counted(fn, *args, **kwargs)
    per_kernel: dict[str, float] = {}
    n_ops = 0
    for e in prof.profiler.kineto_results.events():
        ns = e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA and ns > 0:
            per_kernel[e.name()] = per_kernel.get(e.name(), 0.0) + ns / 1e6
            n_ops += 1
    return per_kernel, n_ops


def kernel_ms(per_kernel: dict, name: str) -> float:
    """Device ms of a ``device_profile`` in kernels whose name holds ``name``."""
    return sum(v for k, v in per_kernel.items() if name in k)


def top_kernels(per_kernel: dict) -> dict:
    """The ten largest entries of a ``device_profile``, in ms."""
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {k[:90]: round(v, 3) for k, v in top}


def stub_inputs(cfg, B: int, device, seed: int = 0) -> dict:
    """Whisper's frames or the VLM's patch embeddings, N(0, 0.1) from
    ``seed`` in the model's dtype (``make_inputs`` gives the reference's
    zeros); none for the other families."""
    if cfg.arch_type == "audio":
        key, shape = "frames", (B, cfg.encoder.num_frames, cfg.d_model)
    elif cfg.arch_type == "vlm":
        key, shape = "image_embeds", (B, cfg.vision.num_patches, cfg.d_model)
    else:
        return {}
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device) * 0.1
    return {key: x.to(dtype_of(cfg))}


def image_positions(cfg) -> int:
    """Positions the VLM's patches take before the text (0 otherwise)."""
    return cfg.vision.num_patches if cfg.arch_type == "vlm" else 0


def phase_scoring(cfg, B: int, S: int, device: torch.device,
                  label: str = "3") -> tuple[dict, object]:
    """Phase 3 (and 8-10): ``loss_fn`` / ``model_forward`` with the kernels
    at full width; ``label`` heads the result lines and checks. The VLM's
    S positions hold its patches and ``S - patches`` tokens; whisper's
    decoder takes min(S, 448) tokens against its encoded frames."""
    n_attn, n_rglru = layer_counts(cfg)
    model = registry.init_model(cfg, seed=0, device=device)
    batch = registry.make_inputs(cfg, B, S, seed=0, device=device)
    batch.update(stub_inputs(cfg, B, device))
    S_text = batch["tokens"].shape[1]
    S = image_positions(cfg) + S_text  # the forward's positions
    out: dict = {"params": sum(p.numel() for p in model.parameters()), "positions": S,
                 "text_tokens": S_text}
    with torch.inference_mode():
        (loss, metrics), counts, out["loss_s"] = counted(registry.loss_fn, model, cfg, batch,
                                                         impl="kernel")
        # the loss is the NLL, plus router_aux_coef * aux with MoE
        out["nll"], out["aux"] = float(metrics["nll"]), float(metrics["aux"])
        expect_lm(f"{label} loss_fn kernel path", counts, n_attn, n_rglru, device)
        launches = counts
        torch.cuda.reset_peak_memory_stats()
        (logits, _, _), counts, out["forward_s"] = counted(
            registry.model_forward, model, cfg, batch, impl="kernel")
        out["forward_peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        expect_lm(f"{label} model_forward kernel path", counts, n_attn, n_rglru, device)
        launches = {k: launches[k] + counts[k] for k in launches}
        check(tuple(logits.shape) == (B, S, cfg.vocab_size), f"{label}: logits shape")
        check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
        # the loss recomputed from the forward's text logits, one row at a
        # time in float64, and the logit of each position's own input token:
        # with the tied, sqrt(d)-scaled embedding it dominates at random init
        nll, own = [], []
        for b in range(B):
            lf = logits[b, S - S_text :].double()
            nll.append(torch.logsumexp(lf, -1) - lf.gather(-1, batch["labels"][b, :, None])[:, 0])
            own.append(lf.gather(-1, batch["tokens"][b, :, None])[:, 0])
        del logits, lf
        plain_loss, _ = registry.loss_fn(model, cfg, batch, impl="plain")
        out["loss"], out["plain_loss"] = float(loss), float(plain_loss)
        out["loss_from_logits"] = float(torch.cat(nll).mean())
        out["own_token_logit_mean"] = float(torch.cat(own).mean())
        out["ln_vocab"] = math.log(cfg.vocab_size)
        note(f"# {label} loss {out['loss']:.5f} (plain {out['plain_loss']:.5f}; nll "
             f"{out['nll']:.5f}, from the forward's logits {out['loss_from_logits']:.5f}; aux "
             f"{out['aux']:.5f}), ln(vocab) {out['ln_vocab']:.5f}, mean logit of the input "
             f"token {out['own_token_logit_mean']:.3f}")
        check(math.isfinite(out["loss"]), f"{label}: non-finite loss")
        check(out["nll"] >= out["ln_vocab"] - 1.0,
              f"{label}: loss below ln(vocab) - 1 on random labels")
        check(abs(out["nll"] - out["loss_from_logits"]) <= 1e-2,
              f"{label}: loss_fn and the forward's logits give losses more than 1e-2 apart")
        check(abs(out["loss"] - out["plain_loss"]) <= 1e-2,
              f"{label}: kernel and plain losses differ by more than 1e-2")
        fwd = _median_s(registry.model_forward, model, cfg, batch, impl="kernel")
        out["forward_steady_s"] = fwd
        out["tokens_per_s"] = B * S / fwd
        out["plain_forward_steady_s"] = _median_s(registry.model_forward, model, cfg, batch,
                                                  impl="plain")
        per_kernel, out["device_ops"] = device_profile(
            registry.model_forward, model, cfg, batch, impl="kernel")
        out["device_ms"] = sum(per_kernel.values())
        out["top_kernels_ms"] = top_kernels(per_kernel)
        out["rglru_scan_device_ms"] = kernel_ms(per_kernel, "rglru_scan_kernel")
        out["flash_attention_device_ms"] = kernel_ms(per_kernel, "flash_fwd")
        out["device_busy_share"] = out["device_ms"] / (1e3 * fwd)
    return {"scoring": out, "launches": launches}, model


def phase_f32_depth3(cfg_full, B: int, S: int, device: torch.device,
                     label: str = "3b", depth: int = 3) -> tuple[dict, object]:
    """Phase 3b (and 8-10): the same forward in float32 at ``depth`` layers
    (3: for recurrentgemma-2b rglru, rglru, local_attn), kernel path
    against plain path at 1e-4; with MoE, the kernel path routed as the
    plain path."""
    cfg = dataclasses.replace(cfg_full, num_layers=depth, dtype="float32")
    n_attn, n_rglru = layer_counts(cfg)
    model = registry.init_model(cfg, seed=2, device=device)
    batch = registry.make_inputs(cfg, B, S, seed=2, device=device)
    batch.update(stub_inputs(cfg, B, device, seed=2))
    out: dict = {"depth": depth}
    # MoE: a router top-k is a threshold, and the kernel path's ~1e-6 moves
    # can swap near-tied experts; with capacity drops a swap reorders both
    # experts' queues, so the paths are compared with the kernel path routed
    # to the plain path's experts (its own gate values), and the swaps of
    # the unpinned kernel path are counted
    pinned = cfg.moe is not None
    with torch.inference_mode():
        with moe_routes() as plain_routes:
            plain, _, _ = registry.model_forward(model, cfg, batch, impl="plain")
        with moe_routes() as kernel_routes:
            (kernel, _, _), counts, _ = counted(registry.model_forward, model, cfg, batch,
                                                impl="kernel")
        expect_lm(f"{label} f32 depth-{depth} forward, kernel path", counts, n_attn, n_rglru,
                  device)
        if pinned:
            out["unpinned_max_abs_err"] = float((kernel - plain).abs().max())
            out["swapped_choices_by_layer"] = [
                int((torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1).sum())
                for a, b in zip(plain_routes, kernel_routes)]
            with moe_routes(plain_routes):
                kernel, _, _ = registry.model_forward(model, cfg, batch, impl="kernel")
        err = out["max_abs_err"] = float((kernel - plain).abs().max())
        note(f"# {label} f32 depth {depth}: max |kernel - plain| logits {err:.3e}"
             + ("" if not pinned else
                f" (routes pinned; unpinned {out['unpinned_max_abs_err']:.3e}, token-layers "
                f"with swapped experts {out['swapped_choices_by_layer']})"))
        check(torch.allclose(kernel, plain, atol=1e-4, rtol=1e-4),
              f"{label}: f32 kernel and plain logits differ by {err:.3e} (atol = rtol = 1e-4)")
        del kernel, plain
        with moe_routes() as loss_routes:
            out["plain_loss"] = float(registry.loss_fn(model, cfg, batch, impl="plain")[0])
        with moe_routes(loss_routes if pinned else None):
            out["loss"] = float(registry.loss_fn(model, cfg, batch, impl="kernel")[0])
        check(abs(out["loss"] - out["plain_loss"]) <= 1e-4,
              f"{label}: f32 kernel and plain losses differ")
    return out, model


def eager_generate(model, cfg, prompt: torch.Tensor, new_tokens: int, extra: dict | None = None,
                   long_context: bool = False):
    """The eager reference of ``generate``: ``prefill``, then a loop over
    ``decode_step`` (both in the mode of ``long_context``); ``extra``: the
    frames or patch embeddings. Returns (tokens (B, new_tokens), each
    step's logits, the decode loop's wall seconds)."""
    extra = extra or {}
    B, S = prompt.shape
    S += image_positions(cfg)
    with torch.inference_mode():
        logits, cache = engine.prefill(model, cfg, prompt, max_len=S + new_tokens + 1,
                                       long_context=long_context, **extra)
        toks, all_logits = [logits.argmax(-1, keepdim=True)], [logits]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(S, S + new_tokens - 1):
            position = torch.full((B, 1), pos, device=prompt.device)
            logits, cache = engine.decode_step(model, cfg, toks[-1], position, cache,
                                               long_context=long_context)
            toks.append(logits.argmax(-1, keepdim=True))
            all_logits.append(logits)
        torch.cuda.synchronize()
        return torch.cat(toks, dim=1), all_logits, time.perf_counter() - t0


def decode_steps(dec, steps: int) -> None:
    """``steps`` steps of a started decoder (replays, once it has captured)."""
    for _ in range(steps):
        dec.step()


def timed_decode(dec, prompt: torch.Tensor, steps: int, extra: dict) -> float:
    """Wall seconds of ``steps`` decoder steps after a (untimed) start."""
    dec.start(prompt, **extra)
    return counted(decode_steps, dec, steps)[2]


def decoder_logits(dec, prompt: torch.Tensor, new_tokens: int, extra: dict | None = None) -> list:
    """Each step's logits of the decoder ``generate`` uses, stepped by hand."""
    dec.start(prompt, **(extra or {}))
    out = [dec.logits.clone()]
    for _ in range(new_tokens - 1):
        dec.step()
        out.append(dec.logits.clone())
    return out


def phase_serving(model, cfg, B: int, prompt_len: int, new_tokens: int,
                  device: torch.device, label: str = "4") -> dict:
    """Phase 4 (and 8-10): prefill and greedy ``generate`` at full width.
    ``generate`` runs its decode step as a CUDA graph (``serve.engine.
    Decoder``); the eager reference is a loop over ``decode_step``. The
    graph's tokens must be the loop's and each step's logits bitwise the
    loop's, with one capture. Decode is timed and profiled over the
    ``new_tokens - 1`` decode steps alone, after a prefill outside the
    timed region (the graph's on the started decoder); the busy shares are
    profiler device time over unprofiled wall time. The VLM's prompt
    follows its patches (the prefill's positions count them); whisper's
    prefill encodes its frames first."""
    n_attn, n_rglru = layer_counts(cfg)
    positions = image_positions(cfg) + prompt_len
    prompt = registry.make_inputs(cfg, B, positions, seed=1, device=device)["tokens"]
    check(prompt.shape[1] == prompt_len, f"{label}: a prompt of {prompt.shape[1]} tokens")
    extra = stub_inputs(cfg, B, device, seed=1)
    max_len = positions + new_tokens + 1
    steps = new_tokens - 1
    out: dict = {"prompt_len": prompt_len, "prefill_positions": positions,
                 "new_tokens": new_tokens}
    with torch.inference_mode():
        _, counts, _ = counted(engine.prefill, model, cfg, prompt, max_len=max_len, **extra)
        expect_lm(f"{label} prefill", counts, n_attn, n_rglru, device)
        launches = counts
        out["prefill_s"] = _median_s(engine.prefill, model, cfg, prompt, max_len=max_len, **extra)
        out["prefill_tokens_per_s"] = B * positions / out["prefill_s"]
        prefill_kernels, prefill_ops = device_profile(engine.prefill, model, cfg, prompt,
                                                      max_len=max_len, **extra)
    out["prefill_device_ops"] = prefill_ops
    out["prefill_top_kernels_ms"] = top_kernels(prefill_kernels)
    out["prefill_rglru_scan_device_ms"] = kernel_ms(prefill_kernels, "rglru_scan_kernel")
    out["prefill_flash_attention_device_ms"] = kernel_ms(prefill_kernels, "flash_fwd")
    out["prefill_device_busy_share"] = sum(prefill_kernels.values()) / (1e3 * out["prefill_s"])

    (eager_toks, eager_logits, _), counts, _ = counted(eager_generate, model, cfg, prompt,
                                                       new_tokens, extra)
    expect_lm(f"{label} eager decode loop (prefill + decode)", counts, n_attn, n_rglru, device)
    gen_kw = dict(max_new_tokens=new_tokens, device=device, **extra)
    toks, counts, _ = counted(engine.generate, model, cfg, prompt, **gen_kw)
    expect_lm(f"{label} generate (prefill + captured decode)", counts, n_attn, n_rglru,
              device)
    launches = {k: launches[k] + counts[k] for k in launches}
    dec = engine.decoder_for(model, cfg, B, max_len)
    check(dec.n_captures == 1, f"{label}: {dec.n_captures} captures of the decode step")
    check(tuple(toks.shape) == (B, new_tokens), f"{label}: generated tokens' shape")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"{label}: tokens out of range")
    check(torch.equal(toks, eager_toks), f"{label}: captured and eager greedy tokens differ")
    graph_logits = decoder_logits(dec, prompt, new_tokens, extra)  # replays only
    differ = [i for i, (a, b) in enumerate(zip(graph_logits, eager_logits))
              if not torch.equal(a, b)]
    out["logits_bitwise_steps"] = len(graph_logits) - len(differ)
    out["logits_max_abs_diff"] = max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(graph_logits, eager_logits))
    check(not differ, f"{label}: captured logits differ from the eager loop's at steps "
          f"{differ} (max |diff| {out['logits_max_abs_diff']:.3e})")
    check(dec.n_captures == 1, f"{label}: the decode step was captured again")
    out["captures"] = dec.n_captures
    out["capture_ms"] = 1e3 * dec.capture_s if dec.capture_s is not None else None
    out["first_tokens"] = toks[:, :8].tolist()
    del graph_logits, eager_logits

    out["generate_s"] = _median_s(engine.generate, model, cfg, prompt, **gen_kw)
    # the decode steps alone, timed after an untimed prefill (a difference of
    # two whole runs was mostly noise where the prefill dominates, xLSTM's)
    graph_s = np.median([timed_decode(dec, prompt, steps, extra) for _ in range(3)])
    eager_s = np.median([eager_generate(model, cfg, prompt, new_tokens, extra)[2]
                         for _ in range(3)])
    for arm, seconds in (("", graph_s), ("eager_", eager_s)):
        out[f"{arm}decode_ms_per_token"] = 1e3 * float(seconds) / steps
    out["decode_tokens_per_s"] = B * 1e3 / out["decode_ms_per_token"]
    dec.start(prompt, **extra)
    decode_kernels, decode_ops = device_profile(decode_steps, dec, steps)
    out["decode_device_ops_per_token"] = decode_ops / steps
    out["decode_device_ms_per_token"] = sum(decode_kernels.values()) / steps
    out["decode_top_kernels_ms"] = top_kernels(decode_kernels)
    # the eager loop launches the same kernels (profiled on an H100, its
    # device ms per token came within 3% of the graph's), so its busy share
    # is the graph's device time over the loop's own wall time
    for arm in ("", "eager_"):
        out[f"{arm}decode_device_busy_share"] = (out["decode_device_ms_per_token"]
                                                 / out[f"{arm}decode_ms_per_token"])
    return {"serving": out, "launches": launches}


def phase_decode_consistency(model, cfg_f32, B: int, S: int, device: torch.device,
                             label: str = "4b") -> float:
    """Phase 4b (and 8-10): prefill S - 3 tokens (after the VLM's patches,
    or against whisper's encoded frames) into the decoder, decode the last
    three through it (the warm-up, the capture, a replay) and compare each
    step's logits with the full forward's at the reference's 2e-3
    (tests/test_decode_consistency.py)."""
    toks = registry.make_inputs(cfg_f32, B, S, seed=3, device=device)["tokens"]
    S = toks.shape[1]
    extra = stub_inputs(cfg_f32, B, device, seed=3)
    dec = engine.Decoder(model, cfg_f32, B, image_positions(cfg_f32) + S + 8)
    with torch.inference_mode():
        if cfg_f32.arch_type == "audio":
            hidden, _, _ = whisper_mod.whisper_forward(model, cfg_f32, extra["frames"], toks,
                                                       return_hidden=True)
            full = whisper_mod.unembed(model, hidden[:, -3:])
        else:
            hidden, _, _ = model(toks, return_hidden=True, **extra)
            full = unembed(model.embed, hidden[:, -3:], cfg_f32)
        del hidden
        dec.start(toks[:, : S - 3], **extra)
        errs = []
        for i in range(3):
            dec.step(toks[:, S - 3 + i : S - 2 + i])
            errs.append(float((dec.logits - full[:, i]).abs().max()))
    err = max(errs)
    note(f"# {label} f32 depth-{cfg_f32.num_layers} decode (through the decoder) vs full "
         f"forward at positions {S - 3}-{S - 1} of the text: max |diff| "
         f"{', '.join(f'{e:.3e}' for e in errs)}; "
         f"captures {dec.n_captures}")
    check(err < 2e-3, f"{label}: decode and full forward differ by {err:.3e} (limit 2e-3)")
    check(dec.n_captures == 1, f"{label}: {dec.n_captures} captures of the decode step")
    return err


SMOKE_CROSS_DEVICE = {"recurrentgemma-2b": 5, "xlstm-350m": None, "whisper-small": None,
                      "llava-next-mistral-7b": None}  # name -> num_layers (None: the smoke's)


def phase_lm_cross_device() -> float:
    """Phase 5: each smoke config's kernel path on the card against its
    plain path on the CPU (float32; recurrentgemma-2b at num_layers = 5),
    within 1e-4. Returns the largest error."""
    errs = []
    for name, layers in SMOKE_CROSS_DEVICE.items():
        cfg = get_smoke_config(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cpu_model = registry.init_model(cfg, seed=0, device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        batch = registry.make_inputs(cfg, 2, 256, seed=0, device="cpu")
        batch.update(stub_inputs(cfg, 2, "cpu"))
        gpu_batch = {k: v.cuda() for k, v in batch.items()}
        with torch.inference_mode():
            gpu, _, _ = registry.model_forward(gpu_model, cfg, gpu_batch, impl="kernel")
            cpu, _, _ = registry.model_forward(cpu_model, cfg, batch, impl="plain")
            gpu_loss = float(registry.loss_fn(gpu_model, cfg, gpu_batch, impl="kernel")[0])
            cpu_loss = float(registry.loss_fn(cpu_model, cfg, batch, impl="plain")[0])
        err = float((gpu.cpu() - cpu).abs().max())
        note(f"# 5 {name} smoke config, max |cuda kernel path - cpu plain path| {err:.3e}, "
             f"losses {gpu_loss:.6f} and {cpu_loss:.6f}")
        check(torch.allclose(gpu.cpu(), cpu, atol=1e-4, rtol=1e-4),
              f"5 {name}: cuda kernel path and cpu plain path differ by {err:.3e}")
        check(abs(gpu_loss - cpu_loss) <= 1e-4, f"5 {name}: cuda and cpu losses differ")
        errs.append(err)
    return max(errs)


def phase_lm(device: torch.device) -> dict:
    """Phases 3-5; returns the LM kernels' launches over the main-path runs
    (phase 3's loss and forward, phase 4's prefill and generate)."""
    cfg = get_config("recurrentgemma-2b")
    n_attn, n_rglru = layer_counts(cfg)
    check((n_attn, n_rglru) == (8, 18), f"recurrentgemma-2b has {n_attn} + {n_rglru} layers")
    scoring, model = phase_scoring(cfg, 2, 4096, device)
    note("# 3 " + json.dumps(scoring["scoring"]))
    serving = phase_serving(model, cfg, 2, 2560, 32, device)
    note("# 4 " + json.dumps(serving["serving"]))
    del model
    free_card()
    f32, model32 = phase_f32_depth3(cfg, 2, 4096, device)
    note("# 3b f32 depth 3 " + json.dumps(f32))
    phase_decode_consistency(model32, model32.cfg, 2, 2560, device)
    del model32
    free_card()
    phase_lm_cross_device()
    launches = {k: scoring["launches"][k] + serving["launches"][k]
                for k in ("flash_attention", "rglru_scan")}
    return {"launches": launches, "per_forward": {"flash_attention": n_attn,
                                                  "rglru_scan": n_rglru}}


def free_card() -> None:
    """Release a dropped model's memory (its decoder's graph and cache go
    with it) before the next one is built."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8: the dense GQA families at their published widths and full depth
# ---------------------------------------------------------------------------

# name -> (attention layers, serving prompt length): gemma2's prompt
# overruns its 4096 window (a multiple of 512, so the prefill takes the
# chunked attention and the ring clamp, and decode wraps the ring)
DENSE = {"qwen3-0.6b": (28, 2560), "gemma-2b": (18, 2560), "gemma2-2b": (26, 4608),
         "qwen2.5-14b": (48, 2560)}


def phase_dense(name: str, device: torch.device) -> dict:
    """Phase 8 for one family, random bf16 weights from seed 0: scoring at
    B = 2, S = 4096 (one flash_attention launch per attention layer and
    forward; the loss against the plain path and ln(vocab) - 1); f32 at
    depth 3 (kernel against plain path, decode against the full forward
    through the decoder, 2e-3); serving at B = 2 (a ``prompt_len`` prompt,
    32 new tokens), the captured decode against the eager loop."""
    t0 = time.perf_counter()
    label = f"8 {name}"
    cfg = get_config(name)
    n_want, prompt_len = DENSE[name]
    n_attn, n_rglru = layer_counts(cfg)
    check((n_attn, n_rglru) == (n_want, 0), f"{name} has {n_attn} + {n_rglru} layers")
    scoring, model = phase_scoring(cfg, 2, 4096, device, label)
    note(f"# {label} scoring " + json.dumps(scoring["scoring"]))
    t1 = time.perf_counter()
    serving = phase_serving(model, cfg, 2, prompt_len, 32, device, label)
    note(f"# {label} serving " + json.dumps(serving["serving"]))
    del model
    free_card()
    t2 = time.perf_counter()
    f32, model32 = phase_f32_depth3(cfg, 2, 4096, device, label)
    note(f"# {label} f32 depth 3 " + json.dumps(f32))
    f32["decode_max_abs_err"] = phase_decode_consistency(model32, model32.cfg, 2, prompt_len,
                                                         device, label)
    del model32
    free_card()
    note(f"# {label} " + json.dumps(family_summary(name, n_attn, scoring, serving, f32,
                                                    (t0, t1, t2))))
    return {k: scoring["launches"][k] + serving["launches"][k]
            for k in ("flash_attention", "rglru_scan")}


def family_summary(name: str, flash: int, scoring: dict, serving: dict, f32: dict,
                   starts: tuple, **extra) -> dict:
    """Phases 8 and 9's summary line of one family: its parts' headline
    numbers and seconds (``starts``: the scoring, serving and f32 parts')."""
    sc, sv = scoring["scoring"], serving["serving"]
    t0, t1, t2 = starts
    return {
        "family": name, **extra, "params": sc["params"],
        "flash_launches_per_forward": flash,
        "loss": sc["loss"], "plain_loss": sc["plain_loss"], "ln_vocab": sc["ln_vocab"],
        "scoring_tokens_per_s": sc["tokens_per_s"],
        "scoring_device_busy_share": sc["device_busy_share"],
        "flash_attention_device_ms": sc["flash_attention_device_ms"],
        "f32_depth3": f32, "prefill_tokens_per_s": sv["prefill_tokens_per_s"],
        "decode_ms_per_token": sv["decode_ms_per_token"],
        "eager_decode_ms_per_token": sv["eager_decode_ms_per_token"],
        "decode_tokens_per_s": sv["decode_tokens_per_s"],
        "decode_device_busy_share": sv["decode_device_busy_share"],
        "eager_decode_device_busy_share": sv["eager_decode_device_busy_share"],
        "decode_device_ops_per_token": sv["decode_device_ops_per_token"],
        "capture_ms": sv["capture_ms"], "seconds": time.perf_counter() - t0,
        "seconds_by_part": {"scoring": t1 - t0, "serving": t2 - t1,
                            "f32": time.perf_counter() - t2},
    }


def phase_dense_families(device: torch.device) -> dict:
    """Phase 8: every dense family, one at a time (qwen2.5-14b alone is
    29.6 GB of bf16 weights); returns their main-path launches."""
    launches = {"flash_attention": 0, "rglru_scan": 0}
    for name in DENSE:
        for k, v in phase_dense(name, device).items():
            launches[k] += v
    check(launches["rglru_scan"] == 0, "8: the dense families launched rglru_scan")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the MoE families
# ---------------------------------------------------------------------------

# name -> (depth run, flash_attention launches a forward, decode-consistency
# S): qwen3-moe-30b-a3b at its full depth (61.1 GB of bf16 weights fit one
# card); deepseek-v2-236b at its published widths cut to 4 of its 60 layers
# (~8.1 GB of bf16 a layer), its MLA plain on every path (no flash
# attention), and its decode consistency at S = 512: with C >= S at float32
# its expert buffers at 2560 would not fit beside the model
MOE = {"qwen3-moe-30b-a3b": (48, 48, 2560), "deepseek-v2-236b": (4, 0, 512)}


@contextlib.contextmanager
def moe_routes(replay: list | None = None):
    """Record each MoE layer's router top-k in call order (yields the list
    of (B, S, K) expert ids), or, with ``replay``, route each call to the
    recorded experts instead: the gate values are still the call's own
    probabilities of those experts, renormalised. The model returns no
    routes; this wraps ``models.moe.route`` for the smoke's measurements."""
    route, seen = moe_mod.route, []

    def wrapped(params, c, x):
        probs, gate_vals, ids = route(params, c, x)
        if replay is not None:
            ids = replay[len(seen)]
            gate_vals = probs.gather(-1, ids)
            gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
        seen.append(ids)
        return probs, gate_vals, ids

    moe_mod.route = wrapped
    try:
        yield seen
    finally:
        moe_mod.route = route


def drop_share(model, cfg, batch: dict) -> dict:
    """The share of token-choices past their expert's capacity in one
    forward, from each MoE layer's router top-k."""
    with moe_routes() as routes, torch.inference_mode():
        registry.model_forward(model, cfg, batch, impl="kernel")
    B, S = batch["tokens"].shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    C = moe_mod.capacity(S, cfg)
    per_layer = []
    for ids in routes:
        counts = torch.zeros((B, E), dtype=torch.int64, device=ids.device)
        counts.scatter_add_(1, ids.reshape(B, -1), torch.ones_like(ids.reshape(B, -1)))
        per_layer.append(float((counts - C).clamp(min=0).sum()) / (B * S * K))
    return {"capacity": C, "capacity_factor": cfg.moe.capacity_factor,
            "dropped_share": sum(per_layer) / len(per_layer),
            "dropped_share_by_layer_min_max": [min(per_layer), max(per_layer)]}


def decode_weight_bound_ms(model) -> float:
    """Least ms of a decode step from its weights alone: every weight read
    once (the reference's dispatch multiplies every expert, even at one
    token), an untied token table aside (a decode step gathers B rows of
    it; a tied one is also the unembedding, read whole)."""
    untied = any(n == "embed.unembed" for n, _ in model.named_parameters())
    n_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                  if not (untied and n == "embed.table"))
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def phase_moe(name: str, device: torch.device) -> dict:
    """Phase 9 for one family, random bf16 weights from seed 0, B = 2:
    scoring at S = 4096 (flash_attention launches, the loss against the
    plain path, the aux and the dropped share at the config's capacity
    factor), serving (a 2560-token prompt, 32 new tokens, captured decode
    bitwise eager, one capture), f32 at depth 3 (kernel against plain path
    at 1e-4), and decode through the decoder against the full forward
    within 2e-3 at capacity factor E / K (C >= S: nothing drops; at 1.25 the
    full forward drops overflow choices that a one-token step never does)."""
    t0 = time.perf_counter()
    label = f"9 {name}"
    depth, flash, decode_S = MOE[name]
    cfg = dataclasses.replace(get_config(name), num_layers=depth)
    check(layer_counts(cfg) == (flash, 0), f"{name}: {layer_counts(cfg)} kernel layers")
    scoring, model = phase_scoring(cfg, 2, 4096, device, label)
    sc = scoring["scoring"]
    sc["gigabytes"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    sc.update(drop_share(model, cfg, registry.make_inputs(cfg, 2, 4096, seed=0, device=device)))
    note(f"# {label} scoring " + json.dumps(sc))
    t1 = time.perf_counter()
    serving = phase_serving(model, cfg, 2, 2560, 32, device, label)
    sv = serving["serving"]
    sv["decode_weight_bound_ms"] = decode_weight_bound_ms(model)
    note(f"# {label} serving " + json.dumps(sv))
    del model
    free_card()
    t2 = time.perf_counter()
    f32, model32 = phase_f32_depth3(cfg, 2, 4096, device, label)
    note(f"# {label} f32 depth 3 " + json.dumps(f32))
    m = cfg.moe
    no_drop = dataclasses.replace(
        model32.cfg, moe=dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k))
    check(moe_mod.capacity(decode_S, no_drop) >= decode_S, f"{label}: C < S at cf = E / K")
    note(f"# {label} cut: decode consistency at capacity_factor E / K = "
         f"{no_drop.moe.capacity_factor:.4f} (C >= S = {decode_S}, nothing drops), not "
         f"{m.capacity_factor}")
    model32.cfg = no_drop  # the same weights; the capacity factor is read at each forward
    f32["decode_max_abs_err"] = phase_decode_consistency(model32, no_drop, 2, decode_S, device,
                                                         label)
    del model32
    free_card()
    note(f"# {label} " + json.dumps(family_summary(
        name, flash, scoring, serving, f32, (t0, t1, t2), layers=depth,
        published_layers=get_config(name).num_layers, gigabytes=sc["gigabytes"],
        nll=sc["nll"], aux=sc["aux"], dropped_share=sc["dropped_share"],
        decode_weight_bound_ms=sv["decode_weight_bound_ms"],
        decode_device_ms_per_token=sv["decode_device_ms_per_token"])))
    return {k: scoring["launches"][k] + serving["launches"][k]
            for k in ("flash_attention", "rglru_scan")}


def phase_moe_families(device: torch.device) -> dict:
    """Phase 9: both MoE families, one at a time, after phase 8 has freed
    its models; returns their main-path launches."""
    launches = {"flash_attention": 0, "rglru_scan": 0}
    for name in MOE:
        for k, v in phase_moe(name, device).items():
            launches[k] += v
    check(launches["rglru_scan"] == 0, "9: the MoE families launched rglru_scan")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the last three families (xLSTM, whisper, the VLM)
# ---------------------------------------------------------------------------

# name -> (scoring S, serving prompt length, depth of the f32 checks,
# decode-consistency S): xlstm-350m's f32 depth 4 reaches the pattern's
# sLSTM (layer 3) and its decode S = 2560 takes the chunkwise mLSTM in the
# full forward; whisper at full depth (its decoder takes at most 448
# tokens); llava's S counts its 2880 patches (1216 and 512 text tokens)
LAST = {"xlstm-350m": (4096, 2560, 4, 2560), "whisper-small": (448, 64, 12, 448),
        "llava-next-mistral-7b": (4096, 512, 3, 2880 + 512)}


def slstm_loops(model, cfg, B: int, S: int, device: torch.device, fwd_s: float,
                device_ms: float, label: str) -> dict:
    """xLSTM's scoring forward with the sLSTM time loop as CUDA graphs (the
    default) and eagerly, step by step: bitwise equal logits, and both
    loops' tokens/s; the eager loop's busy share is the captured forward's
    device time over its own wall time (the same kernels run)."""
    batch = registry.make_inputs(cfg, B, S, seed=0, device=device)
    before = xlstm_mod.loop_captures()
    with torch.inference_mode():
        captured, _, _ = registry.model_forward(model, cfg, batch)
        with xlstm_mod.slstm_loop("eager"):  # host-bound and steady: timed once
            (eager, _, _), counts, eager_s = counted(registry.model_forward, model, cfg, batch)
    expect_lm(f"{label} eager sLSTM loop", counts, 0, 0, device)
    differ = float((captured.float() - eager.float()).abs().max())
    check(torch.equal(captured, eager), f"{label}: the captured sLSTM loop's logits differ "
          f"from the eager loop's (max |diff| {differ:.3e})")
    out = {"slstm_loop_bitwise": True, "captured_loop_tokens_per_s": B * S / fwd_s,
           "eager_loop_tokens_per_s": B * S / eager_s, "eager_loop_forward_s": eager_s,
           "eager_loop_device_busy_share": device_ms / (1e3 * eager_s),
           "slstm_loop_captures_so_far": xlstm_mod.loop_captures(),
           "slstm_loop_captures_here": xlstm_mod.loop_captures() - before}
    note(f"# {label} sLSTM loop: captured bitwise eager over the whole forward; "
         f"{out['captured_loop_tokens_per_s']:.0f} against {out['eager_loop_tokens_per_s']:.0f} "
         f"tokens/s")
    return out


def phase_last(name: str, device: torch.device) -> dict:
    """Phase 10 for one family, random bf16 weights from seed 0, B = 2:
    scoring (xLSTM also with its eager sLSTM loop), serving (32 new
    tokens, the captured decode bitwise the eager loop, one capture;
    decode ms/token beside the weight bound), the f32 checks (kernel
    against plain path at 1e-4, decode through the decoder within 2e-3 of
    the full forward), and the family's seconds."""
    t0 = time.perf_counter()
    label = f"10 {name}"
    S, prompt_len, depth, decode_S = LAST[name]
    cfg = get_config(name)
    flash = cfg.num_layers if cfg.arch_type == "vlm" else 0
    check(layer_counts(cfg) == (flash, 0), f"{name}: {layer_counts(cfg)} kernel layers")
    scoring, model = phase_scoring(cfg, 2, S, device, label)
    sc = scoring["scoring"]
    sc["gigabytes"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    if cfg.arch_type == "audio":
        sc["encoder_frames"] = cfg.encoder.num_frames
    if "slstm" in cfg.layer_pattern:
        sc.update(slstm_loops(model, cfg, 2, S, device, sc["forward_steady_s"], sc["device_ms"],
                              label))
    note(f"# {label} scoring " + json.dumps(sc))
    t1 = time.perf_counter()
    serving = phase_serving(model, cfg, 2, prompt_len, 32, device, label)
    sv = serving["serving"]
    sv["decode_weight_bound_ms"] = decode_weight_bound_ms(model)
    note(f"# {label} serving " + json.dumps(sv))
    del model
    free_card()
    t2 = time.perf_counter()
    f32, model32 = phase_f32_depth3(cfg, 2, S, device, label, depth=depth)
    note(f"# {label} f32 depth {depth} " + json.dumps(f32))
    f32["decode_max_abs_err"] = phase_decode_consistency(model32, model32.cfg, 2, decode_S,
                                                         device, label)
    del model32
    free_card()
    note(f"# {label} " + json.dumps(family_summary(
        name, flash, scoring, serving, f32, (t0, t1, t2), gigabytes=sc["gigabytes"],
        decode_weight_bound_ms=sv["decode_weight_bound_ms"],
        decode_device_ms_per_token=sv["decode_device_ms_per_token"],
        prefill_positions=sv["prefill_positions"],
        **{k: sc[k] for k in ("eager_loop_tokens_per_s", "slstm_loop_bitwise") if k in sc})))
    return {k: scoring["launches"][k] + serving["launches"][k]
            for k in ("flash_attention", "rglru_scan")}


def phase_last_families(device: torch.device) -> dict:
    """Phase 10: xlstm-350m, whisper-small and llava-next-mistral-7b, one
    at a time, after phase 9 has freed its models; returns their main-path
    launches."""
    launches = {"flash_attention": 0, "rglru_scan": 0}
    for name in LAST:
        for k, v in phase_last(name, device).items():
            launches[k] += v
    check(launches["rglru_scan"] == 0, "10: the last families launched rglru_scan")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: long-context serving (window rings, MLA's wrapping ring)
# ---------------------------------------------------------------------------

# name -> (layers, None: the published depth; prompt length; the f32
# check's window and prompt): qwen3's prompt is twice its 4096 window,
# deepseek's overruns its MLA ring; deepseek's f32 check wraps a ring of
# 512 (at capacity factor E / K, C = S, its f32 dispatch buffers at S 5120
# and depth 3 outgrow the card)
LONG = {"qwen3-0.6b": (None, 8192, 4096, 8192), "deepseek-v2-236b": (4, 4608, 512, 1024)}
LONG_NEW = 32
LONG_CHECKED = 8  # f32 decode steps held to the windowed full forward


def ring_slots(cache: list) -> set:
    """The slots of every attention layer's cache."""
    return {(layer["c_kv"] if "c_kv" in layer else layer["k"]).shape[1]
            for layer in cache if "c_kv" in layer or "k" in layer}


def long_consistency(name: str, window: int, prompt_len: int, device: torch.device,
                     label: str) -> float:
    """Float32 at depth 3, B = 1, ``long_context_window = window`` (MoE at
    capacity factor E / K, so nothing drops): prefill the prompt in the
    long-context mode (the flash kernel), decode ``LONG_CHECKED``
    teacher-forced tokens with ``decode_step(long_context=True)``, and
    hold the prefill's and each step's logits to the plain full forward
    (``impl="plain"``) with ``window_override`` at the same positions (the
    forward runs over the sequence padded to a multiple of 512, so
    attention and MLA take their chunked plain paths; positions past the
    decoded ones cannot reach them: causal)."""
    cfg = dataclasses.replace(get_config(name), num_layers=3, dtype="float32",
                              long_context_window=window)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = registry.init_model(cfg, seed=2, device=device)
    toks = registry.make_inputs(cfg, 1, prompt_len + 512, seed=3, device=device)["tokens"]
    with torch.inference_mode():
        hidden, _, _ = model(toks, window_override=window, return_hidden=True, impl="plain")
        full = unembed(model.embed, hidden[:, prompt_len - 1: prompt_len + LONG_CHECKED], cfg)
        del hidden
        logits, cache = engine.prefill(model, cfg, toks[:, :prompt_len],
                                       max_len=prompt_len + LONG_CHECKED + 1, long_context=True)
        errs = [float((logits - full[:, 0]).abs().max())]
        for i in range(LONG_CHECKED):
            pos = prompt_len + i
            logits, cache = engine.decode_step(model, cfg, toks[:, pos:pos + 1],
                                               torch.full((1, 1), pos, device=device), cache,
                                               long_context=True)
            errs.append(float((logits - full[:, i + 1]).abs().max()))
    check(ring_slots(cache) == {window}, f"{label}: f32 ring slots {ring_slots(cache)}")
    err = max(errs)
    note(f"# {label} f32 depth 3: long-context prefill and {LONG_CHECKED} decode steps vs the "
         f"plain full forward with window_override={window} at positions {prompt_len - 1}-"
         f"{prompt_len + LONG_CHECKED - 1}: max |diff| {err:.3e}")
    check(err < 2e-3, f"{label}: long-context decode and the windowed full forward differ by "
          f"{err:.3e} (limit 2e-3)")
    del model
    free_card()
    return err


def phase_long(name: str, device: torch.device) -> dict:
    """Phase 11 for one family (module docstring)."""
    t0 = time.perf_counter()
    label = f"11 {name}"
    depth, prompt_len, f32_window, f32_prompt = LONG[name]
    cfg = get_config(name)
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    window = cfg.long_context_window
    n_attn, _ = layer_counts(cfg)
    model = registry.init_model(cfg, seed=0, device=device)
    prompt = registry.make_inputs(cfg, 2, prompt_len, seed=1, device=device)["tokens"]
    max_len = prompt_len + LONG_NEW + 1
    steps = LONG_NEW - 1
    out: dict = {"layers": cfg.num_layers, "prompt_len": prompt_len, "window": window,
                 "new_tokens": LONG_NEW}
    gen_kw = dict(max_new_tokens=LONG_NEW, device=device, long_context=True)
    with torch.inference_mode():
        toks, counts, _ = counted(engine.generate, model, cfg, prompt, **gen_kw)
    expect_lm(f"{label} generate(long_context=True)", counts, n_attn, 0, device)
    launches = counts["flash_attention"]
    ring = engine.decoder_for(model, cfg, 2, max_len, long_context=True)
    check(ring.long_context and ring.n_captures == 1, f"{label}: {ring.n_captures} captures")
    check(ring_slots(ring.cache) == {window}, f"{label}: ring slots {ring_slots(ring.cache)}")
    eager_toks, eager_logits, _ = eager_generate(model, cfg, prompt, LONG_NEW,
                                                 long_context=True)
    check(torch.equal(toks, eager_toks), f"{label}: captured and eager long-context tokens differ")
    graph_logits = decoder_logits(ring, prompt, LONG_NEW)
    differ = [i for i, (a, b) in enumerate(zip(graph_logits, eager_logits))
              if not torch.equal(a, b)]
    check(not differ, f"{label}: captured long-context logits differ from the eager loop's at "
          f"steps {differ}")
    out["logits_bitwise_steps"] = len(graph_logits)
    del graph_logits, eager_logits
    out["first_tokens"] = toks[:, :8].tolist()
    with torch.inference_mode():
        for arm, lc in (("long_", True), ("full_", False)):
            out[f"{arm}prefill_ms"] = 1e3 * _median_s(engine.prefill, model, cfg, prompt,
                                                      max_len=max_len, long_context=lc)
    dec_s = np.median([timed_decode(ring, prompt, steps, {}) for _ in range(3)])
    out["long_decode_ms_per_token"] = 1e3 * float(dec_s) / steps
    out["long_slots"] = window
    out["long_captures"] = ring.n_captures
    full = engine.decoder_for(model, cfg, 2, max_len)  # the full caches: a decoder of its own
    check(full is not ring and not full.long_context, f"{label}: the full decoder")
    full.start(prompt)
    decode_steps(full, steps)  # warm-up and capture
    dec_s = np.median([timed_decode(full, prompt, steps, {}) for _ in range(3)])
    out["full_decode_ms_per_token"] = 1e3 * float(dec_s) / steps
    out["full_slots"] = max(ring_slots(full.cache))
    out["full_captures"] = full.n_captures
    check(out["full_slots"] == max_len, f"{label}: full cache of {out['full_slots']} slots")
    check(ring.n_captures == 1 and full.n_captures == 1, f"{label}: captures "
          f"{ring.n_captures} / {full.n_captures}")
    del model, ring, full
    free_card()
    out["f32_depth3_max_abs_err"] = long_consistency(name, f32_window, f32_prompt, device,
                                                     label)
    out["f32_window"], out["f32_prompt_len"] = f32_window, f32_prompt
    out["seconds"] = time.perf_counter() - t0
    note(f"# {label} " + json.dumps(out))
    return {"flash_attention": launches}


def phase_long_context(device: torch.device) -> dict:
    """Phase 11: long-context serving, each family in turn."""
    launches = {"flash_attention": 0}
    for name in LONG:
        launches["flash_attention"] += phase_long(name, device)["flash_attention"]
    return launches


# ---------------------------------------------------------------------------
# Phase 12: LM D-SGD training on one card
# ---------------------------------------------------------------------------

# phases 12-14's model: qwen3-0.6b at its published widths, 14 of its 28
# layers (whole before the serve arms of phase 14 came: four ranks over the
# socket pay ~20-35 ms a collective, and the gossip and TP collectives go
# with the layers)
TRAIN = {"name": "qwen3-0.6b", "layers": 14, "nodes": 4, "batch": 2, "seq": 1024, "lr": 1e-3,
         "steps": 6, "segment": 2, "budget": 2}
GOSSIP = ("gossip_schedule", "gossip_mix")
# a training step's flash calls: the forward kernel and the backward's
ATTENTION = ("flash_attention", "flash_attention_bwd")


def train_config():
    """Phases 12-14's model (``TRAIN``): the config at its depth cut."""
    return dataclasses.replace(get_config(TRAIN["name"]), num_layers=TRAIN["layers"])


LM_KERNELS = GOSSIP + ATTENTION + ("rglru_scan",)


def attention_since(before: dict) -> dict:
    """The flash forward and backward calls since ``before`` (a
    ``launch_counts()``)."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in ATTENTION}


def expect_attention(label: str, got: dict, calls: int, device: torch.device,
                     forwards: int | None = None) -> None:
    """A training run's flash calls (``attention_since``): ``calls``
    backward calls, one a layer, node and step (every full-sequence
    attention trains through the kernels), and ``forwards`` forward calls
    (default ``calls``; more where the backward recomputes the layers or a
    loss is read without gradient); none on the CPU."""
    want = {"flash_attention": calls if forwards is None else forwards,
            "flash_attention_bwd": calls}
    if device.type != "cuda":
        want = {k: 0 for k in ATTENTION}
    check(got == want, f"{label}: flash launches {got}, expected {want}")


def card_batches(corpus: DomainSkewCorpus, Pi: np.ndarray, steps: int, batch: int, seq: int,
                 device: torch.device, seed: int = 0) -> dict:
    """Each step's per-node batches drawn on the card from the corpus's
    domain distributions: a domain per sequence from the node's row of
    ``Pi`` (numpy), its tokens i.i.d. from that domain's unigram, as
    ``TokenBatcher`` draws them on the host with a counter-based generator
    of its own; labels next-token shifted. A token is the first entry of
    the domain's float64 CDF (summed on the host) above a uniform draw of
    ``gen``: the same tokens in every process (``torch.multinomial`` sums
    its CDF on the card in an order that varies from run to run, and then
    draws other tokens)."""
    rng = np.random.default_rng(seed)
    cdf = torch.as_tensor(np.cumsum(np.stack([corpus.domain_probs(k)
                                              for k in range(corpus.n_domains)]), axis=1),
                          dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = Pi.shape[0]
    toks = torch.empty((steps, n, batch, seq + 1), dtype=torch.int64, device=device)
    for t in range(steps):
        for i in range(n):
            for b, dom in enumerate(rng.choice(corpus.n_domains, size=batch, p=Pi[i])):
                u = torch.rand((seq + 1,), generator=gen, dtype=torch.float64, device=device)
                toks[t, i, b] = torch.searchsorted(cdf[dom], u * cdf[dom, -1], right=True
                                                   ).clamp_(max=cdf.shape[1] - 1)
    return {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}


def train_arm(label: str, setup, params, opt, batches: dict, mix=None, rollout: str = "scan",
              swap=None, profile: bool = False) -> dict:
    """Run ``TRAIN["steps"]`` steps in segments of ``TRAIN["segment"]``
    (multi-step calls, or ``run_segments`` when ``swap`` is given); the
    launch counts, the losses, the last segment's ms/step (a replay under
    ``"scan"``), the peak memory; with ``profile``, the device time by
    kernel of one more segment (the first one's batches again)."""
    seg = TRAIN["segment"]
    free_card()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    if swap is not None:
        res = setup.run_segments(params, opt, batches, mix, segment_len=seg, rollout=rollout,
                                 on_segment=lambda t: swap if t == seg - 1 else None)
        losses, seg_s, n_traces = res["losses"], res["segment_s"], res["n_traces"]
        params, opt = res["params"], res["opt_state"]
        check(res["swaps"] == [seg - 1], f"{label}: swaps {res['swaps']}")
    else:
        multi = setup.multi_step_fn(rollout)
        extra = (mix,) if mix is not None else ()
        losses, seg_s = [], []
        for t0 in range(0, TRAIN["steps"], seg):
            tic = time.perf_counter()
            params, opt, lo = multi(params, opt, {k: v[t0:t0 + seg] for k, v in batches.items()},
                                    *extra)
            losses.append(lo.cpu().numpy())
            seg_s.append(time.perf_counter() - tic)
        losses, n_traces = np.concatenate(losses), multi.n_traces
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    prof = None
    if profile:
        first = {k: v[:seg] for k, v in batches.items()}
        wall_s = counted(multi, params, opt, first, *extra)[2]
        per_kernel, n_ops = device_profile(multi, params, opt, first, *extra)
        device_ms = sum(per_kernel.values())
        prof = {"device_ms_per_step": device_ms / seg, "device_ops_per_step": n_ops / seg,
                "device_busy_share": device_ms / (1e3 * wall_s),
                "top_kernels_ms": top_kernels(per_kernel)}
    if swap is None:
        del multi
    free_card()  # the arm's graphs and their memory pools go before the next arm's state
    tokens = TRAIN["nodes"] * TRAIN["batch"] * TRAIN["seq"]
    ms = 1e3 * seg_s[-1] / seg
    out = {"ms_per_step": ms, "tokens_per_s": tokens * 1e3 / ms, "profile": prof,
           "segment_ms": [1e3 * s for s in seg_s], "first_loss": float(losses[0]),
           "last_loss": float(losses[-1]), "captures": n_traces,
           "max_memory_gb": peak / 1e9,
           "launches": {k: counts[k] for k in GOSSIP}}
    check(np.isfinite(losses).all(), f"{label}: non-finite losses")
    check(out["last_loss"] < out["first_loss"], f"{label}: the loss went {out['first_loss']:.4f}"
          f" -> {out['last_loss']:.4f}")
    return {"row": out, "params": params, "opt": opt, "losses": losses, "counts": counts}


# The held mix: the half-step plus per-node noise of a weight's size, so
# that the nodes differ by far more than the limit below (from one shared
# init they differ by little). The kernel and the plain version both sum
# in float32 and round once to bfloat16: elementwise, one rounding of the
# result (2^-7 relative) plus 1e-6 where a sum cancels.
MIX_NOISE = 0.02
MIX_REL, MIX_ABS = 2.0 ** -7, 1e-6


def mix_excess(out: dict, plain: dict) -> float:
    """max |out - plain| / (MIX_REL |plain| + MIX_ABS) over every leaf:
    at most 1 holds."""
    return max(float(((out[k].float() - plain[k].float()).abs()
                      / (MIX_REL * plain[k].float().abs() + MIX_ABS)).max()) for k in out)


def mix_check(label: str, setup, params, batch: dict, schedule) -> dict:
    """One step's mixed parameters through the kernel (``gossip_schedule``
    for a schedule, ``gossip_mix`` for the complete graph): the step's
    parameters must be the kernel mix of its half-step, bitwise; then the
    half-step plus ``MIX_NOISE`` per node, mixed by the kernel, against
    the plain version (``kernels/gossip_mix/ref.py``, on the card) within
    ``mix_excess`` <= 1, where the unmixed input must fail by far."""
    n = TRAIN["nodes"]
    _, grads = setup.grad_fn(params, batch)
    half, _ = _sgd_update(params, grads, None, TRAIN["lr"], 0.0)
    del grads
    after, _, _ = setup.train_step(params, None, batch)
    mix = gossip_fn(schedule, n)
    mixed = mix(half)
    check(all(torch.equal(after[k], mixed[k]) for k in after),
          f"{label}: the step's parameters are not the kernel mix")
    del after, mixed
    g = torch.Generator(device=half[next(iter(half))].device).manual_seed(7)
    for v in half.values():
        v.add_(torch.randn(v.shape, generator=g, device=v.device, dtype=v.dtype),
               alpha=MIX_NOISE)
    mixed = mix(half)
    flat, spec = ravel_stack(half, pad_to=KERNEL_ROW_ALIGN)
    if schedule is not None:
        plain = gossip_schedule_ref(flat, *schedule.operands(flat.device))
    else:
        plain = gossip_mix_ref(flat, torch.full((n, n), 1.0 / n, device=flat.device))
    del flat
    plain = unravel_stack(plain, spec)
    out = {"max_abs_err": max(float((mixed[k].float() - plain[k].float()).abs().max())
                              for k in mixed),
           "excess": mix_excess(mixed, plain), "unmixed_excess": mix_excess(half, plain)}
    check(out["excess"] <= 1.0, f"{label}: kernel and plain mix differ: {out}")
    check(out["unmixed_excess"] > 10.0, f"{label}: the unmixed input passes too: {out}")
    return out


def phase_lm_training(device: torch.device) -> dict:
    """Phase 12 (module docstring): qwen3-0.6b D-SGD on 4 stacked nodes."""
    t_phase = time.perf_counter()
    label = "12 qwen3-0.6b"
    cfg = train_config()
    n, b, S, steps = TRAIN["nodes"], TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    Pi = np.eye(n)  # 4 domains, one a node
    res = learn_topology(Pi, budget=TRAIN["budget"])
    sched = schedule_from_result(res)
    arrays = schedule_to_arrays(sched, device=device)
    corpus = DomainSkewCorpus(cfg.vocab_size, n_domains=n, seed=0)
    # the host batcher draws vocab Gumbel values per token: timed on one
    # 128-token sequence, its rate scaled to a step's (n, b, S + 1) tokens
    batcher = TokenBatcher(corpus, Pi, 1, 127, seed=0)
    tic = time.perf_counter()
    x, y = batcher.node_batch(0, 0)
    batcher_s = time.perf_counter() - tic
    check(x.shape == (1, 127) and np.array_equal(x[:, 1:], y[:, :-1]), f"{label}: batcher")
    batcher_step_s = batcher_s * n * b * (S + 1) / 128
    batches = card_batches(corpus, Pi, steps, b, S, device)
    tokens = n * b * S
    common = dict(n_nodes=n, lr=TRAIN["lr"], device=device)
    setup_a = make_train_setup(cfg, schedule=sched, **common)
    params0 = setup_a.init_params(0)
    n_params = sum(v[0].numel() for v in params0.values())
    bound_ms = 1e3 * n * 6 * n_params * (b * S) / PEAK_OPS_PER_S[torch.bfloat16]
    head = {"nodes": n, "tokens_per_step": tokens, "params_per_node": n_params,
            "schedule_atoms": sched.n_atoms, "communication_atoms": sched.n_communication_atoms,
            "batcher_128_tokens_s": batcher_s, "batcher_step_s_estimate": batcher_step_s,
            "step_bound_ms": bound_ms}
    note(f"# {label} setup " + json.dumps(head))
    rows, launches = {}, {k: 0 for k in GOSSIP + ATTENTION}

    def record(arm: str, out: dict) -> None:
        row = out["row"]
        row["bound_share"] = bound_ms / row["ms_per_step"]
        row["attention"] = {k: out["counts"][k] for k in ATTENTION}
        rows[arm] = row
        for k in GOSSIP + ATTENTION:
            launches[k] += out["counts"][k]
        note(f"# {label} arm {arm} " + json.dumps(row))
        # (d)'s microbatches are a node's sequences: a call a layer each too
        expect_attention(f"{label} {arm}", row["attention"], cfg.num_layers * n * steps, device)

    a = train_arm("(a)", setup_a, params0, None, batches, profile=True)
    record("a_dsgd_schedule_scan", a)
    check(a["row"]["captures"] == 1, f"{label} (a): {a['row']['captures']} captures")
    check(a["counts"]["gossip_schedule"] == steps and a["counts"]["gossip_mix"] == 0,
          f"{label} (a): launches {a['counts']}")
    b_ = train_arm("(b)", setup_a, params0, None, batches, rollout="loop")
    record("b_dsgd_schedule_loop", b_)
    check(np.array_equal(a["losses"], b_["losses"]), f"{label}: scan and loop losses differ")
    check(all(torch.equal(a["params"][k], b_["params"][k]) for k in params0),
          f"{label}: scan and loop parameters differ")
    del b_
    setup_f = make_train_setup(cfg, **common)
    batch0 = {k: v[0] for k, v in batches.items()}
    errs = {"gossip_schedule": mix_check(f"{label} mix", setup_a, a["params"], batch0, sched),
            "gossip_mix": mix_check(f"{label} mix", setup_f, a["params"], batch0, None)}
    note(f"# {label} kernel mix vs plain (bf16, noise {MIX_NOISE} a node, limit "
         f"|d| <= {MIX_REL} |plain| + {MIX_ABS}): " + json.dumps(errs))
    del a
    setup_c = make_train_setup(cfg, online_w=True, **common)
    L = arrays.l_max
    swap = ScheduleArrays(gammas=torch.full((L,), 1.0 / L, device=device),
                          perms=torch.stack([torch.roll(torch.arange(n, device=device), j)
                                             for j in range(L)]).to(torch.int32))
    yard = rank_yardstick(setup_c, params0, batches, arrays, max(RANKS["steps"].values()))
    note(f"# {label} phase 13's yardstick " + json.dumps(yard))
    c = train_arm("(c)", setup_c, params0, None, batches, mix=arrays, swap=swap)
    record("c_online_arrays_swap", c)
    check(c["row"]["captures"] == 1, f"{label} (c): the swap added a capture")
    check(c["counts"]["gossip_schedule"] == steps, f"{label} (c): launches {c['counts']}")
    del c
    # the global batch in microbatches of a node's 2 sequences: one pass over
    # all 8 captures ~63 GB of activations beside the stacked states
    setup_d = make_train_setup(cfg, mode="fsdp", lr=TRAIN["lr"], grad_accum=n, device=device)
    flat_batches = {k: v.reshape(steps, n * b, S) for k, v in batches.items()}
    d = train_arm("(d)", setup_d, {k: v[0] for k, v in params0.items()}, None, flat_batches)
    record("d_fsdp", d)
    check(sum(d["counts"][k] for k in GOSSIP) == 0, f"{label} (d): fsdp mixed")
    del d
    setup_e = make_train_setup(cfg, schedule=sched, momentum=0.9, gossip_every=2, **common)
    e = train_arm("(e)", setup_e, params0, setup_e.init_opt_state(params0), batches)
    record("e_momentum_gossip_every_2", e)
    check(e["counts"]["gossip_schedule"] == steps // 2, f"{label} (e): launches {e['counts']}")
    check(int(e["opt"]["step"]) == steps, f"{label} (e): the step counter")
    del e
    f = train_arm("(f)", setup_f, params0, None, batches)
    record("f_dsgd_complete_graph", f)
    check(f["counts"]["gossip_mix"] == steps * len(params0),
          f"{label} (f): launches {f['counts']}")
    del f
    robust, robust_yard = phase_lm_robust(cfg, sched, arrays, params0, batches, device)
    for k in robust:
        launches[k] += robust[k]
    yard.update(robust_yard)
    del params0
    free_card()
    note(f"# {label} " + json.dumps({
        "seconds": time.perf_counter() - t_phase, "step_bound_ms": bound_ms,
        "ms_per_step": {k: r["ms_per_step"] for k, r in rows.items()},
        "tokens_per_s": {k: r["tokens_per_s"] for k, r in rows.items()},
        "mix_check": errs, "launches": launches}))
    return launches, yard


# phase 12's robustness arms (g)-(j): steps an arm takes (the pool drill
# (g) in segments of one, its restage after step 2; the others in segments
# of 2: an eager warm-up, a capture, a replay under "scan")
ROBUST = {"g": 5, "h": 4, "i": 6, "j": 6, "segment": 2}


def pool_drill(n: int, sched) -> tuple:
    """The staged pool of phase 12 (g) and phase 13 (b): the schedule's
    atoms and an identity slot of headroom, its projection, and the hook's
    swaps -- in pool after the first step (half the weight moves to the
    node itself: another W), a restage after the second (two cyclic shifts
    and the identity)."""
    pool = PermPool.from_schedule(sched, capacity=sched.n_atoms + 1)
    g0, _ = pool.project(sched)
    ident = pool.perms.index(tuple(range(n)), len(pool.perms) - 1)  # the headroom slot
    swapped = 0.5 * np.asarray(g0, np.float32)
    swapped[ident] += 0.5
    shifted = [tuple(int((q + j) % n) for q in range(n)) for j in range(1, 3)]
    new_pool = PermPool(perms=tuple(shifted) + (tuple(range(n)),))
    hook = {0: PoolSwap(gammas=swapped),
            1: PoolSwap(gammas=np.full(3, 1.0 / 3, np.float32), pool=new_pool)}
    return pool, g0, hook


def stale_delays(n: int) -> np.ndarray:
    """The raw delays of phase 12 (h) and phase 13 (c), (ROBUST["h"], n)
    in {0, 1, 2}: phase 13 takes the first rows."""
    return np.random.default_rng(13).integers(0, 3, size=(ROBUST["h"], n))


class _Isolated:
    """A quarantine controller's accounting face: node 1 isolated."""

    def __init__(self, n: int):
        self.n = n

    def mask(self):
        return np.arange(self.n) == 1

    def summary(self):
        return {"isolated": [1]}


def phase_lm_robust(cfg, sched, arrays, params0: dict, batches: dict,
                    device: torch.device) -> tuple[dict, dict]:
    """Phase 12 (g)-(j) (module docstring): the robustness options on the
    stacked nodes. Returns the gossip launches and the losses phase 13's
    ranks are held to."""
    label = "12 qwen3-0.6b"
    n, seg = TRAIN["nodes"], ROBUST["segment"]
    common = dict(n_nodes=n, lr=TRAIN["lr"], device=device, online_w=True)
    launches, yard = {k: 0 for k in GOSSIP + ATTENTION}, {}

    def first(k: int) -> dict:
        return {name: v[:k] for name, v in batches.items()}

    def run(arm: str, fn, k: int):
        free_card()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        tic = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        row = {"steps": k, "seconds": time.perf_counter() - tic,
               "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {name: counts[name] for name in GOSSIP},
               "attention": {name: counts[name] for name in ATTENTION}}
        for name in GOSSIP + ATTENTION:
            launches[name] += counts[name]
        check(counts["gossip_schedule"] > 0, f"{label} {arm}: no gossip_schedule launch")
        expect_attention(f"{label} {arm}", row["attention"], cfg.num_layers * n * k, device)
        return res, row

    def segmented(res: dict, row: dict, seg_len: int) -> dict:
        """The run's row: ms/step of its last segment (a replay under
        "scan"), its losses, captures, swaps and meter."""
        losses = np.asarray(res["losses"])
        check(np.isfinite(losses).all(), f"{label}: non-finite losses {losses}")
        row.update({"ms_per_step": 1e3 * res["segment_s"][-1] / seg_len,
                    "segment_ms": [1e3 * t for t in res["segment_s"]],
                    "losses": losses.tolist(), "captures": res["n_traces"],
                    "recompiles": res["recompiles"], "swaps": res["swaps"],
                    "comm": res["comm"]})
        return row

    # (g) the staged pool: an in-pool swap, then a restage, captured and loop
    pool, g0, hook = pool_drill(n, sched)
    setup = make_train_setup(cfg, sharded_transport="pool", pool=pool, **common)
    k = ROBUST["g"]
    out = {}
    for rollout in ("scan", "loop"):
        res, row = run(f"g {rollout}", lambda: setup.run_segments(
            params0, None, first(k), g0, segment_len=1, rollout=rollout, on_segment=hook.get), k)
        note(f"# {label} arm g_pool_swap_restage_{rollout} " + json.dumps(
            segmented(res, row, 1) | {"transport": res["setup"].sharded_transport}))
        out[rollout] = res
    check(np.array_equal(out["scan"]["losses"], out["loop"]["losses"]) and all(
        torch.equal(out["scan"]["params"][name], out["loop"]["params"][name])
        for name in params0), f"{label} (g): the captured run is not bitwise the loop")
    check(out["loop"]["swaps"] == [0, 1] and out["loop"]["recompiles"] == 1,
          f"{label} (g): swaps {out['loop']['swaps']}, recompiles {out['loop']['recompiles']}")
    yard["g_losses"] = out["loop"]["losses"].tolist()
    del out, res, setup
    # (h) the pool with the bf16 wire and bounded delay (wait, tau_max 1):
    # the EF memory (float32) and a bfloat16 ring of 2 carried
    policy = StragglerPolicy("wait", 1)
    setup = make_train_setup(cfg, sharded_transport="pool", pool=pool, compression="bf16",
                             staleness=policy, **common)
    k, raw = ROBUST["h"], stale_delays(n)
    res, row = run("h", lambda: setup.run_segments(
        params0, setup.init_opt_state(params0), first(k), g0, segment_len=seg, rollout="loop",
        delays=raw), k)
    ring = res["opt_state"]["stale"]["buf"]
    row = segmented(res, row, seg) | {
        "delays": raw.tolist(), "ring_dtype": str(next(iter(ring.values())).dtype),
        "carry_gb": sum(v.numel() * v.element_size() for tree in (ring, res["opt_state"]["ef"])
                        for v in tree.values()) / 1e9}
    note(f"# {label} arm h_pool_bf16_ef_stale " + json.dumps(row))
    yard["h_losses"] = row["losses"]
    del res, ring, setup
    # (i) probes on the ScheduleArrays, captured, against the probes-off twin
    k = ROBUST["i"]

    def probed(setup):
        multi = setup.multi_step_fn("scan")
        p, series, seg_s = params0, [], []
        for t0 in range(0, k, seg):
            tic = time.perf_counter()
            p, _, lo = multi(p, None, {name: v[t0:t0 + seg] for name, v in first(k).items()},
                             arrays)
            torch.cuda.synchronize()
            seg_s.append(time.perf_counter() - tic)
            series.append(lo if isinstance(lo, dict) else {"loss": lo})
        return p, {name: torch.cat([x[name] for x in series]) for name in series[0]}, seg_s, \
            multi.n_traces

    probes = HealthProbes(consensus=True, grad_dev=True)
    (p_on, s_on, t_on, c_on), row = run("i", lambda: probed(
        make_train_setup(cfg, probes=probes, **common)), k)
    (p_off, s_off, t_off, c_off), row_off = run("i off", lambda: probed(
        make_train_setup(cfg, **common)), k)
    check(torch.equal(s_on["loss"], s_off["loss"]) and all(
        torch.equal(p_on[name], p_off[name]) for name in params0),
        f"{label} (i): the probes-on run is not bitwise the probes-off run")
    check(bool(torch.isfinite(s_on["consensus"]).all() and (s_on["consensus"] >= 0).all()),
          f"{label} (i): consensus {s_on['consensus'].tolist()}")
    row.update({"ms_per_step": 1e3 * t_on[-1] / seg, "ms_per_step_probes_off": 1e3 * t_off[-1] / seg,
                "captures": [c_on, c_off], "losses": s_on["loss"].tolist(),
                "consensus": s_on["consensus"].tolist(), "grad_dev": s_on["grad_dev"].tolist(),
                "max_memory_gb_probes_off": row_off["max_memory_gb"]})
    note(f"# {label} arm i_probes " + json.dumps(row))
    del p_on, p_off, s_on, s_off
    # (j) degrade + raw delays + a quarantine on the all-gather transport
    setup = make_train_setup(cfg, staleness=StragglerPolicy("degrade", 1), **common)
    k = ROBUST["j"]
    raw = np.random.default_rng(15).integers(0, 3, size=(k, n))
    res, row = run("j", lambda: setup.run_segments(
        params0, setup.init_opt_state(params0), first(k), arrays, segment_len=seg,
        rollout="scan", delays=raw, quarantine=_Isolated(n)), k)
    row = segmented(res, row, seg) | {"delays": raw.tolist(), "quarantine": res["quarantine"]}
    check(row["comm"]["quarantined_bytes"] > 0, f"{label} (j): nothing quarantined {row['comm']}")
    note(f"# {label} arm j_degrade_delays_quarantine " + json.dumps(row))
    del res, setup
    free_card()
    return launches, yard


def rank_yardstick(setup, params0: dict, batches: dict, arrays, steps: int) -> dict:
    """Phase 13's yardstick: phase 12's online ``ScheduleArrays`` arm on
    the stacked nodes, eagerly, its first ``steps`` steps: every node's
    loss (``grad_fn``) and the step's mean, and a float64 checksum of the
    initial parameters and each node's token sum over those steps (phase
    13's ranks draw the same)."""
    per_node, mean, p = [], [], params0
    for t in range(steps):
        batch = {k: v[t] for k, v in batches.items()}
        per_node.append(setup.grad_fn(p, batch)[0].tolist())
        p, _, loss = setup.train_step(p, None, batch, arrays)
        mean.append(float(loss))
    del p
    free_card()
    return {"per_node": per_node, "mean": mean,
            "init_checksum": float(sum(v[0].double().sum() for v in params0.values())),
            "token_sums": [int(batches["tokens"][:steps, i].sum())
                           for i in range(batches["tokens"].shape[1])]}


# ---------------------------------------------------------------------------
# Phase 13: D-SGD over ranks, four ranks on the one card
# ---------------------------------------------------------------------------

RANKS = {"nodes": 4, "seed": 0, "timeout_s": 600,
         # steps an arm takes (each moves the whole model over the socket);
         # two at least where a loss is held to a yardstick, so that the
         # second loss reads the first step's update
         "steps": {"a": 2, "b": 3, "c": 2, "d_schedule": 2, "d_pmean": 1}}
# NCCL refuses two ranks on one device ("duplicate GPU"); a host id of its
# own per rank makes it take the ranks for separate hosts and move bytes
# over its socket transport (loopback), so the collectives below are real
# NCCL collectives on CUDA tensors of the one card. Only the rank processes
# this phase spawns get this environment; the library sets none of it.
RANK_NCCL_ENV = {"NCCL_SOCKET_IFNAME": "lo"}
# the four ranks' allocators share the card: each is held to a quarter
# (less the contexts), and segments expand, so cached blocks are
# reused rather than one rank's cache starving another's allocation
RANK_MEMORY_FRACTION = 0.235


def rank_env(rank: int) -> dict:
    return {"NCCL_HOSTID": f"chip-smoke-rank-{rank}",
            "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True", **RANK_NCCL_ENV}


def _check_tree() -> dict:
    """The distinct leaf widths of qwen3-0.6b: the embedding (the largest
    leaf), one layer's leaves (every layer has the same) and the final
    norm; shapes from the meta model."""
    meta = transformer.LM(train_config(), "meta")
    return {k: tuple(p.shape) for k, p in meta.named_parameters()
            if k.startswith(("embed.", "layers.0.", "final_norm."))}


def _node_leaf(shape: tuple, node: int, leaf: int, device) -> torch.Tensor:
    """Node ``node``'s float32 value of leaf ``leaf``: N(0, 1) from a seed
    of both, so every rank can draw any node's leaf."""
    gen = torch.Generator(device=device).manual_seed(1000 * leaf + node + 1)
    return torch.randn(shape, generator=gen, device=device)


CHECK_CHUNK = 1 << 24  # columns of a leaf the stacked yardstick mixes at once


def _f32_excess(out: torch.Tensor, want: torch.Tensor, mag: torch.Tensor, terms: int,
                rel: float = 2.0 ** -24) -> float:
    """max |out - want| / (terms x rel x mag + 1e-30): at most 1 is within
    one float32 rounding of each summed term (``mag`` the sum of the terms'
    magnitudes)."""
    return float(((out - want).abs() / (terms * rel * mag + 1e-30)).max())


def rank_transport_checks(rank: int, n: int, group, device, sched, W) -> dict:
    """Phase 13's transports on the distinct leaf widths of qwen3-0.6b,
    float32 nodes drawn from a seed: each rank's output against the stacked
    kernels' on the same four nodes (``mix_schedule_arrays`` /
    ``mix_stacked``: ``gossip_schedule``; ``mix_dense``: ``gossip_mix``),
    leaf by leaf in chunks of columns; one transport's output held at a
    time (and the two the bitwise claims compare)."""
    from repro_torch.core import compression as C
    from repro_torch.core import mixing as M

    shapes = _check_tree()
    names = sorted(shapes)
    own = {k: _node_leaf(shapes[k], rank, i, device) for i, k in enumerate(names)}
    pool = M.PermPool.from_schedule(sched)
    gammas_np, _ = pool.project(sched)
    gammas = torch.as_tensor(gammas_np, device=device)
    arrays = pool.arrays_for(gammas_np, device=device)
    abs_arrays = ScheduleArrays(arrays.gammas.abs(), arrays.perms)
    s_arrays = schedule_to_arrays(sched, device=device)
    abs_sched = ScheduleArrays(s_arrays.gammas.abs(), s_arrays.perms)
    Wt = torch.as_tensor(W, dtype=torch.float32, device=device)
    complete = torch.full((n, n), 1.0 / n, device=device)
    zeros = torch.zeros((n,), dtype=torch.int32, device=device)
    L = arrays.l_max
    max_leaf = max(int(np.prod(s)) for s in shapes.values())
    p_tree = sum(int(np.prod(s)) for s in shapes.values())
    out: dict = {"leaves": len(names), "p_tree": p_tree, "max_leaf": max_leaf, "seconds": {},
                 "bytes": {}, "peak_increment": {}, "excess": {}}

    def run(label, fn):
        M.reset_collective_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tic = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["seconds"][label] = time.perf_counter() - tic
        out["bytes"][label] = dict(M.collective_bytes)
        out["peak_increment"][label] = torch.cuda.max_memory_allocated() - base
        return res

    def held(label, res, yard, terms: int, rel: float = 2.0 ** -24) -> None:
        """``res`` against ``yard(stack) -> (this rank's row, its terms'
        magnitudes)`` on the four nodes, chunk by chunk."""
        worst = 0.0
        for i, k in enumerate(names):
            nodes = [_node_leaf(shapes[k], j, i, device).reshape(-1) for j in range(n)]
            got = res[k].reshape(-1)
            for c0 in range(0, got.numel(), CHECK_CHUNK):
                want, mag = yard(torch.stack([x[c0:c0 + CHECK_CHUNK] for x in nodes]))
                worst = max(worst, _f32_excess(got[c0:c0 + CHECK_CHUNK], want, mag, terms, rel))
            del nodes
        out["excess"][label] = worst

    def schedule_yard(stack):
        return (mix_schedule_arrays(stack, arrays)[rank],
                mix_schedule_arrays(stack.abs(), abs_arrays)[rank])

    def dense_yard(W_):  # gossip_mix multiplies as 3xTF32: ~1e-6 of f32
        return lambda stack: (mix_dense(stack, W_)[rank], mix_dense(stack.abs(), W_.abs())[rank])

    def ef_yard(stack):  # zero memory: x + sum_j W_ij c_j - c_i, c = bf16(x)
        c = stack.to(torch.bfloat16).float()
        return (stack[rank] + mix_schedule_arrays(c, arrays)[rank] - c[rank],
                stack[rank].abs() + mix_schedule_arrays(c.abs(), abs_arrays)[rank]
                + c[rank].abs())

    ag = run("allgather_arrays", lambda: M.mix_arrays_sharded(own, arrays, group))
    held("allgather_arrays", ag, schedule_yard, L + 1)
    pl = run("pool", lambda: M.mix_ppermute_pool(own, gammas, pool, group))
    held("pool", pl, schedule_yard, L + 1)
    bit = lambda a, b: all(torch.equal(a[k], b[k]) for k in names)
    out["bitwise"] = {"allgather_is_pool": bit(ag, pl)}
    res = run("allgather_stale0", lambda: M.mix_arrays_sharded_stale(
        own, M.shard_stale_init(own, 2), arrays, zeros, group)[0])
    out["bitwise"]["allgather_stale0_is_fresh"] = bit(res, ag)
    res = run("pool_stale0", lambda: M.mix_ppermute_pool_stale(
        own, M.shard_stale_init(own, 2), gammas, pool, zeros, group)[0])
    out["bitwise"]["pool_stale0_is_fresh"] = bit(res, pl)
    res = run("ef_identity", lambda: C.mix_arrays_sharded_ef(own, C.ef_init(own), arrays,
                                                             group, "identity")[0])
    out["bitwise"]["identity_wire_is_plain"] = bit(res, ag)
    del ag, pl, res
    res = run("allgather_dense", lambda: M.mix_dense_sharded(own, Wt, group))
    held("allgather_dense", res, dense_yard(Wt), n + 1, 2.0 ** -20)
    res = run("allreduce", lambda: M.mix_allreduce(own, group))
    held("allreduce", res, dense_yard(complete), n + 1, 2.0 ** -20)
    res = run("ppermute", lambda: M.mix_ppermute(own, sched, group))
    held("ppermute", res, lambda stack: (
        mix_stacked(stack, schedule=sched, transport="schedule")[rank],
        mix_schedule_arrays(stack.abs(), abs_sched)[rank]), s_arrays.l_max + 1)
    res = run("ef_bf16_pool", lambda: C.mix_ppermute_pool_ef(own, C.ef_init(own), gammas,
                                                             pool, group, "bf16")[0])
    held("ef_bf16_pool", res, ef_yard, L + 3)
    del res, own
    return out


def rank_checkpoint(rank: int, n: int, setup, params: dict, arrays, t: int) -> dict:
    """Arm (a)'s parameters of the distinct leaf widths (``_check_tree``)
    checkpointed as ``run_segments`` does (``TrainSetup._save``): rank 0
    writes the stacked layout, each leaf
    gathered to it alone when the writer reaches it. Returns the seconds,
    this rank's peak over what it held before, and on rank 0 the written
    embedding's shape and the archive's bytes."""
    from repro_torch.train.checkpoints import latest_step

    with tempfile.TemporaryDirectory(prefix="rank_ckpt_") as ck:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tic = time.perf_counter()
        setup._save(ck, t, params, None, arrays)
        torch.cuda.synchronize()
        out = {"seconds": time.perf_counter() - tic,
               "peak_increment": torch.cuda.max_memory_allocated() - base}
        if rank == 0:
            step = Path(ck) / f"step_{latest_step(ck):08d}"
            manifest = json.loads((step / "manifest.json").read_text())
            out["embed_shape"] = manifest["shapes"][manifest["keys"].index(
                "['params']['embed.table']")]
            out["archive_bytes"] = (step / "arrays.npz").stat().st_size
    return out


def join_ranks(rank: int, n: int, init: str, device: torch.device) -> torch.device:
    """Join this rank process to the group of ``n`` at ``init``: NCCL on
    the card (its share of the card's memory, float32 products in full
    float32), gloo where a rehearsal passes the CPU; returns the rank's
    device. Every rank has passed a barrier when it returns."""
    import datetime

    import torch.distributed as dist

    kw = {}
    if device.type == "cuda":
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_per_process_memory_fraction(RANK_MEMORY_FRACTION, device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init,
                            rank=rank, world_size=n, timeout=datetime.timedelta(seconds=300),
                            **kw)
    dist.barrier()
    return device


def rank_phase(rank: int, n: int, init: str, yard: dict, device: torch.device) -> dict:
    """Phase 13 on one rank (a spawned process; see ``phase_lm_ranks``):
    NCCL on the card (gloo where a rehearsal passes the CPU)."""
    import torch.distributed as dist

    from repro_torch.core import mixing as M

    t0 = time.perf_counter()
    device = join_ranks(rank, n, init, device)
    group = dist.group.WORLD
    out: dict = {"init_s": time.perf_counter() - t0, "backend": M.group_backend(group)}
    reset_launch_counts()
    cfg = train_config()
    b, S, lr = TRAIN["batch"], TRAIN["seq"], TRAIN["lr"]
    Pi = np.eye(n)
    sched = schedule_from_result(learn_topology(Pi, budget=TRAIN["budget"]))
    W = sched.to_matrix()
    tic = time.perf_counter()
    out["transports"] = rank_transport_checks(rank, n, group, device, sched, W)
    out["transports"]["phase_s"] = time.perf_counter() - tic
    free_card()
    steps = RANKS["steps"]
    corpus = DomainSkewCorpus(cfg.vocab_size, n_domains=n, seed=0)
    batches = card_batches(corpus, Pi, max(steps.values()), b, S, device)
    mine = {k: v[:, rank].contiguous() for k, v in batches.items()}
    out["token_sum"] = int(mine["tokens"].sum())
    del batches
    arrays = schedule_to_arrays(sched, device=device)
    pool, g0, hook = pool_drill(n, sched)
    # four ranks share the card: each recomputes its layers' activations in
    # the backward pass (remat); the socket, not the compute, sets a step
    common = dict(group=group, lr=lr, device=device, remat=True)
    arms: dict = {}

    def timed_steps(label, fn, k):
        M.reset_collective_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        tic = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - tic
        arms[label] = {"steps": k, "ms_per_step": 1e3 * seconds / k,
                       "bytes_per_step": {kk: v / k for kk, v in M.collective_bytes.items()},
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "attention": attention_since(before)}
        return res

    def falls(label, setup, params, loss0: float) -> None:
        """The node's loss on its first batch, after the arm, against before."""
        after = float(setup.grad_fn(params, {kk: v[0] for kk, v in mine.items()})[0])
        arms[label].update({"first_batch_loss_before": loss0, "first_batch_loss_after": after})

    # (a) online_w, a ScheduleArrays on the all-gather transport, loop
    setup = make_train_setup(cfg, online_w=True, **common)
    params0 = setup.init_params(RANKS["seed"])
    out["init_checksum"] = float(sum(v.double().sum() for v in params0.values()))
    own, means = [], []
    torch.cuda.reset_peak_memory_stats()
    grad_base = torch.cuda.memory_allocated()
    l0, g = setup.grad_fn(params0, {k: v[0] for k, v in mine.items()})
    peak_grad = torch.cuda.max_memory_allocated()
    del g
    # the same gradient pass keeping its activations, in 2 microbatches
    # (what the ranks would run without remat; not used below)
    kept = make_train_setup(cfg, online_w=True, grad_accum=2, group=group, lr=lr,
                            device=device)
    torch.cuda.reset_peak_memory_stats()
    l_kept, g = kept.grad_fn(params0, {k: v[0] for k, v in mine.items()})
    peak_kept = torch.cuda.max_memory_allocated()
    del g, kept
    free_card()
    p = params0
    attention = {k: 0 for k in ATTENTION}
    for t in range(steps["a"]):
        if t:
            own.append(float(setup.grad_fn(p, {k: v[t] for k, v in mine.items()})[0]))
        else:
            own.append(float(l0))
        M.reset_collective_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        tic = time.perf_counter()
        p, _, loss = setup.train_step(p, None, {k: v[t] for k, v in mine.items()}, arrays)
        means.append(float(loss))
        torch.cuda.synchronize()
        for k, v in attention_since(before).items():
            attention[k] += v
        if t == 0:
            arms["a_allgather_arrays"] = {
                "steps": steps["a"], "ms_first_step": 1e3 * (time.perf_counter() - tic),
                "bytes_per_step": dict(M.collective_bytes),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "peak_grad_gb": peak_grad / 1e9, "grad_base_gb": grad_base / 1e9,
                "peak_grad_no_remat_accum2_gb": peak_kept / 1e9,
                "no_remat_accum2_loss_diff": abs(float(l_kept) - float(l0))}
    arms["a_allgather_arrays"].update({"own_losses": own, "mean_losses": means,
                                       "attention": attention})
    falls("a_allgather_arrays", setup, p, own[0])
    out["checkpoint"] = rank_checkpoint(rank, n, setup, {k: p[k] for k in _check_tree()},
                                        arrays, steps["a"])
    comm = {"a": setup.comm_bytes_per_step}
    del p, setup
    free_card()
    # (b) the staged pool: an in-pool swap, then a restage, from the hook
    setup = make_train_setup(cfg, online_w=True, sharded_transport="pool", pool=pool, **common)
    res = timed_steps("b_pool_swap_restage", lambda: setup.run_segments(
        params0, None, {k: v[:steps["b"]] for k, v in mine.items()}, g0, segment_len=1,
        rollout="loop", on_segment=hook.get), steps["b"])
    arms["b_pool_swap_restage"].update({"losses": res["losses"].tolist(),
                                        "swaps": res["swaps"], "recompiles": res["recompiles"],
                                        "transport": res["setup"].sharded_transport})
    falls("b_pool_swap_restage", setup, res["params"], own[0])
    comm["b"] = setup.comm_bytes_per_step
    comm["b_restaged"] = res["setup"].comm_bytes_per_step
    del res, setup
    free_card()
    # (c) the pool with the bf16 wire and bounded delay (tau_max 1): the
    # raw delays resolved by straggler_pool_stream, one multi-step call
    # (a rank holds one copy of its EF memory and ring beside the step's)
    policy = M.StragglerPolicy("wait", 1)
    setup = make_train_setup(cfg, online_w=True, sharded_transport="pool", pool=pool,
                             compression="bf16", staleness=policy, **common)
    raw = stale_delays(n)[:steps["c"]]
    g_stack, eff = M.straggler_pool_stream(policy, g0, pool, raw)
    p, opt, losses = timed_steps("c_pool_bf16_stale", lambda: setup.multi_step_fn("loop")(
        params0, setup.init_opt_state(params0), {k: v[:steps["c"]] for k, v in mine.items()},
        g_stack, eff), steps["c"])
    arms["c_pool_bf16_stale"].update({"losses": losses.tolist(), "delays": raw.tolist(),
                                      "effective_delays": eff.tolist(),
                                      "ring_dtype": str(opt["stale"]["buf"][
                                          next(iter(opt["stale"]["buf"]))].dtype)})
    del opt
    falls("c_pool_bf16_stale", setup, p, own[0])
    comm["c"] = setup.comm_bytes_per_step
    del p, setup
    free_card()
    # (d) a static schedule (mix_ppermute), the captured rollout against the
    # loop; then the complete graph (pmean)
    setup = make_train_setup(cfg, schedule=sched, **common)
    k = steps["d_schedule"]
    seg = {kk: v[:k] for kk, v in mine.items()}

    def segments(rollout):
        multi = setup.multi_step_fn(rollout)
        q, ls = params0, []
        for t in range(k):
            q, _, lo = multi(q, None, {kk: v[t:t + 1] for kk, v in seg.items()})
            ls.append(lo)
        return q, torch.cat(ls), multi.n_traces

    # gloo cannot capture: a CPU rehearsal runs both as the loop
    pc, lc, traces = timed_steps("d_schedule_scan", lambda: segments(
        "scan" if device.type == "cuda" else "loop"), k)
    pl, ll, _ = timed_steps("d_schedule_loop", lambda: segments("loop"), k)
    arms["d_schedule_scan"].update({"losses": lc.tolist(), "captures": traces})
    arms["d_schedule_loop"]["losses"] = ll.tolist()
    out["captured_is_loop"] = bool(torch.equal(lc, ll)) and all(
        torch.equal(pc[kk], pl[kk]) for kk in pc)
    falls("d_schedule_loop", setup, pl, own[0])
    comm["d_schedule"] = setup.comm_bytes_per_step
    del pc, pl, setup
    free_card()
    setup = make_train_setup(cfg, **common)
    first = {kk: v[:steps["d_pmean"]] for kk, v in mine.items()}
    p, _, losses = timed_steps("d_pmean", lambda: setup.multi_step_fn("loop")(
        params0, None, first), steps["d_pmean"])
    arms["d_pmean"]["losses"] = losses.tolist()
    falls("d_pmean", setup, p, own[0])
    comm["d_pmean"] = setup.comm_bytes_per_step
    del p, setup
    free_card()
    out.update({"arms": arms, "comm_model": comm, "launches": launch_counts(),
                "seconds": time.perf_counter() - t0,
                "max_leaf": max(v.numel() for v in params0.values()),
                "params": sum(v.numel() for v in params0.values())})
    dist.barrier(group=group)
    dist.destroy_process_group()
    return out


def spawn_ranks(worker, n: int, yard: dict, device: torch.device, timeout_s: float,
                label: str) -> tuple[list, float]:
    """``worker`` in n spawned rank processes (one rendezvous file); their
    results in rank order and the wall seconds; every process is joined
    or killed before it returns."""
    import multiprocessing as mp
    import queue as queue_mod

    tic = time.perf_counter()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    results, errors = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=worker, args=(r, n, init, yard, device, q))
                 for r in range(n)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) + len(errors) < n and time.monotonic() < deadline:
                try:
                    rank, res, err = q.get(timeout=5)
                except queue_mod.Empty:
                    if not any(proc.is_alive() for proc in procs):
                        break
                    continue
                (errors if err else results)[rank] = err or res
        finally:
            for proc in procs:
                proc.join(timeout=30)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=10)
    check(not errors, f"{label}: ranks failed:\n" + "\n".join(
        f"rank {r}: {e[-3000:]}" for r, e in sorted(errors.items())))
    check(len(results) == n, f"{label}: {n - len(results)} ranks hung or died "
          f"(exit codes {[proc.exitcode for proc in procs]})")
    return [results[r] for r in range(n)], time.perf_counter() - tic


def _rank_worker(rank: int, n: int, init: str, yard: dict, device: torch.device,
                 queue) -> None:
    """A phase-13 rank process: its NCCL environment, then ``rank_phase``;
    what it returns (or its traceback) goes back on ``queue``."""
    import traceback

    os.environ.update(rank_env(rank))
    try:
        queue.put((rank, rank_phase(rank, n, init, yard, device), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def phase_lm_ranks(yard: dict, device: torch.device) -> dict:
    """Phase 13 (module docstring): D-SGD over four NCCL ranks on the card."""
    t_phase = time.perf_counter()
    label = "13 qwen3-0.6b ranks"
    n = RANKS["nodes"]
    rows, wall = spawn_ranks(_rank_worker, n, yard, device, RANKS["timeout_s"], label)
    n_params, max_leaf = rows[0]["params"], rows[0]["max_leaf"]
    # transports against the stacked kernels, and the port's bitwise claims
    for r, row in enumerate(rows):
        tr = row["transports"]
        check(all(tr["bitwise"].values()), f"{label} rank {r}: bitwise {tr['bitwise']}")
        check(max(tr["excess"].values()) <= 1.0, f"{label} rank {r}: transports {tr['excess']}")
        # one leaf's (n, P_leaf) gather live at a time: n gathered rows of the
        # largest leaf, the outputs and four leaf-sized temporaries, float32
        bound = 1.1 * 4 * ((n + 4) * tr["max_leaf"] + tr["p_tree"])
        check(tr["peak_increment"]["allgather_arrays"] <= bound,
              f"{label} rank {r}: the all-gather mix's peak "
              f"{tr['peak_increment']['allgather_arrays']} B over {bound:.0f} B")
        want = "nccl" if device.type == "cuda" else "gloo"
        check(row["backend"] == want, f"{label} rank {r}: backend {row['backend']}")
        check(abs(row["init_checksum"] - yard["init_checksum"]) == 0.0,
              f"{label} rank {r}: the initial parameters are not phase 12's")
        check(row["token_sum"] == yard["token_sums"][r],
              f"{label} rank {r}: the batches are not phase 12's")
    note(f"# {label} transports (rank 0; distinct leaf widths, float32) " + json.dumps(
        rows[0]["transports"]))
    a = [row["arms"]["a_allgather_arrays"] for row in rows]
    # (a) against phase 12's stacked run: per-node and mean losses, its steps
    for r, arm in enumerate(a):
        for t, loss in enumerate(arm["own_losses"]):
            check(abs(loss - yard["per_node"][t][r]) <= 1e-2,
                  f"{label} (a) rank {r} step {t + 1}: {loss} against phase 12's "
                  f"{yard['per_node'][t][r]}")
        # the step's peak against its gradient pass's, plus n gathered leaves
        bound = 1.1 * (arm["peak_grad_gb"] * 1e9 + 4 * n * max_leaf)
        check(arm["peak_gb"] * 1e9 <= bound, f"{label} (a) rank {r}: step peak "
              f"{arm['peak_gb']:.2f} GB over {bound / 1e9:.2f} GB")
        # the checkpoint: one bfloat16 leaf's (n, P_leaf) gather on rank 0
        # at a time, nothing gathered elsewhere (the largest leaf's bytes)
        ck = rows[r]["checkpoint"]
        bound = 1.1 * 2 * max_leaf * (n if r == 0 else 1)
        check(ck["peak_increment"] <= bound, f"{label} rank {r}: the checkpoint's peak "
              f"{ck['peak_increment']} B over {bound:.0f} B")
    cfg = train_config()
    check(rows[0]["checkpoint"]["embed_shape"] == [n, cfg.vocab_size, cfg.d_model],
          f"{label}: checkpoint layout {rows[0]['checkpoint']}")
    check(rows[0]["checkpoint"]["archive_bytes"] >= 2 * n * rows[0]["transports"]["p_tree"],
          f"{label}: the checkpoint holds {rows[0]['checkpoint']['archive_bytes']} B")
    check(all(row["captured_is_loop"] for row in rows),
          f"{label}: the captured static schedule != loop")
    check(all(row["arms"]["d_schedule_scan"]["captures"] >= 1 for row in rows),
          f"{label}: the static schedule's rollout captured nothing")
    for row in rows:
        b = row["arms"]["b_pool_swap_restage"]
        check(b["swaps"] == [0, 1] and b["recompiles"] == 1, f"{label} (b): {b}")
        # (b) and (c) against phase 12's stacked (g) and (h): the same
        # options, initial parameters and batches, at every step
        for arm, key in (("b_pool_swap_restage", "g_losses"), ("c_pool_bf16_stale", "h_losses")):
            got = row["arms"][arm]["losses"]
            want = yard[key][:len(got)]
            check(len(want) == len(got) and all(abs(x - y) <= MESH_TOL for x, y in zip(got, want)),
                  f"{label} {arm}: losses {got} against the stacked arm's {want}")
        for arm_name, arm in row["arms"].items():
            if "first_batch_loss_after" in arm:
                check(arm["first_batch_loss_after"] < arm["first_batch_loss_before"],
                      f"{label} {arm_name}: the loss did not fall: {arm}")
    # every arm's steps through the flash kernels; remat runs each layer's
    # forward again in the backward
    layers = train_config().num_layers
    for r, row in enumerate(rows):
        for arm_name, arm in row["arms"].items():
            calls = layers * arm["steps"]
            expect_attention(f"{label} {arm_name} rank {r}", arm["attention"], calls, device,
                             forwards=2 * calls)
    launches = {k: sum(row["launches"][k] for row in rows) for k in GOSSIP + ATTENTION}
    check(all(v > 0 for v in launches.values()), f"{label}: yardstick launches {launches}")
    summary = {
        "seconds": time.perf_counter() - t_phase, "ranks_wall_s": wall,
        "init_s": [row["init_s"] for row in rows], "rank_seconds": [row["seconds"] for row in rows],
        "backend": rows[0]["backend"], "nccl_env": {**rank_env(0), "NCCL_HOSTID": "per rank"},
        "params_per_node": n_params,
        "ms_per_step": {k: v.get("ms_per_step", v.get("ms_first_step"))
                        for k, v in rows[0]["arms"].items()},
        "bytes_per_step": {k: v["bytes_per_step"] for k, v in rows[0]["arms"].items()},
        "bytes_model": rows[0]["comm_model"],
        "peak_gb": [{k: v["peak_gb"] for k, v in row["arms"].items()} for row in rows],
        "a_peak_grad_gb": [row["arms"]["a_allgather_arrays"]["peak_grad_gb"] for row in rows],
        "a_peak_grad_no_remat_accum2_gb": [
            row["arms"]["a_allgather_arrays"]["peak_grad_no_remat_accum2_gb"] for row in rows],
        "a_no_remat_accum2_loss_diff": [
            row["arms"]["a_allgather_arrays"]["no_remat_accum2_loss_diff"] for row in rows],
        "checkpoint": [row["checkpoint"] for row in rows],
        "losses": {k: v.get("losses", v.get("mean_losses")) for k, v in rows[0]["arms"].items()},
        "phase12_mean_losses": yard["mean"],
        "a_own_losses": [row["arms"]["a_allgather_arrays"]["own_losses"] for row in rows],
        "phase12_per_node_losses": yard["per_node"],
        "phase12_g_losses": yard["g_losses"], "phase12_h_losses": yard["h_losses"],
        "launches": launches,
        "note": "ranks share one card; NCCL moves bytes over its socket transport (loopback): "
                "not a multi-card rate"}
    note(f"# {label} " + json.dumps(summary))
    return launches


# ---------------------------------------------------------------------------
# Phase 14: tensor parallelism and the mesh modes, four ranks on the one card
# ---------------------------------------------------------------------------

MESH = {"seed": 0, "timeout_s": 600,
        # steps an arm takes: (a) captured and loop (the captured leg then
        # times one more replay), (b) fsdp, (c) dsgd_pod; two each, so that
        # the second loss held to the yardstick reads the first update
        "steps": {"a": 2, "b": 2, "c": 2}}
MESH_TOL = 1e-2  # on losses, against the one-card yardsticks (bfloat16)
# phase 14 (d)-(g): the other families tensor-parallel, (depth -- None:
# whole --, (data, model)); deepseek's one layer is ~10 GB of bf16 a node,
# so data 1: only the tensor-parallel collectives cross the socket
TP_FAMILIES = {"recurrentgemma-2b": (3, (1, 4)), "xlstm-350m": (4, (2, 2)),
               "whisper-small": (None, (2, 2)), "deepseek-v2-236b": (1, (1, 4))}
TP_STEPS = 2  # the second loss reads the first update and its gossip over data
# the TP arms keep their activations (their depths leave room; the sLSTM's
# step loop would run three times with recomputation)
TP_COMMON = dict(lr=TRAIN["lr"], remat=False)
# what a TP arm is held to against its one-card yardstick: its bf16
# losses within TP_LOSS_TOL (3x the largest gap measured, 1.0e-3: at
# random init a loss sits near log V whatever the split); and a float32
# pass at the initial parameters (their bf16 values) on the first batch's
# first sequence (``float32_pass``): its loss within TP_LOSS32_TOL, and the gradient, each rank's block of
# each leaf against the same block of the yardstick's, its norm and
# TP_PROBES Gaussian projections (a projection sees a difference of the
# blocks as its norm) within TP_GRAD_RTOL of the block's norm. In bf16
# the blocks' gaps run to 7% (xlstm) and 19% (deepseek's experts: a
# near-tie at the top-k boundary routes a token differently), where the
# planted faults of scripts/tp_fault_drill.py move them by 40-100%; in
# float32 only the summation order differs (a rare routing flip moves an
# expert block by about one token's share)
TP_LOSS_TOL = 3e-3
TP_LOSS32_TOL = 1e-4
TP_GRAD_RTOL = 2e-2
TP_PROBES = 4
TP_SKETCH_TOKENS = 512  # the float32 pass: the first sequence's first tokens
# phase 14 (h)-(j): the sharded serve setup on the same ranks. key ->
# (family, depth (None: whole), (data, model), prompts, prompt length,
# decode steps, dtype run, the logits' limit against the one-card
# yardstick, relative to their largest magnitude). The weights are drawn
# in the config's bfloat16 from the seed and cast (float32 arms), so a
# rank draws a node's 10 GB of deepseek, not 20
SERVE = {"h": ("qwen3-0.6b", None, (2, 2), 4, 1024, 16, "bfloat16", 3e-2),
         "i": ("recurrentgemma-2b", 3, (1, 4), 2, 1024, 4, "float32", 1e-4),
         "j": ("deepseek-v2-236b", 1, (1, 4), 2, 512, 4, "float32", 1e-4)}
# the CLI's full-width run after phase 14 (4 stacked nodes on the card)
CLI_ARGS = ("--arch", "qwen3-0.6b", "--full", "--data", "4", "--steps", "4",
            "--topology", "stl-fw", "--budget", "2")


def tp_config(name: str):
    depth = TP_FAMILIES[name][0]
    cfg = get_config(name)
    return cfg if depth is None else dataclasses.replace(cfg, num_layers=depth)


def grad_sketch(pairs) -> dict:
    """Per ``(leaf name, gradient block)``: ``[norm, TP_PROBES
    projections]`` in float64, each projection the block's product with
    N(0, 1) draws from a seed of the leaf's name (the same draws in every
    process for a block of the same shape): E(projection^2) is the
    squared norm, so a difference of two blocks shows as its norm."""
    out = {}
    for name, g in pairs:
        g64 = g.detach().reshape(-1).double()
        gen = torch.Generator(device=g64.device).manual_seed(zlib.crc32(name.encode()))
        out[name] = [float(torch.linalg.vector_norm(g64))] + [
            float(torch.dot(g64, torch.randn(g64.shape, generator=gen, device=g64.device,
                                             dtype=torch.float64)))
            for _ in range(TP_PROBES)]
        del g64
    return out


def float32_pass(setup, params: dict, batch: dict, stacked: bool):
    """``setup``'s (a float32 twin's) loss and gradient at ``params``'s
    values on ``batch``'s first step, its first sequence and that
    sequence's first ``TP_SKETCH_TOKENS`` tokens (frames whole), in
    float32: ``(loss, grads)``. ``params`` is emptied for the pass (a rank
    holds its float32 copy, the gradient and the autograd pass's beside
    it) and refilled with its own dtype's values after it (exact: each
    float32 value is one of them)."""
    small = {}
    for k, v in batch.items():
        v = v[0][:, :1] if stacked else v[0][:1]
        if k in ("tokens", "labels"):
            v = v[..., :TP_SKETCH_TOKENS]
        small[k] = v.float() if v.is_floating_point() else v
    dtypes = {k: v.dtype for k, v in params.items()}
    p32 = {k: params.pop(k).float() for k in list(params)}
    loss, grads = setup.grad_fn(p32, small)
    params.update({k: p32.pop(k).to(dtypes[k]) for k in list(p32)})
    return loss, grads


def tp_errors(arm: dict, ref: dict, coords: dict) -> dict:
    """A TP arm's largest gaps to its yardstick ``ref`` at the rank's
    ``coords``: the losses' absolute gap (``loss32``: the float32 pass's),
    and over the leaves of the float32 gradient the relative
    gap of the gradient block's norm and of its projections (scaled by
    the norm times sqrt(TP_PROBES)); ``worst``: the leaf of the larger."""
    want = ref["sketch"][f"{coords['data']},{coords['model']}"]
    got = arm["grad"]
    out = {"loss": max(abs(x - y) for x, y in zip(arm["losses"], ref["mean"])),
           "loss32": abs(arm["loss32"] - ref["loss32"][coords["data"]]),
           "grad_norm": 0.0, "grad_proj": 0.0, "worst": None,
           "leaves_match": sorted(got) == sorted(want)}
    for name, (n0, *p0) in want.items():
        if name not in got:
            continue
        n1, *p1 = got[name]
        scale = n0 * math.sqrt(TP_PROBES)
        diff = math.sqrt(sum((a - b) ** 2 for a, b in zip(p1, p0)))
        norm_err = abs(n1 - n0) / n0 if n0 else (math.inf if n1 else 0.0)
        proj_err = diff / scale if scale else (math.inf if diff else 0.0)
        if max(norm_err, proj_err) > max(out["grad_norm"], out["grad_proj"]):
            out["worst"] = name
        out["grad_norm"] = max(out["grad_norm"], norm_err)
        out["grad_proj"] = max(out["grad_proj"], proj_err)
    return out


def tp_batches(cfg, nodes: int, device: torch.device) -> dict:
    """A family's ``(TP_STEPS, nodes, batch, seq)`` batches in the
    reference's layout: tokens uniform over its vocabulary from the seed
    (next-token labels; whisper's 448 decoder tokens), whisper's stub
    frames N(0, 0.1) from it, the same in every process."""
    seq = TRAIN["seq"]
    if cfg.arch_type == "audio":
        seq = min(seq, registry.WHISPER_MAX_TARGET)
    rng = np.random.default_rng(MESH["seed"])
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TP_STEPS, nodes, TRAIN["batch"],
                                                            seq + 1)), device=device)
    out = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
    if cfg.arch_type == "audio":
        gen = torch.Generator(device=device).manual_seed(MESH["seed"])
        shape = (TP_STEPS, nodes, TRAIN["batch"], cfg.encoder.num_frames, cfg.d_model)
        out["frames"] = (torch.randn(shape, generator=gen, device=device) * 0.1).to(
            dtype_of(cfg))
    return out


def mesh_batches(device: torch.device) -> dict:
    """Phase 12's batches (4 nodes, its seed), nodes 0 and 1: ``(steps, 2,
    batch, seq)``, the reference's layout of 2 nodes (pods) of 2 sequences."""
    cfg = train_config()
    n = RANKS["nodes"]
    corpus = DomainSkewCorpus(cfg.vocab_size, n_domains=n, seed=0)
    batches = card_batches(corpus, np.eye(n), max(MESH["steps"].values()), TRAIN["batch"],
                           TRAIN["seq"], device)
    return {k: v[:, :2].contiguous() for k, v in batches.items()}


def tp_yardstick(name: str, device: torch.device) -> dict:
    """Phase 14 (d)-(g)'s yardstick of one family: on one card, no tensor
    parallelism, its nodes stacked (one node on a mesh of data 1): a
    float32 pass at the initial parameters on the first batch (each
    node's loss, the gradient sketch (``grad_sketch``) of every rank's
    block), then ``TP_STEPS`` steps' mean losses."""
    tic = time.perf_counter()
    cfg = tp_config(name)
    shape = TP_FAMILIES[name][1]
    sizes = {"data": shape[0], "model": shape[1]}
    setup = make_train_setup(cfg, n_nodes=shape[0], **TP_COMMON, device=device)
    p, mean = setup.init_params(MESH["seed"]), []
    batches = tp_batches(cfg, shape[0], device)
    specs = sharding.make_param_specs({k: tuple(v.shape[1:]) for k, v in p.items()}, sizes,
                                      cfg=cfg)
    f32 = make_train_setup(dataclasses.replace(cfg, dtype="float32"), n_nodes=shape[0],
                           **TP_COMMON, device=device)
    loss32, g = float32_pass(f32, p, batches, stacked=True)
    sketch = {f"{d},{m}": grad_sketch(
        (k, sharding.shard(g[k][d], specs[k], sizes, {"data": d, "model": m})) for k in g)
        for d in range(shape[0]) for m in range(shape[1])}
    del g, f32
    for t in range(TP_STEPS):
        p, _, loss = setup.train_step(p, None, {k: v[t] for k, v in batches.items()})
        mean.append(float(loss))
    out = {"mean": mean, "sketch": sketch, "loss32": loss32.tolist(),
           "seconds": time.perf_counter() - tic,
           "node_bytes": sum(v[0].numel() * v.element_size() for v in p.values())}
    del p, setup, batches
    gc.collect()
    return out


def mesh_yardsticks(device: torch.device) -> dict:
    """Phase 14's yardsticks, on the card in this process before the
    spawn, from the ranks' initial parameters (seed 0) and batches: (a)
    the stacked 2-node run of the static schedule (``gossip_schedule``),
    every node's loss (``grad_fn``) before each step and the step's mean;
    (b) a one-card fsdp run on the 4 sequences (phase 12 (d)'s setup);
    (c) the stacked 2-node complete graph (``gossip_mix``) on each pod's 2
    sequences. All recompute activations in the backward (``remat``, the
    same gradients)."""
    t0 = time.perf_counter()
    cfg = train_config()
    steps = MESH["steps"]
    two = mesh_batches(device)
    sched = schedule_from_result(learn_topology(np.eye(2), budget=1))  # 2 one-domain nodes
    common = dict(lr=TRAIN["lr"], device=device, remat=True)
    reset_launch_counts()
    out: dict = {"token_sum": int(two["tokens"].sum()),
                 "sched": {"coeffs": list(sched.coeffs), "perms": [list(p) for p in sched.perms]}}
    setup = make_train_setup(cfg, n_nodes=2, schedule=sched, **common)
    p = setup.init_params(MESH["seed"])
    out["init_checksum"] = float(sum(v[0].double().sum() for v in p.values()))
    per_node, mean = [], []
    for t in range(steps["a"]):
        batch = {k: v[t] for k, v in two.items()}
        per_node.append(setup.grad_fn(p, batch)[0].tolist())
        p, _, loss = setup.train_step(p, None, batch)
        mean.append(float(loss))
    out["a"] = {"per_node": per_node, "mean": mean}
    del p, setup
    free_card()
    setup = make_train_setup(cfg, n_nodes=2, **common)
    p, mean = setup.init_params(MESH["seed"]), []
    for t in range(steps["c"]):
        p, _, loss = setup.train_step(p, None, {k: v[t] for k, v in two.items()})
        mean.append(float(loss))
    out["c"] = {"mean": mean}
    del p, setup
    free_card()
    setup = make_train_setup(cfg, mode="fsdp", **common)
    p, mean = setup.init_params(MESH["seed"]), []
    for t in range(steps["b"]):
        p, _, loss = setup.train_step(p, None, {k: v[t].reshape((-1,) + v.shape[3:])
                                                for k, v in two.items()})
        mean.append(float(loss))
    out["b"] = {"mean": mean}
    out["model_bytes"] = sum(v.numel() * v.element_size() for v in p.values())
    del p, setup, two
    free_card()
    out["tp"] = {name: tp_yardstick(name, device) for name in TP_FAMILIES}
    free_card()
    out["serve"] = {key: serve_yardstick(key, device) for key in SERVE}
    counts = launch_counts()
    out["launches"] = {k: counts[k] for k in LM_KERNELS}
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_phase(rank: int, n: int, init: str, yard: dict, device: torch.device) -> dict:
    """Phase 14 on one rank (a spawned process; see ``phase_lm_mesh``):
    one process group, a ``DeviceMesh`` an arm."""
    import torch.distributed as dist

    from repro_torch.core import mixing as M

    t0 = time.perf_counter()
    device = join_ranks(rank, n, init, device)
    out: dict = {"init_s": time.perf_counter() - t0, "backend": M.group_backend(None)}
    reset_launch_counts()
    cfg = train_config()
    steps = MESH["steps"]
    two = mesh_batches(device)
    out["token_sum"] = int(two["tokens"].sum())
    sched = BirkhoffSchedule(coeffs=tuple(yard["sched"]["coeffs"]),
                             perms=tuple(tuple(p) for p in yard["sched"]["perms"]))
    common = dict(lr=TRAIN["lr"], device=device, remat=True)
    arms: dict = {}
    serve: dict = {}

    def measured(label: str, k: int, fn):
        M.reset_collective_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        tic = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        arms[label] = {"steps": k, "ms_per_step": 1e3 * (time.perf_counter() - tic) / k,
                       "attention": attention_since(before),
                       "bytes_per_step": {kk: v / k for kk, v in M.collective_bytes.items() if v},
                       "collectives_per_step": {kk: v / k for kk, v in
                                                M.collective_calls.items() if v},
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        return res

    def steps_of(setup, rollout: str, params, k: int, own: list | None = None,
                 times: list | None = None, replay: list | None = None):
        multi = setup.multi_step_fn(rollout)
        losses = []
        for t in range(k + (replay is not None)):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            i = min(t, k - 1)  # the timed replay takes the last step's batch again
            batch = setup.local_batch({kk: v[i] for kk, v in two.items()} if setup.mode != "fsdp"
                                      else {kk: v[i].reshape((-1,) + v.shape[3:])
                                            for kk, v in two.items()})
            if own is not None:
                own.append(node_loss(setup, params, batch))
            if t == k:  # one more replay, timed alone, on a copy: the result is the k steps'
                tic = time.perf_counter()
                multi({kk: v.clone() for kk, v in params.items()}, None,
                      {kk: v[None] for kk, v in batch.items()})
                torch.cuda.synchronize()
                replay.append(1e3 * (time.perf_counter() - tic))
                break
            params, _, lo = multi(params, None, {kk: v[None] for kk, v in batch.items()})
            losses.append(lo)
            torch.cuda.synchronize()
            if times is not None:
                times.append(1e3 * (time.perf_counter() - tic))
        return params, torch.cat(losses), multi.n_traces

    # (a) dsgd on (data 2, model 2): the schedule, captured against the loop
    tic = time.perf_counter()
    mesh = mesh_of((2, 2), ("data", "model"))
    setup = make_train_setup(cfg, mesh=mesh, schedule=sched, **common)
    out["mesh_s"] = time.perf_counter() - tic
    params0 = setup.init_params(MESH["seed"])
    out["a_resident_bytes"] = sum(v.numel() * v.element_size() for v in params0.values())
    out["a_coords"] = setup._layout.coords
    own, t_loop, t_scan, t_replay = [], [], [], []
    pl, ll, _ = measured("a_dsgd_tp_loop", steps["a"],
                         lambda: steps_of(setup, "loop", params0, steps["a"], own, t_loop))
    # gloo cannot capture: a CPU rehearsal runs both as the loop
    pc, lc, traces = measured("a_dsgd_tp_scan", steps["a"], lambda: steps_of(
        setup, "scan" if device.type == "cuda" else "loop", params0, steps["a"], None, t_scan,
        t_replay))
    arms["a_dsgd_tp_loop"].update({"losses": ll.tolist(), "own_losses": own, "step_ms": t_loop,
                                   "note": "each step after a grad_fn pass (the node's loss)"})
    # the scan's steps: the eager warm-up, the capture and a replay; then
    # one more replay, timed alone
    arms["a_dsgd_tp_scan"].update({"losses": lc.tolist(), "captures": traces, "step_ms": t_scan,
                                   "replay_ms": t_replay[0]})
    out["a_captured_is_loop"] = bool(torch.equal(lc, ll)) and all(
        torch.equal(pc[k], pl[k]) for k in pc)
    out["a_comm_model"] = setup.comm_bytes_per_step
    del pc, pl, setup, params0
    free_card()
    # (b) fsdp on (data 2, model 2): one model, a quarter a rank at rest
    mesh = mesh_of((2, 2), ("data", "model"))
    setup = make_train_setup(cfg, mesh=mesh, mode="fsdp", **common)
    params0 = setup.init_params(MESH["seed"])
    out["b_resident_bytes"] = sum(v.numel() * v.element_size() for v in params0.values())
    _, lb, _ = measured("b_fsdp", steps["b"], lambda: steps_of(setup, "loop", params0,
                                                                steps["b"]))
    arms["b_fsdp"]["losses"] = lb.tolist()
    del setup, params0
    free_card()
    # (c) dsgd_pod on (pod 2, data 2, model 1): the complete graph over pods
    mesh = mesh_of((2, 2, 1), ("pod", "data", "model"))
    setup = make_train_setup(cfg, mesh=mesh, mode="dsgd_pod", **common)
    params0 = setup.init_params(MESH["seed"])
    out["c_resident_bytes"] = sum(v.numel() * v.element_size() for v in params0.values())
    _, lc2, _ = measured("c_dsgd_pod", steps["c"], lambda: steps_of(setup, "loop", params0,
                                                                    steps["c"]))
    arms["c_dsgd_pod"]["losses"] = lc2.tolist()
    del setup, params0
    free_card()
    # (d)-(g): the other families, tensor-parallel on their meshes, loop
    for name in TP_FAMILIES:
        tp_arm(name, device, measured, arms)
        free_card()
    # (h)-(j): the sharded serve setup, the yardsticks' tokens
    for key in SERVE:
        serve_arm(key, device, yard["serve"][key]["tokens"], serve)
    out.update({"arms": arms, "serve": serve, "launches": launch_counts(),
                "seconds": time.perf_counter() - t0})
    dist.barrier()
    dist.destroy_process_group()
    return out


_MESHES: dict = {}


def mesh_of(shape: tuple, names: tuple):
    """This rank's ``DeviceMesh`` of ``shape``, made once a process (its
    groups' communicators set up once)."""
    if (shape, names) not in _MESHES:
        _MESHES[(shape, names)] = sharding.make_mesh(shape, names)
    return _MESHES[(shape, names)]


def node_loss(setup, params: dict, batch: dict) -> float:
    """A mesh setup's node loss on ``batch`` (a rank's slice): the forward
    of its gradient pass (``tensor_parallel.lm_loss``), no gradient."""
    from repro_torch.train import tensor_parallel

    core = setup._core
    with torch.no_grad():
        return float(tensor_parallel.lm_loss(params, core.cfg, batch, core.plan, core.tp,
                                             impl=core.loss_module.impl))


def tp_arm(name: str, device: torch.device, measured, arms: dict) -> None:
    """Phase 14 (d)-(g) on this rank (the process group joined): the
    family ``name`` tensor-parallel on its mesh, a float32 pass at the
    initial parameters on the first batch (its loss, its gradient sketch),
    then ``TP_STEPS`` steps in the loop, timed by ``measured`` into
    ``arms["tp_" + name]``."""
    cfg = tp_config(name)
    shape = TP_FAMILIES[name][1]
    mesh = mesh_of(shape, ("data", "model"))
    setup = make_train_setup(cfg, mesh=mesh, **TP_COMMON, device=device)
    params0 = setup.init_params(MESH["seed"])
    resident = sum(v.numel() * v.element_size() for v in params0.values())
    local = setup.local_batch(tp_batches(cfg, shape[0], device), lead=1)
    f32 = make_train_setup(dataclasses.replace(cfg, dtype="float32"), mesh=mesh, **TP_COMMON,
                           device=device)
    loss32, g = float32_pass(f32, params0, local, stacked=False)
    sketch = grad_sketch(g.items())
    del g, f32
    label = f"tp_{name}"
    # the loop's carries bound once and the caller's copy dropped: a rank
    # holds one copy of its blocks (deepseek's are 2.55 GB)
    multi = setup.multi_step_fn("loop")
    multi._bind(params0, None)
    del params0
    losses = measured(label, TP_STEPS, lambda: multi.run(local).tolist())
    plan = setup._core.plan
    arms[label].update({
        "losses": losses, "mesh": list(shape), "layers": cfg.num_layers,
        "coords": dict(setup._layout.coords), "grad": sketch, "loss32": float(loss32),
        "resident_bytes": resident, "vocab": plan.vocab, "heads_inside": any(
            not lp["attn"].get("aligned", True) for lp in plan.layers if "attn" in lp)})
    del multi, local, setup


def serve_configs(key: str):
    """(the config the weights are drawn in, the config served) of a
    phase-14 serve arm."""
    name, depth, *_, dtype, _ = SERVE[key]
    cfg = get_config(name)
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    return cfg, dataclasses.replace(cfg, dtype=dtype)


def serve_prompt(key: str, device) -> torch.Tensor:
    """A serve arm's prompts (B, S): uniform tokens from the seed."""
    name, _, _, B, S, *_ = SERVE[key]
    rng = np.random.default_rng(MESH["seed"] + 1)
    return torch.as_tensor(rng.integers(0, get_config(name).vocab_size, (B, S)), device=device)


def serve_model(key: str, device, cast: bool = True):
    """The serve arm's whole model on ``device``: drawn from the seed in
    the config's dtype, cast to the served dtype (``cast``)."""
    cfg_init, cfg = serve_configs(key)
    model = registry.init_model(cfg_init, seed=MESH["seed"], device=device)
    if cast and cfg.dtype != cfg_init.dtype:
        model = model.to(dtype_of(cfg))
        model.cfg = cfg
    return model


def serve_yardstick(key: str, device: torch.device) -> dict:
    """A serve arm's one-card yardstick: ``engine.prefill`` of the prompts,
    then ``decode_step`` eagerly on the greedy tokens; every step's logits
    (float32, on the host) and the tokens fed."""
    tic = time.perf_counter()
    _, cfg = serve_configs(key)
    *_, steps, _, _ = SERVE[key]
    model = serve_model(key, device)
    prompt = serve_prompt(key, device)
    B, S = prompt.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(model, cfg, prompt, max_len=S + steps + 1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out, tokens = [logits.float().cpu()], []
        tok = logits.argmax(dim=-1, keepdim=True)
        t0 = time.perf_counter()
        for t in range(steps):
            tokens.append(tok)
            lo, cache = engine.decode_step(model, cfg, tok, torch.full_like(tok, S + t), cache)
            out.append(lo.float().cpu())
            tok = lo.argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / steps
    del model, cache
    free_card()
    return {"tokens": torch.stack(tokens).cpu().tolist(), "logits": torch.stack(out),
            "prefill_s": prefill_s, "decode_ms": decode_ms,
            "seconds": time.perf_counter() - tic}


def serve_arm(key: str, device: torch.device, tokens: list, arms: dict) -> None:
    """Phase 14 (h)-(j) on this rank: the arm's model split by the serve
    setup's specs (``engine.make_serve_setup``), the sharded prefill of
    its prompts into a fresh cache block, its decode steps on the
    yardstick's tokens by ``serve_step`` (eager, timed), and for (h) the
    same steps through a captured ``MeshDecoder`` from a second prefill;
    into ``arms[key]``."""
    from repro_torch.core import mixing as M

    tic_arm = time.perf_counter()
    name, _, shape, B, S, steps, _, _ = SERVE[key]
    _, cfg = serve_configs(key)
    mesh = mesh_of(shape, ("data", "model"))
    setup = engine.make_serve_setup(cfg, mesh, batch=B, seq_len=S + steps + 1, device=device)
    model = serve_model(key, device, cast=False)  # a rank casts its blocks, not the model
    params = {k: sharding.shard(p.detach(), setup.param_specs[k], mesh).to(dtype_of(cfg))
              for k, p in model.named_parameters()}
    del model
    free_card()
    prompt = setup.local_batch(serve_prompt(key, device))
    toks = [setup.local_batch(torch.as_tensor(t, device=device)) for t in tokens]
    cache = setup.init_cache()
    leaves: list = []
    engine._map_cache(lambda _, t: leaves.append(t) or t, cache, flags=False)
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves)
    param_bytes = sum(v.numel() * v.element_size() for v in params.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts0 = launch_counts()
    M.reset_collective_bytes()
    tic = time.perf_counter()
    logits = [setup.prefill(params, prompt, cache)]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - tic
    counts1 = launch_counts()
    prefill_bytes = {k: v for k, v in M.collective_bytes.items() if v}
    M.reset_collective_bytes()
    eager_ms = []
    for t in range(steps):
        tic = time.perf_counter()
        lo, _ = setup.serve_step(params, toks[t], torch.full_like(toks[t], S + t), cache)
        torch.cuda.synchronize()
        eager_ms.append(1e3 * (time.perf_counter() - tic))
        logits.append(lo)
    out = {"mesh": list(shape), "coords": sharding.mesh_coords(mesh),
           "prefill_s": prefill_s, "eager_ms": eager_ms,
           "flash_prefill": counts1["flash_attention"] - counts0["flash_attention"],
           "scan_prefill": counts1["rglru_scan"] - counts0["rglru_scan"],
           "prefill_bytes": prefill_bytes,
           "bytes_per_token": {k: v / steps for k, v in M.collective_bytes.items() if v},
           "collectives_per_token": {k: v / steps for k, v in M.collective_calls.items() if v},
           "cache_bytes": cache_bytes, "cache_spec_bytes": setup.cache_bytes(),
           "param_bytes": param_bytes, "param_spec_bytes": setup.param_bytes(),
           "token_bytes": 2 * toks[0].numel() * toks[0].element_size()}
    if key == "h":
        dec = setup.decoder(params, setup.init_cache())
        dec.start(prompt)
        captured, cap_ms = [], []
        for t in range(steps):
            tic = time.perf_counter()
            dec.step(toks[t])
            torch.cuda.synchronize()
            cap_ms.append(1e3 * (time.perf_counter() - tic))
            captured.append(dec.logits.clone())
        out.update({"captures": dec.n_captures, "captured_ms": cap_ms,
                    "captured_is_eager": all(torch.equal(c, e)
                                             for c, e in zip(captured, logits[1:]))})
        del dec, captured
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - tic_arm
    # the logits are whole on every rank of a data coordinate: the first
    # model rank returns them, the others a checksum
    out["checksum"] = [float(x.double().sum()) for x in logits]
    if out["coords"]["model"] == 0:  # numpy: a tensor would go back by a file descriptor
        out["logits"] = [x.float().cpu().numpy() for x in logits]
    arms[key] = out
    del params, cache, logits
    free_card()


def dry_run_process(key: str) -> subprocess.Popen:
    """The dry run of a serve arm's decode step at its shape on a fake
    process group of its mesh (``launch/dryrun.py``; the CPU only), in a
    process of its own."""
    name, _, shape, B, S, steps, _, _ = SERVE[key]
    code = (f"import json; from repro_torch.launch import dryrun; "
            f"rec = dryrun.run_one({name!r}, 'decode', '{shape[0]}x{shape[1]}', None, "
            f"shape={{'seq_len': {S + steps + 1}, 'global_batch': {B}, 'kind': 'decode'}}); "
            f"print('RECORD ' + json.dumps(rec))")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


def dry_run_record(proc: subprocess.Popen) -> dict:
    stdout, stderr = proc.communicate(timeout=600)
    line = next((x for x in stdout.splitlines() if x.startswith("RECORD ")), None)
    check(proc.returncode == 0 and line is not None, f"the dry run failed: {stderr[-2000:]}")
    rec = json.loads(line[len("RECORD "):])
    check(rec["status"] == "ok", f"the dry run failed: {rec.get('traceback')}")
    return rec


def phase_cli() -> dict:
    """``python -m repro_torch.launch.train`` (``CLI_ARGS``: qwen3-0.6b
    whole, 4 stacked nodes on the card, STL-FW budget 2) in a process of
    its own: it exits 0, its losses are finite; its s/step."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    tic = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGS],
                          capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
    wall = time.perf_counter() - tic
    check(proc.returncode == 0, f"14 cli: exit {proc.returncode}: {proc.stderr[-3000:]}")
    line = next((x for x in proc.stdout.splitlines() if x.startswith("loss: ")), "")
    vals = [float(v) for v in line.split()[1:4:2]] if line else []
    check(len(vals) == 2 and all(math.isfinite(v) for v in vals),
          f"14 cli: no finite losses in {proc.stdout[-2000:]}")
    steps = [x for x in proc.stdout.splitlines() if x.startswith("step ")]
    s_per_step = float(steps[-1].split("(")[1].split("s/step")[0])
    out = {"args": " ".join(CLI_ARGS), "loss_first": vals[0], "loss_last": vals[1],
           "s_per_step": s_per_step, "wall_s": wall, "steps_printed": steps}
    note("# 14 cli " + json.dumps(out))
    return out


def _mesh_worker(rank: int, n: int, init: str, yard: dict, device: torch.device,
                 queue) -> None:
    """A phase-14 rank process: its NCCL environment, then ``mesh_phase``."""
    import traceback

    os.environ.update(rank_env(rank))
    try:
        queue.put((rank, mesh_phase(rank, n, init, yard, device), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def without_sketches(yard: dict) -> dict:
    """Phase 14's yardsticks less the TP arms' gradient sketches and the
    serve arms' logits."""
    return yard | {"tp": {k: {kk: vv for kk, vv in v.items() if kk != "sketch"}
                          for k, v in yard["tp"].items()},
                   "serve": {k: {kk: vv for kk, vv in v.items() if kk != "logits"}
                             for k, v in yard["serve"].items()}}


def check_tp(where: str, arm: dict, ref: dict, err: dict) -> None:
    """A TP arm against its yardstick (``tp_errors``'s gaps): the losses
    within TP_LOSS_TOL (the float32 pass's within TP_LOSS32_TOL), every
    leaf's gradient block within TP_GRAD_RTOL."""
    check(len(arm["losses"]) == len(ref["mean"]) and err["loss"] <= TP_LOSS_TOL,
          f"{where}: losses {arm['losses']} against the one-card {ref['mean']}")
    check(err["loss32"] <= TP_LOSS32_TOL,
          f"{where}: the float32 loss {arm['loss32']} against the one-card {ref['loss32']}")
    check(err["leaves_match"], f"{where}: the gradient's leaves differ from the yardstick's")
    check(err["grad_norm"] <= TP_GRAD_RTOL and err["grad_proj"] <= TP_GRAD_RTOL,
          f"{where}: gradient blocks off the one-card yardstick's by {err['grad_norm']:.3e} "
          f"(norm), {err['grad_proj']:.3e} (projections), worst {err['worst']}")


def phase_lm_mesh(device: torch.device) -> dict:
    """Phase 14 (module docstring): dsgd with tensor parallelism, fsdp and
    dsgd_pod on four NCCL ranks of the card."""
    t_phase = time.perf_counter()
    label = "14 qwen3-0.6b mesh"
    yard = mesh_yardsticks(device)
    note(f"# {label} yardsticks " + json.dumps(without_sketches(yard)))
    # the ranks take the yardsticks without the sketches, which the checks
    # below read here: a payload past the pipe's 64 KiB makes each spawn
    # wait for the last child to import this module
    dry = dry_run_process("h")  # on the host's CPU while the ranks run
    rows, wall = spawn_ranks(_mesh_worker, RANKS["nodes"], without_sketches(yard), device,
                             MESH["timeout_s"], label)
    serve = check_serve(label, rows, yard, dry_run_record(dry), device)
    tol, tp_err = MESH_TOL, {}
    for r, row in enumerate(rows):
        want = "nccl" if device.type == "cuda" else "gloo"
        check(row["backend"] == want, f"{label} rank {r}: backend {row['backend']}")
        check(row["token_sum"] == yard["token_sum"], f"{label} rank {r}: not phase 12's batches")
        arms = row["arms"]
        node = row["a_coords"]["data"]
        # (a): the node's own loss before each step, and the steps' mean
        for t, loss in enumerate(arms["a_dsgd_tp_loop"]["own_losses"]):
            check(abs(loss - yard["a"]["per_node"][t][node]) <= tol,
                  f"{label} (a) rank {r} step {t + 1}: node loss {loss} against the stacked "
                  f"{yard['a']['per_node'][t][node]}")
        for arm, key in (("a_dsgd_tp_loop", "a"), ("b_fsdp", "b"), ("c_dsgd_pod", "c")):
            got, ref = arms[arm]["losses"], yard[key]["mean"]
            check(len(got) == len(ref) and all(abs(x - y) <= tol for x, y in zip(got, ref)),
                  f"{label} {arm} rank {r}: losses {got} against the yardstick's {ref}")
        check(row["a_captured_is_loop"], f"{label} (a) rank {r}: captured != loop")
        check(arms["a_dsgd_tp_scan"]["captures"] >= 1 or device.type != "cuda",
              f"{label} (a) rank {r}: the rollout captured nothing")
        check(arms["a_dsgd_tp_loop"]["collectives_per_step"].get("tp_all_gather", 0) == 0,
              f"{label} (a) rank {r}: the tensor-parallel pass gathered")
        bound = 1.1 * yard["model_bytes"] / 4
        check(row["b_resident_bytes"] <= bound, f"{label} (b) rank {r}: {row['b_resident_bytes']}"
              f" B of parameters at rest, over {bound:.0f} B")
        for name, (_, shape) in TP_FAMILIES.items():
            arm = arms[f"tp_{name}"]
            err = tp_errors(arm, yard["tp"][name], arm["coords"])
            tp_err.setdefault(name, []).append(err)
            check_tp(f"{label} tp {name} {shape} rank {r}", arm, yard["tp"][name], err)
            # at rest a rank holds its blocks: at most 1.1 x the node over model
            bound = 1.1 * yard["tp"][name]["node_bytes"] / shape[1]
            check(arm["resident_bytes"] <= bound,
                  f"{label} tp {name} rank {r}: {arm['resident_bytes']} B at rest")
    # each arm's flash calls on a rank, remat running a layer's forward again
    # in the backward: (a)'s loop also reads the node's loss without
    # gradient before each step, (a)'s captured leg replays once more; the
    # other families train no attention through the kernels (RG-LRU,
    # mLSTM / sLSTM, whisper's and MLA's attention are plain)
    layers = train_config().num_layers
    for r, row in enumerate(rows):
        arms = row["arms"]
        for arm, calls, no_grad in (
                ("a_dsgd_tp_loop", MESH["steps"]["a"], MESH["steps"]["a"]),
                ("a_dsgd_tp_scan", MESH["steps"]["a"] + 1, 0),
                ("b_fsdp", MESH["steps"]["b"], 0), ("c_dsgd_pod", MESH["steps"]["c"], 0)):
            expect_attention(f"{label} {arm} rank {r}", arms[arm]["attention"], layers * calls,
                             device, forwards=layers * (2 * calls + no_grad))
        for name in TP_FAMILIES:
            expect_attention(f"{label} tp_{name} rank {r}", arms[f"tp_{name}"]["attention"], 0,
                             device)
    r0 = rows[0]["arms"]
    check(r0["tp_recurrentgemma-2b"]["heads_inside"] and
          r0["tp_whisper-small"]["vocab"] == "features",
          f"{label}: the odd placements did not run (recurrentgemma's heads inside a head, "
          f"whisper's table by features)")
    launches = {k: yard["launches"][k] + sum(row["launches"][k] for row in rows)
                for k in LM_KERNELS}
    check(all(v > 0 for v in launches.values()), f"{label}: launches {launches}")
    arms0 = rows[0]["arms"]
    summary = {
        "seconds": time.perf_counter() - t_phase, "yardstick_s": yard["seconds"],
        "ranks_wall_s": wall, "init_s": [row["init_s"] for row in rows],
        "mesh_s": [row["mesh_s"] for row in rows],
        "rank_seconds": [row["seconds"] for row in rows], "backend": rows[0]["backend"],
        "ms_per_step": {k: v["ms_per_step"] for k, v in arms0.items()},
        "a_step_ms": {k: arms0[k]["step_ms"] for k in ("a_dsgd_tp_loop", "a_dsgd_tp_scan")},
        "a_replay_ms": arms0["a_dsgd_tp_scan"]["replay_ms"],
        "bytes_per_step": {k: v["bytes_per_step"] for k, v in arms0.items()},
        "collectives_per_step": {k: v["collectives_per_step"] for k, v in arms0.items()},
        "a_bytes_model": rows[0]["a_comm_model"], "model_bytes": yard["model_bytes"],
        "resident_bytes": {k: [row[f"{k}_resident_bytes"] for row in rows] for k in "abc"},
        "peak_gb": [{k: v["peak_gb"] for k, v in row["arms"].items()} for row in rows],
        "losses": {k: v["losses"] for k, v in arms0.items()},
        "a_own_losses": [row["arms"]["a_dsgd_tp_loop"]["own_losses"] for row in rows],
        "yardsticks": {"a_per_node": yard["a"]["per_node"], "a_mean": yard["a"]["mean"],
                       "b": yard["b"]["mean"], "c": yard["c"]["mean"],
                       "tp": {k: v["mean"] for k, v in yard["tp"].items()}},
        "tp_yardstick_s": {k: v["seconds"] for k, v in yard["tp"].items()},
        "tp_node_bytes": {k: v["node_bytes"] for k, v in yard["tp"].items()},
        "tp_resident_bytes": {k: [row["arms"][f"tp_{k}"]["resident_bytes"] for row in rows]
                              for k in TP_FAMILIES},
        "tp_errors": tp_err, "tp_limits": {"loss": TP_LOSS_TOL, "loss32": TP_LOSS32_TOL,
                                           "grad_rtol": TP_GRAD_RTOL},
        "launches": launches, "serve": serve,
        "note": "ranks share one card; NCCL moves bytes over its socket transport (loopback): "
                "not a multi-card rate"}
    note(f"# {label} " + json.dumps(summary))
    return launches


def logits_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap of two logits arrays over the reference's largest
    magnitude."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    return float((got - want).abs().max() / want.abs().max())


def check_serve(label: str, rows: list, yard: dict, dry: dict, device: torch.device) -> dict:
    """Phase 14 (h)-(j) against the one-card yardsticks: every step's
    logits within the arm's limit (relative to their largest magnitude),
    the logits whole and equal on every rank of a data coordinate, the
    prefill's kernel launches (a flash launch per attention layer, a scan
    per RG-LRU layer), a rank's cache at rest its specs' block in bytes;
    (h) also its captured steps bitwise the eager ones, one capture a
    rank, and the dry run's argument bytes the rank's resident bytes.
    Returns the arms' summary (printed per arm)."""
    summary = {}
    cuda = device.type == "cuda"
    for key, (name, _, shape, B, S, steps, dtype, tol) in SERVE.items():
        ref = yard["serve"][key]
        cfg = serve_configs(key)[1]
        want_flash = sum(cfg.kind(i) in ("attn", "local_attn") for i in range(cfg.num_layers)) \
            if cfg.mla is None else 0
        want_scan = sum(cfg.kind(i) == "rglru" for i in range(cfg.num_layers))
        err, per_rank = 0.0, []
        for r, row in enumerate(rows):
            arm = row["serve"][key]
            where = f"{label} serve ({key}) {name} {shape} rank {r}"
            if "logits" in arm:
                d, rows_d = arm["coords"]["data"], B // shape[0]
                for t, got in enumerate(arm["logits"]):
                    e = logits_error(got, ref["logits"][t][d * rows_d:(d + 1) * rows_d])
                    err = max(err, e)
                    check(e <= tol, f"{where}: step {t} logits off the one-card yardstick by "
                                    f"{e:.3e} (limit {tol})")
            twin = next(x["serve"][key] for x in rows
                        if x["serve"][key]["coords"] == {"data": arm["coords"]["data"],
                                                         "model": 0})
            check(arm["checksum"] == twin["checksum"], f"{where}: logits differ across model")
            check(not cuda or (arm["flash_prefill"] == want_flash and
                               arm["scan_prefill"] == want_scan),
                  f"{where}: prefill launched {arm['flash_prefill']} flash / "
                  f"{arm['scan_prefill']} scan, not {want_flash} / {want_scan}")
            check(arm["cache_bytes"] == arm["cache_spec_bytes"],
                  f"{where}: cache at rest {arm['cache_bytes']} B, its specs' block "
                  f"{arm['cache_spec_bytes']} B")
            check(arm["param_bytes"] == arm["param_spec_bytes"],
                  f"{where}: parameters at rest {arm['param_bytes']} B, the specs' "
                  f"{arm['param_spec_bytes']} B")
            resident = arm["param_bytes"] + arm["cache_bytes"] + arm["token_bytes"]
            if key == "h":
                check(arm["captured_is_eager"], f"{where}: captured steps != eager steps")
                check(arm["captures"] == 1, f"{where}: {arm['captures']} captures, not 1")
                check(resident == dry["memory"]["argument_bytes"],
                      f"{where}: resident {resident} B, the dry run's argument bytes "
                      f"{dry['memory']['argument_bytes']}")
            per_rank.append({"peak_gb": arm["peak_gb"], "resident_bytes": resident,
                             "prefill_s": arm["prefill_s"]})
        a0 = rows[0]["serve"][key]
        out = {"mesh": list(shape), "dtype": dtype, "prompts": B, "prompt_len": S,
               "steps": steps, "max_logits_err": err, "limit": tol,
               "prefill_s": a0["prefill_s"], "one_card_prefill_s": ref["prefill_s"],
               "eager_ms_per_token": float(np.median(a0["eager_ms"])),
               "one_card_eager_ms_per_token": ref["decode_ms"],
               "bytes_per_token": a0["bytes_per_token"],
               "collectives_per_token": a0["collectives_per_token"],
               "prefill_bytes": a0["prefill_bytes"],
               "flash_prefill": a0["flash_prefill"], "scan_prefill": a0["scan_prefill"],
               "cache_bytes": a0["cache_bytes"], "param_bytes": a0["param_bytes"],
               "ranks": per_rank, "yardstick_s": ref["seconds"], "arm_s": a0["seconds"]}
        if key == "h":
            # the replays: the first step warms up, the second captures
            out.update({"captured_ms_per_token": float(np.median(a0["captured_ms"][2:])),
                        "captured_ms": a0["captured_ms"], "captures": a0["captures"],
                        "dry_run_argument_bytes": dry["memory"]["argument_bytes"],
                        "dry_run_temp_bytes": dry["memory"]["temp_bytes"],
                        "dry_run_collectives": {k: v for k, v in dry["collectives"].items()
                                                if k not in ("calls", "by_axis")}})
        note(f"# {label} serve ({key}) {name} " + json.dumps(out))
        summary[key] = out
    return summary


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    parser.add_argument("--save-table", metavar="PATH",
                        help="also write phase 2d's measured transport table to PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0

    def stamp(phase: str) -> None:
        """Seconds since the start at the end of a phase (where the time goes)."""
        print(f"# t {phase} {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"# 0 {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"kernels built in {build_s:.1f} s")

    mnist = mnist_width_data()
    rows = phase_kernels(mnist[3]) + phase_lm_kernels() + phase_auction(mnist[3])
    for r in rows:
        if r["kernel"] == "auction":
            note(f"# 1 auction {r['case']}: kernel_ms={r['kernel_ms']:.3f} "
                 f"solve_ms={r['solve_ms']:.3f} plain_ms={r['plain_ms']:.1f} (host) "
                 f"numpy_auction_ms={r['numpy_auction_ms']:.1f} scipy_ms={r['scipy_ms']:.1f} "
                 f"bound_ms={r['bound_ms']:.4f} phases={r['phases']} rounds={r['rounds']}")
        if "design" in r:  # the redesigned kernels: which design ran, and its numbers
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            note(f"# 1 {r['kernel']} {r['case']} {r['dtype']}: {r['design']}; "
                  f"kernel_ms={r['kernel_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                  f"library_ms={lib} max_abs_err={r['max_abs_err']:.3e}")
        note("# 1 " + json.dumps(r))
    # the redesigned kernels' headlines against one library call, same run
    for name in ("gossip_schedule", "gossip_mix", "flash_attention"):
        head = next(r for r in rows if r["kernel"] == name)
        check(head["kernel_ms"] < head["library_ms"],
              f"{name} {head['case']} {head['dtype']}: {head['kernel_ms']:.4f} ms is not below "
              f"the library call's {head['library_ms']:.4f} ms")
    stamp("1")
    launches = phase_main_path(mnist)
    phase_cross_device()
    table = phase_transport_table(mnist[3], args.save_table)
    for arm, r in step_breakdown(mnist).items():
        note(f"# 2e {arm} " + json.dumps(r))
    stamp("2")
    online = phase_online(mnist, table["phase_2b_bucket"]["winner"])
    stamp("6")
    for k, v in online.items():
        launches[k] += v
    robust = phase_robustness(mnist)
    for k, v in robust.items():
        launches[k] += v
    stamp("7")
    lm = phase_lm(torch.device("cuda"))
    launches.update(lm["launches"])
    launches["flash_attention_bwd"] = 0  # phases 3-11 score and serve: no backward
    stamp("3-5")
    dense = phase_dense_families(torch.device("cuda"))
    launches["flash_attention"] += dense["flash_attention"]
    stamp("8")
    moe = phase_moe_families(torch.device("cuda"))
    launches["flash_attention"] += moe["flash_attention"]
    stamp("9")
    last = phase_last_families(torch.device("cuda"))
    launches["flash_attention"] += last["flash_attention"]
    stamp("10")
    long = phase_long_context(torch.device("cuda"))
    launches["flash_attention"] += long["flash_attention"]
    stamp("11")
    train, yard = phase_lm_training(torch.device("cuda"))
    for k, v in train.items():
        launches[k] += v
    free_card()
    stamp("12")
    ranks = phase_lm_ranks(yard, torch.device("cuda"))
    for k, v in ranks.items():
        launches[k] += v
    free_card()
    stamp("13")
    mesh = phase_lm_mesh(torch.device("cuda"))
    for k, v in mesh.items():
        launches[k] += v
    phase_cli()
    stamp("14")

    kernels = []
    for name, meta in KERNELS.items():
        head = next(r for r in rows if r["kernel"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head.get("shape", [head.get("n"), head.get("P")]), "dtype": head["dtype"],
        })
        if "design" in head:
            kernels[-1]["design"] = head["design"]
        if name in lm["per_forward"]:
            kernels[-1]["launches_per_forward"] = lm["per_forward"][name]
        if name in online:
            kernels[-1]["launches_phase6"] = online[name]
        if name in robust:
            kernels[-1]["launches_phase7"] = robust[name]
        if name == "flash_attention":
            kernels[-1]["launches_phase8"] = dense[name]
            kernels[-1]["launches_phase9"] = moe[name]
            kernels[-1]["launches_phase10"] = last[name]
            kernels[-1]["launches_phase11"] = long[name]
        if name in train:
            kernels[-1]["launches_phase12"] = train[name]
        if name in ranks:
            kernels[-1]["launches_phase13"] = ranks[name]
        if name in mesh:
            kernels[-1]["launches_phase14"] = mesh[name]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
