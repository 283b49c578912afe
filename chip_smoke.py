#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. the card's name and power limit (``nvidia-smi``), and its idle power
   draw read through NVML before anything runs on it;
2. build of every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``;
3. each kernel held against its plain PyTorch version on the card, at the
   main path's shape (N_t = N_s = 16384, fp32 and mixed), on a rectangle
   with a partial target mask that includes a fully inactive block, and on
   a batch of two systems; then two launches of each kernel at the main
   path's shape, fp32 and mixed, must give the same bits;
4. the committed golden trajectories replayed through the kernels, then the
   main path through ``repro_torch.launch.nbody_run.run``: Plummer
   N = 16384, seed 0, Hermite-6, shared Aarseth step (eta = 0.02) to
   t = 0.0625 at fp32, and a shorter mixed-precision run; the kernels'
   launch counts are zeroed just before each run and read just after;
5. CUDA-event timings of K1 and K2 at N = 16384 and 65536, at the block
   path's shapes (phase 8), and of the
   flash-attention kernel K3 at the prefill shape (B = 4, S = 2048,
   H = 16, KV = 8, D = 128, causal) in bf16 and fp32, each beside its
   plain version and its bound, K3 also beside
   ``scaled_dot_product_attention`` under each backend that takes the
   shape (flash, efficient, cuDNN), the fastest of which is K3's library
   time;
6. K3 held against its plain version on the card: the prefill shape in
   bf16 and fp32, a non-causal rectangle, an MHA case, Sq < 512, fp32
   rows of 8192 and 32768 keys, and the rows-sum-to-one property in both
   types at the prefill shape and at those two lengths; bf16 element by
   element, and against the plain version at the kernel's own key tile;
7. the serve path at full width: qwen3-0.6b (28 layers, d_model 1024, 16
   query and 8 kv heads, head_dim 128, vocab 151936) with seeded random
   weights, ``Engine.generate`` on 4 prompts of 2048 tokens for 32 tokens
   with ``attn_impl="flash"``, after one ``Engine.generate`` for a single
   token; every launch count is zeroed just before each and read just
   after, and the two totals show K3 launching once per layer in the
   prefill and never in decode; the flash route's prefill and first decode
   logits are held against the plain route (``attn_impl="xla"``) on the
   same weights;
8. block ensembles (``repro_torch.sim``): K1 and K2 held against their
   plain versions at the block path's shapes (gathered targets, caps
   below 128 and off it, B = 3 and 4, against 16384 sources);
   binary_plummer N = 16384 fp32 through the block stepper to t = 1/64,
   once with ``compaction="none"`` and once with ``"gather"``: equal
   events and pairs, bitwise equal final states, fewer tiles, |dE/E| in
   its tier, one K1 and one K2 launch per event, the host reads per
   event, the blocks of each K1 launch as its launcher reports them, and
   a profiled window over the first 64 events of each; the same
   bitwise check in mixed mode at N = 4096; a padded batch king:4096
   merger:8192 plummer:16384 in member bucket groups, each member bitwise
   equal to its own B = 1 run, padding rows frozen, one launch per pass
   per group; fixed-dt and adaptive ensembles of four Plummer N = 16384
   members, one launch per pass for the batch, |dE/E| per member; and
   ``benchmarks/bench_ci.py``'s block_compaction recipe at N = 256 with
   gather compaction over its --quick span, recorded;
9. the simulation API and CLI (``repro_torch.launch.sim_run``,
   ``repro_torch.sim.api``) at the main path's width: the single runner
   on Plummer N = 16384 to t = 1/64 (CLI, and build/step/collect on the
   same config) bit for bit against ``hermite.evolve`` on the same state;
   the block runner on phase 8's binary_plummer gather run (events, tiles
   and final bits equal to phase 8's, one engine build at most, the tile
   chain launched <= bound <= dense, host reads per event, a trace that
   loads); the mixed runner on phase 8's padded batch (each member's
   events, tiles and bits equal to phase 8's); the card's energy counter
   (NVML) read around the single and block CLI runs beside the report's
   modeled energy;
10. the distribution strategies: Table 1's recipe at N = 409600 (a
   bootstrap and one step) under each strategy over four slots of the card, phase 8's block run under
   each over two, and ``sim_run`` under a strategy;
11. the Ahmad-Cohen neighbor scheme at the reference's acceptance point
   (``benchmarks/bench_ci.py``'s neighbor A/B, Plummer N = 16384): full
   and neighbor sources at fp32 and the neighbor run at mixed through
   ``repro_torch.sim.driver``, each with its events, force evaluations,
   refreshes, |dE/E| in its tier, wall per event, host reads and syncs per
   event, K1/K2 launches and grids; K1/K2 at the run's most used window
   shapes against their plain versions and timed; ``near1``/``near2``
   against their plain versions on the same windows, and bit for bit the
   same at the next bucket up; the overflow run (every window the full
   extent) against full sources at N = 4096; the peak allocated memory;
12. the simulation server (``repro_torch.serve.sim_engine``) at n_max =
   16384: a deterministic Poisson trace of 6 requests (plummer, king,
   binary_plummer, merger at 2048-16384 bodies, adaptive and block) through
   a server with full-source block pods and its block requests through one
   with neighbor pods, after ``warmup`` with no engine build and no kernel
   library load, every report's |dE/E| in its tier, requests/s and p50/p99
   turnaround; then the trace suspended mid-way and resumed in a fresh
   server, its final states bit for bit the uninterrupted run's, the first
   ticks profiled for the card's busy share;
13. the batch layouts (``sim.ensemble``'s ``devices=`` and ``mesh=``): phase
   8's ensemble of four Plummer N = 16384 members over two slots of the
   card (fixed dt, adaptive, block with none/gather x member/shared, and a
   batch of three, padded) bit for bit against one slot, counters equal;
   the fused 2x2 mesh over four slots at B = 4 Plummer N = 65536, block
   gather, one 128-event chunk, bit for bit against the 1-D layout over
   two slots, one slot and each member's solo ``mesh_sharded`` run, its
   tiles those of ``CapacityPlan.shard`` at the recorded bounds, with wall
   per event, launches and host reads per event, peak memory and a
   profiled window of 16 events per layout printed;
   the server on the fused mesh (plummer:8192, full and neighbor pods): no
   engine build and no kernel load after warmup, final rows bit for bit a
   one-slot server's, suspend/resume bit for bit;
14. training (``train_phase``): qwen3-0.6b as registered (28 layers, bf16
   activations, fp32 masters, remat full, ``_attn_full``) through
   ``Trainer`` for 8 steps of one repeated B = 4, S = 2048 batch: finite,
   falling losses, step ms, tokens/s, TFLOP/s, peak memory and a profiled
   step; one step at depth 2 on the card against the CPU; a checkpoint
   restart against an uninterrupted run in a temporary directory; the
   trained weights prefilled through K3 (28 launches) against the xla
   route; the flash route refusing a gradient;
15. the moe, vlm and audio families served (``families_phase``): K3 held
   against its plain version at the shapes they give it (g = 4 and 6 at
   D = 128, non-causal D = 64 with Sq != Sk, Sq = 1), timed beside its
   plain version, its bound and SDPA; then phi3.5-moe-42b-a6.6b (8 of 32
   layers), deepseek-v2-236b (4 of 60: one dense, three MoE; MLA through
   ``_attn_full``), qwen2-vl-2b (256 patches + 1792 tokens) and
   seamless-m4t-medium (1024 frames, prompts of 512) at their published
   widths with seeded random bf16 weights through ``Engine.generate``,
   launch counts zeroed before each run and read after: K3's launches per
   prefill and per decode step, prefill and decode ms beside their
   limits, a profiled prefill and decode step, peak memory; for MoE two
   prefills bit for bit and the share of slots dropped over capacity; MLA
   refusing the flash route before any launch; each config at depth 2 on
   the card against the CPU (MoE: bf16 routing, fp32 logits);
16. the ssm and hybrid families served (``ssm_phase``): K3 at D = 112
   (zamba2's heads; B = 4, S = 2048 and B = 1, S = 8192, H = KV = 32, bf16
   and fp32) against its plain version, timed beside it, its bound and
   SDPA; xlstm-1.3b (16 of 48 layers) and zamba2-7b (27 of 81 layers) at
   their published widths, as registered (fp32 masters; the engine keeps
   the fp32 leaves), B = 4,
   prompts of 2048, 32 generated, zamba2 under the flash route; zamba2 at
   B = 1, a prompt of 8192, 16 generated, under the xla route, which runs
   ``_attn_streamed``; launch counts zeroed before each run and read
   after (K3: 4 per zamba2 flash prefill, none in decode), prefill and
   decode ms beside their limits, a profiled decode step (and zamba2's
   prefill), every cache leaf finite; zamba2's routes against each other
   (bf16 read, fp32 held at B = 1); each config cut in depth (8 and 9
   layers) on the card against the CPU (fp32 logits, bf16's first block),
   and prefill(255) + one decode step against prefill(256);
17. the dry-run (``repro_torch.launch.dryrun``, ``dryrun_phase``) against
   real steps: qwen3-0.6b's train step at B = 4, S = 2048, its prefill and
   one decode step at phase 7's shapes, and one Plummer N = 16384 fp32
   Hermite step, each run on meta through ``lower_cell`` or
   ``run_nbody_cell`` with single-device rules: (a) the dry-run's product
   FLOPs (N-body: FLOPs) against FlopCounterMode on the real step plus the
   kernel formulas times the launches, within 0.1%; (b) its peak bytes
   within 0.8 to 1.25 of max_memory_allocated over the step; (c) the
   step's median ms at least 0.95 of the dry-run's roofline;
18. training the other families (``train_families_phase``): qwen2-vl-2b
   and seamless-m4t-medium whole, phi3.5-moe-42b-a6.6b (1 of 32 layers),
   deepseek-v2-236b (1 of 60, and its first MoE layer's loss and
   gradients at depth 2), zamba2-7b (9 of 81) and xlstm-1.3b (8 of 48,
   S = 128) at their published widths, each cut to what the dry-run puts
   at 72 GB or less, zamba2 and xlstm further for time:
   ``Trainer`` over one warm-up and three timed steps of one repeated
   batch (finite, falling losses, step ms, tokens/s, TFLOP/s, peak memory,
   a profiled step), each step held against the dry-run as phase 17 holds
   qwen3's; each family at depth 2 (the MoE configs 1, xlstm 8, zamba2 9)
   in fp32 on the card
   against the CPU (the loss and every gradient leaf; the scans' families
   at the tolerance ``ssm_grad_witness.py`` sets), two gradient calls bit
   for bit; then
   ``launch.train.main`` for seamless-m4t-medium;
19. the examples (``examples_phase``): ``launch/cluster_simulation.py`` at
   the example's defaults single and replicated over four slots of the
   card (bit for bit, the Fig. 4 overlap against the reference example's)
   and at N = 16384 to t = 1/64; ``launch/ensemble_scenarios.py`` at the example's
   defaults against the port's steps and |dE/E| there on the CPU (the
   reference example's printed beside), and on the card against the CPU
   in this process at a smaller size;
20. the strategies over a process mesh (``process_mesh_phase``: one OS
   process per shard over ``torch.distributed``,
   ``repro_torch.distributed.process_mesh``): (a) Table 1's Plummer
   N = 409600 fp32, a bootstrap and one step under every strategy (the
   ring in both schedules) on four gloo ranks, every rank on ``cuda:0``
   with its tensors staged through host memory: every rank's bootstrap
   and final state bit for bit each other's and the in-process ``[cuda:0]
   * 4`` run's, K1/K2 launches per rank (1 per evaluation resident, p
   ring) and shift rounds per rank; (b) the block evaluator over the same
   ranks, since PR 30 in phase 24 (a), whose events hold its checks; (c)
   nccl at one rank on ``cuda:0`` (the rank function
   in a group of this process alone) bit for bit the one-slot in-process
   mesh; (d) nccl refusing two ranks on one card
   before any group exists; (e) ``compressed_psum`` on four ranks against
   the int32 sum of the levels times the shared scale computed in this
   process; the wall per step of each run beside the in-process run's,
   with the transport (the cost of host staging on one card, not a
   scaling result); phases 24 and 21 to 23 run their jobs on the same
   four ranks after these, one spawn for all five phases;
21. the dense LM over a device mesh (``mesh_lm_phase``: ``MeshRules`` on a
   ``DeviceMesh`` of ranks, parameters and activations as ``DTensor``s):
   K3 at the mesh's local prefill shape (B 2, S 2048, H 8, KV 4, D 128,
   bf16) against its plain version, timed beside its bound and SDPA;
   four gloo ranks on ``cuda:0`` as a (data, model) = (2, 2) mesh: (a)
   the four collectives DTensor issues, each checked; (b) qwen3-0.6b at
   full width cut to 2 layers, a bf16 prefill of 4 x 2048 through the
   flash route and 4 greedy decode steps (logits against the one-device
   run of the same code, tokens equal or near-ties, K3 launches per rank
   per prefill), two fp32 ``Trainer`` steps of 4 x 256 against the
   one-device run (phase 14 (b)'s rule), the moments placed as the
   parameters; (c) the mesh's checkpoint restored on one nccl rank (a
   process group of this process alone), every parameter and moment bit
   for bit; (d) per rank ms per prefill, decode
   step and train step beside the one-device run's;
22. the moe, vlm and audio families over the device mesh
   (``mesh_family_phase``): K3 at the mesh's new local shapes (g = 4 and
   6 at D = 128, non-causal D = 64 with Sq != Sk, Sq = 1) against its
   plain version, timed beside its bound and SDPA; then one spawn of four
   gloo ranks on ``cuda:0`` as the (2, 2) mesh runs phi3.5-moe-42b-a6.6b
   (1 of 32 layers), deepseek-v2-236b (2 of 60: the dense layer and one
   MoE layer; MLA through ``_attn_full``), qwen2-vl-2b (2 layers, 256
   patches + 256 tokens) and seamless-m4t-medium (2 encoder + 2 decoder
   layers, 512 frames, prompts of 128) at their published widths: (a)
   bf16 ``Engine.generate`` of 4 prompts and 2 greedy decode steps, the
   prefill logits against the one-device run of the same code, tokens
   equal or near-ties; (b) K3's launches per rank per prefill; (c) MoE:
   each rank's routing and dropped entries against one device's on its
   sequences (the router's disagreement and the tokens routed otherwise
   below limits that a router fed with unreduced partial sums, read in
   the same run, exceeds), two meshed prefills bit for bit; (d) one fp32
   ``Trainer``
   step of 4 x 128 with the registered remat (deepseek-v2: one gradient
   call at depth 1) held by
   rank 0 against the one-device run (phase 14 (b)'s rule; each gradient
   leaf), the moments placed as the parameters; (f) per rank ms per
   prefill, decode step and train step beside the one-device run's (in
   the whole run its jobs go to phase 21's ranks, after phase 21's own);
23. the ssm and hybrid families over the device mesh
   (``mesh_ssm_phase``): K3 at zamba2-7b's local shape (B 2, S 512, H 16,
   KV 16, D 112, bf16, causal) against its plain version, timed beside its
   bound and SDPA; then, on the same four gloo ranks as the (2, 2) mesh,
   zamba2-7b (7 of 81 layers: one group of 6 Mamba2 layers, the shared
   attention block through K3, one tail layer) and xlstm-1.3b (8 of 48:
   one group of 7 mLSTM blocks and one sLSTM block) at their published
   widths: (a) the fp32 witness (the prefill logits in fp32 activations
   against one device's, its greedy token equal), then bf16
   ``Engine.generate`` of 4 prompts (512 and 256 tokens) and 2 greedy
   decode steps, the prefill logits against the one-device run of the
   same code (``MESH_SSM_RUNS``' limits), zamba2's tokens equal or
   near-ties; (b) K3's launches per rank per prefill (zamba2: 1); (c) two
   meshed prefills bit for bit; (d) two fp32 steps of 4 x 128, labels
   masked unevenly between the microbatches, with gradient accumulation
   (accum = 2): zamba2 through the ``Trainer``, xlstm through
   ``make_train_step`` with int8 compression, each held by rank 0 against
   the one-device run of the same accumulation and compression (phase 14
   (b)'s rule, xlstm's flips by ``MESH_INT8_FLIP_SHARE`` and its fp32
   gradients held themselves), the recurrent cache, the moments and the
   int8 error buffers placed by their logical axes; (f) per rank ms per
   prefill, decode step and train step beside the one-device run's;
24. the N-body engines over a process mesh (``process_engines_phase``,
   on phase 20's four gloo ranks of the card, every rank holding the
   whole output): (a) phase 10 (b)'s binary_plummer N = 16384 run, one
   macro-step of 1/64 at 8 levels, through ``evolve_strategy_block`` under
   every strategy with gather and none, the ring in both schedules: each
   rank bit for bit the in-process engine over ``[cuda:0] * 4``, gather ==
   none and overlap == sync on the state's bytes, tiles per shard those
   of ``CapacityPlan.shard`` at the recorded bounds (gather's at most
   none's), K1/K2 launches per rank (events + 1, times p for the ring),
   |dE/E| in the fp32 tier; (b) phase 13 (a)'s ensemble (B = 4 Plummer
   N = 16384, one chunk of 64 events) over the 1-D layout, block with
   none, gather per member, gather shared and gather with B = 3 padded,
   each rank bit for bit one slot's run; (c) phase 13 (b)'s fused run (B =
   4 Plummer N = 65536 on the (2, 2) grid, 128 events) bit for bit the
   in-process fused run; (d) ``BlockStrategyRunner`` (the ring) and
   ``EnsembleRunner`` on the (2, 2) grid through ``sim.api.run`` on each
   rank, every rank's report the in-process report outside the wall
   clock; for every run the ms per event per rank beside in-process, the
   transport, and host reads and collectives per event; K1/K2 at the
   per-rank shapes (a resident shard, a ring round, a fused slot) against
   plain, timed beside the bound;
then one ``kernels`` JSON line and ``{"ok": true, "device": {...}}`` as the
last line.

It imports torch, numpy, the standard library and ``repro_torch`` only, and
exits nonzero without a card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import io
import itertools
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import hermite, nbody  # noqa: E402
from repro_torch.core import strategies  # noqa: E402
from repro_torch.core.evaluate import (  # noqa: E402
    make_evaluator, make_neighbor_block_evaluator)
from repro_torch.kernels import _build, nbody_force, neighbor, ops  # noqa: E402
from repro_torch.kernels.bounds import (  # noqa: E402
    FLOPS_PER_PAIR, PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_HBM_BYTES,
    attn_bound_ms, attn_flops, bound_ms, flash_bound_ms, window_bound_ms)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.data import BatchSpec, SyntheticLM, batch_spec_for  # noqa: E402
from repro_torch.distributed import mesh_runs, process_mesh  # noqa: E402
from repro_torch.distributed.shardings import MeshRules  # noqa: E402
from repro_torch.launch import dryrun as lm_dryrun  # noqa: E402
from repro_torch.launch import cluster_simulation  # noqa: E402
from repro_torch.launch import ensemble_scenarios  # noqa: E402
from repro_torch.launch import nbody_run, sim_run  # noqa: E402
from repro_torch.launch import shapes as lm_shapes  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.models import config as lm_config  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models import params as lm_params  # noqa: E402
from repro_torch.serve import sim_engine  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.obs import energy  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig, make_train_step  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.sim import api, driver  # noqa: E402
from repro_torch.sim import ensemble as ens  # noqa: E402
from repro_torch.sim import scenarios  # noqa: E402

N_MAIN = 16384
N_LARGE = 65536
T_END = 0.0625
T_END_MIXED = 0.015625
ETA = 0.02

#: Kernel vs plain version, as max |kernel - plain| over a column group
#: divided by max |plain| over that group.  fp32: both sum the same float32
#: terms in other orders (the kernel per lane over every 16th source of a
#: 512-source tile, then across lanes; the plain version per 512-source
#: block) and the kernel uses rsqrtf and FMA contraction;
#: rounding of a 16384-term sum stays near sqrt(16384) * 2**-24 ~ 8e-6 of
#: the partial-sum scale at worst, so 1e-5 of the group's largest value
#: holds.  mixed: a term that lands on the other side of a bfloat16 rounding
#: boundary moves by one bf16 ulp (2**-8 relative); 1e-2 bounds a few such
#: flips in the largest row while an uncompensated or unrounded sum fails.
TOL = {"fp32": 1e-5, "mixed": 1e-2}
#: |dE/E| tiers of the precision modes (benchmarks/bench_ci.py DE_TIERS)
DE_TIERS = {"fp32": 1e-4, "mixed": 1e-3}
#: golden-trajectory tiers (tests/test_golden_trajectories.py TOL)
GOLDEN_TOL = {"fp32": 1e-7, "mixed": 1e-3}

REPLACES = {
    "acc_jerk_pot": "src/repro/kernels/nbody_force.py:146",
    "snap": "src/repro/kernels/nbody_force.py:189",
    "flash_attention": "src/repro/kernels/flash_attention.py:36",
}
SOURCE = "src/repro_torch/csrc/nbody_force.cu"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"

#: the serve path: qwen3-0.6b at full width, 4 prompts of 2048 tokens, 32
#: generated tokens; K3's prefill shape follows from it
LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
#: K3 vs its plain version on the same inputs.  fp32: max |kernel - plain|
#: / max |plain| <= 2e-5, the JAX package's flash tolerance
#: (tests/test_flash_attention.py): the products summed in other orders and
#: tile sizes, the kernel's as 3xTF32 (about 21 of fp32's 24 bits; with
#: the lo terms dropped, 11 bits, it fails this limit: flash_mutants.py).
#: bf16, element by element, against the plain version in the reference's
#: (block_q, block_k) order:
#:     |kernel - plain| <= 2**-7 (|plain| + A),  A = sum_i p_i |v_i| / l,
#: the attention of |v| (fp32 plain version).  Both sides round each p to
#: bf16, against running maxima of other tile sizes (the kernel's 64 keys,
#: the reference's 512) and from scores summed in other orders, so the two
#: roundings of one p differ by at most one bf16 ulp, 2**-7 of p; over the
#: row that moves the output by at most 2**-7 A.  Each side then rounds
#: the output to bf16, at most one ulp apart, 2**-7 |plain|.  A short row
#: can reach several ulps of a small output this way (one flipped p of
#: five keys); a long row's limit is near 2**-7 E|v|, 0.006 for v ~ N(0, 1).
FLASH_TOL = {"fp32": 2e-5, "bf16": 2.0 ** -7}
#: bf16 against the plain version at the kernel's own key tile
#: (``kBf16Keys`` in csrc/flash_attention.cu; tests/test_torch_rules.py
#: holds this copy to it): the same running maxima, so the same p up to a
#: flip from the scores' summation order.  At most this share of the
#: outputs may differ.  flash_mutants.py on an H100 80GB HBM3 (700 W) read
#: 0.10% to 0.40% for the mma.sync kernel, 1.4% to 2.9% with l summed from
#: the rounded p and about 60% with p rounded toward zero.
KERNEL_KEY_TILE = 64
TILE_SHARE_TOL = 8e-3
#: rows sum to one (v = 1): fp32 up to rounding; bf16 within the bf16
#: rounding of p (2**-9) plus that of the output near one (2**-8)
ROWS_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}
#: flash route vs plain route (attn_impl="xla", ``layers._attn_full``) at
#: full width, as max |flash - xla| / max |xla| over the logits.  Both run
#: bf16 activations through 28 layers, but the xla route rounds its scores
#: to bf16 before the softmax and the flash route keeps them in fp32, so
#: each layer's attention differs by a few bf16 ulps (2**-8); a 28-layer
#: narrow model with the same heads showed 1.0e-2 to 1.2e-2 on the CPU.
SERVE_TOL = 5e-2

#: the block path (phase 8): binary_plummer at the main path's width, one
#: macro-step of dt_max split into 2**(n_levels-1) ticks.  The finest step
#: must be 2**-13: at a macro-step of 1/16, 8 levels (finest 2**-11) left
#: the fp32 tier and 10 held it (PERF.md gives the readings at 8, 9 and 11
#: levels).  A macro-step of 1/64 at 8 levels keeps that finest step in 128
#: events instead of 512 (phase 13's FUSED_KW); cut for time
BLOCK_SCENARIO = "binary_plummer"
BLOCK_KW = dict(t_end=2.0 ** -6, dt_max=2.0 ** -6, n_levels=8, eta=0.02)
#: events in the profiled window of each block mode (the first half)
BLOCK_PROFILE_EVENTS = 64
N_BLOCK_MIXED = 4096
#: the padded mixed batch (B = 3, n_max 16384)
PADDED_MIX = (("king", 4096), ("merger", 8192), ("plummer", 16384))
#: fixed and adaptive ensembles: B members of Plummer N_MAIN
ENSEMBLE_B, FIXED_STEPS, FIXED_DT = 4, 16, 2.0 ** -16
ADAPTIVE_T_END, ADAPTIVE_STEPS = 2.0 ** -11, 64
#: benchmarks/bench_ci.py's block_compaction recipe at its --quick span
#: (T_END / 2, bench_ci.py:185; the full span's 4685 events took 27 to 38
#: s of host-bound events, cut for time), and the reference's row for seed
#: 0 at the full span (BENCH_ci.json): events, tiles none, tiles gather
BENCH_CI_KW = dict(t_end=0.125, eta=0.01, dt_max=0.0625, n_levels=12,
                   block_i=32, block_j=256)
BENCH_CI_N, BENCH_CI_REF = 256, (4685, 74960, 13466)
#: K1 and K2 at the block path's shapes against N_s = N_MAIN sources:
#: label, batch (0 = unbatched), gathered targets N_t, block_i.  The caps
#: of 32 and 224 (block_i 32) are below and off the kernels' 128-target
#: block; a gathered buffer's last eighth is inactive fill
BLOCK_SHAPES = [("cap 32", 0, 32, 32), ("cap 224", 0, 224, 32),
                ("cap 256", 0, 256, 256), ("cap 2048", 0, 2048, 256),
                ("B=3 cap 4096", 3, 4096, 256),
                ("B=4 N_t 16384", 4, N_MAIN, 256)]


#: phase 9: the CLI's flags for the single, block and mixed runners, at the
#: main path's width and on phase 4's and phase 8's configurations; the
#: single runner to API_T_END, a quarter of phase 4's span (cut for time).
#: ``--no-validate`` skips the construction-time diagnostics (a numpy
#: O(N^2) potential on the host), which check the initial state and leave
#: it as it is; phase 8 skips them too
API_T_END = 2.0 ** -6
API_SINGLE_ARGS = ["--scenario", "plummer", "--n", str(N_MAIN), "--t-end",
                   str(API_T_END), "--dtype", "fp32", "--no-validate"]
API_BLOCK_ARGS = ["--scenario", BLOCK_SCENARIO, "--n", str(N_MAIN),
                  "--stepper", "block",
                  "--levels", str(BLOCK_KW["n_levels"]),
                  "--compaction", "gather",
                  "--t-end", str(BLOCK_KW["t_end"]),
                  "--dt-max", str(BLOCK_KW["dt_max"]),
                  "--eta", str(BLOCK_KW["eta"]), "--no-validate"]
API_MIXED_ARGS = (["--scenario"] + [f"{name}:{n}" for name, n in PADDED_MIX]
                  + ["--pad", "auto"] + API_BLOCK_ARGS[4:])
#: idle power: NVML readings averaged before anything runs on the card
IDLE_READINGS, IDLE_INTERVAL_S = 50, 0.1

#: phase 10 (a): the paper's Table 1 recipe at full scale
#: (benchmarks/table1_strategies.py:17-19): Plummer N = 409600, seed 0,
#: fixed dt, the bootstrap and one Hermite step (the recipe's three cut
#: for time, as phase 20's PM_STEPS), each strategy over TABLE1_P slots
#: of the one card (two_level as 2 cards x 2 chips)
TABLE1_N, TABLE1_STEPS, TABLE1_DT, TABLE1_P = 409600, 1, 1e-3, 4
#: each run: (strategy, dtype, ring mode); "single" is the one-card path
TABLE1_RUNS = [("single", "fp32", None), ("replicated", "fp32", None),
               ("two_level", "fp32", None), ("mesh_sharded", "fp32", None),
               ("ring", "fp32", "overlap"), ("ring", "fp32", "sync"),
               ("single", "mixed", None), ("replicated", "mixed", None),
               ("ring", "mixed", "overlap")]
#: a strategy's bootstrap evaluation against the single path's, relative
#: per field (max |a - b| / max |b|): fp32 the reference's own limit
#: (tests/test_strategies.py:39), mixed the mixed tier
STRATEGY_TOL = {"fp32": 1e-5, "mixed": 1e-3}
#: phase 20: the strategies over a process mesh, one rank per shard, at
#: phase 10 (a)'s Table 1 size and (b)'s block shape; the ring in both
#: schedules; gloo ranks all on the one card; one step after the
#: bootstrap keeps the phase near 50 s (it took 63.5 s at two steps)
PM_RUNS = [(s_, "overlap") for s_ in strategies.STRATEGIES] + [("ring", "sync")]
PM_STEPS = 1
#: (e): compressed_psum's length per rank (a 4 MB fp32 gradient bucket)
PM_PSUM_LEN = 1 << 20
#: phase 24: the N-body engines over a process mesh of PE_P gloo ranks on
#: the card (phase 20's spawn).  (a) phase 10 (b)'s runs (binary_plummer
#: N_MAIN, one macro-step of 1/64 at 8 levels: PE_EVENTS ticks, every one
#: an event) under each strategy; (b) phase 13 (a)'s ensemble over the
#: 1-D layout, one chunk of LAYOUT_EVENTS events: (compaction, bucket
#: mode, members); (c) phase 13 (b)'s fused run; (d) the API's block
#: strategy runner (the ring) and ensemble runner on the (2, 2) grid, at
#: phase 9's block configuration cut to one macro-step of 2**-9 at 5
#: levels (16 events: the report's fields are held, not a length); phase
#: 10 (b) runs (a)'s jobs in-process, the reference (a)'s ranks are held to
PE_P = 4
PE_EVENTS = 2 ** (BLOCK_KW["n_levels"] - 1)
PE_STRATEGY = [(s_, c_, "overlap") for s_ in strategies.STRATEGIES
               for c_ in ("gather", "none")] + [("ring", "gather", "sync")]
PE_LAYOUTS = (("none", "member", ENSEMBLE_B), ("gather", "member", ENSEMBLE_B),
              ("gather", "shared", ENSEMBLE_B), ("gather", "member", 3))
PE_API = {
    "block ring": dict(strategy="ring", devices=PE_P),
    "ensemble 2x2": dict(ensemble=2, devices=PE_P, mesh=(2, 2)),
}
PE_API_KW = dict(t_end=2.0 ** -9, dt_max=2.0 ** -9, n_levels=5)
#: the report's wall-clock fields: the only ones a rank's report may
#: differ in from the in-process report
PE_WALL = ("wall_s", "step_wall_s", "steps_per_s", "interactions_per_s",
           "modeled", "report_path")
#: phase 21: the dense LM over a (data, model) = (2, 2) mesh of four gloo
#: ranks on the one card (NCCL refuses two ranks on one card), qwen3-0.6b at
#: full width cut to MESH_DEPTH layers: a bf16 prefill of MESH_SERVE_B x
#: MESH_SERVE_S through the flash route (K3 at the local shape B 2, S 2048,
#: H 8, KV 4, D 128) and MESH_GEN greedy decode steps, two Trainer steps
#: of MESH_TRAIN_B x MESH_TRAIN_S (xla route, remat full) in fp32
#: activations, held to phase 14 (b)'s rule (TRAIN_CPU_TOL on the losses,
#: TRAIN_PARAM_RTOL / ATOL per element but for TRAIN_FLIP_SHARE, each
#: within 2 lr per step, TRAIN_UPDATE_NORM_TOL per leaf)
MESH_SHAPE, MESH_DEPTH = (2, 2), 2
MESH_SERVE_B, MESH_SERVE_S, MESH_GEN = 4, 2048, 4
MESH_TRAIN_B, MESH_TRAIN_S, MESH_TRAIN_STEPS = 4, 256, 2
#: mesh against one device, bf16 activations: max |mesh - one| / max |one|
#: over the prefill logits.  The mesh rounds each rank's partial products
#: (the output projections' heads, the FFN's d_ff halves) to bf16 before
#: summing them, one more rounding (2**-9 relative) per layer and sum
MESH_LOGITS_TOL = 3e-2
#: a mesh greedy token that differs from the one-device run's must be a
#: near-tie there: within this share of the step's largest |logit| of the
#: one-device run's largest logit (the same bf16 roundings)
MESH_TIE_TOL = 3e-2
#: phase 22: the moe, vlm and audio families over the same (2, 2) mesh,
#: each at its published width cut in depth (``cut``), with seeded random
#: weights.  Serving: bf16 weights and activations, MESH_FAM_B prompts of
#: ``prompt`` tokens after ``patches`` patch or ``frames`` frame
#: embeddings, MESH_FAM_GEN greedy decode steps; ``k3``: K3's launches per
#: rank per prefill.  Training (``train``): two fp32 Trainer steps of
#: MESH_FAM_B x MESH_FAM_TRAIN_S (the xla route) or, for deepseek-v2, one
#: fp32 gradient call at ``grads_cut``: at depth 2 its fp32 parameters,
#: gradients and Adam moments (5.35 G parameters x 16 bytes, 86 GB) do not
#: fit the card, before four ranks' gathers
MESH_FAMILY_RUNS = (
    dict(arch="phi3.5-moe-42b-a6.6b", cut=dict(n_layers=1), attn="flash",
         prompt=512, k3=1, train="steps"),
    dict(arch="deepseek-v2-236b", cut=dict(n_layers=2), attn="xla",
         prompt=512, k3=0, train="grads", grads_cut=dict(n_layers=1)),
    dict(arch="qwen2-vl-2b", cut=dict(n_layers=2), attn="flash", prompt=256,
         patches=256, k3=2, train="steps"),
    dict(arch="seamless-m4t-medium", cut=dict(n_layers=2, encoder_layers=2),
         attn="flash", prompt=128, frames=512, k3=6, train="steps"),
)
MESH_FAM_B, MESH_FAM_GEN, MESH_FAM_TRAIN_S = 4, 2, 128
#: K3 at the local shapes of MESH_FAMILY_RUNS on the (2, 2) mesh: a rank's
#: half of the batch and of the heads (b, sq, sk, h, kv, d), causal, and
#: ``_attn_dispatch``'s blocks min(512, S)
MESH_FAM_FLASH = (
    ("mesh phi3.5 prefill g=4", (2, 512, 512, 16, 4, 128), True, (512, 512)),
    ("mesh qwen2-vl prefill g=6", (2, 512, 512, 6, 1, 128), True,
     (512, 512)),
    ("mesh seamless encoder", (2, 512, 512, 8, 8, 64), False, (512, 512)),
    ("mesh seamless decoder", (2, 128, 128, 8, 8, 64), True, (128, 128)),
    ("mesh seamless cross", (2, 128, 512, 8, 8, 64), False, (128, 512)),
    ("mesh seamless cross decode", (2, 1, 512, 8, 8, 64), False, (1, 512)),
)
#: MoE in bf16, mesh against one device: the router's inputs differ by
#: the mesh's bf16 partial sums (``MESH_LOGITS_TOL``).  Its disagreement,
#: |log p_mesh - log p_one| over each token's top k + 1 experts on either
#: side, may be at most MESH_ROUTER_TOL, and the share of a MoE layer's
#: tokens that take another set of experts at most MESH_FLIP_SHARE.  The
#: sound mesh reads 3.260e-2 and 0.0063 (phi3.5-moe), 3.278e-2 and 0.0518
#: (deepseek-v2), the same bits in every run on one H100; each limit lies
#: about twice above them.  Each run also reads the fault the limits must
#: catch, on one device: a router fed with the partial sums of one "data"
#: rank's part of d, never reduced (``partial_router_fault``); its
#: readings, at every MoE layer, must lie above both limits.  A sequence whose last token takes
#: or drops other experts at a MoE layer, or any of whose tokens does
#: before the last MoE layer, is held apart from the logits and tokens (at
#: most MESH_APART of them; none in any run so far); a sequence with no
#: token routed otherwise must drop one device's entries
MESH_ROUTER_TOL, MESH_FLIP_SHARE, MESH_APART = 2.0 ** -4, 2.0 ** -3, 1
#: phase 23: the hybrid (zamba2-7b) and ssm (xlstm-1.3b) families over the
#: (2, 2) mesh at their published widths, cut in depth (``cut``): zamba2
#: to one group of 6 Mamba2 layers, the shared block and one tail layer,
#: xlstm to one group of 7 mLSTM blocks and one sLSTM block.  Serving as
#: phase 22's (bf16 weights and activations, MESH_FAM_B prompts of
#: ``prompt`` tokens, MESH_FAM_GEN decode steps; ``k3``: K3's launches per
#: rank per prefill, one per application of zamba2's shared block).
#: Training: MESH_TRAIN_STEPS fp32 steps of MESH_FAM_B x MESH_FAM_TRAIN_S,
#: each of MESH_SSM_ACCUM microbatches, through the Trainer (``train``)
#: or ``make_train_step`` with int8 compression (``step``), held by rank 0
#: against the one-device run of the same accumulation and compression by
#: phase 14 (b)'s rule, the update gap over the elements within the
#: element bound (``gap="kept"``): the flips, which the element share
#: counts, concentrate in leaves of sparse updates (zamba2's embedding
#: holds 130 of the tree's 133 flips of 980699440 elements, which put its
#: gap over every element at 3.466e-3 on an H100; ROADMAP queue 3 A7)
#: ``logits_tol``: zamba2's bf16 logits read 3.302e-2 of one device's on
#: an H100 80GB HBM3 at 700 W (seven Mamba2 layers each add a bf16
#: rounding of the partial sums of ``wo`` over "model", the shared block
#: two more), above MESH_LOGITS_TOL; the same mesh in fp32 must lie within
#: MESH_SSM_FP32_TOL of one device (the witness that the function is the
#: same: ``mesh_ssm_witness``), and the limit lies about twice above the
#: bf16 reading (ROADMAP queue 3 A7).  xlstm's bf16 logits read 1.677e-1
#: of one device's there, and 5 of its 8 greedy tokens differ: through 8
#: blocks of random weights bf16 rounding alone moves its logits by tens
#: of percent (phase 16's note on SSM_CPU_CUT).  With the fp32 witness
#: held, they are held at MESH_SSM_OWN_RATIO times one device's own
#: distance between its bf16 and its fp32 logits, read in the same run
#: (``logits_tol="own"``): two bf16 runs that round in other places lie
#: up to twice as far apart as each lies from the fp32 function.  The
#: bf16 tokens are read, not held; the witness's fp32 greedy tokens must
#: equal one device's
#: xlstm's int8 steps: its fp32 gradients on the mesh lie up to 1e-4 of
#: one device's (the scans' rounding, ROADMAP queue 3 A6), about a hundredth
#: of an int8 level, so about 1% of the elements take the other level and
#: an Adam step of another size, and the residuals move with the noise:
#: the gradients themselves are held (``grads``: one fp32 gradient call
#: against one device within FAMILY_GRAD_TOL_SCAN, the scan's tier), the
#: int8 steps by the losses, each element within the most two Adam paths
#: can part and the share of elements outside phase 14 (b)'s element bound
#: at most MESH_INT8_FLIP_SHARE (1.43e-2 read on an H100), the update gap
#: read; a per-rank scale would not show in Adam's steps (each a sign at
#: first) but moves every residual: tests/test_torch_mesh_ssm.py holds
#: those against the reference
MESH_INT8_FLIP_SHARE = 3e-2
#: xlstm's int8 losses, mesh against one device: the first step's loss is
#: the same function at the same parameters (the gradient call's loss
#: reads 8.797e-8 on an H100), the second follows parameters in which the
#: flips above took the other int8 level (9.746e-6 read there, against
#: TRAIN_CPU_TOL's 1e-5): held at ten times that reading
MESH_INT8_LOSS_TOL = 1e-4
MESH_SSM_RUNS = (
    dict(arch="zamba2-7b", cut=dict(n_layers=7), attn="flash", prompt=512,
         k3=1, train="train", logits_tol=6e-2, gap="kept"),
    dict(arch="xlstm-1.3b", cut=dict(n_layers=8), attn="xla", prompt=256,
         k3=0, train="step", grad_compression="int8", gap="read",
         flip_share=MESH_INT8_FLIP_SHARE, logits_tol="own", ties_held=False,
         witness="scan tier", grads=True, loss_tol=MESH_INT8_LOSS_TOL,
         faults=("local_chunk", "rms_per_rank"), perturbed=True),
)
MESH_SSM_ACCUM = 2
#: the share of the microbatches' labels masked out, by microbatch:
#: unequal, so that a rank's own rows taken as its microbatch would give
#: another loss (each microbatch's loss is a mean over its own labels)
MESH_SSM_MASKED = (0.5, 0.1)
#: the witness: each family served in fp32 activations (its bf16 weights
#: cast to fp32) on the mesh, its prefill logits against one device's:
#: max |mesh - one| / max |one| at most this (a run's ``witness="scan
#: tier"``: at SSM_CPU_TOL_FP32).
#: xlstm's reads 8.360e-5 on an H100: the mesh sums its products in
#: other orders (other shapes, so other cuBLAS kernels), and through 8
#: blocks of random weights the scans amplify fp32 rounding about 25
#: times (phase 16 (e): card against CPU in fp32 at the same depth, the
#: first block 9.591e-6 apart, the logits 2.368e-4), so it is held to
#: that check's fp32 tier, SSM_CPU_TOL_FP32 (ROADMAP queue 3 A7).  Two
#: readings of the same run place that limit: one device against itself
#: with every weight moved by one ulp reads 6.562e-5 (the mesh 1.274
#: times that: rounding), and the witness with each planted fault
#: (``faults``: the mLSTM's halves chunked on each rank, its ``onorm``
#: per rank) reads 1.140 and 1.050, a thousand times above the limit
MESH_SSM_FP32_TOL = 1e-5
MESH_SSM_OWN_RATIO = 2.0
#: K3 at zamba2-7b's local shape on the (2, 2) mesh: a rank's half of the
#: batch and of the 32 heads, head dim 112
MESH_SSM_FLASH = (
    ("mesh zamba2 prefill", (2, 512, 512, 16, 16, 112), True, (512, 512)),
)
#: phase 10 (c): the CLI under a strategy on one card
API_STRATEGY_SINGLE_ARGS = ["--scenario", "plummer", "--n", str(N_MAIN),
                            "--t-end", "0.0078125", "--dtype", "fp32",
                            "--strategy", "replicated", "--devices", "1",
                            "--no-validate"]
API_STRATEGY_BLOCK_ARGS = API_BLOCK_ARGS + ["--strategy", "mesh_sharded",
                                            "--devices", "1"]
#: phase 11: the reference's neighbor A/B recipe (benchmarks/bench_ci.py
#: _NEIGHBOR, :392-495) at its acceptance point, the largest N of
#: NEIGHBOR_NS_FULL (:425): the scheme's own cell, at fp32 on the card
NBR_N = 16384
NBR_CFG = dict(scenario="plummer", n=NBR_N, seed=0, t_end=0.0625,
               stepper="block", dt_max=0.0625, n_levels=8, eta=0.01,
               eps=4.0 / NBR_N, block_i=32, block_j=32,
               neighbor_radius=0.125, refresh_levels=2, validate_ic=False,
               diag_every=64)
#: phase 11 (c): every window the full extent, against full sources
NBR_OVERFLOW_N, NBR_OVERFLOW_RADIUS = 4096, 1e9
#: tests/test_golden_trajectories.py BLOCK_TOL at fp32 (pos, vel)
BLOCK_TOL_FP32 = (1e-6, 1e-5)
#: phase 12: the simulation server at full size, a deterministic Poisson
#: trace as benchmarks/serve_throughput.py builds one (numpy seed 0,
#: exponential gaps of its MEAN_GAP_S, every request to its T_END:
#: serve_throughput.py:38-39) cycling through these (scenario, n, stepper)
#: shapes; block pods run full sources in one server and the neighbor
#: split (phase 11's radius and tile) in a second.  The softening is the
#: reference's at N = 16384 (eps = 4/N, as phase 11): unsoftened (the
#: server's default 1e-7), plummer:16384 seed 0 leaves the fp32 tier by
#: t = 0.04 at 8 levels, in the float64 oracle as in the kernels
SERVE_CFG = dict(n_max=16384, slots_per_pod=4, chunk_events=16,
                 dtype="fp32", eps=4.0 / 16384)
SERVE_NBR = dict(sources="neighbor", neighbor_radius=0.125, block_i=32,
                 block_j=32)
SERVE_SHAPES = (("plummer", 16384, "block"), ("king", 2048, "adaptive"),
                ("binary_plummer", 4096, "block"),
                ("merger", 8192, "adaptive"),
                ("plummer", 2048, "adaptive"),
                ("binary_plummer", 8192, "block"))
#: six requests, each shape once (twelve until cut for time)
SERVE_REQUESTS, SERVE_MEAN_GAP_S, SERVE_T_END = 6, 0.05, 0.04
#: phase 12: the profiled window of the suspended run, in scheduler ticks
SERVE_PROFILE_TICKS = 2
#: phase 13: the batch layouts, every run fp32 with eps = 4/N.  (a) phase
#: 8's ensemble (ENSEMBLE_B Plummer N_MAIN) over LAYOUT_SLOTS slots of the
#: card beside one slot, its block runs one chunk of LAYOUT_EVENTS events;
#: (b) the fused mesh at full width: FUSED_B Plummer members of N_LARGE
#: (seeds 0-3), block, gather, one chunk of FUSED_EVENTS events.  8 levels
#: make the chunk the whole macro-step (128 ticks), so the run ends
#: synchronized at t_end and its energy is the members' own; a macro of
#: 1/64 (finest step 2^-13) keeps it in the fp32 tier, where 1/16 left
#: it (member 0 at |dE/E| 2.267e-4, PERF.md).  (c) the
#: server on the fused mesh of four slots of the card; N = 8192 keeps the
#: host's IC validation at about 2 s a request (PERF.md, ROADMAP queue 3
#: B10), built once per request and reused by the phase's servers
LAYOUT_SLOTS, LAYOUT_EVENTS = 2, 64
FUSED_B, FUSED_MESH, FUSED_EVENTS = 4, (2, 2), 128
#: the profiled window of each fused-phase layout, in events from the start
FUSED_PROFILE_EVENTS = 16
FUSED_KW = dict(t_end=2.0 ** -6, dt_max=2.0 ** -6, n_levels=8, eta=0.02)
MESH_SERVE_CFG = dict(n_max=8192, slots_per_pod=4, devices=4, mesh=(2, 2),
                      dtype="fp32", eps=4.0 / 8192)
MESH_SERVE_TRACE = tuple(("plummer:8192", seed) for seed in (1, 2, 3, 4))
MESH_SERVE_T_END = 2.0 ** -8
#: phase 14 (a): qwen3-0.6b as registered (bf16 activations, fp32 masters,
#: remat full, attn_impl xla: the reference trains through _attn_full, its
#: flash kernel has no VJP), 8 steps of one repeated SyntheticLM batch at a
#: constant lr, so that learning shows within 8 steps; steps 2 to 7 timed.
#: The lr is the reference launcher's default: at 1e-3 without warmup the
#: loss swung up and down (11.95 to 9.26, 10.84, 8.70, 11.23 in one run)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 2048, 8, 3e-4
#: (b) card against CPU: full width, depth 2, fp32 activations, one step.
#: Loss and gnorm relative; the parameters to tests/test_substrate.py's
#: accum bound (rtol, atol) at that lr.  Adam's first step divides m by
#: sqrt(v), so an element whose gradient lies within fp32 noise of 0 takes
#: a step of another size, up to 2 lr apart: at most FLIP_SHARE of the
#: elements may leave the bound (tests/test_torch_train.py's rule), and the
#: update's norm must agree to UPDATE_NORM_TOL per leaf
TRAIN_CPU_DEPTH, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 1, 256
TRAIN_CPU_TOL = 1e-5
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 1e-3, 5e-5
TRAIN_FLIP_SHARE = 1e-3
TRAIN_UPDATE_NORM_TOL = 1e-3
#: (c) restart: full width, depth 2, bf16, a warmup-cosine lr; steps 0-3
#: then a resumed 4-5 against an uninterrupted 0-5
RESTART_BATCH, RESTART_SEQ = 2, 256
RESTART_TOL = 1e-6


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


T_START = time.perf_counter()


def phase(title: str):
    print(f"== {title} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


# --------------------------------------------------------------------------
# operands
# --------------------------------------------------------------------------
def plummer_operands(n, seed, dev, block_i, block_j):
    """Packed K1 and K2 operands of a Plummer system; the snap pass's
    accelerations come from the plain K1 at float32."""
    s = nbody.plummer(n, seed=seed, device=dev)
    nt = -(-n // block_i) * block_i
    ns = -(-n // block_j) * block_j
    tgt = ops.pack_targets(s.pos, s.vel, nt)
    src = ops.pack_sources(s.pos, s.vel, s.mass, ns)
    acc = nbody_force._acc_jerk_plain(
        ops.pack_targets(s.pos, s.vel, ns), src, eps=1e-7,
        block_i=block_i, block_j=block_j, compute_dtype=None)[:n, 0:3]
    tacc = ops.pack_acc_targets(acc, nt)
    sacc = ops.pack_acc_sources(acc, ns)
    return tgt, src, tacc, sacc


def rect_operands(n_t, n_s, dev, block_i, block_j, seed=7):
    """A target cloud of n_t and a source cloud of n_s (some zero-mass
    sources, some targets also sources), with a partial mask whose first
    block_i targets are all inactive."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    ps, vs = t(rng.standard_normal((n_s, 3))), t(0.1 * rng.standard_normal((n_s, 3)))
    ms = t(rng.uniform(0.5, 1.5, n_s) / n_s)
    ms[-97:] = 0.0
    pt, vt = t(rng.standard_normal((n_t, 3))), t(0.1 * rng.standard_normal((n_t, 3)))
    pt[: n_t // 4], vt[: n_t // 4] = ps[: n_t // 4], vs[: n_t // 4]
    mask = torch.as_tensor(rng.uniform(size=n_t) < 0.5, device=dev)
    mask[:block_i] = False
    nt = -(-n_t // block_i) * block_i
    ns = -(-n_s // block_j) * block_j
    acc_t, acc_s = t(rng.standard_normal((n_t, 3))), t(rng.standard_normal((n_s, 3)))
    return (ops.pack_targets(pt, vt, nt, mask), ops.pack_sources(ps, vs, ms, ns),
            ops.pack_acc_targets(acc_t, nt), ops.pack_acc_sources(acc_s, ns))


def block_operands(systems, batch, n_t, block_i):
    """K1 and K2 operands at a block event's shapes: the first ``n_t`` rows
    of Plummer systems of N_MAIN (``systems[seed]``, from
    :func:`plummer_operands`) as the gathered targets (the last eighth
    inactive fill), each whole system as sources; ``batch`` systems (seeds
    0, 1, ...) stacked, or one unbatched for ``batch`` 0."""
    out = []
    for seed in range(max(batch, 1)):
        tgt, src, tacc, sacc = systems[seed]
        nt = -(-n_t // block_i) * block_i
        tgt, tacc = tgt[:nt].clone(), tacc[:nt].clone()
        tgt[n_t - n_t // 8:, 3] = 0.0
        out.append((tgt, src, tacc, sacc))
    if not batch:
        return out[0]
    return tuple(torch.stack(xs) for xs in zip(*out))


# --------------------------------------------------------------------------
# comparisons and timings
# --------------------------------------------------------------------------
GROUPS = {"acc_jerk_pot": {"acc": (0, 3), "jerk": (3, 6), "pot": (6, 7)},
          "snap": {"snap": (0, 3)}}


def compare(name, got, want, tgt, tol):
    """Normalised and absolute error of a kernel output against its plain
    version, with the exact-zero contracts (pad column, inactive rows)."""
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    norm_err, abs_err = 0.0, 0.0
    for lo, hi in GROUPS[name].values():
        d = float((got[..., lo:hi] - want[..., lo:hi]).abs().max())
        scale = float(want[..., lo:hi].abs().max())
        abs_err = max(abs_err, d)
        norm_err = max(norm_err, d / scale if scale > 0 else d)
    zero_cols = 7 if name == "acc_jerk_pot" else 3
    check(bool((got[..., zero_cols:] == 0).all()),
          f"{name}: padding columns not exactly zero")
    inactive = tgt[..., 3] == 0
    check(bool((got[inactive] == 0).all()),
          f"{name}: inactive target rows not exactly zero")
    check(norm_err <= tol, f"{name}: normalised error {norm_err:.3e} > {tol}")
    return norm_err, abs_err


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sdpa_calls(q, k, v, causal=True):
    """One PyTorch call computing K3's function on the same q, k, v, as a
    yardstick only (the port never calls it): ``enable_gqa=True`` where this
    torch takes it, else k and v repeated G-fold outside the timed call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    d, g = q.shape[-1], q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kr, vr = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    return [("enable_gqa=True",
             lambda: sdpa(qt, kt, vt, is_causal=causal, scale=d ** -0.5,
                          enable_gqa=True)),
            ("k and v repeated G-fold",
             lambda: sdpa(qt, kr, vr, is_causal=causal, scale=d ** -0.5))]


def sdpa_backends(q, k, v, reps=10, causal=True):
    """SDPA's time under each backend that accepts these inputs (flash,
    efficient, cuDNN, each pinned with ``sdpa_kernel``): name -> (ms, how),
    or (None, why) for a backend that refuses them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            out[name] = (None, "not in this torch")
            continue
        why = "refused"
        with sdpa_kernel(backend):
            for how, call in sdpa_calls(q, k, v, causal):
                try:
                    call()
                    torch.cuda.synchronize()
                except (RuntimeError, TypeError) as e:
                    why = f"refused: {str(e).splitlines()[0][:80]}"
                    continue
                out[name] = (cuda_ms(call, reps), how)
                break
            else:
                out[name] = (None, why)
    return out


def flash_operands(b, sq, sk, h, kv, d, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))


def flash_cases(prefill):
    """Phase 6's K3 cases: label, (b, sq, sk, h, kv, d), dtype, causal,
    (block_q, block_k)."""
    return [
        ("prefill", prefill, torch.bfloat16, True, (512, 512)),
        ("prefill", prefill, torch.float32, True, (512, 512)),
        ("rectangle", (2, 256, 1024, 16, 8, 128), torch.bfloat16, False, (256, 512)),
        ("rectangle", (2, 256, 1024, 16, 8, 128), torch.float32, False, (256, 512)),
        ("mha g=1", (2, 1024, 1024, 8, 8, 128), torch.bfloat16, True, (512, 512)),
        ("sq<512", (4, 384, 384, 16, 8, 128), torch.bfloat16, True, (384, 384)),
        ("long 8k", (1, 8192, 8192, 16, 8, 128), torch.float32, True, (512, 512)),
        ("long 32k", (1, 32768, 32768, 16, 8, 128), torch.float32, True, (512, 512)),
    ]


def flash_readings(q, k, v, causal, block_q, block_k):
    """K3 on (q, k, v) against its plain version on the same inputs: the
    normalised and absolute error; for bf16 also the largest share of the
    element-wise limit used, and the share of outputs that differ from the
    plain version at the kernel's own key tile."""
    got = fa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                             block_k=block_k)
    want = fa._flash_plain(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape
          and bool(torch.isfinite(got).all()), "flash: bad output")
    d = (got.float() - want.float()).abs()
    r = {"abs_err": float(d.max()),
         "norm_err": float(d.max()) / float(want.float().abs().max())}
    if q.dtype == torch.bfloat16:
        mean_abs_v = fa._flash_plain(q.float(), k.float(), v.float().abs(),
                                     causal=causal, block_q=block_q,
                                     block_k=block_k)
        lim = FLASH_TOL["bf16"] * (want.float().abs() + mean_abs_v)
        r["elem"] = float((d / lim).max())
        tile = fa._flash_plain(q, k, v, causal=causal, block_q=block_q,
                               block_k=min(KERNEL_KEY_TILE, k.shape[1]))
        r["tile_share"] = float((got != tile).float().mean())
    return r


def flash_failures(r, tag):
    """The checks a K3 reading fails (empty if it passes them all)."""
    if tag == "fp32":
        return ([f"normalised error {r['norm_err']:.3e} > {FLASH_TOL['fp32']}"]
                if r["norm_err"] > FLASH_TOL["fp32"] else [])
    out = []
    if r["elem"] > 1:
        out.append(f"|kernel - plain| reaches {r['elem']:.3f} of 2**-7 "
                   f"(|plain| + A)")
    if r["tile_share"] > TILE_SHARE_TOL:
        out.append(f"{100 * r['tile_share']:.4f}% of outputs (tol "
                   f"{100 * TILE_SHARE_TOL:g}%) differ from the plain version "
                   f"at the kernel's key tile")
    return out


def profile_readings(prof):
    """``(device, by_op)`` of a ``torch.profiler`` window, read from its
    kineto events as torch's own parse (``_parse_kineto_results``) reads
    them, without building torch's event tree, which takes tens of seconds
    at tens of thousands of launches.  ``device`` lists each device event's
    (name, microseconds) in the profiler's order, an asynchronous one at 0
    as ``device_time_total`` counts it; ``by_op`` maps the name of a CPU op
    to the device microseconds of the kernels it launched itself (its self
    device time, as ``key_averages`` sums it)."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    device, ops = [], {}
    for e in res.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        kind = e.device_type()
        is_async = e.is_async() or e.start_thread_id() != e.end_thread_id()
        if kind == cuda:
            us = (e.end_ns() - t0) / 1000 - (e.start_ns() - t0) / 1000
            device.append((_rewrite_name(name, with_wildcard=True), us,
                           0.0 if is_async else us,
                           e.linked_correlation_id()))
        elif kind == cpu and not is_async and e.linked_correlation_id() == 0:
            ops.setdefault(e.correlation_id(), []).append(
                _rewrite_name(name, with_wildcard=True))
    by_op = {}
    for _, us, _, corr in device:
        for op in ops.get(corr, ()):
            by_op[op] = by_op.get(op, 0.0) + us
    return [(name, us) for name, _, us, _ in device], by_op


def device_profile(prof, wall_ms):
    """Kernel time, launch count and the three costliest kernels of a
    ``torch.profiler`` window, the device's busy share of ``wall_ms`` (one
    stream, so kernels do not overlap), and the device ms by the aten op
    that launched each kernel (self time, so each kernel counts once), the
    costliest first.  None if it saw no device activity."""
    device, by_op = profile_readings(prof)
    by_name = {}
    for name, us in device:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    n = len(device)
    if not n:
        return None  # the profiler saw no device activity
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    flash_ms = sum(ms for name, ms in by_name.items() if "flash_bf16_kernel" in name)
    ops = sorted(((op, us / 1e3) for op, us in by_op.items() if us > 0),
                 key=lambda kv: -kv[1])
    return {"device_ms": device_ms, "kernels": n, "busy": device_ms / wall_ms,
            "top": top, "flash_ms": flash_ms, "by_name": by_name,
            "ops": ops}


def counted(fn, all_kernels):
    """``fn()`` with every launch count, K1's and K2's grid sizes and the
    block path's host-read count set to 0 just before and read just after;
    returns ``(result, launches by kernel, host reads, wall seconds)``; the
    grid sizes stay in each wrapper's ``blocks``."""
    for k in all_kernels.values():
        k.launches = 0
        if hasattr(k, "blocks"):
            k.blocks = {}
    ens.ensemble_run_block.host_syncs = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, {name: k.launches for name, k in all_kernels.items()},
            ens.ensemble_run_block.host_syncs, wall)


def member(batched, i):
    """Member ``i`` of a batched state as a B = 1 batch."""
    return nbody.ParticleState(**{f: getattr(batched, f)[i:i + 1]
                                  for f in nbody.FIELDS})


def bitwise_same(a, b, fields=("pos", "vel", "acc", "jerk", "snap")):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)


def de_rel(e0, e1):
    return [abs(float(x)) for x in (e1 - e0) / e0]


def kernel_profile(fn):
    """Device time of a ``torch.profiler`` window over ``fn()``: total,
    K1 + K2's share and the busy share of the wall, and the host syncs
    that CUDA's sync debug mode reports in it (every read to the host and
    every copy that waits for the device); None if the profiler saw no
    device activity."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    total, nbody_ms, n = 0.0, 0.0, 0
    for name, us in profile_readings(prof)[0]:
        ms = us / 1e3
        total += ms
        n += 1
        if "acc_jerk_pot_kernel" in name or "snap_kernel" in name:
            nbody_ms += ms
    if not n:
        return None
    return {"wall_ms": wall, "device_ms": total, "kernels": n,
            "nbody_ms": nbody_ms, "busy": total / wall, "syncs": syncs}


def block_phase(dev, kernels, plains, block_ops, all_kernels):
    """Phase 8: the block-timestep ensembles on the card.  Returns the
    readings the JSON line and PERF.md report."""
    bi, bj = nbody_force.DEFAULT_BLOCK_I, nbody_force.DEFAULT_BLOCK_J
    out = {"holds": {}}

    # K1 and K2 at the block path's shapes against their plain versions
    for label, batch, n_t, _ in BLOCK_SHAPES:
        x4, bi_s = block_ops[label]
        for name in kernels:
            x = x4[:2] if name == "acc_jerk_pot" else x4
            for dtype in ("fp32", "mixed"):
                cdt = ops.compute_dtype_for(dtype)
                got = kernels[name](*x, block_i=bi_s, block_j=bj,
                                    compute_dtype=cdt)
                want = nbody_force._plain(plains[name], x, batch, eps=1e-7,
                                          block_i=bi_s, block_j=bj,
                                          compute_dtype=cdt)
                torch.cuda.synchronize()
                norm_err, abs_err = compare(name, got, want, x[0], TOL[dtype])
                out["holds"][(label, name, dtype)] = (norm_err, abs_err)
                print(f"block {label:<14} {name:<13} {dtype:<6} max "
                      f"normalised err {norm_err:.3e} (tol "
                      f"{TOL[dtype]:.0e})  max abs err {abs_err:.3e}",
                      flush=True)

    # the full-width block run, gather and none, fp32
    st = scenarios.make(BLOCK_SCENARIO, N_MAIN, seed=0, device=dev,
                        validate=False)
    init = ens.ensemble_initialize(ens.stack_states([st]))
    e0 = ens.batched_total_energy(init)
    runs = {}
    for compaction in ("gather", "none"):
        # none reads nothing per event, so it runs exactly the gather
        # run's event count in one chunk
        n_ev = 256 if compaction == "gather" else \
            int(runs["gather"]["carry"].n_events.max())
        (s, carry), counts, syncs, wall = counted(
            lambda: ens.evolve_ensemble_block(
                init, initialized=True, compaction=compaction, n_events=n_ev,
                **BLOCK_KW), all_kernels)
        events = int(carry.n_events[0])
        r = runs[compaction] = {
            "state": s, "carry": carry, "counts": counts, "wall": wall,
            "events": events, "reads": syncs,
            "tiles": float(carry.n_tiles[0]),
            "pairs": float(carry.n_pairs[0]),
            "de": de_rel(e0, ens.batched_total_energy(s))[0],
            # the grid sizes K1's launcher reported in this run
            "blocks": dict(sorted(kernels["acc_jerk_pot"].blocks.items()))}
        print(f"block {BLOCK_SCENARIO} N={N_MAIN} fp32 {compaction:<6}: "
              f"events={events} wall={wall:.3f} s "
              f"({1e3 * wall / events:.4f} ms/event) host reads "
              f"{r['reads']} ({r['reads'] / events:.3f}/event) "
              f"launches={counts} tiles={r['tiles']:.0f} "
              f"pairs={r['pairs']:.0f} |dE/E|={r['de']:.3e} (tier "
              f"{DE_TIERS['fp32']:.0e}) K1 blocks per launch: "
              f"{r['blocks']}", flush=True)
        for name in kernels:
            check(counts[name] == events, f"block {compaction}: {name} "
                  f"launched {counts[name]} times for {events} events")
        check(r["de"] <= DE_TIERS["fp32"],
              f"block {compaction}: |dE/E| {r['de']:.3e}")
        check(abs(float(s.time[0]) - BLOCK_KW["t_end"]) < 1e-12,
              f"block {compaction} stopped at t={float(s.time[0])}")
    g, nn = runs["gather"], runs["none"]
    same = bitwise_same(g["state"], nn["state"])
    print(f"block gather vs none: events {g['events']} / {nn['events']}, "
          f"pairs equal {g['pairs'] == nn['pairs']}, final pos vel acc "
          f"jerk snap bitwise equal {same}, tiles {g['tiles']:.0f} vs "
          f"{nn['tiles']:.0f} ({nn['tiles'] / g['tiles']:.2f}x fewer), wall "
          f"per event {nn['wall'] / g['wall'] * g['events'] / nn['events']:.2f}x"
          f" lower", flush=True)
    check(g["events"] == nn["events"] and g["pairs"] == nn["pairs"],
          "block gather vs none: events or pairs differ")
    check(same, "block gather vs none: final state not bitwise equal")
    check(g["tiles"] < nn["tiles"], "block gather: no fewer tiles")
    check(len(nn["blocks"]) == 1 and max(g["blocks"]) <= max(nn["blocks"]),
          f"block: K1 grids {g['blocks']} (gather) vs {nn['blocks']} (none)")
    out["runs"] = {k: {x: v[x] for x in ("events", "wall", "reads", "tiles",
                                         "de", "blocks", "counts")}
                   for k, v in runs.items()}
    out["gather_state"] = g["state"]  # phase 9 holds the API's run to it
    # where an event's time goes: a profiled window over the first
    # BLOCK_PROFILE_EVENTS events of each mode
    prof = {}
    n_prof = BLOCK_PROFILE_EVENTS
    for compaction in ("gather", "none"):
        p = kernel_profile(lambda: ens.ensemble_run_block(
            init, compaction=compaction, n_events=n_prof, **BLOCK_KW))
        prof[compaction] = p
        if p is None:
            print(f"profile block {compaction}: torch.profiler recorded no "
                  f"device time", flush=True)
            continue
        print(f"profile block {compaction} ({n_prof} events): wall "
              f"{p['wall_ms']:.3f} ms, device {p['device_ms']:.3f} ms in "
              f"{p['kernels']} launches ({p['kernels'] / n_prof:.1f} per "
              f"event, busy {100 * p['busy']:.1f}%), K1 + K2 "
              f"{p['nbody_ms']:.3f} ms ({100 * p['nbody_ms'] / p['wall_ms']:.1f}"
              f"% of the wall, {p['nbody_ms'] / n_prof:.4f} ms per event), "
              f"host syncs (sync debug mode) {p['syncs']} "
              f"({p['syncs'] / n_prof:.3f} per event)", flush=True)
    out["profile"] = prof
    del init, runs, g, nn

    # mixed mode at N_BLOCK_MIXED: the same bitwise contract
    st = scenarios.make(BLOCK_SCENARIO, N_BLOCK_MIXED, seed=0, device=dev)
    init = ens.ensemble_initialize(ens.stack_states([st]), dtype="mixed")
    e0 = ens.batched_total_energy(init)
    mixed = {}
    for compaction in ("gather", "none"):
        n_ev = 256 if compaction == "gather" else mixed["gather"][1]
        s, carry = ens.evolve_ensemble_block(
            init, initialized=True, compaction=compaction, n_events=n_ev,
            dtype="mixed", **BLOCK_KW)
        mixed[compaction] = (s, int(carry.n_events[0]),
                             float(carry.n_tiles[0]), float(carry.n_pairs[0]),
                             de_rel(e0, ens.batched_total_energy(s))[0])
    (sg, eg, tg, pg, dg), (sn, en, tn, pn, dn) = mixed["gather"], mixed["none"]
    same = bitwise_same(sg, sn)
    print(f"block {BLOCK_SCENARIO} N={N_BLOCK_MIXED} mixed: events {eg} / "
          f"{en}, pairs equal {pg == pn}, bitwise equal {same}, tiles "
          f"{tg:.0f} vs {tn:.0f}, |dE/E| {dg:.3e} / {dn:.3e} (tier "
          f"{DE_TIERS['mixed']:.0e})", flush=True)
    check(eg == en and pg == pn and same and tg < tn,
          "block mixed: gather vs none differ")
    check(max(dg, dn) <= DE_TIERS["mixed"], f"block mixed: |dE/E| {dg:.3e}")
    out["mixed"] = {"events": eg, "tiles_gather": tg, "tiles_none": tn,
                    "de": dg}
    del init, mixed, sg, sn

    # the padded mixed batch, member bucket groups
    specs = scenarios.make_mix(PADDED_MIX, seed=0)
    batched, n_active = scenarios.build_padded(specs, device=dev,
                                               validate=False)
    n_max = batched.pos.shape[1]
    e0 = ens.batched_total_energy(ens.ensemble_initialize(
        batched, n_active=n_active))
    groups = ens._bucket_groups(n_max, n_active.tolist(), bi, bj, "gather",
                                "member")
    kw = dict(compaction="gather", bucket_mode="member", **BLOCK_KW)
    (res, carry), counts, syncs, wall = counted(
        lambda: ens.evolve_ensemble_block(batched, n_active=n_active, **kw),
        all_kernels)
    events = carry.n_events.tolist()
    iters = max(events)
    de = de_rel(e0, ens.batched_total_energy(res))
    print(f"padded B={len(specs)} {[f'{s.name}:{s.n}' for s in specs]} "
          f"n_max={n_max}: {len(groups)} bucket groups of "
          f"{[n_caps for _, n_caps in groups]} caps, events per member "
          f"{events}, wall {wall:.3f} s, "
          f"launches={counts} (bootstrap 1 + {iters} event rounds x "
          f"{len(groups)} groups), host reads {syncs}, |dE/E| "
          f"{[f'{x:.3e}' for x in de]}", flush=True)
    for name in kernels:
        check(counts[name] == 1 + iters * len(groups),
              f"padded: {name} launched {counts[name]} times, expected one "
              f"per pass per bucket group ({1 + iters * len(groups)})")
    check(max(de) <= DE_TIERS["fp32"], f"padded: |dE/E| {max(de):.3e}")
    for i, n in enumerate(n_active.tolist()):
        frozen = all(not getattr(res, f)[i, n:].any()
                     for f in ("pos", "vel", "acc", "jerk", "snap", "pot"))
        solo, c_solo = ens.evolve_ensemble_block(
            member(batched, i), n_active=n_active[i:i + 1], **kw)
        same = bitwise_same(member(res, i), solo)
        print(f"  member {i} {specs[i].name}:{n}: padding rows frozen "
              f"{frozen}, bitwise equal to its B=1 run {same} (events "
              f"{events[i]} / {int(c_solo.n_events[0])})", flush=True)
        check(frozen, f"padded member {i}: padding rows moved")
        check(same and events[i] == int(c_solo.n_events[0]),
              f"padded member {i}: differs from its B=1 run")
    out["padded"] = {"groups": len(groups), "events": events,
                     "tiles": carry.n_tiles.tolist(),
                     "counts": counts, "wall": wall, "de": de}
    out["padded_state"] = res
    del batched, res

    # fixed and adaptive ensembles of ENSEMBLE_B Plummer members
    batched, _ = scenarios.build_padded(
        scenarios.make_mix([("plummer", N_MAIN)], seed=0,
                           repeat=ENSEMBLE_B), device=dev, validate=False)
    init = ens.ensemble_initialize(batched)
    e0 = ens.batched_total_energy(init)
    res, counts, _, wall = counted(
        lambda: ens.evolve_ensemble(batched, n_steps=FIXED_STEPS,
                                    dt=FIXED_DT), all_kernels)
    de = de_rel(e0, ens.batched_total_energy(res))
    print(f"fixed ensemble B={ENSEMBLE_B} plummer N={N_MAIN} fp32: "
          f"{FIXED_STEPS} steps of {FIXED_DT:g}, wall {wall:.3f} s "
          f"({1e3 * wall / (FIXED_STEPS + 1):.4f} ms per batched step), "
          f"launches={counts}, |dE/E| {[f'{x:.3e}' for x in de]}",
          flush=True)
    for name in kernels:
        check(counts[name] == FIXED_STEPS + 1, f"fixed ensemble: {name} "
              f"launched {counts[name]} times for {FIXED_STEPS} steps and "
              f"the bootstrap")
    check(max(de) <= DE_TIERS["fp32"], f"fixed ensemble: |dE/E| {max(de):.3e}")
    out["fixed"] = {"counts": counts, "wall": wall, "de": de}
    (res, h, taken), counts, _, wall = counted(
        lambda: ens.ensemble_run_adaptive(init, t_end=ADAPTIVE_T_END,
                                          n_steps=ADAPTIVE_STEPS),
        all_kernels)
    de = de_rel(e0, ens.batched_total_energy(res))
    print(f"adaptive ensemble B={ENSEMBLE_B} to t={ADAPTIVE_T_END:g}: "
          f"steps per member {taken.tolist()} in {ADAPTIVE_STEPS} batched "
          f"steps, wall {wall:.3f} s, launches={counts}, |dE/E| "
          f"{[f'{x:.3e}' for x in de]}", flush=True)
    for name in kernels:
        check(counts[name] == ADAPTIVE_STEPS, f"adaptive ensemble: {name} "
              f"launched {counts[name]} times for {ADAPTIVE_STEPS} steps")
    check(bool((res.time == ADAPTIVE_T_END).all()),
          f"adaptive ensemble: members stopped at {res.time.tolist()}")
    check(len(set(taken.tolist())) > 1 or ENSEMBLE_B == 1,
          "adaptive ensemble: every member took the same steps")
    check(max(de) <= DE_TIERS["fp32"],
          f"adaptive ensemble: |dE/E| {max(de):.3e}")
    out["adaptive"] = {"counts": counts, "wall": wall, "de": de,
                       "taken": taken.tolist()}
    del batched, init, res

    # benchmarks/bench_ci.py's block_compaction recipe: recorded, not gated.
    # Only the gather run: an uncompacted event enqueues the plan's dense
    # tiles, so the uncompacted run's tiles are its events times those
    st = scenarios.make(BLOCK_SCENARIO, BENCH_CI_N, seed=0, device=dev)
    init = ens.ensemble_initialize(ens.stack_states([st]))
    (_, carry), _, _, wg = counted(
        lambda: ens.evolve_ensemble_block(
            init, initialized=True, compaction="gather", **BENCH_CI_KW),
        all_kernels)
    eg, tg = int(carry.n_events[0]), float(carry.n_tiles[0])
    bi_ci, bj_ci = BENCH_CI_KW["block_i"], BENCH_CI_KW["block_j"]
    tn = eg * ops.CapacityPlan(
        n_targets=-(-BENCH_CI_N // bi_ci) * bi_ci,
        n_sources=-(-BENCH_CI_N // bj_ci) * bj_ci, block_i=bi_ci,
        block_j=bj_ci).dense_tiles
    ref_e, ref_tn, ref_tg = BENCH_CI_REF
    print(f"bench_ci block_compaction --quick {BLOCK_SCENARIO} N={BENCH_CI_N} "
          f"seed 0 {BENCH_CI_KW}: events {eg}, tiles_gather {tg:.0f}, "
          f"tiles_none (events x dense tiles per event) {tn}, tiles ratio "
          f"{tn / tg:.2f} (the reference's row at t_end 0.25: events {ref_e}, "
          f"tiles {ref_tn} / {ref_tg}, ratio {ref_tn / ref_tg:.2f}); wall per "
          f"gather event {1e3 * wg / eg:.4f} ms (recorded, not gated)",
          flush=True)
    out["bench_ci"] = {"events": eg, "tiles_none": tn, "tiles_gather": tg,
                       "ms_per_event_gather": 1e3 * wg / eg}
    return out


class Nvml:
    """The card's name, power limit, power draw and energy counter through
    NVML, the driver's library (``libnvidia-ml.so.1``, loaded with
    ``ctypes``).  Raises if it cannot be loaded or a query fails."""

    def __init__(self, index: int = 0):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._call("nvmlInit_v2")
        self.handle = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(index),
                   ctypes.byref(self.handle))

    def _call(self, fn: str, *args):
        rc = getattr(self.lib, fn)(*args)
        check(rc == 0, f"NVML {fn} returned {rc}")

    def name(self) -> str:
        buf = ctypes.create_string_buffer(96)
        self._call("nvmlDeviceGetName", self.handle, buf, ctypes.c_uint(96))
        return buf.value.decode()

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._call("nvmlDeviceGetPowerManagementLimit", self.handle,
                   ctypes.byref(mw))
        return mw.value / 1e3

    def power_w(self) -> float:
        mw = ctypes.c_uint()
        self._call("nvmlDeviceGetPowerUsage", self.handle, ctypes.byref(mw))
        return mw.value / 1e3

    def energy_j(self) -> float:
        """The card's energy counter since the driver loaded."""
        mj = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                   ctypes.byref(mj))
        return mj.value / 1e3


def measured(nvml, fn, all_kernels):
    """``counted(fn)`` with the card's energy counter read around it;
    returns ``(result, launches, host reads, wall s, joules)``."""
    torch.cuda.synchronize()
    e0 = nvml.energy_j()
    out, counts, syncs, wall = counted(fn, all_kernels)
    return out, counts, syncs, wall, nvml.energy_j() - e0


def drive(cfg):
    """``api`` build/step/collect on ``cfg`` in a registry of its own;
    returns ``(handle, report)``."""
    with obs_metrics.use():
        runner = api.get_runner(api.resolve_kind(cfg))
        h = runner.build(cfg)
        while not runner.step(h):
            pass
        return h, runner.collect(h)


def energy_line(label, nvml, joules, wall, report):
    """Measured energy over a CLI call beside the report's modeled energy;
    returns the readings."""
    mean_w = joules / wall
    model = report["modeled"]
    chip_w = energy.P_CHIP * (energy.IDLE_FRAC + (1 - energy.IDLE_FRAC)
                              * model["util"])
    r = {"measured_J": joules, "call_wall_s": wall, "mean_W": mean_w,
         "report_wall_s": report["wall_s"],
         "measured_J_over_report_wall": mean_w * report["wall_s"],
         "modeled_J": model["energy_J"], "modeled_W": model["peak_W"],
         "modeled_chip_W": chip_w,
         "ratio": mean_w * report["wall_s"] / model["energy_J"],
         "ratio_chip": mean_w / chip_w}
    print(f"energy {label}: NVML measured {joules:.3f} J over the CLI call "
          f"({wall:.3f} s, mean {mean_w:.2f} W; "
          f"{r['measured_J_over_report_wall']:.3f} J over the report's wall_s {report['wall_s']:.3f} s) vs modeled "
          f"{model['energy_J']:.3f} J ({model['peak_W']:.2f} W = host "
          f"{energy.P_HOST:.0f} W + card {chip_w:.2f} W at util "
          f"{model['util']}): measured/modeled {r['ratio']:.4f}, card "
          f"measured/modeled {r['ratio_chip']:.4f}; {nvml.name()}, "
          f"limit {nvml.power_limit_w():.2f} W", flush=True)
    return r


def api_phase(dev, all_kernels, block, main_run, nvml):
    """Phase 9: the simulation API and CLI on the card.  Returns the
    readings the JSON line and PERF.md report."""
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_api_")
    try:
        # (a) the single runner: CLI, build/step/collect, hermite.evolve
        path = os.path.join(tmp, "single.json")
        rc, counts, _, wall, joules = measured(
            nvml, lambda: sim_run.main(API_SINGLE_ARGS + ["--out", path]),
            all_kernels)
        with open(path) as f:
            rep = json.load(f)
        check(rc == 0, f"api single: sim_run exited {rc}")
        steps = rep["steps"]
        cfg = api.SimConfig(scenario="plummer", n=N_MAIN, t_end=API_T_END,
                            dtype="fp32", validate_ic=False)
        (h, rep_b), counts_b, _, _ = counted(lambda: drive(cfg), all_kernels)
        st = scenarios.make("plummer", N_MAIN, seed=0, device=dev,
                            validate=False)
        ev = make_evaluator(order=6, eps=1e-7, dtype="fp32")
        e0 = float(nbody.total_energy(hermite.initialize(st, ev)))
        ref, counts_ev, _, wall_ev = counted(
            lambda: hermite.evolve(st, ev, t_end=API_T_END, eta=ETA),
            all_kernels)
        e1 = float(nbody.total_energy(ref))
        de = abs((e1 - e0) / e0)
        same = bitwise_same(h.state, ref, nbody.FIELDS)
        # phase 4's main path again, in this process state: the control for
        # the step walls above
        ctrl = nbody_run.run(n=N_MAIN, t_end=API_T_END, eta=ETA, seed=0,
                             dtype="fp32", device=dev)
        ctrl_ms = 1e3 * ctrl["wall_s"] / ctrl["steps"]
        step_ms = 1e3 * rep["step_wall_s"]["median"]
        print(f"api single plummer N={N_MAIN} fp32 (CLI): steps {steps} "
              f"(phase 4's nbody.plummer state: {main_run['steps']}), "
              f"|dE/E| {rep['de_rel']:.3e}, launches {counts}, wall "
              f"{wall:.3f} s, report wall_s {rep['wall_s']:.3f} s, step wall "
              f"median {step_ms:.4f} ms (phase 4 {main_run['step_ms']:.4f} "
              f"ms/step), metrics {rep['metrics']['counters']}", flush=True)
        print(f"api single build/step/collect: steps {h.steps}, |dE/E| "
              f"{rep_b['de_rel']:.3e}, launches {counts_b}; hermite.evolve "
              f"on scenarios.make('plummer', {N_MAIN}, seed=0): steps "
              f"{counts_ev['acc_jerk_pot'] - 1}, |dE/E| {de:.3e}, wall "
              f"{wall_ev:.3f} s ({1e3 * wall_ev / steps:.4f} ms/step); final "
              f"state bitwise equal {same}; phase 4's main path rerun here: "
              f"{ctrl['steps']} steps, {ctrl_ms:.4f} ms/step", flush=True)
        for name in ("acc_jerk_pot", "snap"):
            for c in (counts, counts_b, counts_ev):
                check(c[name] == steps + 1, f"api single: {name} launched "
                      f"{c[name]} times for {steps} steps and the bootstrap")
        check(counts["flash_attention"] == 0,
              "api single: the flash kernel ran on the N-body path")
        check(h.steps == steps and rep_b["steps"] == steps,
              "api single: CLI and build/step/collect took other steps")
        check(same, "api single: final state differs from hermite.evolve")
        check(rep["de_rel"] == de and rep_b["de_rel"] == de,
              f"api single: |dE/E| {rep['de_rel']} / {rep_b['de_rel']} vs "
              f"hermite.evolve {de}")
        check(rep["de_rel"] <= DE_TIERS["fp32"],
              f"api single: |dE/E| {rep['de_rel']:.3e}")
        check(abs(rep["t_final"] - API_T_END) < 1e-12,
              f"api single stopped at t={rep['t_final']}")
        out["single"] = {"steps": steps, "counts": counts, "wall": wall,
                         "report_wall": rep["wall_s"],
                         "step_ms_median": step_ms,
                         "step_ms_mean": 1e3 * rep["step_wall_s"]["mean"],
                         "evolve_ms": 1e3 * wall_ev / steps,
                         "main_path_rerun_ms": ctrl_ms,
                         "de": rep["de_rel"],
                         "energy": energy_line("api single", nvml, joules,
                                               wall, rep)}
        del h, ref, st

        # (b) the block runner on phase 8's gather run, traced; the host
        # syncs are counted on the build/step/collect run of the same
        # config, since CUDA's sync debug mode slows each one it reports
        path = os.path.join(tmp, "block.json")
        trace_path = os.path.join(tmp, "block_trace.json")
        g8 = block["runs"]["gather"]
        rc, counts, reads, wall, joules = measured(
            nvml, lambda: sim_run.main(API_BLOCK_ARGS + [
                "--out", path, "--trace", trace_path]), all_kernels)
        with open(path) as f:
            rep = json.load(f)
        with open(trace_path) as f:
            doc = json.load(f)
        check(rc == 0, f"api block: sim_run exited {rc}")
        events, tiles = rep["steps"], rep["grid_tiles_total"]
        cnt, gauges = rep["metrics"]["counters"], rep["metrics"]["gauges"]
        launched = cnt["sim.tiles_launched"]["value"]
        bound = gauges["sim.tiles_occupancy_bound"]["value"]
        dense = cnt["sim.tiles_dense_baseline"]["value"]
        builds = cnt.get("engine.cache_miss.block", {"value": 0.0})["value"]
        macro = [e for e in doc["traceEvents"] if e["name"] == "macro-step"]
        macro_s = sum(e["dur"] for e in macro) / 1e6
        cfg = api.SimConfig(scenario=BLOCK_SCENARIO, n=N_MAIN,
                            stepper="block", compaction="gather",
                            validate_ic=False, **BLOCK_KW)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                h, _ = drive(cfg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchronizing" in str(w.message) for w in caught)
        prof = block["profile"].get("gather")
        same = bitwise_same(h.batched, block["gather_state"], nbody.FIELDS)
        chunks = -(-events // cfg.diag_every)
        print(f"api block {BLOCK_SCENARIO} N={N_MAIN} gather (CLI): events "
              f"{events} (phase 8 {g8['events']}), grid_tiles_total "
              f"{tiles:.0f} (phase 8 {g8['tiles']:.0f}), launches {counts}, "
              f"wall {wall:.3f} s ({1e3 * rep['wall_s'] / events:.4f} ms per "
              f"event over the report's wall_s; phase 8 "
              f"{1e3 * g8['wall'] / g8['events']:.4f}), engine.cache_miss."
              f"block {builds:g}, tiles launched {launched:.0f} <= bound "
              f"{bound:.0f} <= dense {dense:.0f}; final state bitwise equal "
              f"to phase 8's {same} (build/step/collect)", flush=True)
        print(f"api block host reads: engine {reads} ({reads / events:.3f} "
              f"per event; phase 8 {g8['reads'] / g8['events']:.3f}), all "
              f"syncs (sync debug mode) {syncs} ({syncs / events:.3f} per "
              f"event; phase 8's profiled window "
              + (f"{prof['syncs'] / BLOCK_PROFILE_EVENTS:.3f}"
                 if prof else "not measured")
              + f"), so the API adds {syncs - reads} over {chunks} chunks of "
              f"{cfg.diag_every} events ({(syncs - reads) / chunks:.2f} per "
              f"chunk; syncs counted on the build/step/collect run); trace "
              f"{len(doc['traceEvents'])} events, "
              f"{len(macro)} macro-step spans summing to {macro_s:.3f} s of "
              f"wall_s {rep['wall_s']:.3f} s", flush=True)
        check(events == g8["events"] and tiles == g8["tiles"],
              "api block: events or tiles differ from phase 8's")
        check(same, "api block: final state differs from phase 8's")
        check(builds <= 1, f"api block: {builds:g} block engine builds")
        check(0 < launched <= bound <= dense,
              f"api block: tiles {launched} / {bound} / {dense}")
        check(launched == tiles, "api block: sim.tiles_launched != tiles")
        for name in ("acc_jerk_pot", "snap"):
            check(counts[name] == events + 1, f"api block: {name} launched "
                  f"{counts[name]} times for {events} events and the "
                  "bootstrap")
        check(counts["flash_attention"] == 0,
              "api block: the flash kernel ran on the N-body path")
        check(macro and macro_s <= rep["wall_s"],
              f"api block: macro-step spans {macro_s} s vs wall_s "
              f"{rep['wall_s']} s")
        check(doc["otherData"]["producer"] == "repro_torch.obs.trace",
              "api block: trace producer")
        out["block"] = {"events": events, "tiles": tiles, "counts": counts,
                        "wall": wall, "report_wall": rep["wall_s"],
                        "reads": reads, "syncs": syncs, "chunks": chunks,
                        "builds": builds, "bound": bound, "dense": dense,
                        "macro_s": macro_s,
                        "energy": energy_line("api block", nvml, joules,
                                              wall, rep)}
        del h

        # (c) the mixed runner on phase 8's padded batch
        path = os.path.join(tmp, "mixed.json")
        rc, counts, _, wall = counted(
            lambda: sim_run.main(API_MIXED_ARGS + ["--out", path]),
            all_kernels)
        with open(path) as f:
            rep = json.load(f)
        check(rc == 0, f"api mixed: sim_run exited {rc}")
        p8 = block["padded"]
        events = [r["steps"] for r in rep["runs"]]
        tiles = [r["grid_tiles"] for r in rep["runs"]]
        cfg = api.SimConfig(
            mix=PADDED_MIX, scenario="mixed", stepper="block",
            compaction="gather", validate_ic=False, **BLOCK_KW)
        h, _ = drive(cfg)
        same = bitwise_same(h.batched, block["padded_state"], nbody.FIELDS)
        print(f"api mixed {[f'{n}:{k}' for n, k in PADDED_MIX]} (CLI): events "
              f"per member {events} (phase 8 {p8['events']}), tiles per "
              f"member {tiles} (phase 8 {p8['tiles']}), launches {counts}, "
              f"wall {wall:.3f} s, |dE/E| {rep['de_rel']:.3e}; final state "
              f"bitwise equal to phase 8's {same} (build/step/collect)",
              flush=True)
        check(events == p8["events"] and tiles == p8["tiles"],
              "api mixed: events or tiles differ from phase 8's")
        check(same, "api mixed: final state differs from phase 8's")
        check(counts["flash_attention"] == 0,
              "api mixed: the flash kernel ran on the N-body path")
        for name in ("acc_jerk_pot", "snap"):
            check(counts[name] > 0, f"api mixed: {name} never launched")
        out["mixed"] = {"events": events, "tiles": tiles, "counts": counts,
                        "wall": wall, "de": rep["de_rel"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def strategy_evaluator(strategy, dtype, mode, slots):
    if strategy == "single":
        return make_evaluator(dtype=dtype)
    return strategies.make_strategy_evaluator(
        strategy, devices=slots, dtype=dtype, ring_mode=mode or "overlap")


def table1_runs(dev, all_kernels, nvml):
    """Phase 10 (a): Table 1 at full scale on one card.  Returns the
    readings by (strategy, dtype, mode)."""
    p = TABLE1_P
    slots = [dev] * p
    state0 = nbody.plummer(TABLE1_N, seed=0, device=dev)
    evals = TABLE1_STEPS + 1
    out = {}
    for strategy, dtype, mode in TABLE1_RUNS:
        ev = strategy_evaluator(strategy, dtype, mode, slots)
        boot = []

        def bootstrap():
            def first(pos, vel, mass):
                boot.append(ev(pos, vel, mass))
                return boot[-1]
            return hermite.initialize(state0, first)

        def steps(s):
            for _ in range(TABLE1_STEPS):
                s = hermite.step(s, TABLE1_DT, ev)
            return s

        with obs_metrics.use() as reg:
            torch.cuda.synchronize()
            e0 = nvml.energy_j()
            s, c0, _, w0 = counted(bootstrap, all_kernels)
            s, c1, _, wall = counted(lambda: steps(s), all_kernels)
            joules = nvml.energy_j() - e0
            shifts = reg.counter("ring.shifts_issued").value
        counts = {k: c0[k] + c1[k] for k in c0}
        shards = 1 if strategy == "single" else p
        model = energy.modeled_energy(w0 + wall, shards, energy.DEFAULT_UTIL)
        out[(strategy, dtype, mode)] = r = {
            "boot": boot[0], "state": s, "counts": counts, "shifts": shifts,
            "step_ms": 1e3 * wall / TABLE1_STEPS, "boot_ms": 1e3 * w0,
            "joules": joules, "modeled_J": model["energy_J"],
            "shards": shards}
        label = strategy + (f" {mode}" if mode else "")
        print(f"table1 {label:<17} {dtype:<6} N={TABLE1_N} p={shards}: "
              f"{1e3 * wall / TABLE1_STEPS:.3f} ms per step "
              f"(bootstrap {1e3 * w0:.3f} ms), launches {counts}, "
              f"ring.shifts_issued {shifts:g}; NVML {joules:.3f} J over the "
              f"run ({joules / (w0 + wall):.2f} W mean), modeled "
              f"{model['energy_J']:.3f} J (the report's model at "
              f"n_devices={shards}, util {energy.DEFAULT_UTIL}; one card "
              f"ran)", flush=True)
        per_shard = 1 if strategy == "single" else (
            p * p if strategy == "ring" else p)
        for name in ("acc_jerk_pot", "snap"):
            check(counts[name] == evals * per_shard,
                  f"table1 {label} {dtype}: {name} launched {counts[name]} "
                  f"times, expected {per_shard} per evaluation x {evals}")
        check(counts["flash_attention"] == 0,
              f"table1 {label}: the flash kernel ran on the N-body path")
        if strategy == "ring":
            want = evals * 2 * (p - 1 if mode == "overlap" else p)
            check(shifts == want, f"table1 ring {mode} {dtype}: "
                  f"{shifts:g} shift rounds, expected {want}")
        check(all(bool(torch.isfinite(x).all()) for x in (s.pos, s.vel, s.acc))
              and tuple(s.pos.shape) == (TABLE1_N, 3),
              f"table1 {label} {dtype}: bad state")
        del ev
    for (strategy, dtype, mode), r in out.items():
        if strategy == "single":
            continue
        ref = out[("single", dtype, None)]
        errs = {f: float((getattr(r["boot"], f) - getattr(ref["boot"], f))
                         .abs().max() / getattr(ref["boot"], f).abs().max())
                for f in ("acc", "jerk", "snap", "pot")}
        dpos = float((r["state"].pos - ref["state"].pos).abs().max())
        r["errs"], r["dpos"] = errs, dpos
        label = strategy + (f" {mode}" if mode else "")
        print(f"table1 {label:<17} {dtype:<6} vs single: bootstrap "
              + " ".join(f"{f} {e:.3e}" for f, e in errs.items())
              + f" (relative, tol {STRATEGY_TOL[dtype]:.0e}); final max "
              f"|dpos| {dpos:.3e} (tol {GOLDEN_TOL[dtype]:.0e}); step "
              f"{r['step_ms'] / ref['step_ms']:.3f}x the single path's, "
              f"NVML J {r['joules'] / ref['joules']:.3f}x", flush=True)
        for f, e in errs.items():
            check(e <= STRATEGY_TOL[dtype],
                  f"table1 {label} {dtype}: bootstrap {f} off by {e:.3e}")
        check(dpos <= GOLDEN_TOL[dtype],
              f"table1 {label} {dtype}: final positions off by {dpos:.3e}")
    ov, sy = out[("ring", "fp32", "overlap")], out[("ring", "fp32", "sync")]
    same = bitwise_same(ov["state"], sy["state"], nbody.FIELDS) and all(
        torch.equal(a, b) for a, b in zip(ov["boot"], sy["boot"]))
    print(f"table1 ring overlap vs sync: bootstrap and final state bitwise "
          f"equal {same}", flush=True)
    check(same, "table1 ring: overlap and sync differ")
    for r in out.values():
        del r["boot"], r["state"]
    return out


def shard_timings(dev):
    """K1 and K2 at phase 10 (a)'s shapes, fp32: the single path's launch
    (N against N), a resident shard's (N/p targets against N sources) and
    a ring round's (N/p against N/p); returns ``{(name, label): (ms, bound
    ms, bound by, shape)}``."""
    bi, bj = nbody_force.DEFAULT_BLOCK_I, nbody_force.DEFAULT_BLOCK_J
    st = nbody.plummer(TABLE1_N, seed=0, device=dev)
    st = hermite.initialize(st, make_evaluator())
    f32 = torch.float32
    pos, vel, acc, mass = (x.to(f32) for x in (st.pos, st.vel, st.acc,
                                                st.mass))
    out = {}
    for label, n_l, n_s in (
            ("single", TABLE1_N, TABLE1_N),
            ("resident shard", TABLE1_N // TABLE1_P, TABLE1_N),
            ("ring round", TABLE1_N // TABLE1_P, TABLE1_N // TABLE1_P)):
        nt_pad, ns_pad = ops._round_up(n_l, bi), ops._round_up(n_s, bj)
        tgt = ops.pack_targets(pos[:n_l], vel[:n_l], nt_pad)
        tacc = ops.pack_acc_targets(acc[:n_l], nt_pad)
        src = ops.pack_sources(pos[:n_s], vel[:n_s], mass[:n_s], ns_pad)
        sacc = ops.pack_acc_sources(acc[:n_s], ns_pad)
        operands = {"acc_jerk_pot": (tgt, src), "snap": (tgt, src, tacc, sacc)}
        for name, fn in (("acc_jerk_pot", nbody_force.acc_jerk_pot_packed),
                         ("snap", nbody_force.snap_packed)):
            x = operands[name]
            ms = cuda_ms(lambda: fn(*x, block_i=bi, block_j=bj), 3, warmup=1)
            bms, by = bound_ms(name, "fp32", n_l, n_l, n_s)
            out[(name, label)] = (ms, bms, by, (n_l, n_s))
            print(f"{name:<13} fp32 {label} N_t={n_l} N_s={n_s}: kernel "
                  f"{ms:.4f} ms  bound {bms:.4f} ms ({by})  bound/kernel "
                  f"{bms / ms:.3f}", flush=True)
    return out


def strategy_block_runs(dev, all_kernels, block=None):
    """Phase 10 (b): phase 8's block run under each strategy over PE_P
    slots of the one card: phase 24 (a)'s jobs (``mesh_runs``), whose
    results are the in-process engine that phase 24 holds its ranks to.
    Held: the events (phase 8's, where ``block`` gives them), tiles per
    shard those of ``CapacityPlan.shard`` at the recorded bounds,
    launched <= bound-sized <= dense, K1/K2 launches, |dE/E|, the end
    time, gather == none on the state's bytes and overlap == sync.
    Returns the readings by label, the jobs' results in their order and
    the launch shapes recorded in the dense resident and ring runs (the
    per-rank shapes)."""
    bi, bj = nbody_force.DEFAULT_BLOCK_I, nbody_force.DEFAULT_BLOCK_J
    p = PE_P
    jobs = {label: j for (part, label), j in engine_jobs().items()
            if part == "a"}
    st = scenarios.make(BLOCK_SCENARIO, N_MAIN, seed=0, device=dev,
                        validate=False)
    out, ref, shapes = {}, [], {}
    for label, job in jobs.items():
        ring = job["strategy"] == "ring"
        rec = {}
        dense = job["compaction"] == "none" and job["strategy"] in (
            "mesh_sharded", "ring")
        with (recording(rec) if dense else contextlib.nullcontext()):
            (res,) = mesh_runs.in_process([dev] * p, [job])
        if dense:
            shapes["ring round" if ring else "resident shard"] = rec
        ref.append(res)
        t, counts = res["tensors"], res["counts"]
        events = int(t["carry.n_events"])
        tiles = t["carry.n_tiles"].tolist()
        plan = ops.CapacityPlan(N_MAIN, N_MAIN, bi, bj).shard(p)
        if ring:
            plan = dataclasses.replace(plan, n_sources=N_MAIN // p,
                                       n_passes=2 * p)
        dense_tiles = events * plan.dense_tiles
        expect = ([float(sum(plan.tiles(strategies._shard_bucket(plan, b[k]))
                             for b in t["bounds"].tolist()))
                   for k in range(p)] if job["compaction"] == "gather"
                  else [float(dense_tiles)] * p)
        # the a-priori bound: every event sized from occupancy entry 0
        # (each shard's real particles)
        sized = float(events * plan.tiles(strategies._shard_bucket(
            plan, N_MAIN // p)))
        e0 = nbody.total_energy(hermite.initialize(
            st, strategies.make_strategy_evaluator(
                job["strategy"], devices=[dev] * p,
                ring_mode=job["ring_mode"])))
        state = _on(dev, pe_state(res))
        de = abs(float((nbody.total_energy(state) - e0) / e0))
        wall = res["times"]["wall_s"]
        out[label] = r = {"events": events, "tiles": tiles,
                          "counts": {k: counts[k] for k in (
                              "acc_jerk_pot", "snap")},
                          "reads": counts["host_syncs"], "wall": wall,
                          "de": de}
        g8 = "" if block is None else (
            f" (phase 8 {block['runs']['gather']['events']})")
        print(f"block strategy {label:<20} p={p}: events {events}{g8}, wall "
              f"{wall:.3f} s ({res['times']['ms_per_event']:.4f} ms/event), "
              f"host reads {r['reads']} ({r['reads'] / events:.3f}/event), "
              f"launches {r['counts']}, tiles per shard {tiles} "
              f"(CapacityPlan.shard at the recorded bounds {expect}; "
              f"bound-sized {sized:.0f}, dense {dense_tiles}), |dE/E| "
              f"{de:.3e}", flush=True)
        check(events == PE_EVENTS and (
            block is None or events == block["runs"]["gather"]["events"]),
            f"block strategy {label}: {events} events")
        check(tiles == expect, f"block strategy {label}: tiles {tiles} vs "
              f"CapacityPlan.shard {expect}")
        check(all(x <= sized <= dense_tiles for x in tiles),
              f"block strategy {label}: launched <= bound-sized <= dense")
        per_shard = p * p if ring else p
        for name, n in r["counts"].items():
            check(n == (events + 1) * per_shard,
                  f"block strategy {label}: {name} launched {n} times for "
                  f"{events} events and the bootstrap")
        check(de <= DE_TIERS["fp32"], f"block strategy {label}: |dE/E| {de}")
        check(abs(float(state.time) - BLOCK_KW["t_end"]) < 1e-12,
              f"block strategy {label} stopped at t={float(state.time)}")
    by = dict(zip(jobs, ref))
    for s_ in strategies.STRATEGIES:
        m_ = " overlap" if s_ == "ring" else ""
        g, n = by[f"{s_} gather{m_}"], by[f"{s_} none{m_}"]
        same = all(mesh_runs.digest(g["tensors"][f"state.{f}"])
                   == mesh_runs.digest(n["tensors"][f"state.{f}"])
                   for f in nbody.FIELDS)
        tg, tn = g["tensors"]["carry.n_tiles"], n["tensors"]["carry.n_tiles"]
        print(f"block strategy {s_}: gather == none on the state's bytes "
              f"{same}; tiles per shard gather {tg.tolist()} none "
              f"{tn.tolist()}", flush=True)
        check(same, f"block strategy {s_}: gather and none differ")
        check(bool((tg <= tn).all() and (tg < tn).any()),
              f"block strategy {s_}: gather tiles {tg.tolist()}")
    ov, sy = by["ring gather overlap"], by["ring gather sync"]
    same = all(torch.equal(ov["tensors"][k], sy["tensors"][k])
               for k in ov["tensors"])
    print(f"block strategy ring gather: overlap == sync bit for bit {same}",
          flush=True)
    check(same, "block strategy ring: overlap and sync differ")
    return {"runs": out, "ref": ref, "shapes": shapes}


def strategy_cli(dev, all_kernels, block):
    """Phase 10 (c): the CLI under a strategy on one card, and a device
    count above the visible one refused."""
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_strategy_")
    try:
        path = os.path.join(tmp, "single.json")
        rc, counts, _, wall = counted(
            lambda: sim_run.main(API_STRATEGY_SINGLE_ARGS + ["--out", path]),
            all_kernels)
        with open(path) as f:
            rep = json.load(f)
        check(rc == 0, f"cli replicated: sim_run exited {rc}")
        print(f"cli replicated --devices 1 plummer N={N_MAIN}: steps "
              f"{rep['steps']}, devices {rep['devices']}, |dE/E| "
              f"{rep['de_rel']:.3e}, launches {counts}, wall {wall:.3f} s",
              flush=True)
        for name in ("acc_jerk_pot", "snap"):
            check(counts[name] == rep["steps"] + 1, f"cli replicated: {name} "
                  f"launched {counts[name]} times for {rep['steps']} steps")
        check(rep["de_rel"] <= DE_TIERS["fp32"] and rep["devices"] == 1,
              f"cli replicated: |dE/E| {rep['de_rel']}")
        out["single"] = {"steps": rep["steps"], "counts": counts,
                         "wall": wall}

        path = os.path.join(tmp, "block.json")
        rc, counts, reads, wall = counted(
            lambda: sim_run.main(API_STRATEGY_BLOCK_ARGS + ["--out", path]),
            all_kernels)
        with open(path) as f:
            rep = json.load(f)
        check(rc == 0, f"cli mesh_sharded block: sim_run exited {rc}")
        g8 = block["runs"]["gather"]
        per_shard = rep["grid_tiles_per_shard"]
        print(f"cli mesh_sharded --stepper block --compaction gather "
              f"--devices 1: events {rep['steps']} (phase 8 {g8['events']}), "
              f"grid_tiles_per_shard {per_shard} (phase 8's gather tiles "
              f"{g8['tiles']:.0f}), launches {counts}, host reads {reads}, "
              f"wall {wall:.3f} s, |dE/E| {rep['de_rel']:.3e}", flush=True)
        check(per_shard == [rep["grid_tiles_total"]] and
              rep["steps"] == g8["events"] and per_shard[0] == g8["tiles"],
              f"cli mesh_sharded block: grid_tiles_per_shard {per_shard}")
        check(rep["de_rel"] <= DE_TIERS["fp32"],
              f"cli mesh_sharded block: |dE/E| {rep['de_rel']}")
        out["block"] = {"events": rep["steps"], "tiles": per_shard,
                        "counts": counts, "wall": wall}

        # in this process (a new interpreter takes some 10 s to reach the
        # card): the error the CLI exits with
        visible = torch.cuda.device_count()
        refused = None
        try:
            sim_run.main(
                ["--scenario", "plummer", "--n", "64", "--t-end", "0.001",
                 "--strategy", "replicated", "--devices", str(visible + 1),
                 "--no-validate", "--out", os.path.join(tmp, "refused.json")])
        except ValueError as e:
            refused = str(e)
        said = f"only {visible} visible"
        print(f"cli --devices {visible + 1} on {visible} visible card(s): "
              f"refused {refused is not None}, names the visible count "
              f"{refused is not None and said in refused}", flush=True)
        check(refused is not None and said in refused,
              f"cli --devices {visible + 1}: {refused!r}")
        out["refused"] = refused
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def strategy_phase(dev, all_kernels, block, nvml):
    """Phase 10: the paper's distribution strategies on the card."""
    out = {"table1": table1_runs(dev, all_kernels, nvml)}
    out["shapes"] = shard_timings(dev)
    out["block"] = strategy_block_runs(dev, all_kernels, block)
    out["cli"] = strategy_cli(dev, all_kernels, block)
    return out


def serve_path(cfg, dev, all_kernels):
    """Phase 7: qwen3-0.6b at full width through ``Engine.generate`` with the
    flash kernel, after holding the flash route's logits against the plain
    route's on the same weights.  Returns the launch counts and timings."""
    torch.cuda.reset_peak_memory_stats(dev)
    cfg_flash = dataclasses.replace(cfg, attn_impl="flash")
    params = lm_params.init_params(
        cfg_flash, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = lm_params.count_params(cfg)
    engine = Engine(cfg_flash, params, ServeConfig(max_len=LM_PROMPT + LM_GEN))
    del params
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    print(f"{cfg.name}: {n_params} parameters ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size} padded to "
          f"{cfg.padded_vocab}), {cfg.dtype} weights and activations; "
          f"{LM_BATCH} prompts of {LM_PROMPT} tokens, {LM_GEN} generated",
          flush=True)

    # flash route vs plain route: a prefill and one decode step of each
    logits, routes = {}, {}
    lf, cache = lm_model.prefill(cfg_flash, engine.params, batch,
                                 max_len=LM_PROMPT + LM_GEN)
    first = torch.argmax(lf, dim=-1)[:, None]
    df, _ = lm_model.decode_step(cfg_flash, engine.params, cache, first)
    torch.cuda.synchronize()
    logits["flash"] = (lf.float(), df.float())
    del cache
    # plain route: the same weights, attention by layers._attn_full
    cfg_xla = dataclasses.replace(cfg, attn_impl="xla")
    lx, cache = lm_model.prefill(cfg_xla, engine.params, batch,
                                 max_len=LM_PROMPT + LM_GEN)
    dx, _ = lm_model.decode_step(cfg_xla, engine.params, cache, first)
    torch.cuda.synchronize()
    logits["xla"] = (lx.float(), dx.float())
    del cache
    for i, stage in enumerate(("prefill", "first decode")):
        a, b = logits["flash"][i], logits["xla"][i]
        check(a.shape == (LM_BATCH, cfg.padded_vocab)
              and bool(torch.isfinite(a).all()), f"{stage} logits: bad output")
        err = float((a - b).abs().max()) / float(b.abs().max())
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        routes[stage] = err
        print(f"{stage} logits, flash route vs plain route (attn_impl=xla): "
              f"max normalised err {err:.3e} (tol {SERVE_TOL:.0e}), max "
              f"|logit| {float(b.abs().max()):.4f}, same argmax in "
              f"{100 * same:.0f}% of rows", flush=True)
        check(err <= SERVE_TOL, f"{stage} logits: flash vs plain route "
                                f"{err:.3e} > {SERVE_TOL}")
    del logits

    # the main path: Engine.generate for one token, then for LM_GEN, every
    # launch count zeroed just before each; the two totals give K3's
    # launches per prefill and per decode step
    totals = {}
    for n_tokens in (1, LM_GEN):
        for k in all_kernels.values():
            k.launches = 0
        out, stats = engine.generate({"tokens": prompts}, n_tokens)
        counts = {name: k.launches for name, k in all_kernels.items()}
        totals[n_tokens] = counts["flash_attention"]
    peak = torch.cuda.max_memory_allocated(dev)
    n_decode = (totals[LM_GEN] - totals[1]) / (LM_GEN - 1)
    n_prefill = totals[1] - n_decode
    print(f"flash kernel launches in Engine.generate: {totals[1]} for 1 "
          f"token, {totals[LM_GEN]} for {LM_GEN}: {n_prefill:g} per prefill "
          f"(expected {cfg.n_layers}), {n_decode:g} per decode step "
          f"(expected 0)", flush=True)
    check(n_prefill == cfg.n_layers, f"flash kernel launched {n_prefill:g} "
                                     f"times in a {cfg.n_layers}-layer prefill")
    check(n_decode == 0, f"flash kernel launched {n_decode:g} times per "
                         f"decode step")
    print(f"serve main path: Engine.generate launches={counts} "
          f"prefill {1e3 * stats['prefill_s']:.3f} ms, decode "
          f"{1e3 * stats['decode_s']:.3f} ms ({1e3 * stats['decode_s'] / LM_GEN:.3f}"
          f" ms per token step), {stats['tok_per_s']:.1f} tok/s, "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB", flush=True)
    check(counts["flash_attention"] == cfg.n_layers,
          f"serve main path: flash kernel launched "
          f"{counts['flash_attention']} times, expected {cfg.n_layers}")
    check(counts["acc_jerk_pot"] == 0 and counts["snap"] == 0,
          "serve main path: N-body kernels ran")
    check(tuple(out.shape) == (LM_BATCH, LM_GEN) and not out.is_floating_point()
          and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          f"serve main path: tokens {tuple(out.shape)} {out.dtype}")
    print(f"  seq 0: {out[0, :16].tolist()} ...", flush=True)

    profile = serve_profile(cfg_flash, engine.params, batch,
                            LM_PROMPT + LM_GEN, first)
    return {"launches": counts["flash_attention"],
            "launches_prefill": int(n_prefill), "launches_decode": int(n_decode),
            "stats": stats, "peak": peak, "routes": routes, "profile": profile}

#: the profiled prefill's and decode step's costliest aten ops printed
SERVE_PROFILE_OPS = 6


def serve_profile(cfg, params, batch, max_len, first, cache=None):
    """Where the time goes: one prefill and one decode step (tokens
    ``first``) under the profiler, each printed with its launches, the
    card's busy share, K3's share and the costliest kernels.  Given a
    prefill's ``cache``, only the decode step is profiled, on it (a prefill
    of hundreds of thousands of launches takes the profiler longer than
    the run)."""
    profile = {}
    for stage in ("prefill", "decode step")[0 if cache is None else 1:]:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if cache is None:
                _, cache = lm_model.prefill(cfg, params, batch,
                                            max_len=max_len)
            else:
                lm_model.decode_step(cfg, params, cache, first)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        profile[stage] = p = device_profile(prof, wall)
        if p is None:
            print(f"profile {stage}: wall {wall:.3f} ms; torch.profiler "
                  f"recorded no device time", flush=True)
            continue
        top = ", ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in p["top"])
        p["ops"] = p["ops"][:SERVE_PROFILE_OPS]
        ops = ", ".join(f"{name} {ms:.3f}" for name, ms in p["ops"])
        print(f"profile {stage}: wall {wall:.3f} ms, device kernels "
              f"{p['device_ms']:.3f} ms in {p['kernels']} launches (busy "
              f"{100 * p['busy']:.1f}%, idle {100 * (1 - p['busy']):.1f}%); "
              f"K3 {p['flash_ms']:.3f} ms "
              f"({100 * p['flash_ms'] / p['device_ms']:.1f}% of the kernels' "
              f"time); top: {top}; device ms by aten op: {ops}", flush=True)
    del cache
    return profile


# --------------------------------------------------------------------------
# phase 11: the Ahmad-Cohen neighbor scheme
# --------------------------------------------------------------------------
@contextlib.contextmanager
def recording(shapes):
    """Record each K1/K2 launch's operand shapes while the path runs as it
    does (the rect wrappers, which pack and launch, are wrapped, not the
    kernels): ``shapes[(name, targets shape, sources shape)] = [launches,
    (arguments, keywords) of the last one]``."""
    real = {"acc_jerk_pot": ops.acc_jerk_pot_rect, "snap": ops.snap_rect}

    def wrap(name):
        def call(*x, **kw):
            key = (name, tuple(x[0].shape), tuple(x[-2].shape))
            entry = shapes.setdefault(key, [0, None])
            entry[0] += 1
            entry[1] = (x, kw)
            return real[name](*x, **kw)
        return call

    ops.acc_jerk_pot_rect = wrap("acc_jerk_pot")
    ops.snap_rect = wrap("snap")
    try:
        yield shapes
    finally:
        ops.acc_jerk_pot_rect = real["acc_jerk_pot"]
        ops.snap_rect = real["snap"]


def packed(name, x, kw):
    """The packed kernel operands and keywords of a recorded rect call, as
    ``ops.acc_jerk_pot_rect`` / ``ops.snap_rect`` build them."""
    bi, bj = kw["block_i"], kw["block_j"]
    nt = -(-x[0].shape[-2] // bi) * bi
    ns = -(-x[-2].shape[-2] // bj) * bj
    mask = kw.get("mask_t")
    tgt = ops.pack_targets(x[0], x[1], nt, mask)
    kkw = dict(eps=kw["eps"], block_i=bi, block_j=bj,
               compute_dtype=ops.compute_dtype_for(kw["dtype"]))
    if name == "acc_jerk_pot":
        return (tgt, ops.pack_sources(x[2], x[3], x[4], ns)), kkw
    return (tgt, ops.pack_sources(x[3], x[4], x[6], ns),
            ops.pack_acc_targets(x[2], nt),
            ops.pack_acc_sources(x[5], ns)), kkw


@contextlib.contextmanager
def plain_kernels():
    """K1 and K2 replaced by their plain versions on the same (CUDA)
    operands, for the comparisons only: nothing launches, nothing counts."""
    real = (nbody_force.acc_jerk_pot_packed, nbody_force.snap_packed)

    def plain(fn):
        def call(*x, eps, block_i, block_j, compute_dtype):
            batch = x[0].shape[0] if x[0].dim() == 3 else 0
            return nbody_force._plain(fn, x, batch, eps=eps, block_i=block_i,
                                      block_j=block_j,
                                      compute_dtype=compute_dtype)
        return call

    nbody_force.acc_jerk_pot_packed = plain(nbody_force._acc_jerk_plain)
    nbody_force.snap_packed = plain(nbody_force._snap_plain)
    try:
        yield
    finally:
        nbody_force.acc_jerk_pot_packed, nbody_force.snap_packed = real


def launch_readings(name, x, kw, kern):
    """K1 or K2 (``kern``) on the operands ``x`` of a launch the path made:
    against its plain version at the fp32 tolerance, timed beside it (CUDA
    events), with the launcher's grid and the bound of the pairs this data
    needs (:func:`window_bound_ms`)."""
    plain = {"acc_jerk_pot": nbody_force._acc_jerk_plain,
             "snap": nbody_force._snap_plain}[name]
    batch = x[0].shape[0]
    got = kern(*x, **kw)
    # the plain version's time is that of the comparison's one cold call
    # (a second, warm call took 1.2 to 2.1 s a shape)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = nbody_force._plain(plain, x, batch, **kw)
    end.record()
    torch.cuda.synchronize()
    pms = start.elapsed_time(end)
    norm_err, abs_err = compare(name, got, want, x[0], TOL["fp32"])
    del got, want
    kern.blocks = {}
    ms = cuda_ms(lambda: kern(*x, **kw), 20)
    blocks = next(iter(kern.blocks))
    bms, by, pairs = window_bound_ms(name, "fp32", x)
    return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "pairs": pairs, "blocks": blocks, "max_norm_err": norm_err,
            "max_abs_err": abs_err}


def near_holds(dev, dtype, nbr_state):
    """(a) and (b): near1/near2 on the card against their plain versions on
    the same windows, and a window evaluated at its bucket and the next one
    up giving the same bits.  The targets are a seeded 30% of the rows of
    the sorted state's blocks whose windows fit a bucket below the full
    extent (so a bucket above theirs exists), the first block inactive."""
    n, bi, bj = NBR_N, NBR_CFG["block_i"], NBR_CFG["block_j"]
    eps = NBR_CFG["eps"]
    near1, near2 = make_neighbor_block_evaluator(
        n=n, eps=eps, block_i=bi, block_j=bj, dtype=dtype)
    s = nbr_state
    real = torch.ones(1, n, dtype=torch.bool, device=dev)
    win_idx, win_cnt = neighbor.build_windows(
        s.pos, real, block_i=bi, block_j=bj,
        radius=NBR_CFG["neighbor_radius"])
    plan = ops.CapacityPlan(n, n, bi, bj, sources="neighbor")
    fits = win_cnt * bj <= plan.source_caps[-2]
    rng = np.random.default_rng(11)
    mask = torch.as_tensor(rng.uniform(size=(1, n)) < 0.3, device=dev)
    mask &= fits.repeat_interleave(bi, dim=1)[:, :n]
    mask[:, :bi] = False
    w = int(plan.source_bucket(torch.where(fits, win_cnt, 0).max() * bj))
    acc_s = s.acc.clone()
    args1 = (s.pos, s.vel, s.mass, mask, win_idx, win_cnt)
    args2 = (s.pos, s.vel, s.acc, acc_s, s.mass, mask, win_idx, win_cnt)
    got1, got2 = near1(*args1, w), near2(*args2, w)
    with plain_kernels():
        want1, want2 = near1(*args1, w), near2(*args2, w)
    torch.cuda.synchronize()
    out = {"bucket": w, "window_rows": plan.source_caps[w],
           "max_win_cnt": int(win_cnt.max()),
           "mean_win_cnt": float(win_cnt.float().mean()),
           "blocks_held": int(fits.sum()), "targets": int(mask.sum())}
    errs = {}
    for label, g, want in zip(("acc", "jerk", "pot", "snap"),
                              got1 + (got2,), want1 + (want2,)):
        check(bool(torch.isfinite(g).all()), f"near {label}: non-finite")
        d = float((g - want).abs().max())
        scale = float(want.abs().max())
        errs[label] = (d / scale, d)
        check(bool((g[~mask] == 0).all()),
              f"near {dtype} {label}: inactive rows not exactly zero")
        check(d / scale <= TOL[dtype], f"near {dtype} {label}: normalised "
              f"error {d / scale:.3e} > {TOL[dtype]}")
    out["errs"] = errs
    # (b) the next bucket up appends only zero-mass slots to every window
    up = w + 1
    same = (all(torch.equal(a, b) for a, b in zip(got1, near1(*args1, up)))
            and torch.equal(got2, near2(*args2, up)))
    out["growth_bitwise"] = same
    print(f"near {dtype} (sorted plummer {n}, {out['targets']} targets in "
          f"{out['blocks_held']} of {n // bi} blocks, bucket {w} = "
          f"{plan.source_caps[w]} rows; every block's window max "
          f"{out['max_win_cnt']}, mean {out['mean_win_cnt']:.2f} of "
          f"{n // bj} blocks): kernel vs "
          f"plain max normalised err " + ", ".join(
              f"{k} {v[0]:.3e}" for k, v in errs.items())
          + f" (tol {TOL[dtype]:.0e}); bucket {w} vs {up} "
          f"({plan.source_caps[up]} rows) bitwise equal {same}", flush=True)
    check(same, f"near {dtype}: bucket growth changed the bits")
    return out


def neighbor_phase(dev, all_kernels):
    """Phase 11: the neighbor scheme at full size.  Returns the readings
    the JSON line and PERF.md report."""
    torch.cuda.reset_peak_memory_stats()
    out = {"runs": {}, "shapes": {}}
    runs = (("full", "fp32"), ("neighbor", "fp32"), ("neighbor", "mixed"))
    for sources, dtype in runs:
        cfg = driver.SimConfig(device="cuda", sources=sources, dtype=dtype,
                               **NBR_CFG)
        shapes = {}
        with recording(shapes):
            rep, counts, reads, wall = counted(lambda: driver.run(cfg),
                                               all_kernels)
        blocks = {name: dict(sorted(k.blocks.items()))
                  for name, k in all_kernels.items() if hasattr(k, "blocks")}
        events = rep["steps"]
        prof = kernel_profile(lambda: driver.run(cfg))
        r = out["runs"][(sources, dtype)] = {
            "events": events, "force_evals": rep["force_evals_total"],
            "de": rep["de_rel"], "wall": wall, "report_wall": rep["wall_s"],
            "chunk_median": rep["step_wall_s"]["median"],
            "refreshes": rep.get("neighbor_refreshes", 0),
            "overflows": rep.get("neighbor_overflows", 0),
            "counts": counts, "reads": reads, "blocks": blocks,
            "profile": prof, "shapes": {k: v[0] for k, v in shapes.items()}}
        tier = DE_TIERS[dtype]
        print(f"neighbor A/B {sources:<8} {dtype:<5}: plummer N={NBR_N} "
              f"events {events}, force evals {r['force_evals']:.0f}, "
              f"refreshes {r['refreshes']}, overflows {r['overflows']}, "
              f"|dE/E| {r['de']:.3e} (tier {tier:.0e}), wall {wall:.3f} s "
              f"(report {r['report_wall']:.3f} s, "
              f"{1e3 * r['report_wall'] / events:.4f} ms/event; median "
              f"chunk {1e3 * r['chunk_median'] / NBR_CFG['diag_every']:.4f} "
              f"ms/event), engine host reads {reads} "
              f"({reads / events:.3f}/event), launches {counts}, grids "
              f"{blocks}", flush=True)
        for key, n_launch in sorted(r["shapes"].items(),
                                    key=lambda kv: -kv[1]):
            print(f"  launches {key[0]:<13} tgt {key[1]} src {key[2]}: "
                  f"{n_launch}", flush=True)
        if prof is not None:
            print(f"  profile: wall {prof['wall_ms']:.3f} ms, device "
                  f"{prof['device_ms']:.3f} ms in {prof['kernels']} launches "
                  f"({prof['kernels'] / events:.1f} per event, busy "
                  f"{100 * prof['busy']:.1f}%), K1 + K2 "
                  f"{prof['nbody_ms']:.3f} ms, host syncs (sync debug mode) "
                  f"{prof['syncs']} ({prof['syncs'] / events:.3f} per "
                  f"event)", flush=True)
        else:
            print("  profile: torch.profiler recorded no device time",
                  flush=True)
        for name in ("acc_jerk_pot", "snap"):
            check(counts[name] > 0, f"neighbor {sources} {dtype}: {name} "
                  f"never launched")
        check(r["de"] <= tier, f"neighbor {sources} {dtype}: |dE/E| "
              f"{r['de']:.3e} > {tier}")
        if sources == "neighbor":
            check(r["refreshes"] > 0, "neighbor: no refresh")
            # one read per event, one more per refresh event, the read that
            # finds no member live, and sim.driver's per-chunk reads
            check(reads >= events + r["refreshes"],
                  f"neighbor: {reads} host reads for {events} events")
            out["shapes"][dtype] = shapes
    full, nbr = out["runs"][("full", "fp32")], out["runs"][("neighbor",
                                                             "fp32")]
    print(f"neighbor A/B fp32: events {full['events']} / {nbr['events']}, "
          f"force evals {full['force_evals'] / nbr['force_evals']:.3f}x "
          f"fewer, wall per event {full['report_wall'] / full['events'] * 1e3:.4f}"
          f" / {nbr['report_wall'] / nbr['events'] * 1e3:.4f} ms "
          f"({(full['report_wall'] / full['events']) / (nbr['report_wall'] / nbr['events']):.3f}x)",
          flush=True)

    # K1 and K2 at the neighbor run's most used window shapes: kernel
    # against plain on the operands of its last launch there, and timed
    shapes = out["shapes"]["fp32"]
    out["window_timings"] = {}
    for name in ("acc_jerk_pot", "snap"):
        near = sorted(((v[0], k) for k, v in shapes.items()
                       if k[0] == name and k[1][0] > 1), reverse=True)[:2]
        for n_launch, key in near:
            x, kw = packed(name, *shapes[key][1])
            r = launch_readings(name, x, kw, all_kernels[name])
            shape = (x[0].shape[0], x[0].shape[1], x[1].shape[2])
            out["window_timings"][(name, shape)] = dict(r, launches=n_launch)
            print(f"{name:<13} window B*nbt={shape[0]} x N_t={shape[1]} x "
                  f"N_s={shape[2]}: {n_launch} launches in the run, blocks "
                  f"{r['blocks']}, kernel {r['ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {r['pairs']:.0f} active pairs)  "
                  f"bound/kernel {r['bound_ms'] / r['ms']:.3f}  vs plain max "
                  f"normalised err {r['max_norm_err']:.3e}", flush=True)
    del shapes, out["shapes"]

    # (a), (b): near1/near2 vs plain, bucket growth, on the sorted state
    st = ens.spatial_sort_batched(ens.stack_states(
        [scenarios.make("plummer", NBR_N, seed=0, device=dev,
                        validate=False)]), leaf=NBR_CFG["block_i"])
    st = ens.ensemble_initialize(st, eps=NBR_CFG["eps"])
    out["near"] = {dtype: near_holds(dev, dtype, st)
                   for dtype in ("fp32", "mixed")}
    del st

    # (c) the overflow run (every window the full extent) vs full sources
    kw = dict(BLOCK_KW, block_i=32, block_j=32)
    st = scenarios.make(BLOCK_SCENARIO, NBR_OVERFLOW_N, seed=0, device=dev)
    srt = ens.spatial_sort_state(st, leaf=32)
    full_s, full_c = ens.evolve_ensemble_block([srt], **kw)
    nbr_s, nbr_c = ens.evolve_ensemble_block(
        [st], sources="neighbor", neighbor_radius=NBR_OVERFLOW_RADIUS, **kw)
    dpos = float((nbr_s.pos - full_s.pos).abs().max())
    dvel = float((nbr_s.vel - full_s.vel).abs().max())
    same = bitwise_same(nbr_s, full_s)
    ov = {"events": (int(full_c.n_events[0]), int(nbr_c.n_events[0])),
          "overflows": int(nbr_c.nbr.n_overflow[0]),
          "refreshes": int(nbr_c.nbr.n_refresh[0]), "dpos": dpos,
          "dvel": dvel, "bitwise": same}
    out["overflow"] = ov
    print(f"overflow (radius {NBR_OVERFLOW_RADIUS:g}) vs full sources, "
          f"{BLOCK_SCENARIO} N={NBR_OVERFLOW_N} fp32: events {ov['events']}, "
          f"overflows {ov['overflows']} of {ov['refreshes']} refreshes, "
          f"final max |dpos| {dpos:.3e} |dvel| {dvel:.3e} (BLOCK_TOL fp32 "
          f"{BLOCK_TOL_FP32}), bitwise equal {same}", flush=True)
    check(ov["overflows"] == ov["refreshes"] > 0,
          "overflow run: not every refresh overflowed")
    check(ov["events"][0] == ov["events"][1], "overflow run: events differ")
    check(dpos <= BLOCK_TOL_FP32[0] and dvel <= BLOCK_TOL_FP32[1],
          "overflow run: outside BLOCK_TOL fp32")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 11 peak allocated memory {out['peak_gb']:.3f} GB",
          flush=True)
    return out


# --------------------------------------------------------------------------
# phase 12: the simulation server
# --------------------------------------------------------------------------
def serve_trace():
    """``[(arrival_s, SimRequest), ...]``: the deterministic Poisson trace
    (numpy seed 0, exponential gaps of mean SERVE_MEAN_GAP_S)."""
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(SERVE_MEAN_GAP_S,
                                         size=SERVE_REQUESTS))
    out = []
    for i in range(SERVE_REQUESTS):
        name, n, stepper = SERVE_SHAPES[i % len(SERVE_SHAPES)]
        spec = scenarios.ScenarioSpec.parse(f"{name}:{n}", seed=i)
        out.append((float(arrivals[i]), sim_engine.SimRequest(
            spec=spec, stepper=stepper, t_end=SERVE_T_END)))
    return out


@contextlib.contextmanager
def capturing_retirements(finals):
    """Keep each retired member's rows (``finals[request_id]``) as
    ``Pod.retire`` frees its slot."""
    real = sim_engine.Pod.retire

    def retire(pod, slot, now):
        rows = {f: getattr(pod.batched, f)[slot].clone()
                for f in nbody.FIELDS}
        report = real(pod, slot, now)
        finals[report["request_id"]] = rows
        return report

    sim_engine.Pod.retire = retire
    try:
        yield finals
    finally:
        sim_engine.Pod.retire = real


@contextlib.contextmanager
def timing(methods, seconds):
    """Add each call's host seconds of ``cls.name`` to ``seconds[label]``
    for ``(cls, name, label)`` in ``methods``.  Each method ends in a
    device-to-host read, so the host clock spans its device work."""
    reals = [(cls, name, getattr(cls, name)) for cls, name, _ in methods]

    def timed(real, label):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                seconds[label] = (seconds.get(label, 0.0)
                                  + time.perf_counter() - t0)
        return call

    for (cls, name, real), (_, _, label) in zip(reals, methods):
        setattr(cls, name, timed(real, label))
    try:
        yield seconds
    finally:
        for cls, name, real in reals:
            setattr(cls, name, real)


#: phase 12's time split: admission (of it, building and validating the
#: initial conditions on the host) and the pods' engine chunks
SERVE_SPLIT = ((sim_engine.Pod, "admit", "admit"),
               (scenarios.ScenarioSpec, "build", "build ICs"),
               (sim_engine.Pod, "advance", "advance"))


def serve_run(server, trace, *, stop_after=None):
    """Replay ``trace`` in real time (each request submitted at its arrival
    second) until drained, or until ``stop_after`` reports; returns the
    wall seconds and the requests not yet submitted."""
    pending = list(trace)
    t0 = time.perf_counter()
    while pending or server.busy():
        if stop_after is not None and len(server.reports) >= stop_after:
            break
        now = time.perf_counter() - t0
        while pending and pending[0][0] <= now:
            server.submit(pending.pop(0)[1])
        if server.busy():
            server.step()
        else:
            time.sleep(0.001)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, pending


def serve_phase(dev, all_kernels):
    """Phase 12: the simulation server at full size.  Returns the readings
    the JSON line and PERF.md report.  Each server builds and validates
    its requests' initial conditions on the host, as a server does."""
    trace = serve_trace()
    out = {}
    lib = nbody_force._library

    for label, extra in (("full", {}), ("neighbor", SERVE_NBR)):
        reqs = [(t, r) for t, r in trace
                if label == "full" or r.stepper == "block"]
        server = sim_engine.SimServer(sim_engine.ServerConfig(
            device="cuda", **SERVE_CFG, **extra))
        t0 = time.perf_counter()
        warm = server.warmup([r for _, r in reqs])
        warm_s = time.perf_counter() - t0
        misses0, loads0 = server.cache_misses(), lib.cache_info().misses
        finals, split = {}, {}
        with capturing_retirements(finals), timing(SERVE_SPLIT, split):
            (wall, _), counts, reads, _ = counted(
                lambda: serve_run(server, reqs), all_kernels)
        misses = server.cache_misses() - misses0
        loads = lib.cache_info().misses - loads0
        turn = sorted(r["turnaround_s"] for r in server.reports)
        p50 = turn[len(turn) // 2]
        p99 = turn[min(int(0.99 * (len(turn) - 1) + 0.5), len(turn) - 1)]
        des = {r["request_id"]: r["de_rel"] for r in server.reports}
        r = out[label] = {
            "requests": len(server.reports), "wall": wall, "warmup_s": warm_s,
            "warmup_builds": warm, "misses": misses, "loads": loads,
            "rps": len(server.reports) / wall, "p50": p50, "p99": p99,
            "counts": counts, "reads": reads, "max_de": max(des.values()),
            "pods": sorted(server.pods), "finals": finals, "split": split,
            "refreshes": sum(x.get("neighbor_refreshes", 0)
                             for x in server.reports)}
        print(f"server {label}: {r['requests']} requests in {wall:.3f} s "
              f"({r['rps']:.4f} requests/s), turnaround p50 {p50:.3f} s p99 "
              f"{p99:.3f} s, pods {r['pods']}, warmup {warm_s:.3f} s "
              f"({warm:.0f} engine builds), after warmup engine builds "
              f"{misses:.0f} and kernel library loads {loads}, launches "
              f"{counts}, max |dE/E| {r['max_de']:.3e} (tier "
              f"{DE_TIERS['fp32']:.0e}), neighbor refreshes "
              f"{r['refreshes']}", flush=True)
        admit, build = split.get("admit", 0.0), split.get("build ICs", 0.0)
        advance = split.get("advance", 0.0)
        print(f"server {label} time split: admission {admit:.3f} s "
              f"(building the ICs {build:.3f} s), engine chunks "
              f"{advance:.3f} s, the rest (retire, submit, idle) "
              f"{wall - admit - advance:.3f} s of {wall:.3f} s", flush=True)
        for x in sorted(server.reports, key=lambda x: x["request_id"]):
            print(f"  request {x['request_id']:>2} {x['scenario']:<22} "
                  f"{x['stepper'] if 'stepper' in x else '':<8} pod_cap "
                  f"{x['pod_cap']:>5} steps {x['steps']:>5} |dE/E| "
                  f"{x['de_rel']:.3e} turnaround {x['turnaround_s']:.3f} s",
                  flush=True)
        check(r["requests"] == len(reqs), f"server {label}: "
              f"{r['requests']} of {len(reqs)} requests retired")
        check(misses == 0, f"server {label}: {misses} engine builds after "
              f"warmup")
        check(loads == 0, f"server {label}: kernel library loaded after "
              f"warmup")
        check(r["max_de"] <= DE_TIERS["fp32"],
              f"server {label}: |dE/E| {r['max_de']:.3e}")
        for name in ("acc_jerk_pot", "snap"):
            check(counts[name] > 0, f"server {label}: {name} never launched")
        if label == "neighbor":
            check(r["refreshes"] > 0, "server neighbor: no refresh")

    # suspend mid-trace, resume in a fresh server: the final rows must be
    # the uninterrupted run's, bit for bit; the first ticks are profiled
    full = out["full"]
    server = sim_engine.SimServer(sim_engine.ServerConfig(device="cuda",
                                                          **SERVE_CFG))
    server.warmup([r for _, r in trace])
    for _, r in trace:
        server.submit(r)
    finals = {}
    with capturing_retirements(finals):
        server.step()   # the first tick admits: the ICs are built on the host
        prof = kernel_profile(lambda: [server.step()
                                       for _ in range(SERVE_PROFILE_TICKS)])
        serve_run(server, [], stop_after=SERVE_REQUESTS // 2)
        with tempfile.TemporaryDirectory() as tmp:
            server.suspend(tmp, step=1)
            resumed = sim_engine.SimServer.resume(tmp)
        done_before = len(server.reports)
        resumed.run_until_drained()
    same = (sorted(finals) == sorted(full["finals"]) and all(
        all(torch.equal(finals[k][f], full["finals"][k][f])
            for f in nbody.FIELDS) for k in finals))
    out["resume"] = {"before": done_before, "after": len(resumed.reports),
                     "bitwise": same, "profile": prof}
    print(f"server suspend/resume: {done_before} requests retired before "
          f"the suspend, {len(resumed.reports)} after the resume; every "
          f"final state bitwise equal to the uninterrupted run's: {same}",
          flush=True)
    if prof is None:
        print("server profile: torch.profiler recorded no device time",
              flush=True)
    else:
        print(f"server profile ({SERVE_PROFILE_TICKS} ticks after the first, "
              f"all {SERVE_REQUESTS} requests queued): wall {prof['wall_ms']:.3f} ms, device "
              f"{prof['device_ms']:.3f} ms in {prof['kernels']} launches, "
              f"busy {100 * prof['busy']:.1f}%, K1 + K2 {prof['nbody_ms']:.3f}"
              f" ms, host syncs {prof['syncs']}", flush=True)
    check(0 < done_before < SERVE_REQUESTS and len(resumed.reports) > 0,
          f"server: the suspend did not fall mid-trace ({done_before} "
          f"retired before it)")
    check(same, "server: resumed final states differ from the "
          "uninterrupted run's")
    for label in ("full", "neighbor"):
        del out[label]["finals"]
    return out

# --------------------------------------------------------------------------
# phase 13: the batch layouts and the fused mesh
# --------------------------------------------------------------------------
def same_carry(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[:7], b[:7]))


def batch_layout_runs(dev, all_kernels):
    """Phase 13 (a): phase 8's ensemble over LAYOUT_SLOTS slots of the
    card against one slot.  Returns the two-slot runs' readings by label."""
    eps = 4.0 / N_MAIN
    batched, _ = scenarios.build_padded(
        scenarios.make_mix([("plummer", N_MAIN)], seed=0,
                           repeat=ENSEMBLE_B), device=dev, validate=False)
    init = ens.ensemble_initialize(batched, eps=eps)
    init3 = nbody.ParticleState(**{f: getattr(init, f)[:3]
                                   for f in nbody.FIELDS})
    block = dict(BLOCK_KW, n_events=LAYOUT_EVENTS, eps=eps)
    runs = {
        "fixed": lambda d: ens.evolve_ensemble(
            batched, n_steps=FIXED_STEPS, dt=FIXED_DT, eps=eps, devices=d),
        "adaptive": lambda d: ens.ensemble_run_adaptive(
            init, t_end=ADAPTIVE_T_END, n_steps=ADAPTIVE_STEPS, eps=eps,
            devices=d),
    }
    for comp in ("none", "gather"):
        for mode in ("member", "shared"):
            runs[f"block {comp} {mode}"] = (
                lambda d, c=comp, m=mode: ens.ensemble_run_block(
                    init, compaction=c, bucket_mode=m, devices=d, **block))
    runs["block gather member B=3"] = lambda d: ens.ensemble_run_block(
        init3, compaction="gather", devices=d, **block)
    out = {}
    for label, fn in runs.items():
        one, c1, r1, w1 = counted(lambda: fn(None), all_kernels)
        two, c2, r2, w2 = counted(lambda: fn([dev] * LAYOUT_SLOTS),
                                  all_kernels)
        if label == "fixed":
            same = bitwise_same(one, two, nbody.FIELDS)
            extra = ""
        elif label == "adaptive":
            same = bitwise_same(one[0], two[0], nbody.FIELDS) and all(
                torch.equal(x, y) for x, y in zip(one[1:], two[1:]))
            extra = f", steps per member {two[2].tolist()}"
        else:
            same = bitwise_same(one[0], two[0], nbody.FIELDS) and \
                same_carry(one[1], two[1])
            extra = (f", events per member {two[1].n_events.tolist()}, "
                     f"tiles {two[1].n_tiles.tolist()}, host reads {r2} "
                     f"(one slot {r1})")
        out[label] = {"counts": c2, "counts_one": c1, "wall": w2,
                      "wall_one": w1, "bitwise": same}
        print(f"layout {label:<24} over {LAYOUT_SLOTS} slots: wall {w2:.3f} "
              f"s (one slot {w1:.3f} s), launches {c2} (one slot {c1})"
              f"{extra}; every leaf and counter bitwise equal to one "
              f"slot's: {same}", flush=True)
        check(same, f"layout {label}: differs from the one-slot run")
        for name in ("acc_jerk_pot", "snap"):
            check(c2[name] > 0, f"layout {label}: {name} never launched")
    del batched, init, init3
    return out


def fused_runs(dev, all_kernels):
    """Phase 13 (b): the fused mesh at full width against the 1-D layout,
    one slot and each member's solo mesh_sharded run."""
    n, eps = N_LARGE, 4.0 / N_LARGE
    bi, bj = nbody_force.DEFAULT_BLOCK_I, nbody_force.DEFAULT_BLOCK_J
    bdev, p = FUSED_MESH
    grid = [dev] * (bdev * p)
    batched = ens.stack_states([
        scenarios.make("plummer", n, seed=s, device=dev, validate=False)
        for s in range(FUSED_B)])
    init = ens.ensemble_initialize(batched, eps=eps)
    init_f = ens.ensemble_initialize(batched, eps=eps, mesh=FUSED_MESH,
                                     devices=grid)
    check(bitwise_same(init, init_f, nbody.FIELDS),
          "fused: the mesh's bootstrap differs from one slot's")
    e0 = ens.batched_total_energy(init)
    run_kw = {k: v for k, v in FUSED_KW.items() if k != "t_end"}
    run_kw.update(eps=eps, compaction="gather", n_events=FUSED_EVENTS)
    # the fused grid's per-shard bounds, as its engine reads them
    bounds, bound_of = [], ens._BlockEngine._bound

    def record(self, *args):
        b = bound_of(self, *args)
        if b is not None:
            bounds.append(b)
        return b

    layouts = {"fused 2x2": dict(mesh=FUSED_MESH, devices=grid),
               f"1-D x{bdev}": dict(devices=[dev] * bdev), "one slot": {}}
    out, shapes = {}, {}
    ens._BlockEngine._bound = record
    try:
        for label, kw in layouts.items():
            torch.cuda.reset_peak_memory_stats(dev)
            with recording(shapes.setdefault(label, {})):
                (s, carry), counts, reads, wall = counted(
                    lambda: ens.ensemble_run_block(
                        init, t_end=FUSED_KW["t_end"], **kw, **run_kw),
                    all_kernels)
            out[label] = {"state": s, "carry": carry, "counts": counts,
                          "reads": reads, "wall": wall,
                          "peak_gb": torch.cuda.max_memory_allocated(dev)
                          / 2 ** 30,
                          "grids": {name: dict(sorted(
                              all_kernels[name].blocks.items()))
                              for name in ("acc_jerk_pot", "snap")}}
    finally:
        ens._BlockEngine._bound = bound_of
    solo = []
    for i in range(FUSED_B):
        m = nbody.ParticleState(**{f: getattr(init, f)[i]
                                   for f in nbody.FIELDS})
        (s, carry), counts, reads, wall = counted(
            lambda: ens.strategy_run_block(
                m, t_end=FUSED_KW["t_end"], strategy="mesh_sharded",
                devices=[dev] * p, **run_kw), all_kernels)
        solo.append({"state": s, "carry": carry, "counts": counts,
                     "reads": reads, "wall": wall})
    # where an event's time goes in each layout: the first
    # FUSED_PROFILE_EVENTS events again, under the profiler
    for label, kw in layouts.items():
        prof = kernel_profile(lambda: ens.ensemble_run_block(
            init, t_end=FUSED_KW["t_end"], **kw,
            **dict(run_kw, n_events=FUSED_PROFILE_EVENTS)))
        out[label]["profile"] = prof
        if prof is None:
            print(f"fused profile {label}: torch.profiler recorded no device "
                  "time", flush=True)
        else:
            print(f"fused profile {label} ({FUSED_PROFILE_EVENTS} events): "
                  f"wall {prof['wall_ms']:.3f} ms, device "
                  f"{prof['device_ms']:.3f} ms in {prof['kernels']} "
                  f"launches, busy {100 * prof['busy']:.1f}%, K1 + K2 "
                  f"{prof['nbody_ms']:.3f} ms, host syncs {prof['syncs']}",
                  flush=True)
    f_, one_d, one = (out[k] for k in layouts)
    events = f_["carry"].n_events.tolist()
    plan = ops.CapacityPlan(n, n, bi, bj).shard(p)
    bl = FUSED_B // bdev
    expect = [0.0] * FUSED_B
    for b in bounds:
        for m in range(FUSED_B):
            if sum(b[m]):
                row = range(m // bl * bl, (m // bl + 1) * bl)
                expect[m] += sum(plan.tiles(strategies._shard_bucket(
                    plan, [b[j][k] for j in row])) for k in range(p))
    tiles = f_["carry"].n_tiles.tolist()
    de = de_rel(e0, ens.batched_total_energy(f_["state"]))
    for label, r in out.items():
        ev = max(r["carry"].n_events.tolist())
        print(f"fused phase {label:<10} B={FUSED_B} N={n}: events {ev}, "
              f"wall {r['wall']:.3f} s ({1e3 * r['wall'] / ev:.4f} ms per "
              f"event), launches {r['counts']} "
              f"({r['counts']['acc_jerk_pot'] / ev:.3f} K1 per event), host "
              f"reads {r['reads']} ({r['reads'] / ev:.3f} per event), tiles "
              f"per member {r['carry'].n_tiles.tolist()}, peak allocated "
              f"{r['peak_gb']:.3f} GB", flush=True)
    for i, r in enumerate(solo):
        same = bitwise_same(member(f_["state"], i),
                            ens._batch1(r["state"]), nbody.FIELDS)
        r["bitwise"] = same
        print(f"  member {i} solo mesh_sharded p={p}: events "
              f"{int(r['carry'].n_events)}, wall {r['wall']:.3f} s, tiles "
              f"per shard {r['carry'].n_tiles.tolist()} (fused "
              f"{tiles[i]:.0f}), bitwise equal to the fused member {same}",
              flush=True)
        check(same, f"fused member {i}: differs from its solo run")
        check(int(r["carry"].n_events) == events[i],
              f"fused member {i}: events differ from its solo run")
        check(float(r["carry"].n_tiles.sum()) <= tiles[i],
              f"fused member {i}: its slot's shared cap launched fewer "
              "tiles than the solo run")
    same_1d = bitwise_same(f_["state"], one_d["state"], nbody.FIELDS)
    same_one = bitwise_same(f_["state"], one["state"], nbody.FIELDS)
    print(f"fused vs 1-D bitwise {same_1d}, vs one slot {same_one}; events "
          f"{events}; tiles per member {tiles} (CapacityPlan.shard at the "
          f"recorded bounds {expect}); |dE/E| {[f'{x:.3e}' for x in de]} "
          f"(tier {DE_TIERS['fp32']:.0e}); time "
          f"{f_['state'].time.tolist()}", flush=True)
    check(same_1d and same_one, "fused: differs from the 1-D or one-slot run")
    check(events == one_d["carry"].n_events.tolist()
          == one["carry"].n_events.tolist(), "fused: events differ")
    check(same_carry(one_d["carry"], one["carry"]),
          "fused: the 1-D layout's counters differ from one slot's")
    check(tiles == expect, f"fused: tiles {tiles} vs {expect}")
    check(max(de) <= DE_TIERS["fp32"], f"fused: |dE/E| {max(de):.3e}")
    check(bool((f_["state"].time == FUSED_KW["t_end"]).all()),
          f"fused: members stopped at {f_['state'].time.tolist()}")
    for name in ("acc_jerk_pot", "snap"):
        check(f_["counts"][name] == max(events) * bdev * p,
              f"fused: {name} launched {f_['counts'][name]} times, not one "
              f"per slot per event")
    # K1 and K2 at each layout's most launched slot shape, against plain
    res = {label: {k: v for k, v in r.items()
                   if k not in ("state", "carry")} for label, r in out.items()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, r in res.items():
        # a launch takes at least one block's sweep of all its sources:
        # its grid in waves of one block per SM
        r["waves_per_event"] = {
            name: sum(c * -(-b // sms) for b, c in g.items()) / max(events)
            for name, g in r["grids"].items()}
        print(f"fused grids {label:<10}: K1 {r['grids']['acc_jerk_pot']}, "
              f"K2 {r['grids']['snap']} (blocks: launches); waves of "
              f"{sms} blocks per event K1 "
              f"{r['waves_per_event']['acc_jerk_pot']:.3f}, K2 "
              f"{r['waves_per_event']['snap']:.3f}", flush=True)
    res["slot_shapes"] = {}
    for label, rec in shapes.items():
        for name in ("acc_jerk_pot", "snap"):
            n_launch, key = max((v[0], k) for k, v in rec.items()
                                if k[0] == name)
            x, kw = packed(name, *rec[key][1])
            r = launch_readings(name, x, kw, all_kernels[name])
            shape = (x[0].shape[0], x[0].shape[1], x[1].shape[2])
            per_event = r["ms"] * out[label]["counts"][name] / max(events)
            res["slot_shapes"][(name, label)] = dict(
                r, launches=n_launch, shape=shape, sms=sms)
            print(f"{name:<13} slot {label:<10} B={shape[0]} x N_t="
                  f"{shape[1]} x N_s={shape[2]}: {n_launch} of "
                  f"{out[label]['counts'][name]} launches, blocks "
                  f"{r['blocks']} on {sms} SMs, kernel {r['ms']:.4f} ms "
                  f"(x launches per event {per_event:.4f} ms)  plain "
                  f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {r['pairs']:.0f} active pairs)  "
                  f"bound/kernel {r['bound_ms'] / r['ms']:.3f}  vs plain "
                  f"max normalised err {r['max_norm_err']:.3e} (tol "
                  f"{TOL['fp32']:.0e})", flush=True)
    del shapes
    res["events"], res["tiles"], res["de"] = events, tiles, de
    res["solo_counts"] = [r["counts"] for r in solo]
    res["solo_wall"] = [r["wall"] for r in solo]
    del batched, init, init_f, out, solo
    return res


@contextlib.contextmanager
def built_once(specs, device):
    """Each of ``specs``' initial conditions built (and validated) once,
    before the servers start: ``ScenarioSpec.build`` answers these
    requests with a copy of that build, so the servers' walls time the
    engine, not the host's IC validation."""
    real = scenarios.ScenarioSpec.build
    memo = {(s_.format(), s_.seed): real(s_, device=device) for s_ in specs}

    def build(spec, dtype=torch.float64, **kw):
        key = (spec.format(), spec.seed)
        if key in memo and dtype == torch.float64:
            return dataclasses.replace(memo[key])
        return real(spec, dtype=dtype, **kw)

    scenarios.ScenarioSpec.build = build
    try:
        yield
    finally:
        scenarios.ScenarioSpec.build = real


@contextlib.contextmanager
def card_slots(device):
    """A server's slots as ``devices`` slots of the one card (it would
    take that many cards), resumed servers included."""
    real = sim_engine.ServerConfig.slots
    sim_engine.ServerConfig.slots = lambda cfg: (
        None if cfg.devices <= 1 and cfg.mesh is None
        else [device] * cfg.devices)
    try:
        yield
    finally:
        sim_engine.ServerConfig.slots = real


def mesh_serve_runs(dev, all_kernels):
    """Phase 13 (c): the server on the fused mesh of four slots of the
    card, full then neighbor sources, against a one-slot server."""
    reqs = [sim_engine.SimRequest(
        spec=scenarios.ScenarioSpec.parse(tok, seed=seed), stepper="block",
        t_end=MESH_SERVE_T_END) for tok, seed in MESH_SERVE_TRACE]
    trace = [(0.0, r) for r in reqs]
    lib = nbody_force._library
    mesh = dict(MESH_SERVE_CFG, device=dev.type)
    one = dict(MESH_SERVE_CFG, device=dev.type, devices=1, mesh=None)
    out = {}
    with built_once([q.spec for q in reqs], dev), card_slots(dev):
        for label, extra in (("full", {}), ("neighbor", SERVE_NBR)):
            finals = {}
            for layout, cfg in (("mesh", mesh), ("one slot", one)):
                server = sim_engine.SimServer(sim_engine.ServerConfig(
                    **cfg, **extra))
                warm = server.warmup(reqs[:1])
                misses0, loads0 = server.cache_misses(), \
                    lib.cache_info().misses
                finals[layout] = {}
                with capturing_retirements(finals[layout]):
                    (wall, _), counts, reads, _ = counted(
                        lambda: serve_run(server, trace), all_kernels)
                misses = server.cache_misses() - misses0
                loads = lib.cache_info().misses - loads0
                turn = sorted(r["turnaround_s"] for r in server.reports)
                r = out[(label, layout)] = {
                    "wall": wall, "rps": len(server.reports) / wall,
                    "p50": turn[len(turn) // 2], "p99": turn[-1],
                    "counts": counts, "reads": reads, "misses": misses,
                    "loads": loads, "warm": warm,
                    "max_de": max(x["de_rel"] for x in server.reports)}
                print(f"mesh server {label} {layout}: {len(server.reports)} "
                      f"requests in {wall:.3f} s ({r['rps']:.4f} requests/s),"
                      f" turnaround p50 {r['p50']:.3f} s p99 {r['p99']:.3f} "
                      f"s, warmup {warm:.0f} engine builds, after it "
                      f"{misses:.0f} builds and {loads} kernel library "
                      f"loads, launches {counts}, host reads {reads}, max "
                      f"|dE/E| {r['max_de']:.3e}", flush=True)
                check(len(server.reports) == len(reqs),
                      f"mesh server {label} {layout}: requests lost")
                check(misses == 0 and loads == 0,
                      f"mesh server {label} {layout}: built after warmup")
                check(r["max_de"] <= DE_TIERS["fp32"],
                      f"mesh server {label} {layout}: |dE/E| {r['max_de']}")
            same = sorted(finals["mesh"]) == sorted(finals["one slot"]) \
                and all(all(torch.equal(finals["mesh"][k][f],
                                        finals["one slot"][k][f])
                            for f in nbody.FIELDS) for k in finals["mesh"])
            # suspend after the first tick, resume in a fresh server; a
            # chunk of one event keeps the first tick short of t_end (the
            # chunking does not change the bits)
            server = sim_engine.SimServer(sim_engine.ServerConfig(
                **dict(mesh, chunk_events=1), **extra))
            server.warmup(reqs[:1])
            for q in reqs:
                server.submit(q)
            fin = {}
            with capturing_retirements(fin):
                server.step()
                before = len(server.reports)
                with tempfile.TemporaryDirectory() as tmp:
                    server.suspend(tmp, step=1)
                    resumed = sim_engine.SimServer.resume(tmp)
                resumed.run_until_drained()
            resumed_same = sorted(fin) == sorted(finals["mesh"]) and all(
                all(torch.equal(fin[k][f], finals["mesh"][k][f])
                    for f in nbody.FIELDS) for k in fin)
            out[(label, "mesh")].update(bitwise_one_slot=same,
                                        bitwise_resume=resumed_same)
            print(f"mesh server {label}: final rows bitwise equal to the "
                  f"one-slot server's {same}; suspended after one tick "
                  f"({before} retired), resumed: bitwise equal "
                  f"{resumed_same}", flush=True)
            check(same, f"mesh server {label}: differs from one slot")
            check(before == 0 and resumed_same,
                  f"mesh server {label}: resume differs")
    return out


def layout_phase(dev, all_kernels):
    """Phase 13: the batch layouts, the fused mesh and the server on it."""
    t0 = time.perf_counter()
    out = {"batch": batch_layout_runs(dev, all_kernels),
           "fused": fused_runs(dev, all_kernels),
           "serve": mesh_serve_runs(dev, all_kernels)}
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 14: training the dense LM
# --------------------------------------------------------------------------
#: kernel names of cuBLAS's and CUTLASS's matmuls, for the profile's split
MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
#: the profiled step's costliest aten ops printed
TRAIN_PROFILE_OPS = 12


def train_flops(cfg, b, s):
    """Model FLOPs of one train step: 6 N per token, plus _attn_full's two
    products (scores and p v, every key: it does not skip the causal
    half) forward and twice backward.  Remat's recompute is not counted."""
    attn = 3 * 2 * 2 * b * cfg.n_heads * s * s * cfg.head_dim * cfg.n_layers
    return 6 * lm_params.count_params(cfg) * b * s + attn


def profiled_step(label, step_fn, params, opt_state, batch, flops, n_ops):
    """One more train step under ``torch.profiler``: its wall, device time,
    launches, busy share, matmul time and the ``n_ops`` costliest aten ops
    by device time, printed; returns (params, opt_state, readings or None,
    wall ms)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, _ = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        pwall = 1e3 * (time.perf_counter() - t0)
    prof_r = device_profile(prof, pwall)
    if prof_r is None:
        print(f"profile {label}: wall {pwall:.3f} ms; torch.profiler "
              f"recorded no device time", flush=True)
        return params, opt_state, None, pwall
    mm = sum(ms for name, ms in prof_r["by_name"].items()
             if any(t in name.lower() for t in MATMUL_NAMES))
    prof_r["matmul_ms"] = mm
    prof_r["ops"] = prof_r["ops"][:n_ops]
    top = ", ".join(f"{name} {ms:.3f}" for name, ms in prof_r["ops"])
    print(f"profile {label}: wall {pwall:.3f} ms, device kernels "
          f"{prof_r['device_ms']:.3f} ms in {prof_r['kernels']} launches "
          f"(busy {100 * prof_r['busy']:.1f}%, idle "
          f"{100 * (1 - prof_r['busy']):.1f}%); matmuls {mm:.3f} ms "
          f"({100 * mm / prof_r['device_ms']:.1f}% of the kernels' time, "
          f"{flops / mm / 1e9:.2f} TFLOP/s in them); device ms by aten "
          f"op: {top}", flush=True)
    del prof_r["by_name"]
    return params, opt_state, prof_r, pwall


def train_full(dev, all_kernels, cfg):
    """Phase 14 (a): ``Trainer`` at full width and depth on one repeated
    batch.  Returns the readings, the final params and the batch."""
    spec = BatchSpec(TRAIN_BATCH, TRAIN_SEQ)
    batch0 = SyntheticLM(cfg, spec, seed=0)(0)
    opt = AdamW(learning_rate=TRAIN_LR)
    trainer = Trainer(cfg, opt, lambda step: batch0,
                      TrainerConfig(steps=TRAIN_STEPS, log_every=1),
                      device=dev, log=lambda line: print(line, flush=True))
    torch.cuda.reset_peak_memory_stats(dev)
    (params, opt_state, hist), counts, _, wall = counted(trainer.run,
                                                         all_kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in hist]
    gnorms = [h["gnorm"] for h in hist]
    step_ms = float(np.median([1e3 * h["step_time"] for h in hist[2:]]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    floor = float(np.log(cfg.padded_vocab))
    print(f"train {cfg.name}: {lm_params.count_params(cfg)} parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype} "
          f"activations, fp32 masters, remat {cfg.remat}, attn_impl "
          f"{cfg.attn_impl}; B={TRAIN_BATCH} S={TRAIN_SEQ}, lr {TRAIN_LR}, "
          f"{TRAIN_STEPS} steps of step 0's SyntheticLM batch in "
          f"{wall:.3f} s", flush=True)
    print(f"  losses {[round(x, 4) for x in losses]}; ln(padded_vocab) "
          f"{floor:.4f} + z-loss {hist[0]['z']:.4f}; gnorms "
          f"{[round(x, 4) for x in gnorms]}", flush=True)
    print(f"  step ms (steps 2-7) median {step_ms:.3f}, min "
          f"{min(1e3 * h['step_time'] for h in hist[2:]):.3f}, max "
          f"{max(1e3 * h['step_time'] for h in hist[2:]):.3f}; step 0 "
          f"{1e3 * hist[0]['step_time']:.3f}; {tokens / step_ms * 1e3:.1f} "
          f"tokens/s; {flops / 1e12:.3f} TFLOP per step (6 N tokens + "
          f"attention products) -> {flops / step_ms / 1e9:.2f} TFLOP/s, "
          f"{flops / step_ms / 1e9 / (PEAK_BF16_FLOPS / 1e12):.3f} of the "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 peak; "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; launches {counts}",
          flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"train: a loss or gnorm is not finite: {losses} {gnorms}")
    check(abs(losses[0] - floor - hist[0]["z"]) < 0.5,
          f"train: step 0 loss {losses[0]:.4f} is not near ln(V) + z "
          f"{floor + hist[0]['z']:.4f}")
    check(losses[-1] < losses[0], f"train: the repeated batch was not "
                                  f"learned: {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(not any(counts.values()), f"train: a kernel ran on the gradient "
                                    f"path: {counts}")

    # where a step's time goes: one more step under the profiler
    batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
             for k, v in batch0.items()}
    params, opt_state, prof_r, pwall = profiled_step(
        "train step", trainer._step_fn, params, opt_state, batch, flops,
        TRAIN_PROFILE_OPS)
    del opt_state, trainer
    return {"losses": losses, "gnorms": gnorms, "step_ms": step_ms,
            "tokens_per_s": tokens / step_ms * 1e3, "peak_gib": peak / 2 ** 30,
            "tflops": flops / step_ms / 1e9, "flops": flops,
            "profile": prof_r, "profiled_wall_ms": pwall}, params, batch


def train_card_vs_cpu(dev, cfg):
    """Phase 14 (b): one ``make_train_step`` of the same params and batch on
    the card and on the CPU, at full width, depth 2, fp32 activations."""
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_CPU_DEPTH, dtype="float32")
    cpu = lm_params.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    card = tree_util.map(lambda x: x.to(dev, copy=True), cpu)
    start = tree_util.map(torch.clone, cpu)
    batch = SyntheticLM(cfg, BatchSpec(TRAIN_CPU_BATCH, TRAIN_CPU_SEQ),
                        seed=1)(0)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()}
    opt = AdamW(learning_rate=TRAIN_LR)
    step = make_train_step(cfg, opt)
    t0 = time.perf_counter()
    cpu, _, mc = step(cpu, opt.init(cpu), batch)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card, _, mg = step(card, opt.init(card),
                       {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    rel = {k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
           for k in ("loss", "gnorm")}
    n = out = 0
    worst_excess, worst_norm = -np.inf, 0.0
    for g, c, p0 in zip(tree_util.leaves(card), tree_util.leaves(cpu),
                        tree_util.leaves(start)):
        g = g.cpu().double()
        c, p0 = c.double(), p0.double()
        excess = (g - c).abs() - (TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL * c.abs())
        out += int((excess > 0).sum())
        n += excess.numel()
        worst_excess = max(worst_excess, float(excess.max()))
        worst_norm = max(worst_norm, float((g - c).norm() / (c - p0).norm()))
    print(f"card vs CPU, one step, {cfg.name} depth {cfg.n_layers} fp32 "
          f"B={TRAIN_CPU_BATCH} S={TRAIN_CPU_SEQ}: loss {float(mg['loss']):.6f} "
          f"(rel {rel['loss']:.3e}), gnorm {float(mg['gnorm']):.6f} (rel "
          f"{rel['gnorm']:.3e}; tol {TRAIN_CPU_TOL:.0e}); params: {out} of {n} "
          f"elements outside rtol {TRAIN_PARAM_RTOL:g} atol "
          f"{TRAIN_PARAM_ATOL:g} (share tol {TRAIN_FLIP_SHARE:g}), worst "
          f"excess {worst_excess:.3e}, worst leaf update-norm gap "
          f"{worst_norm:.3e} (tol {TRAIN_UPDATE_NORM_TOL:g}); step {card_s:.3f} "
          f"s on the card (first call), {cpu_s:.3f} s on the CPU", flush=True)
    for k, r in rel.items():
        check(r <= TRAIN_CPU_TOL, f"train card vs CPU: {k} rel {r:.3e}")
    check(out <= TRAIN_FLIP_SHARE * n, f"train card vs CPU: {out} of {n} "
                                       f"parameters outside the bound")
    check(worst_excess <= 2 * TRAIN_LR, f"train card vs CPU: a parameter "
                                        f"{worst_excess:.3e} past the bound")
    check(worst_norm <= TRAIN_UPDATE_NORM_TOL,
          f"train card vs CPU: update norm gap {worst_norm:.3e}")
    return {"rel": rel, "outside": out, "n": n, "worst_excess": worst_excess,
            "update_norm_gap": worst_norm}, card


def train_restart(dev, cfg):
    """Phase 14 (c): steps 0-3 and a checkpoint, a new ``Trainer`` resumed to
    step 6, against an uninterrupted 0-6, in a temporary directory."""
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_CPU_DEPTH)
    data = SyntheticLM(cfg, BatchSpec(RESTART_BATCH, RESTART_SEQ), seed=2)
    opt = AdamW(learning_rate=warmup_cosine(TRAIN_LR, warmup=2, total=6))
    ckpt_bytes = 3 * 4 * lm_params.count_params(cfg) + 4
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        free = shutil.disk_usage(tmp).free
        check(free >= 3 * ckpt_bytes, f"train restart: {free / 1e9:.2f} GB "
                                      f"free under {tmp}, need "
                                      f"{3 * ckpt_bytes / 1e9:.2f} GB")

        def trainer(steps, ckpt_dir):
            return Trainer(cfg, opt, data, TrainerConfig(
                steps=steps, ckpt_every=2, ckpt_dir=ckpt_dir, ckpt_keep=1,
                log_every=10 ** 9), device=dev, log=lambda line: None)

        t1 = trainer(4, tmp)
        saves = []
        plain_save = t1._save

        def timed_save(*args):
            t0 = time.perf_counter()
            plain_save(*args)
            saves.append(time.perf_counter() - t0)

        t1._save = timed_save
        p1, o1, _ = t1.run()
        torch.cuda.synchronize()
        written = sum(os.path.getsize(os.path.join(tmp, "step_00000004", f))
                      for f in os.listdir(os.path.join(tmp, "step_00000004")))
        t2 = trainer(6, tmp)
        t0 = time.perf_counter()
        step, p2, o2 = t2.restore_or_init()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        saved = store._flatten({"params": p1, "opt": o1})
        restored = store._flatten({"params": p2, "opt": o2})
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(saved.values(), restored.values()))
        del p1, o1, t1
        _, _, resumed = t2.run(start_params=p2, start_opt=o2, start_step=step)
        del p2, o2
        _, _, straight = trainer(6, None).run()
        gaps = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(resumed, straight[4:])]
        print(f"restart {cfg.name} depth {cfg.n_layers} B={RESTART_BATCH} "
              f"S={RESTART_SEQ}: checkpoint {written} bytes ({len(saved)} "
              f"leaves) in {saves[0]:.3f} s ({len(saves)} saves: "
              f"{', '.join(f'{x:.3f}' for x in saves)} s), restored in "
              f"{restore_s:.3f} s; restored state bitwise equal to the saved "
              f"one: {same}; resumed at step {step}, steps "
              f"{[h['step'] for h in resumed]}; losses resumed "
              f"{[round(h['loss'], 6) for h in resumed]} vs uninterrupted "
              f"{[round(h['loss'], 6) for h in straight[4:]]}, largest "
              f"relative gap {max(gaps):.3e} (tol {RESTART_TOL:.0e})",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(same, "train restart: the restored state differs from the saved")
    check(step == 4 and [h["step"] for h in resumed] == [4, 5],
          f"train restart: resumed at {step}")
    check(max(gaps) <= RESTART_TOL, f"train restart: loss gap {max(gaps):.3e}")
    return {"save_s": saves, "restore_s": restore_s, "bytes": written,
            "gap": max(gaps), "same": same}


def serve_trained(dev, all_kernels, cfg, params, batch):
    """Phase 14 (d): the trained weights, cast to bf16, prefilled through K3
    and held against the xla route, as phase 7 does."""
    cfg_flash = dataclasses.replace(cfg, attn_impl="flash")
    engine = Engine(cfg_flash, lm_params.cast_params(params, "bfloat16"),
                    ServeConfig(max_len=TRAIN_SEQ))
    prompt = {"tokens": batch["tokens"]}
    (lf, _), counts, _, wall = counted(lambda: lm_model.prefill(
        cfg_flash, engine.params, prompt, max_len=TRAIN_SEQ), all_kernels)
    lx, _ = lm_model.prefill(dataclasses.replace(cfg, attn_impl="xla"),
                             engine.params, prompt, max_len=TRAIN_SEQ)
    torch.cuda.synchronize()
    a, b = lf.float(), lx.float()
    check(a.shape == (TRAIN_BATCH, cfg.padded_vocab)
          and bool(torch.isfinite(a).all()), "trained prefill: bad logits")
    err = float((a - b).abs().max()) / float(b.abs().max())
    same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"serve the trained weights: prefill B={TRAIN_BATCH} S={TRAIN_SEQ} "
          f"through K3 in {1e3 * wall:.3f} ms, launches {counts}; last-token "
          f"logits vs the xla route: max normalised err {err:.3e} (tol "
          f"{SERVE_TOL:.0e}), same argmax in {100 * same:.0f}% of rows",
          flush=True)
    check(counts["flash_attention"] == cfg.n_layers,
          f"trained prefill: K3 launched {counts['flash_attention']} times, "
          f"expected {cfg.n_layers}")
    check(err <= SERVE_TOL, f"trained prefill: flash vs xla {err:.3e}")
    return {"launches": counts["flash_attention"], "err": err,
            "prefill_ms": 1e3 * wall}


def flash_trap(dev, cfg, params):
    """Phase 14 (e): a training forward through the flash route raises on
    the card, before the kernel launches."""
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_CPU_DEPTH, attn_impl="flash",
                              dtype="bfloat16")
    batch = SyntheticLM(cfg, BatchSpec(1, 256), seed=3)(0)
    batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
             for k, v in batch.items()}
    opt = AdamW(learning_rate=TRAIN_LR)
    before = fa.flash_attention.launches
    try:
        make_train_step(cfg, opt)(params, opt.init(params), batch)
    except NotImplementedError as e:
        msg = str(e)
    else:
        msg = None
    print(f"flash route under grad on the card: "
          f"{'NotImplementedError: ' + msg if msg else 'no error'}; launches "
          f"{fa.flash_attention.launches - before}", flush=True)
    check(msg is not None and "attn_impl='xla'" in msg,
          "train: the flash route took a gradient on the card")
    check(fa.flash_attention.launches == before,
          "train: the flash kernel launched under grad")


def train_phase(dev, all_kernels):
    """Phase 14: training qwen3-0.6b at full width.  Returns the readings
    the JSON line and PERF.md report."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = lm_config.get(LM_ARCH)
    check(cfg.attn_impl == "xla" and cfg.remat == "full",
          f"{cfg.name}: registered attn_impl {cfg.attn_impl}, remat "
          f"{cfg.remat}")
    out = {}
    out["full"], params, batch = train_full(dev, all_kernels, cfg)
    out["serve"] = serve_trained(dev, all_kernels, cfg, params, batch)
    del params, batch
    torch.cuda.empty_cache()
    out["cpu"], small = train_card_vs_cpu(dev, cfg)
    flash_trap(dev, cfg, small)
    del small
    out["restart"] = train_restart(dev, cfg)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 15: serving the moe, vlm and audio families at full width
# --------------------------------------------------------------------------
#: each config at its published width with seeded random bf16 weights,
#: cut in depth only where one card's 80 GB forces it; attention as the
#: phase runs it (deepseek-v2's MLA has no flash route); B prompts of
#: ``prompt`` tokens after ``patches`` patch or ``frames`` frame
#: embeddings, ``gen`` tokens generated
FAMILY_RUNS = (
    dict(arch="phi3.5-moe-42b-a6.6b", cut=dict(n_layers=8), attn="flash",
         batch=4, prompt=2048, gen=32),
    dict(arch="deepseek-v2-236b", cut=dict(n_layers=4), attn="xla",
         batch=1, prompt=2048, gen=16),
    dict(arch="qwen2-vl-2b", cut={}, attn="flash", batch=4, prompt=1792,
         patches=256, gen=32),
    dict(arch="seamless-m4t-medium", cut={}, attn="flash", batch=4,
         prompt=512, frames=1024, gen=32),
)
#: K3 at the shapes these runs give it (b, sq, sk, h, kv, d), causal, and
#: ``_attn_dispatch``'s blocks min(512, S)
FAMILY_FLASH = (
    ("phi3.5 prefill g=4", (4, 2048, 2048, 32, 8, 128), True, (512, 512)),
    ("qwen2-vl prefill g=6", (4, 2048, 2048, 12, 2, 128), True, (512, 512)),
    ("seamless encoder", (4, 1024, 1024, 16, 16, 64), False, (512, 512)),
    ("seamless decoder", (4, 512, 512, 16, 16, 64), True, (512, 512)),
    ("seamless cross", (4, 512, 1024, 16, 16, 64), False, (512, 512)),
    ("seamless cross decode", (4, 1, 1024, 16, 16, 64), False, (1, 512)),
)
#: card against CPU: full width, depth 2, B = 1, 512 positions (vlm: 256
#: patches + 256 tokens; audio: 512 frames and 512 tokens), the same
#: weights on both sides: the forward's logits in bf16 within bf16 TOL
#: (tests/test_torch_families.py)
FAMILY_CPU_DEPTH, FAMILY_CPU_LEN = 2, 512
FAMILY_CPU_TOL = 3e-2
#: MoE in bf16, card against CPU.  At the first MoE layer the router's
#: inputs differ by bf16 noise only, so a token may take other experts only
#: where its k-th and (k+1)-th probabilities lie within that noise: (p_k -
#: p_(k+1)) / p_k at most this (tests/test_torch_families.py).  The router's
#: logits are bf16, and p_k / p_(k+1) = exp(l_k - l_(k+1)): logits of
#: magnitude 2 to 4 have an ulp of 2**-6, and the two contenders each
#: rounded to the other neighbour part by two of them.  (Set first at
#: 2**-6: deepseek-v2's first MoE layer, behind a dense layer, showed a
#: flip at 2.3e-2 on one H100, with fp32 routing equal.)  Such a
#: token moves its experts' capacity boundaries, so a later token of those
#: experts is dropped or kept in its place (a slot is its entry's rank
#: among the expert's entries); every kept-expert change must follow an
#: earlier change of that expert's entries.  At the next layer those
#: tokens carry a whole expert's output of difference, which attention,
#: near uniform under random weights, spreads over every later token: the
#: bf16 logits are then no longer comparable (phi3.5 at depth 2: 44 of 512
#: positions moved, the rest 7.4e-2 apart, on one H100).  So the MoE
#: configs' logits are held in fp32 (activations and weights), where no
#: token may route otherwise and the dispatch drops the same slots on both
#: sides
ROUTE_NOISE = 2.0 ** -5
#: fp32 card against CPU, max |card - cpu| / max |cpu| over the logits:
#: sums in other orders through two layers (~1e-6) and fp32 K3 at its
#: tolerance (2e-5, FLASH_TOL) per layer
FAMILY_CPU_TOL_FP32 = 1e-4


def family_cfg(run, **kw):
    cfg = lm_config.get(run["arch"])
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               attn_impl=run["attn"], **{**run["cut"], **kw})


def family_batch(cfg, b, prompt, patches=0, frames=0):
    """Seeded numpy prompts and the stub frontend's embeddings."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, prompt)).astype(
        np.int32)}
    for key, n in (("patches", patches), ("frames", frames)):
        if n:
            out[key] = rng.standard_normal((b, n, cfg.d_model)).astype(
                np.float32)
    return out


def on(dev, batch):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def kv_leaves(cache):
    return [t for v in cache.values() if isinstance(v, dict)
            for t in v.values()]


@contextlib.contextmanager
def spying(module, name, record):
    """``module.name`` wrapped so that ``record(args, result)`` sees each
    call, for the ``with`` block only."""
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        record(args, out)
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def family_flash_holds(dev, shapes=FAMILY_FLASH):
    """K3 at the families' shapes against its plain version (phase 6's
    checks), timed beside its plain version, its bound and SDPA's fastest
    backend."""
    out = {}
    for label, (b, sq, sk, h, kvh, d), causal, (bq, bk) in shapes:
        q, k, v = flash_operands(b, sq, sk, h, kvh, d, torch.bfloat16, dev,
                                 seed=sq + sk + h)
        r = flash_readings(q, k, v, causal, bq, bk)
        failed = flash_failures(r, "bf16")
        r["ms"] = cuda_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, block_q=bq, block_k=bk), 10)
        r["plain_ms"] = cuda_ms(lambda: fa._flash_plain(
            q, k, v, causal=causal, block_q=bq, block_k=bk), 2, warmup=1)
        r["bound_ms"], r["bound_by"] = attn_bound_ms(
            b, sq, sk, h, kvh, d, torch.bfloat16, causal)
        timed = {n: t for n, t in sdpa_backends(q, k, v, causal=causal).items()
                 if t[0] is not None}
        check(bool(timed), f"flash {label}: no SDPA backend takes it")
        lname = min(timed, key=lambda n: timed[n][0])
        r["library_ms"], r["library"] = timed[lname][0], (
            f"sdpa {lname} ({timed[lname][1]})")
        r.update(shape=dict(zip("b sq sk h kv d".split(), (b, sq, sk, h, kvh,
                                                            d))),
                 causal=causal)
        print(f"flash {label:<22} bf16 B={b} Sq={sq} Sk={sk} H={h} KV={kvh} "
              f"D={d} causal={causal}: max normalised err "
              f"{r['norm_err']:.3e}  element-wise {r['elem']:.3f} of the "
              f"limit  {100 * r['tile_share']:.4f}% differ at the kernel's "
              f"tile (tol {100 * TILE_SHARE_TOL:g}%)  kernel {r['ms']:.4f} ms"
              f"  plain {r['plain_ms']:.4f} ms  {r['library']} "
              f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  bound/kernel "
              f"{r['bound_ms'] / r['ms']:.3f}", flush=True)
        check(not failed, f"flash {label}: {'; '.join(failed)}")
        out[label] = r
        del q, k, v
    return out


def route_flips(card, cpu, n_experts, cap):
    """``card`` and ``cpu``: per MoE layer (probs, top_i, slots) at B = 1.
    Returns the positions held apart (routed otherwise, or with other kept
    experts, at some layer), the largest k-th/(k+1)-th gap (the CPU's
    probabilities) of a token routed otherwise at the first MoE layer, the
    count routed otherwise at later layers while not yet held, and the
    count of kept-expert changes that no earlier change of the same
    expert's entries explains."""
    held, worst, later, unexplained = None, 0.0, 0, 0
    for layer, ((_, ic, sc), (pp, ip, sp)) in enumerate(zip(card, cpu)):
        ic, sc, ip, sp, pp = ic[0].cpu(), sc[0].cpu(), ip[0], sp[0], pp[0]
        if held is None:
            held = torch.zeros(ip.shape[0], dtype=torch.bool)
        routed = torch.zeros(ip.shape[0], n_experts, dtype=torch.bool)
        rc, rp = routed.scatter(1, ic, True), routed.scatter(1, ip, True)
        kc = routed.scatter(1, ic, sc < n_experts * cap)
        kp = routed.scatter(1, ip, sp < n_experts * cap)
        moved = (rc != rp).any(-1)
        new = moved & ~held
        if layer == 0 and new.any():
            k = ip.shape[-1]
            ranked = pp.sort(-1, descending=True).values
            gap = (ranked[:, k - 1] - ranked[:, k]) / ranked[:, k - 1]
            worst = float(gap[new].max())
        elif layer:
            later += int(new.sum())
        # a kept set changes only after an earlier entry of that expert did
        pos = torch.arange(ip.shape[0])[:, None].expand(-1, n_experts)
        first = torch.where(rc != rp, pos, ip.shape[0]).min(0).values
        shifted = (kc != kp) & ~moved[:, None]
        unexplained += int((shifted & (pos <= first[None])).sum())
        held |= moved | shifted.any(-1)
    return held, worst, later, unexplained


def card_and_cpu(cfg, card, cpu, batch, dev):
    """The forward of ``batch`` on the card and on the CPU; per side the
    logits (on the host), the seconds, and each MoE layer's (probs, top_i,
    slots)."""
    out = {}
    for side, params, dev_ in (("card", card, dev), ("cpu", cpu, "cpu")):
        routes, slots = [], []
        t0 = time.perf_counter()
        with spying(lm_layers, "route", lambda a, r: routes.append(r)), \
                spying(lm_layers, "capacity_slots",
                       lambda a, r: slots.append(r)):
            logits, _ = lm_model.forward(cfg, params, on(dev_, batch))
        out[side] = (logits[0].float().cpu(), time.perf_counter() - t0,
                     [(p, i, sl) for (p, _, i), sl in zip(routes, slots)])
    return out


def family_card_vs_cpu(dev, run):
    """The same depth-2 weights and inputs through the forward on the card
    and on the CPU in bf16; for MoE each layer's routing and kept slots in
    bf16, and the logits in fp32."""
    cut = dict(n_layers=FAMILY_CPU_DEPTH)
    if run.get("frames"):
        cut["encoder_layers"] = FAMILY_CPU_DEPTH
    cfg = family_cfg(run, **cut)
    moe = cfg.family == "moe"
    card = lm_params.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                                 device=dev)
    cpu = tree_util.map(lambda x: x.cpu(), card)
    if run.get("patches"):
        batch = family_batch(cfg, 1, FAMILY_CPU_LEN // 2,
                             patches=FAMILY_CPU_LEN // 2)
    else:
        batch = family_batch(cfg, 1, FAMILY_CPU_LEN,
                             frames=FAMILY_CPU_LEN if run.get("frames") else 0)
    out = card_and_cpu(cfg, card, cpu, batch, dev)
    a, b = out["card"][0], out["cpu"][0]
    check(bool(torch.isfinite(a).all()), f"{cfg.name} depth 2: bad logits")
    r = {"cpu_s": out["cpu"][1], "err": float((a - b).abs().max())
         / float(b.abs().max())}
    line = (f"  card vs CPU, depth {FAMILY_CPU_DEPTH}, B=1, {FAMILY_CPU_LEN} "
            f"positions, bf16: forward logits max normalised err "
            f"{r['err']:.3e}")
    if not moe:
        print(f"{line} (tol {FAMILY_CPU_TOL:g}); CPU forward "
              f"{r['cpu_s']:.3f} s", flush=True)
        check(r["err"] <= FAMILY_CPU_TOL,
              f"{cfg.name}: card vs CPU {r['err']:.3e}")
        return r
    cap = lm_layers.capacity(cfg, FAMILY_CPU_LEN)
    held, r["worst_gap"], r["later"], r["unexplained"] = route_flips(
        out["card"][2], out["cpu"][2], cfg.n_experts, cap)
    r["held"] = int(held.sum())
    r["err_kept"] = float((a - b)[~held].abs().max()) / float(b.abs().max())
    print(f"{line}, {r['err_kept']:.3e} at the {int((~held).sum())} positions "
          f"not moved (not checked: MoE at bf16 is compared by its routing); "
          f"{r['held']} positions moved (routed otherwise or other kept "
          f"experts at some layer); the first MoE layer's largest "
          f"k-th/(k+1)-th gap of a token routed otherwise "
          f"{r['worst_gap']:.3e} (bf16 noise {ROUTE_NOISE:.3e}); "
          f"{r['later']} routed otherwise first at a later layer; "
          f"{r['unexplained']} kept-expert changes without an earlier change "
          f"of that expert's entries; CPU forward {r['cpu_s']:.3f} s",
          flush=True)
    check(r["worst_gap"] <= ROUTE_NOISE,
          f"{cfg.name}: a token routed otherwise on the card than on the "
          f"CPU with a probability gap of {r['worst_gap']:.3e}")
    check(r["unexplained"] == 0, f"{cfg.name}: {r['unexplained']} "
          f"kept-expert changes without a routing change before them")

    # fp32: the same weights and inputs, the same routing and slots
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    del out
    card = tree_util.map(lambda x: x.float(), card)
    cpu = tree_util.map(lambda x: x.float(), cpu)
    out = card_and_cpu(cfg32, card, cpu, batch, dev)
    a, b = out["card"][0], out["cpu"][0]
    held, _, _, _ = route_flips(out["card"][2], out["cpu"][2],
                                cfg.n_experts, cap)
    r["err_fp32"] = float((a - b).abs().max()) / float(b.abs().max())
    r["held_fp32"] = int(held.sum())
    dropped = sum(int((sl == cfg.n_experts * cap).sum())
                  for _, _, sl in out["cpu"][2])
    print(f"  card vs CPU, fp32: forward logits max normalised err "
          f"{r['err_fp32']:.3e} (tol {FAMILY_CPU_TOL_FP32:g}); "
          f"{r['held_fp32']} positions routed otherwise or with other kept "
          f"experts (must be 0); {dropped} token slots dropped on both "
          f"sides; CPU forward {out['cpu'][1]:.3f} s", flush=True)
    check(r["held_fp32"] == 0, f"{cfg.name}: fp32 routing differs")
    check(r["err_fp32"] <= FAMILY_CPU_TOL_FP32,
          f"{cfg.name}: fp32 card vs CPU {r['err_fp32']:.3e}")
    return r


def family_limits(cfg, run):
    """The end-to-end limits of a config's serve path: prefill FLOPs (2 per
    active parameter per position, the routed experts' top-k, and each
    attention's q K^T and P V over its live pairs) over the bf16 peak, and
    the bytes of one decode step (every weight read once: the dense
    combine reads every expert) over HBM bandwidth."""
    b, s = run["batch"], run["prompt"] + run.get("patches", 0)
    hd = cfg.head_dim + cfg.rope_head_dim if cfg.uses_mla else cfg.head_dim
    per_pair = 4 * b * cfg.n_heads * hd
    if cfg.family == "audio":
        f = run["frames"]
        enc = sum(math.prod(p.shape) for p in
                  lm_params.param_defs(cfg)["enc_blocks"].values())
        flops = (2 * enc * b * f + 2 * (lm_params.count_active(cfg) - enc)
                 * b * s + per_pair * (f * f + s * (s + 1) // 2 + s * f)
                 * cfg.n_layers)
    else:
        flops = (2 * lm_params.count_active(cfg) * b * s
                 + per_pair * s * (s + 1) // 2 * cfg.n_layers)
    nbytes = 2 * lm_params.count_params(cfg)
    return flops, 1e3 * flops / PEAK_BF16_FLOPS, nbytes, (
        1e3 * nbytes / PEAK_HBM_BYTES)


def family_run(dev, all_kernels, run):
    """One config through ``Engine.generate`` at full width, its K3 launches
    per prefill and decode step, a profiled prefill and decode step; for
    MoE two prefills bit for bit and the share of dropped slots; for MLA
    the flash route refused."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = family_cfg(run)
    full = lm_config.get(run["arch"])
    params = lm_params.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                   device=dev)
    n_params = lm_params.count_params(cfg)
    b, gen = run["batch"], run["gen"]
    max_len = run["prompt"] + run.get("patches", 0) + gen
    engine = Engine(cfg, params, ServeConfig(max_len=max_len))
    del params
    prompts = family_batch(cfg, b, run["prompt"], run.get("patches", 0),
                           run.get("frames", 0))
    cut = ", ".join(f"{k} {v} of {getattr(full, k)}"
                    for k, v in run["cut"].items()) or "no cut"
    front = "".join(f", {run[k]} {k}" for k in ("patches", "frames")
                    if run.get(k))
    print(f"{cfg.name} ({cfg.family}): {n_params} parameters ({cut}; "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}), bf16 weights and "
          f"activations, attn_impl {cfg.attn_impl}; B={b}, prompts of "
          f"{run['prompt']} tokens{front}, {gen} generated", flush=True)
    flops, flops_ms, nbytes, bytes_ms = family_limits(cfg, run)
    print(f"  limits: prefill {flops:.4e} FLOPs, {flops_ms:.3f} ms at the "
          f"bf16 peak; decode step {nbytes / 1e9:.3f} GB of weights, "
          f"{bytes_ms:.3f} ms at HBM bandwidth", flush=True)

    totals = {}
    for n_tokens in (1, gen):
        for k in all_kernels.values():
            k.launches = 0
        out, stats = engine.generate(prompts, n_tokens)
        counts = {name: k.launches for name, k in all_kernels.items()}
        totals[n_tokens] = counts["flash_attention"]
    peak = torch.cuda.max_memory_allocated(dev)
    n_decode = (totals[gen] - totals[1]) / (gen - 1)
    n_prefill = totals[1] - n_decode
    want = (0, 0)
    if cfg.attn_impl == "flash":
        want = ((cfg.encoder_layers + 2 * cfg.n_layers, cfg.n_layers)
                if cfg.family == "audio" else (cfg.n_layers, 0))
    r = {"prefill_ms": 1e3 * stats["prefill_s"],
         "decode_ms": 1e3 * stats["decode_s"] / gen,
         "tok_per_s": stats["tok_per_s"], "peak_gib": peak / 2 ** 30,
         "launches": counts, "k3_prefill": n_prefill, "k3_decode": n_decode,
         "n_params": n_params, "prefill_bound_ms": flops_ms,
         "decode_bound_ms": bytes_ms}
    print(f"  Engine.generate: prefill {r['prefill_ms']:.3f} ms, decode "
          f"{r['decode_ms']:.3f} ms per token step ({r['tok_per_s']:.1f} "
          f"tok/s); K3 launches {n_prefill:g} per prefill (expected "
          f"{want[0]}), {n_decode:g} per decode step (expected {want[1]}); "
          f"launches {counts}; max_memory_allocated {r['peak_gib']:.3f} GiB",
          flush=True)
    check((n_prefill, n_decode) == want, f"{cfg.name}: K3 launched "
          f"{n_prefill:g} per prefill, {n_decode:g} per decode step")
    check(counts["acc_jerk_pot"] == 0 and counts["snap"] == 0,
          f"{cfg.name}: N-body kernels ran")
    check(tuple(out.shape) == (b, gen) and not out.is_floating_point()
          and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          f"{cfg.name}: tokens {tuple(out.shape)} {out.dtype}")
    print(f"  seq 0: {out[0, :16].tolist()} ...", flush=True)

    batch = on(dev, prompts)
    first = out[:, :1].to(dev)
    r["profile"] = serve_profile(cfg, engine.params, batch, max_len, first)

    if cfg.family == "moe":
        # two prefills of one batch: the same bits, the same slots
        runs, tally = [], []
        with spying(lm_layers, "capacity_slots", lambda a, slots: tally.append(
                (slots == a[1] * a[2]).sum())):
            for _ in range(2):
                logits, cache = lm_model.prefill(cfg, engine.params, batch,
                                                 max_len=max_len)
                runs.append((logits, cache))
        same = torch.equal(runs[0][0], runs[1][0]) and all(
            torch.equal(x, y) for x, y in zip(kv_leaves(runs[0][1]),
                                              kv_leaves(runs[1][1])))
        slots = b * run["prompt"] * cfg.top_k * (cfg.n_layers
                                                 - cfg.first_k_dense)
        dropped = [int(x) for x in tally]
        r["dropped_share"] = sum(dropped[:len(dropped) // 2]) / slots
        r["deterministic"] = same
        print(f"  MoE: two prefills bit for bit: {same} (logits and every "
              f"cache leaf); capacity {lm_layers.capacity(cfg, run['prompt'])}"
              f" slots per expert per sequence; token slots dropped over "
              f"capacity {sum(dropped[:len(dropped) // 2])} of {slots} "
              f"({100 * r['dropped_share']:.3f}%), per layer "
              f"{dropped[:len(dropped) // 2]}", flush=True)
        check(same, f"{cfg.name}: two prefills differ")
        check(dropped[:len(dropped) // 2] == dropped[len(dropped) // 2:],
              f"{cfg.name}: two prefills dropped other slots")
        del runs
    if cfg.uses_mla:
        before = fa.flash_attention.launches
        try:
            lm_model.prefill(dataclasses.replace(cfg, attn_impl="flash"),
                             engine.params, batch, max_len=max_len)
        except NotImplementedError as e:
            msg = str(e)
        else:
            msg = None
        print(f"  under attn_impl='flash': "
              f"{'NotImplementedError: ' + msg if msg else 'no error'}; K3 "
              f"launches {fa.flash_attention.launches - before}", flush=True)
        check(msg is not None and "attn_impl='xla'" in msg,
              f"{cfg.name}: the flash route did not refuse MLA")
        check(fa.flash_attention.launches == before,
              f"{cfg.name}: K3 launched on the refused route")
    del engine, batch
    torch.cuda.empty_cache()
    r["cpu"] = family_card_vs_cpu(dev, run)
    torch.cuda.empty_cache()
    return r


def families_phase(dev, all_kernels):
    """Phase 15: the moe, vlm and audio families served at full width, and
    K3 at their shapes.  Returns the readings the JSON line and PERF.md
    report."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"flash": family_flash_holds(dev), "runs": {}}
    for run in FAMILY_RUNS:
        out["runs"][run["arch"]] = family_run(dev, all_kernels, run)
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 16: serving the ssm and hybrid families at full width
# --------------------------------------------------------------------------
#: each config whole, as registered (fp32 masters, bf16 activations; the
#: engine casts each leaf once to the dtype its every use casts it to),
#: seeded random weights, greedy; (a) xlstm-1.3b (no attention), (b)
#: zamba2-7b under the flash route, (c) zamba2-7b's long prompt under the
#: registered xla route, which runs _attn_streamed at S >= 8192
#: at their published widths, cut for time to a sixth of their depth
#: (from a third when phase 23 came, which serves both over the mesh):
#: xlstm-1.3b 8 of 48 layers (one group of 7 mLSTM + 1 sLSTM), zamba2-7b
#: 13 of 81 (two shared attention blocks, a tail layer); both zamba2 runs
#: share weights
SSM_RUNS = (
    dict(label="xlstm-1.3b", arch="xlstm-1.3b", attn="xla", batch=4,
         prompt=2048, gen=32, cut=dict(n_layers=8)),
    dict(label="zamba2-7b", arch="zamba2-7b", attn="flash", batch=4,
         prompt=2048, gen=32, cut=dict(n_layers=13)),
    dict(label="zamba2-7b long", arch="zamba2-7b", attn="xla", batch=1,
         prompt=8192, gen=16, cut=dict(n_layers=13)),
)
#: (d) K3 at zamba2's shapes (b, sq, sk, h, kv, d): the shared block's
#: prefill in (b) and in (c)'s flash comparison, D = 112
SSM_FLASH = (("zamba2 prefill", (4, 2048, 2048, 32, 32, 112)),
             ("zamba2 long prefill", (1, 8192, 8192, 32, 32, 112)))
#: bf16 K3's tile share was set on rows of at most 2048 keys; longer rows
#: are held to the element-wise limit only (ROADMAP queue 3 A4,
#: tests/test_torch_cuda.py TILE_SHARE_MAX_KEYS)
TILE_SHARE_MAX_KEYS = 2048
#: (e) card against CPU: full width, B = 1, SSM_CPU_LEN positions, the same
#: weights on both sides; xlstm cut to one group (7 mLSTM + 1 sLSTM), zamba2
#: to one group of 6 Mamba2 layers, the shared block and a tail of 1 (a
#: tail of 3 before phase 23 came, for time)
SSM_CPU_CUT = {"xlstm-1.3b": dict(n_layers=8), "zamba2-7b": dict(n_layers=7)}
SSM_CPU_LEN = 512
#: bf16 card against CPU, max |card - cpu| / max |cpu|: the first block's
#: output (the same embedding bits enter it on both sides) within bf16's
#: tier for card against CPU (FAMILY_CPU_TOL).  The logits are read, not
#: held: through 8 or 9 layers of random weights bf16 rounding alone moves
#: them by tens of percent (xlstm-1.3b cut to 8 layers: 0.36 between the
#: CPU's own bf16 and fp32 logits, on an H100 machine's host), so two bf16
#: runs that round in other places lie that far apart; the phase prints
#: that own effect beside them
#: fp32 card against CPU: the scans' decays are exp of differences of
#: cumulative log sums over a chunk of 256 (mLSTM: F_t - F_s of the log
#: forget gates, |F| up to a few hundred; SSD: G_t - G_s), which the card
#: and the CPU add in other orders.  One such 256-term fp32 sum is off by
#: up to 256 half-ulps of |F| (about 2e-3 at |F| ~ 256), typically sqrt(256)
#: of them (2e-4), and exp turns that absolute error into a relative error
#: of every weight; the CPU tests saw 2.8e-5 at a chunk of 64
#: (tests/test_torch_ssm.py MLSTM_TOL)
SSM_CPU_TOL_FP32 = 1e-3
#: prefill(S) and one decode step against prefill(S + 1), fp32 on the card:
#: S + 1 = 256 is one chunk (chunk = min(chunk_size 256, S) must divide
#: S), so both forms run.  The parallel form's decays carry its
#: cumulative sums' rounding over the chunk (SSM_CPU_TOL_FP32's reason),
#: the step form takes one decay a step
SSM_STEP_LEN = 255
SSM_STEP_TOL = SSM_CPU_TOL_FP32
#: zamba2's flash route against its xla route (``_attn_full`` at 2048,
#: ``_attn_streamed`` at 8192) on the same weights, held in fp32, max |a -
#: b| / max |b| over the prefill logits: fp32 K3 (3xTF32) is held to 2e-5
#: of its plain version (FLASH_TOL), the xla routes sum in other orders,
#: and a perturbation may grow tenfold through 81 layers, so 2e-4, with
#: room.  In bf16 the routes are other functions (the xla routes round the
#: scores to bf16 before the softmax; over 13 applications and 81 layers
#: the logits moved 9.3e-2 on an H100), so bf16 is read, not held
SSM_ROUTE_TOL = 5e-4


def ssm_flash_holds(dev):
    """(d): K3 at D = 112 against its plain version, bf16 and fp32, timed
    beside its plain version, its bound and SDPA's fastest backend."""
    out = {}
    for label, (b, sq, sk, h, kvh, d) in SSM_FLASH:
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            q, k, v = flash_operands(b, sq, sk, h, kvh, d, dtype, dev,
                                     seed=sq + h + d)
            r = flash_readings(q, k, v, True, 512, 512)
            failed = flash_failures(r, tag)
            if tag == "bf16" and sk > TILE_SHARE_MAX_KEYS:
                failed = [f for f in failed if "kernel's key tile" not in f]
            r["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                              10)
            r["plain_ms"] = cuda_ms(lambda: fa._flash_plain(
                q, k, v, causal=True, block_q=512, block_k=512), 1, warmup=1)
            r["bound_ms"], r["bound_by"] = flash_bound_ms(b, sq, h, kvh, d,
                                                          dtype)
            timed = {n: t for n, t in sdpa_backends(q, k, v).items()
                     if t[0] is not None}
            check(bool(timed), f"flash {label} {tag}: no SDPA backend")
            lname = min(timed, key=lambda n: timed[n][0])
            r["library_ms"], r["library"] = timed[lname][0], (
                f"sdpa {lname} ({timed[lname][1]})")
            r.update(shape=dict(zip("b sq sk h kv d".split(),
                                    (b, sq, sk, h, kvh, d))), causal=True)
            more = ""
            if tag == "bf16":
                share = ("held" if sk <= TILE_SHARE_MAX_KEYS else
                         "not held past 2048 keys, A4")
                more = (f"  element-wise {r['elem']:.3f} of the limit  "
                        f"{100 * r['tile_share']:.4f}% differ at the "
                        f"kernel's tile ({share}; tol "
                        f"{100 * TILE_SHARE_TOL:g}%)")
            print(f"flash {label:<20} {tag} B={b} S={sq} H={h} KV={kvh} D={d}"
                  f" causal: max normalised err {r['norm_err']:.3e}{more}  "
                  f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
                  f"{r['library']} {r['library_ms']:.4f} ms  bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})  bound/kernel "
                  f"{r['bound_ms'] / r['ms']:.3f}", flush=True)
            check(not failed, f"flash {label} {tag}: {'; '.join(failed)}")
            out[f"{label} {tag}"] = r
            del q, k, v
    return out


def ssm_limits(cfg, params, b, s, gen):
    """The end-to-end limits of a config's serve path.  Prefill: 2 FLOPs
    per parameter per position (the unembedding at the last position
    only), bf16 leaves at the bf16 peak and the fp32 leaves (mLSTM q/k/v
    maps, the sLSTM's R) at the fp32 peak, plus the fp32 scans' chunk
    products (mLSTM: q K^T, P V, q C and the C update; SSD: C B^T, the
    decayed intra product, the state's read and update, every (t, s) pair
    of a chunk as both compute it) at the fp32 peak and each attention's
    live pairs at the bf16 peak, the two parts' times added.  Decode step:
    every weight at its served width (an untied embedding: its B rows),
    the recurrent state read and written, and the KV cache's live
    positions at the step halfway read, over HBM bandwidth."""
    flops16 = flops32 = 0
    nbytes = 0
    for key, sub in params.items():
        leaves = sub.items() if isinstance(sub, dict) else ((key, sub),)
        for name, x in leaves:
            n, size = x.numel(), x.element_size()
            if key == "embed" and not cfg.tie_embeddings:
                nbytes += b * cfg.d_model * size  # a gather of B rows
                continue
            nbytes += n * size
            if key in ("embed", "lm_head"):
                flops16 += 2 * n * b              # the last position's logits
            elif name in lm_params.FP32_LEAVES:
                flops32 += 2 * n * b * s
            else:
                flops16 += 2 * n * b * s
    chunk = min(cfg.chunk_size, s)
    if cfg.family == "ssm":
        n_g, m_per = lm_model._xlstm_groups(cfg)
        h, dk = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
        flops32 += n_g * m_per * b * h * s * (4 * chunk * dk + 4 * dk * dk)
    else:
        nh, p, n = (cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim,
                    cfg.ssm_state)
        flops32 += cfg.n_layers * b * s * (2 * chunk * n + 2 * chunk * nh * p
                                           + 4 * n * nh * p)
        flops16 += (cfg.n_layers // cfg.attn_every) * 4 * b * cfg.n_heads \
            * cfg.head_dim * s * (s + 1) // 2
    cache = lm_model.cache_layout(cfg, b, s + gen)
    for key, entry in cache.items():
        if key in ("len", "offset"):
            continue
        if isinstance(entry, dict):     # the KV cache: live positions read
            for shape, dt, _ in entry.values():
                nbytes += (math.prod(shape) * dt.itemsize
                           * (s + gen // 2) // (s + gen))
        else:                           # a recurrent state: read, written
            shape, dt, _ = entry
            nbytes += 2 * math.prod(shape) * dt.itemsize
    t16, t32 = flops16 / PEAK_BF16_FLOPS, flops32 / PEAK_FP32_FLOPS
    return {"flops_bf16": flops16, "flops_fp32": flops32,
            "prefill_bound_ms": 1e3 * (t16 + t32), "decode_bytes": nbytes,
            "decode_bound_ms": 1e3 * nbytes / PEAK_HBM_BYTES}


def ssm_routes(dev, cfg, params, batch, max_len, label):
    """The route of ``cfg`` against the other (flash against ``_attn_full``
    or ``_attn_streamed``) on the same weights and prompts: both prefills
    timed as served (bf16, the whole batch) and the gap of their logits
    read; then held in fp32 at B = 1 on the weights before the serving
    cast (drawn again from the seed).  Returns the readings."""
    other = "xla" if cfg.attn_impl == "flash" else "flash"
    r = {}
    for dtype, p, bt in (("bfloat16", params, batch),
                         ("float32", None, {"tokens": batch["tokens"][:1]})):
        if p is None:
            p = lm_params.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        out = {}
        for impl in (cfg.attn_impl, other):
            c = dataclasses.replace(cfg, attn_impl=impl, dtype=dtype)
            before = fa.flash_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm_model.prefill(c, p, bt, max_len=max_len)
            torch.cuda.synchronize()
            out[impl] = (logits.float(), time.perf_counter() - t0,
                         fa.flash_attention.launches - before)
            del cache
        del p
        a, b = out[cfg.attn_impl][0], out[other][0]
        check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
              f"{label}: non-finite prefill logits")
        err = float((a - b).abs().max()) / float(b.abs().max())
        r[dtype] = {"err": err, "s": {k: v[1] for k, v in out.items()},
                    "k3": {k: v[2] for k, v in out.items()}}
        held = (f"tol {SSM_ROUTE_TOL:g}" if dtype == "float32" else
                "not held: the xla routes round the scores to bf16, the "
                "flash route does not")
        print(f"  prefill logits, {dtype}, B={a.shape[0]}: attn_impl "
              f"{cfg.attn_impl} against {other} on the same weights: max "
              f"normalised err {err:.3e} ({held}), same argmax in "
              f"{100 * float((a.argmax(-1) == b.argmax(-1)).float().mean()):.0f}"
              f"% of rows; prefill {cfg.attn_impl} "
              f"{1e3 * out[cfg.attn_impl][1]:.3f} ms, {other} "
              f"{1e3 * out[other][1]:.3f} ms; K3 launches "
              f"{out[cfg.attn_impl][2]} and {out[other][2]}", flush=True)
        check(sorted((out[cfg.attn_impl][2], out[other][2])) == [
            0, cfg.n_layers // cfg.attn_every], f"{label}: K3 launches "
            f"{out[cfg.attn_impl][2]}, {out[other][2]} in the two prefills")
        torch.cuda.empty_cache()
    check(r["float32"]["err"] <= SSM_ROUTE_TOL, f"{label}: {cfg.attn_impl} "
          f"vs {other} route in fp32 {r['float32']['err']:.3e} > "
          f"{SSM_ROUTE_TOL}")
    return r


def ssm_run(dev, all_kernels, run, engine=None):
    """One config through ``Engine.generate`` at full width: K3's launches
    per prefill and decode step (zeroed before, read after), prefill and
    decode ms beside the limits, a profiled decode step (and prefill where
    it has few launches), the cache finite, and for zamba2 its two routes
    against each other (``ssm_routes``).  Returns the readings and the
    engine (whose weights (c) reuses)."""
    cfg = dataclasses.replace(lm_config.get(run["arch"]), attn_impl=run["attn"],
                              **run["cut"])
    b, prompt, gen = run["batch"], run["prompt"], run["gen"]
    max_len = prompt + gen
    if engine is None:
        torch.cuda.empty_cache()
        params = lm_params.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        engine = Engine(cfg, params, ServeConfig(max_len=max_len))
        del params
    else:
        engine = Engine(cfg, engine.params, ServeConfig(max_len=max_len))
    torch.cuda.reset_peak_memory_stats(dev)
    n_params = lm_params.count_params(cfg)
    fp32 = {n: x.numel() for sub in engine.params.values()
            if isinstance(sub, dict) for n, x in sub.items()
            if n in lm_params.FP32_LEAVES}
    prompts = family_batch(cfg, b, prompt)
    print(f"{run['label']} ({cfg.family}): {n_params} parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}; served bf16, {sum(fp32.values())} parameters "
          f"kept fp32 ({', '.join(sorted(fp32))}); attn_impl "
          f"{cfg.attn_impl}, chunk {min(cfg.chunk_size, prompt)}; B={b}, "
          f"prompts of {prompt} tokens, {gen} generated, greedy", flush=True)
    lim = ssm_limits(cfg, engine.params, b, prompt, gen)
    print(f"  limits: prefill {lim['flops_bf16']:.4e} FLOPs at the bf16 peak "
          f"+ {lim['flops_fp32']:.4e} at the fp32 peak, "
          f"{lim['prefill_bound_ms']:.3f} ms; decode step "
          f"{lim['decode_bytes'] / 1e9:.3f} GB (weights, state read and "
          f"written, live KV), {lim['decode_bound_ms']:.3f} ms at HBM "
          f"bandwidth", flush=True)

    totals = {}
    for n_tokens in (1, gen):
        for k in all_kernels.values():
            k.launches = 0
        out, stats = engine.generate(prompts, n_tokens)
        counts = {name: k.launches for name, k in all_kernels.items()}
        totals[n_tokens] = counts["flash_attention"]
    peak = torch.cuda.max_memory_allocated(dev)
    n_decode = (totals[gen] - totals[1]) / (gen - 1)
    n_prefill = totals[1] - n_decode
    want = ((cfg.n_layers // cfg.attn_every, 0)
            if cfg.family == "hybrid" and cfg.attn_impl == "flash" else (0, 0))
    r = {"prefill_ms": 1e3 * stats["prefill_s"],
         "decode_ms": 1e3 * stats["decode_s"] / gen,
         "tok_per_s": stats["tok_per_s"], "peak_gib": peak / 2 ** 30,
         "launches": counts, "k3_prefill": n_prefill, "k3_decode": n_decode,
         "n_params": n_params, **lim}
    print(f"  Engine.generate: prefill {r['prefill_ms']:.3f} ms (bound/"
          f"measured {lim['prefill_bound_ms'] / r['prefill_ms']:.3f}), decode "
          f"{r['decode_ms']:.3f} ms per token step (bound/measured "
          f"{lim['decode_bound_ms'] / r['decode_ms']:.3f}; "
          f"{r['tok_per_s']:.1f} tok/s); K3 launches {n_prefill:g} per "
          f"prefill (expected {want[0]}), {n_decode:g} per decode step "
          f"(expected {want[1]}); launches {counts}; max_memory_allocated "
          f"{r['peak_gib']:.3f} GiB", flush=True)
    check((n_prefill, n_decode) == want, f"{run['label']}: K3 launched "
          f"{n_prefill:g} per prefill, {n_decode:g} per decode step")
    check(counts["acc_jerk_pot"] == 0 and counts["snap"] == 0,
          f"{run['label']}: N-body kernels ran")
    check(tuple(out.shape) == (b, gen) and not out.is_floating_point()
          and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          f"{run['label']}: tokens {tuple(out.shape)} {out.dtype}")
    print(f"  seq 0: {out[0, :16].tolist()} ...", flush=True)

    batch = on(dev, prompts)
    first = out[:, :1].to(dev)
    # the cache after a prefill: every leaf finite
    logits, cache = lm_model.prefill(cfg, engine.params, batch,
                                     max_len=max_len)
    leaves = [v for v in cache.values() if isinstance(v, torch.Tensor)]
    leaves += kv_leaves(cache)
    check(bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for t in leaves),
        f"{run['label']}: non-finite prefill logits or cache")
    if run["prompt"] <= 2048:
        # a profiled decode step on that cache; a hybrid prefill profiled
        # too (xlstm's sLSTM prefill makes hundreds of thousands of
        # launches, more than the profiler takes in good time)
        r["profile"] = serve_profile(
            cfg, engine.params, batch, max_len, first,
            cache=None if cfg.family == "hybrid" else cache)
    del cache, logits
    if cfg.family == "hybrid":
        r["routes"] = ssm_routes(dev, cfg, engine.params, batch, max_len,
                                 run["label"])
    del batch
    torch.cuda.empty_cache()
    return r, engine


def ssm_card_vs_cpu(dev, arch):
    """(e): the same weights at full width, cut in depth, through the
    forward on the card and on the CPU, in fp32 and served in bf16: the
    first block's output and the logits; then on the card in fp32,
    prefill(S) and one decode step against prefill(S + 1)'s last logits."""
    cfg = dataclasses.replace(lm_config.get(arch), **SSM_CPU_CUT[arch])
    first = "mlstm_block" if cfg.family == "ssm" else "mamba_block"
    card = lm_params.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                                 device=dev)
    cpu = tree_util.map(lambda x: x.cpu(), card)
    toks = family_batch(cfg, 1, SSM_CPU_LEN + 1)["tokens"]
    batch = {"tokens": toks[:, :SSM_CPU_LEN]}
    r, out = {}, {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        for side, params, dev_ in (("card", card, dev), ("cpu", cpu, "cpu")):
            blocks = []
            t0 = time.perf_counter()
            with spying(lm_model, first, lambda a, res: blocks.append(
                    res[0][0].float().cpu()) if not blocks else None):
                logits, _ = lm_model.forward(
                    c, lm_params.cast_params(params, dtype), on(dev_, batch))
            out[side, dtype] = (logits[0].float().cpu(), blocks[0],
                                time.perf_counter() - t0)
        check(bool(torch.isfinite(out["card", dtype][0]).all()),
              f"{arch} {dtype}: bad logits")
        errs = [float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(out["card", dtype][:2], out["cpu", dtype][:2])]
        r[dtype] = dict(zip(("logits", "first_block"), errs))
    own = out["cpu", "bfloat16"][0], out["cpu", "float32"][0]
    r["bf16_own"] = float((own[0] - own[1]).abs().max()) / float(
        own[1].abs().max())
    for dtype, tol, held in (
            ("float32", SSM_CPU_TOL_FP32, "held"),
            ("bfloat16", FAMILY_CPU_TOL, "the first block held, the logits "
             "read: bf16 rounding alone moves them")):
        print(f"  card vs CPU, {cfg.n_layers} layers, B=1, {SSM_CPU_LEN} "
              f"positions, {dtype}: the first {first}'s output max "
              f"normalised err {r[dtype]['first_block']:.3e}, the forward "
              f"logits' {r[dtype]['logits']:.3e} (tol {tol:g}; {held}); CPU "
              f"forward {out['cpu', dtype][2]:.3f} s", flush=True)
    print(f"  bf16 rounding's own effect: the CPU's bf16 logits against its "
          f"fp32 logits, max normalised err {r['bf16_own']:.3e}", flush=True)
    check(max(r["float32"].values()) <= SSM_CPU_TOL_FP32,
          f"{arch} float32: card vs CPU {r['float32']}")
    check(r["bfloat16"]["first_block"] <= FAMILY_CPU_TOL,
          f"{arch} bfloat16: card vs CPU, first block "
          f"{r['bfloat16']['first_block']:.3e}")
    del out
    # prefill(S) + one decode step against prefill(S + 1), fp32, on the card
    s = SSM_STEP_LEN
    t = torch.as_tensor(toks, device=dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _, cache = lm_model.prefill(cfg32, card, {"tokens": t[:, :s]},
                                max_len=s + 1)
    step, _ = lm_model.decode_step(cfg32, card, cache, t[:, s:s + 1])
    whole, _ = lm_model.prefill(cfg32, card, {"tokens": t[:, :s + 1]})
    err = float((step - whole).abs().max()) / float(whole.abs().max())
    r["step_vs_prefill"] = err
    print(f"  prefill({s}) + one decode step against prefill({s + 1}), fp32 "
          f"on the card: last logits max normalised err {err:.3e} (tol "
          f"{SSM_STEP_TOL:g})", flush=True)
    check(err <= SSM_STEP_TOL, f"{arch}: decode step vs prefill {err:.3e}")
    return r


def ssm_phase(dev, all_kernels):
    """Phase 16: the ssm and hybrid families served whole at full width,
    K3 at zamba2's head dim of 112, _attn_streamed at 8192 positions.
    Returns the readings the JSON line and PERF.md report."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"flash": ssm_flash_holds(dev), "runs": {}, "cpu": {}}
    print(f"  (d) took {time.perf_counter() - t0:.1f} s", flush=True)
    engine = None
    for run in SSM_RUNS:
        t1 = time.perf_counter()
        reuse = engine if run["arch"] == "zamba2-7b" else None
        out["runs"][run["label"]], engine = ssm_run(dev, all_kernels, run,
                                                    reuse)
        if run["arch"] == "xlstm-1.3b":
            engine = None
            torch.cuda.empty_cache()
        print(f"  {run['label']} took {time.perf_counter() - t1:.1f} s",
              flush=True)
    del engine
    torch.cuda.empty_cache()
    for arch in SSM_CPU_CUT:
        t1 = time.perf_counter()
        out["cpu"][arch] = ssm_card_vs_cpu(dev, arch)
        torch.cuda.empty_cache()
        print(f"  {arch} card vs CPU took {time.perf_counter() - t1:.1f} s",
              flush=True)
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


#: phase 17: the dry-run (``launch.dryrun``) against real steps of
#: qwen3-0.6b at full width (phase 14's train step at B = 4, S = 2048,
#: phase 7's prefill and one decode step) and one Plummer N = 16384 fp32
#: Hermite step at a fixed step of DRY_DT.  (a) the dry-run's dot_flops
#: (N-body: flops) against FlopCounterMode on the real step plus the
#: kernel formulas (``kernels.bounds``) times the launches counted;
#: (b) the dry-run's peak bytes against max_memory_allocated over the step
#: (the bytes live before its arguments were made taken off); (c) the
#: step's median ms against the dry-run's roofline, which the card must
#: not beat.
DRY_FLOP_TOL = 1e-3
DRY_PEAK_RANGE = (0.8, 1.25)
DRY_TIME_FLOOR = 0.95
DRY_REPS = 5
DRY_DT = 1.0 / 1024
#: the decode step's cache: phase 7's (prompt + generated tokens)
DRY_DECODE_LEN = LM_PROMPT + LM_GEN


def dry_card(fn, dev, all_kernels, m0):
    """One call of ``fn`` under FlopCounterMode (its product FLOPs and every
    kernel's launches), one for max_memory_allocated above ``m0`` (the
    bytes live before the step's arguments were made), then DRY_REPS timed
    calls; returns those readings."""
    gc.collect()
    torch.cuda.synchronize()
    for k in all_kernels.values():
        k.launches = 0
    with FlopCounterMode(display=False) as fc:
        fn()
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in all_kernels.items()}
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    times = []
    for _ in range(DRY_REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return {"flop_counter": float(fc.get_total_flops()), "launches": launches,
            "peak_bytes": peak - m0, "max_memory_allocated": peak, "m0": m0,
            "ms": float(np.median(times)), "times": times}


def dry_hold(label, rec, card, kernel_flops, key):
    """Checks (a), (b) and (c) of one step, each pair on its own line."""
    pd, rl = rec["per_device"], rec["roofline"]
    want = card["flop_counter"] + kernel_flops
    got = pd[key]
    rel = abs(got - want) / want
    print(f"dryrun {label}: (a) {key} dry-run {got:.6e} vs card {want:.6e} "
          f"(FlopCounterMode {card['flop_counter']:.6e} + kernel formulas x "
          f"launches {kernel_flops:.6e}, launches {card['launches']}, "
          f"dry-run's {pd['kernel_launches']}): rel diff {rel:.3e} (tol "
          f"{DRY_FLOP_TOL:g})", flush=True)
    ratio = pd["peak_bytes"] / card["peak_bytes"]
    print(f"dryrun {label}: (b) peak dry-run {pd['peak_bytes'] / 2 ** 30:.4f}"
          f" GiB (arguments {pd['argument_bytes'] / 2 ** 30:.4f}, step "
          f"{pd['temp_bytes'] / 2 ** 30:.4f}) vs card "
          f"{card['peak_bytes'] / 2 ** 30:.4f} GiB (max_memory_allocated "
          f"{card['max_memory_allocated'] / 2 ** 30:.4f} less "
          f"{card['m0'] / 2 ** 30:.4f} live before): dry-run/card "
          f"{ratio:.4f} (range {DRY_PEAK_RANGE})", flush=True)
    floor = 1e3 * rl["step_time_s"]
    print(f"dryrun {label}: (c) step median {card['ms']:.3f} ms over "
          f"{len(card['times'])} calls {[round(t, 3) for t in card['times']]} vs "
          f"roofline {floor:.3f} ms ({rl['bottleneck']}-bound; "
          f"{pd['flops']:.4e} FLOPs, {pd['bytes_accessed']:.4e} bytes, "
          f"trace {rec['timings']['trace_s']:.2f} s): card/roofline "
          f"{card['ms'] / floor:.3f} (floor {DRY_TIME_FLOOR})", flush=True)
    check(rel <= DRY_FLOP_TOL, f"dryrun {label}: (a) {key} {got:.6e} vs "
                               f"{want:.6e}, rel {rel:.3e}")
    check(DRY_PEAK_RANGE[0] <= ratio <= DRY_PEAK_RANGE[1],
          f"dryrun {label}: (b) peak ratio {ratio:.4f}")
    check(card["ms"] >= DRY_TIME_FLOOR * floor,
          f"dryrun {label}: (c) the card ({card['ms']:.3f} ms) beat the "
          f"roofline ({floor:.3f} ms)")
    return {"dry": got, "card": want, "rel": rel, "peak_dry": pd["peak_bytes"],
            "peak_card": card["peak_bytes"], "peak_ratio": ratio,
            "ms": card["ms"], "roofline_ms": floor,
            "bottleneck": rl["bottleneck"]}


def dryrun_phase(dev, all_kernels):
    """Phase 17: the dry-run held against real steps on the card (see
    DRY_FLOP_TOL).  Each step goes to ``lower_cell`` or ``run_nbody_cell``
    as a ``ShapeCase`` with ``MeshRules.single_device()`` rules."""
    single = MeshRules.single_device()
    cfg = lm_config.get(LM_ARCH)
    cfg_flash = dataclasses.replace(cfg, attn_impl="flash")
    out = {}

    def k3_flops(b, s, launches):
        return launches * attn_flops(b, s, s, cfg.n_heads, cfg.head_dim, True)

    # the train step (phase 14's shape), the xla route as phase 14 trains
    gc.collect()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated(dev)
    params = lm_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = AdamW(learning_rate=TRAIN_LR)
    opt_state = opt.init(params)
    batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
             for k, v in SyntheticLM(cfg, BatchSpec(TRAIN_BATCH, TRAIN_SEQ),
                                     seed=0)(0).items()}
    step = make_train_step(cfg, opt)
    step(params, opt_state, batch)      # warm-up
    card = dry_card(lambda: step(params, opt_state, batch), dev, all_kernels,
                    m0)
    rec, _ = lm_dryrun.lower_cell(
        cfg, lm_shapes.ShapeCase("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        rules=single, accum=1)
    out["train"] = dry_hold("train", rec, card, 0.0, "dot_flops")
    del params, opt_state, step, batch

    # the prefill and one decode step (phase 7's shapes, the flash route)
    gc.collect()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated(dev)
    params = lm_params.cast_params(lm_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        "bfloat16")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}

    def prefill():
        lm_model.prefill(cfg_flash, params, batch)

    prefill()                           # warm-up
    card = dry_card(prefill, dev, all_kernels, m0)
    rec, _ = lm_dryrun.lower_cell(
        cfg_flash, lm_shapes.ShapeCase("prefill", LM_PROMPT, LM_BATCH,
                                       "prefill"), rules=single)
    out["prefill"] = dry_hold(
        "prefill", rec, card,
        k3_flops(LM_BATCH, LM_PROMPT, card["launches"]["flash_attention"]),
        "dot_flops")
    check(card["launches"]["flash_attention"] == cfg.n_layers
          and rec["per_device"]["kernel_launches"].get("flash_attention")
          == cfg.n_layers, "dryrun prefill: K3 launches per prefill")

    logits, cache = lm_model.prefill(cfg_flash, params, batch,
                                     max_len=DRY_DECODE_LEN)
    tokens = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    del logits, batch
    gc.collect()

    def decode():
        lm_model.decode_step(cfg_flash, params, cache, tokens)

    decode()                            # warm-up
    card = dry_card(decode, dev, all_kernels, m0)
    rec, _ = lm_dryrun.lower_cell(
        cfg_flash, lm_shapes.ShapeCase("decode", DRY_DECODE_LEN, LM_BATCH,
                                       "decode"), rules=single)
    out["decode"] = dry_hold("decode", rec, card, 0.0, "dot_flops")
    del params, cache, tokens

    # one Plummer N = 16384 fp32 Hermite step at a fixed step
    gc.collect()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated(dev)
    evaluate = make_evaluator(order=6, dtype="fp32")
    state = hermite.initialize(nbody.plummer(N_MAIN, seed=0, device=dev),
                               evaluate)

    def nbody_step():
        hermite.step(state, DRY_DT, evaluate)

    nbody_step()                        # warm-up
    card = dry_card(nbody_step, dev, all_kernels, m0)
    rec = lm_dryrun.run_nbody_cell(
        "single", n_particles=N_MAIN, rules=single, dt=DRY_DT,
        state_dtype=state.pos.dtype, write=False, verbose=False)
    pairs = sum(FLOPS_PER_PAIR[(name, "fp32")] * card["launches"][name]
                for name in ("acc_jerk_pot", "snap")) * N_MAIN * N_MAIN
    out["nbody"] = dry_hold("nbody step", rec, card, pairs, "flops")
    del state
    return out


# --------------------------------------------------------------------------
# phase 18: training the moe, MLA, vlm, audio, ssm and hybrid families
# --------------------------------------------------------------------------
#: each config at its published width (fp32 masters, bf16 activations,
#: remat full, attn_impl xla: training keeps _attn_full's function), seeded
#: random weights, through the port's own pieces as ``launch/train.py``
#: builds them (``batch_spec_for``, ``SyntheticLM``, ``AdamW`` with
#: ``warmup_cosine``, ``Trainer`` over ``make_train_step``), on one
#: repeated batch of B x S as ``batch_spec_for`` gives it.  Depth is cut
#: where one card's 80 GB forces it (and, below, for time), each such cut
#: the deepest whose
#: dry-run peak (``lower_cell`` at single-device rules, accum 1, this
#: B x S; read on meta before the first run) is at most
#: FAMILY_TRAIN_PEAK_MAX: phi3.5-moe 1 of 32 layers (2 layers: 74.41e9
#: bytes); deepseek-v2 1 of 60, its dense first layer with MLA (depth 2
#: holds 5.36e9 parameters, 85.7e9 bytes with AdamW's state), so its first
#: MoE layer's loss and gradients run at depth 2 without the optimizer
#: (``grads``: 47.52e9 bytes); zamba2-7b would fit 30 of 81, a multiple of
#: attn_every (71.00e9 at 4 x 2048; 36 layers: 83.46e9).  The script's
#: time limit then cuts xlstm's S: xlstm-1.3b runs at S = 128, its
#: sLSTM's steps in turn, some 550 launches per position and step (at S =
#: 1024 18.9 s a step and 565678 launches, busy 11.7%; at 128 3.1 s; H100
#: runs).  Since phase 22 came, it cuts depth too: zamba2-7b to 18 layers
#: (three attn_every groups) and xlstm-1.3b to 24 of 48 (three groups of
#: slstm_every), which took 39.2 s and 42.1 s of phase 18 on an H100 at
#: 30 and 48 (the dry-run holds each step at the depth it runs).  Each
#: config's card-against-CPU check runs before its
#: steps, deepseek-v2's first: its CPU work covers the worker processes'
#: start and their traces of the others' steps
FAMILY_TRAIN_RUNS = (
    dict(arch="deepseek-v2-236b", cut=dict(n_layers=1), batch=1, seq=2048,
         grads=dict(n_layers=2)),
    dict(arch="phi3.5-moe-42b-a6.6b", cut=dict(n_layers=1), batch=4,
         seq=2048),
    dict(arch="qwen2-vl-2b", cut={}, batch=4, seq=2048),
    dict(arch="seamless-m4t-medium", cut={}, batch=4, seq=2048),
    dict(arch="zamba2-7b", cut=dict(n_layers=9), batch=4, seq=2048),
    dict(arch="xlstm-1.3b", cut=dict(n_layers=8), batch=4, seq=128),
)
FAMILY_TRAIN_PEAK_MAX = 72e9
#: (a) one warm-up step, then FAMILY_TRAIN_TIMED timed steps; the lr is
#: warmup_cosine(TRAIN_LR) with one warm-up step over the run
FAMILY_TRAIN_TIMED = 3
FAMILY_TRAIN_OPS = 6
#: (c) card against CPU: full width, fp32 activations, B = 1 and 256
#: positions (a vlm's 128 patches and 128 tokens), so that MoE routing is
#: the same on both; depth 2 (seamless: 2 encoder and 2 decoder layers),
#: xlstm and zamba2 phase 16's 8 and 9 (an sLSTM block, a shared attention
#: block); cut for time, the MoE configs to depth 1: phi3.5-moe's one MoE
#: layer, deepseek-v2's dense layer with MLA (its MoE layer's gradients
#: are held on the card, twice, at depth 2; phi3.5-moe holds MoE's
#: against the CPU).  The tolerance is tests/test_torch_train_families.py's and
#: test_torch_train_ssm.py's fp32 one: the loss within 1e-6 relative, each
#: gradient leaf within 1e-5 of its largest element (the CPU's)
FAMILY_GRAD_CUT = {
    "qwen2-vl-2b": dict(n_layers=2),
    "seamless-m4t-medium": dict(n_layers=2, encoder_layers=2),
    "phi3.5-moe-42b-a6.6b": dict(n_layers=1),
    "deepseek-v2-236b": dict(n_layers=1),
    "xlstm-1.3b": dict(n_layers=8),
    "zamba2-7b": dict(n_layers=9),
}
FAMILY_GRAD_BATCH, FAMILY_GRAD_SEQ = 1, 256
FAMILY_LOSS_TOL, FAMILY_GRAD_TOL = 1e-6, 1e-5
#: except the ssm and hybrid families' gradient leaves.  At full width
#: their fp32 gradients move with the order of the sums alone, so each
#: takes a limit between the largest such reading and a real loss of
#: precision, from ``ssm_grad_witness.py`` at these inputs (NVIDIA H100
#: 80GB HBM3, 700 W): card64 and cpu64 (every op in float64) agree to
#: 4.8e-13 on every leaf, so both sides compute one function.  xlstm-1.3b:
#: the card against the CPU 7.3e-4 (onorm), the CPU on one thread against
#: itself on eight 5.2e-4, each fp32 side against float64 up to 6.3e-4;
#: the error grows through the mLSTM stack (6.5e-6 after the first block,
#: 1.4e-4 after the sixth) and along the sLSTM's positions (its h 7.5e-5
#: over the first 32, 4.3e-4 over the last), which the sLSTM's w_down
#: reads.  bf16 activations move its leaves 0.18 to 0.79.  zamba2-7b: the
#: card against the CPU 4.0e-5 (a_log), one thread against eight 5.2e-5;
#: bf16 0.045 to 0.10.  So 1e-2 (14x the largest fp32 reading, 18x under
#: bf16's least) and 1e-3 (19x, 45x)
FAMILY_GRAD_TOL_SCAN = {"xlstm-1.3b": 1e-2, "zamba2-7b": 1e-3}
#: the training launcher itself on the card, once
LAUNCHER_ARGS = ["--arch", "seamless-m4t-medium", "--steps", "2", "--batch",
                 "2", "--seq", "512"]


def _family_dry_record(job):
    """Phase 18 (b)'s dry-run of one step on meta, run in a worker process
    beside the card's work (a trace takes seconds, xlstm's a minute):
    ``job`` is (cfg, B, S, grads_only); returns the record."""
    cfg, b, s, grads_only = job
    torch.set_num_threads(1)
    rec, _ = lm_dryrun.lower_cell(
        cfg, lm_shapes.ShapeCase("train", s, b, "train"),
        rules=MeshRules.single_device(), accum=1, grads_only=grads_only)
    return rec


def family_label(cfg):
    enc = f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else ""
    return f"{cfg.name} ({cfg.n_layers}{enc} layers)"


def leaf_names(tree, prefix=""):
    """A tree's leaf paths (``blocks/we_g``) in ``tree_util.leaves`` order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaf_names(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def grads_twice(cfg, params, batch):
    """(d): two ``_value_and_grad`` calls from the same parameters and
    batch, compared leaf by leaf on the card.  Returns (same loss, the
    leaves whose bits differ, the leaf count, the first loss and
    gradient leaves)."""
    l1, _, g1 = _value_and_grad(cfg, params, batch)
    g1 = list(tree_util.leaves(g1))
    l2, _, g2 = _value_and_grad(cfg, params, batch)
    names = list(leaf_names(params))
    diff = [names[i] for i, (a, b) in enumerate(zip(g1, tree_util.leaves(g2)))
            if not torch.equal(a, b)]
    same_loss = torch.equal(l1, l2)
    del g2
    return same_loss, diff, len(g1), l1, g1


def family_train_step(dev, all_kernels, run, record):
    """Phase 18 (a) and (b) of one config: the trainer's steps, one more
    under FlopCounterMode and one profiled, held against the dry-run's
    record (``record()`` waits for it); for MoE also (d) at this step's
    shape."""
    cfg = dataclasses.replace(lm_config.get(run["arch"]), **run["cut"])
    label = family_label(cfg)
    spec = batch_spec_for(cfg, run["batch"], run["seq"])
    t_start = time.perf_counter()
    batch0 = SyntheticLM(cfg, spec, seed=0)(0)
    steps = 1 + FAMILY_TRAIN_TIMED
    opt = AdamW(learning_rate=warmup_cosine(TRAIN_LR, warmup=1, total=steps))
    trainer = Trainer(cfg, opt, lambda step: batch0,
                      TrainerConfig(steps=steps, log_every=10 ** 9),
                      device=dev, log=lambda line: print(line, flush=True))
    gc.collect()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    (params, opt_state, hist), counts, _, wall = counted(trainer.run,
                                                         all_kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in hist]
    times = [1e3 * h["step_time"] for h in hist[1:]]
    ms = float(np.median(times))
    batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
             for k, v in batch0.items()}
    for k in all_kernels.values():
        k.launches = 0
    with FlopCounterMode(display=False) as fc:
        params, opt_state, _ = trainer._step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    t_flops = time.perf_counter()
    launches = {name: k.launches for name, k in all_kernels.items()}
    rec = record()
    pd = rec["per_device"]
    check(pd["peak_bytes"] <= FAMILY_TRAIN_PEAK_MAX,
          f"train {label}: the dry-run's peak {pd['peak_bytes']:.4e} bytes "
          f"is over the cut's {FAMILY_TRAIN_PEAK_MAX:.0e}")
    dot = pd["dot_flops"]
    tokens = spec.batch * spec.seq
    print(f"train {label}: {lm_params.count_params(cfg)} parameters, "
          f"B={spec.batch} S={spec.seq} (+{spec.patch_len} patches, "
          f"{spec.enc_len} frames), {steps} steps of one SyntheticLM batch in "
          f"{wall:.3f} s; losses {[round(x, 4) for x in losses]}; step ms "
          f"(steps 1-{steps - 1}) {[round(t, 3) for t in times]}, median "
          f"{ms:.3f}; {tokens / ms * 1e3:.1f} tokens/s; {dot / 1e12:.3f} "
          f"TFLOP of products per step (dry-run) -> {dot / ms / 1e9:.2f} "
          f"TFLOP/s; max_memory_allocated {peak / 2 ** 30:.3f} GiB; kernel "
          f"launches {counts}", flush=True)
    check(all(np.isfinite(losses)), f"train {label}: losses {losses}")
    check(losses[-1] < losses[0], f"train {label}: the repeated batch was "
                                  f"not learned: {losses}")
    check(not any(counts.values()) and not any(launches.values()),
          f"train {label}: a kernel ran on the gradient path: {counts} "
          f"{launches}")
    card = {"flop_counter": float(fc.get_total_flops()),
            "launches": launches, "peak_bytes": peak - m0,
            "max_memory_allocated": peak, "m0": m0, "ms": ms, "times": times}
    held = dry_hold(f"train {label}", rec, card, 0.0, "dot_flops")
    t_wait = time.perf_counter()
    params, opt_state, prof_r, pwall = profiled_step(
        f"train {label}", trainer._step_fn, params, opt_state, batch, dot,
        FAMILY_TRAIN_OPS)
    t_prof = time.perf_counter()
    print(f"train {label}: seconds: trainer {wall:.1f} (init and "
          f"{steps} steps), FlopCounterMode step "
          f"{t_flops - t_start - wall:.1f}, waiting for the dry-run "
          f"{t_wait - t_flops:.1f}, profiled step and its parsing "
          f"{t_prof - t_wait:.1f}", flush=True)
    out = {"cfg": label, "losses": losses, "times": times, "ms": ms,
           "tokens_per_s": tokens / ms * 1e3, "tflops": dot / ms / 1e9,
           "peak_gib": peak / 2 ** 30, "profile": prof_r,
           "profiled_wall_ms": pwall, "dry": held}
    del opt_state, trainer
    if cfg.n_experts and cfg.n_layers > cfg.first_k_dense:
        gc.collect()
        torch.cuda.empty_cache()
        out["twice"] = bits_twice_report(f"train {label} bf16", cfg, params,
                                         batch)
    del params, batch
    return out


def bits_twice_report(label, cfg, params, batch):
    same_loss, diff, n, _, _ = grads_twice(cfg, params, batch)
    print(f"{label}: two _value_and_grad calls give the same loss: "
          f"{same_loss}, the same bits in {n - len(diff)} of {n} gradient "
          f"leaves{'' if not diff else f' (differ: {diff})'}", flush=True)
    check(same_loss and not diff, f"{label}: two gradient calls differ")
    return {"same_loss": same_loss, "leaves": n, "differ": diff}


def family_grads_step(dev, all_kernels, run, record):
    """Phase 18 for a config whose full step does not fit at the depth
    that holds every block kind (deepseek-v2 at depth 2): the loss and
    gradients alone, timed and held against the dry-run's ``grads_only``
    record, and (d) at this shape."""
    cfg = dataclasses.replace(lm_config.get(run["arch"]), **run["grads"])
    label = family_label(cfg) + " loss and gradients"
    spec = batch_spec_for(cfg, run["batch"], run["seq"])
    gc.collect()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated(dev)
    params = lm_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
             for k, v in SyntheticLM(cfg, spec, seed=0)(0).items()}
    out = {"cfg": label}
    out["twice"] = bits_twice_report(label, cfg, params, batch)
    card = dry_card(lambda: _value_and_grad(cfg, params, batch), dev,
                    all_kernels, m0)
    check(not any(card["launches"].values()),
          f"{label}: a kernel ran on the gradient path")
    rec = record()
    check(rec["per_device"]["peak_bytes"] <= FAMILY_TRAIN_PEAK_MAX,
          f"{label}: the dry-run's peak is over the cut's")
    out["dry"] = dry_hold(label, rec, card, 0.0, "dot_flops")
    out["ms"] = card["ms"]
    del params, batch
    return out


def family_grads_vs_cpu(dev, arch):
    """Phase 18 (c) and (d): ``_value_and_grad`` of the same parameters and
    batch (full width, fp32, FAMILY_GRAD_CUT's depth) on the CPU and twice
    on the card."""
    cfg = dataclasses.replace(lm_config.get(arch), dtype="float32",
                              **FAMILY_GRAD_CUT[arch])
    grad_tol = FAMILY_GRAD_TOL_SCAN.get(arch, FAMILY_GRAD_TOL)
    label = family_label(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    card = lm_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    spec = batch_spec_for(cfg, FAMILY_GRAD_BATCH, FAMILY_GRAD_SEQ)
    nb = SyntheticLM(cfg, spec, seed=1)(0)
    t0 = time.perf_counter()
    cpu = tree_util.map(lambda x: x.cpu(), card)
    lc, _, gcpu = _value_and_grad(cfg, cpu, {
        k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in nb.items()})
    del cpu
    cpu_s = time.perf_counter() - t0
    batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
             for k, v in nb.items()}
    t0 = time.perf_counter()
    same_loss, diff, n, lg, g1 = grads_twice(cfg, card, batch)
    card_s = time.perf_counter() - t0
    del card, batch
    lg = lg.cpu()
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    worst, worst_leaf, n_el = 0.0, None, 0
    for i, (g, c) in enumerate(zip(g1, tree_util.leaves(gcpu))):
        if c.numel() == 0:
            continue
        c = c.to(dev)
        n_el += c.numel()
        scale = float(c.abs().max())
        err = float((g - c).abs().max()) / scale if scale else \
            float(g.abs().max())
        if err > worst:
            worst, worst_leaf = err, i
    del g1
    where = None if worst_leaf is None else list(leaf_names(gcpu))[worst_leaf]
    print(f"card vs CPU, {label}, fp32 B={spec.batch} S={spec.seq} "
          f"(+{spec.patch_len} patches, {spec.enc_len} frames): loss "
          f"{float(lg):.6f} vs {float(lc):.6f} (rel {loss_rel:.3e}, tol "
          f"{FAMILY_LOSS_TOL:g}); {n} gradient leaves, {n_el} elements, "
          f"worst leaf {where} at {worst:.3e} of its largest element (tol "
          f"{grad_tol:g}); two card calls: same loss {same_loss}, "
          f"same bits in {n - len(diff)} of {n} leaves; {cpu_s:.1f} s on "
          f"the CPU, {card_s:.1f} s on the card (two calls)", flush=True)
    check(loss_rel <= FAMILY_LOSS_TOL,
          f"card vs CPU {label}: loss rel {loss_rel:.3e}")
    check(worst <= grad_tol,
          f"card vs CPU {label}: gradient leaf {where} at {worst:.3e}")
    check(same_loss and not diff,
          f"{label}: two gradient calls on the card differ: {diff}")
    return {"loss_rel": loss_rel, "worst_grad": worst, "worst_leaf": where,
            "grad_tol": grad_tol,
            "leaves": n, "same_loss": same_loss, "differ": diff,
            "cpu_s": cpu_s, "card_s": card_s}


def launcher_run():
    """``launch.train.main`` on the card at LAUNCHER_ARGS: it must end with
    a finite final loss."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = lm_train.main(LAUNCHER_ARGS)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    print(text.rstrip(), flush=True)
    m = re.search(r"final loss (\S+),", text)
    final = float(m.group(1)) if m else float("nan")
    print(f"launch.train.main({LAUNCHER_ARGS}) returned {rc} in {wall:.1f} s, "
          f"final loss {final}", flush=True)
    check(rc == 0 and np.isfinite(final),
          f"launch.train.main: rc {rc}, final loss {final}")
    return {"rc": rc, "final_loss": final, "wall_s": wall}


def train_families_phase(dev, all_kernels):
    """Phase 18: the moe (with MLA), vlm, audio, ssm and hybrid families
    trained on the card at their published widths, each step held against
    the dry-run, the card against the CPU, two gradient calls bit for bit,
    and the launcher's own run.  Returns the readings."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"runs": {}, "grads": {}, "cpu": {}}
    jobs = {}
    # the slowest trace first: xlstm's sLSTM steps
    order = sorted(FAMILY_TRAIN_RUNS, key=lambda r: r["arch"] != "xlstm-1.3b")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=2,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for run in order:
            for key, grads_only in (("cut", False), ("grads", True)):
                if key in run:
                    cfg = dataclasses.replace(lm_config.get(run["arch"]),
                                              **run[key])
                    jobs[(run["arch"], key)] = pool.submit(
                        _family_dry_record,
                        (cfg, run["batch"], run["seq"], grads_only))
        for run in FAMILY_TRAIN_RUNS:
            # (c) and (d) first: their CPU work covers the workers' start
            arch = run["arch"]
            out["cpu"][arch] = family_grads_vs_cpu(dev, arch)
            out["runs"][arch] = family_train_step(
                dev, all_kernels, run, jobs[(arch, "cut")].result)
            if "grads" in run:
                out["grads"][arch] = family_grads_step(
                    dev, all_kernels, run, jobs[(arch, "grads")].result)
            print(f"  {arch} done at {time.perf_counter() - t0:.1f} s",
                  flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["launcher"] = launcher_run()
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 19: the examples, ported as launchers
# --------------------------------------------------------------------------
#: launch/cluster_simulation.py at the example's defaults (Plummer N = 2048,
#: t_end 0.5, dt 1/256: 128 steps), single and replicated over
#: CLUSTER_SLOTS slots of the card, bit for bit; its Fig. 4 overlap within
#: CLUSTER_OVERLAP_TOL of the reference example's at the same defaults,
#: which printed 1.000 (|dE/E| 2.601e-02: a close encounter at eps 1e-7)
#: running ``python examples/cluster_simulation.py`` on a CPU host
CLUSTER_SLOTS = 4
CLUSTER_REF_OVERLAP = 1.000
CLUSTER_OVERLAP_TOL = 0.02
#: one single run at N = 16384 to t = 1/64 (1/16 until cut for time), with
#: the FP64 oracle's seconds
CLUSTER_LARGE = dict(n=16384, t_end=1.0 / 64)

#: launch/ensemble_scenarios.py at the example's defaults (n = 128, an
#: ensemble of 4, t_end 0.125, every scenario) on the card.  (steps, max
#: |dE/E|) by scenario of the port on the CPU (``python -m
#: repro_torch.launch.ensemble_scenarios --device cpu``, 11 minutes on one
#: thread of a CPU host: too long for this script) and of the reference
#: example (``python examples/ensemble_scenarios.py``, same host).  A run
#: inside the fp32 tier must take the CPU's steps on the card and stay in
#: the tier; the reference's steps are printed beside (kepler_disk: 1818,
#: the port's 1819 on the CPU as on the card; in fp64 both take 1820,
#: tests/witness_tour_steps.py: rounding moves a step, ROADMAP queue 3
#: A5).  cold_collapse's singular collapse
#: (eps 1e-7) leaves every tier on both hosts (3474 and 3470 steps), so
#: its step count is no stable reading: it must finish
ENSEMBLE_CPU_DEFAULTS = {
    "binary_plummer": (476, 3.83e-08), "cold_collapse": (3474, 2.42e+02),
    "kepler_disk": (1819, 4.81e-08), "king": (1086, 5.38e-07),
    "merger": (807, 5.57e-08), "plummer": (293, 1.76e-08),
    "two_body": (5, 1.20e-09)}
ENSEMBLE_REF = {"binary_plummer": (476, 3.44e-08),
                "cold_collapse": (3470, 2.43e+02),
                "kepler_disk": (1818, 1.89e-07), "king": (1086, 4.70e-07),
                "merger": (807, 6.61e-08), "plummer": (293, 2.95e-08),
                "two_body": (5, 7.04e-10)}
#: and the card against the port on the CPU in this process, at
#: tests/test_torch_ensemble_scenarios.py's size
ENSEMBLE_CPU_KW = dict(n=32, ensemble=2, t_end=1.0 / 32)


def cluster_runs(dev, all_kernels):
    """Phase 19 (a): the cluster simulation on the card."""
    out = {}
    for label, kw in (("single", {}),
                      (f"replicated x{CLUSTER_SLOTS}",
                       dict(strategy="replicated", devices=CLUSTER_SLOTS))):
        lines = []
        r, counts, _, wall = counted(
            lambda: cluster_simulation.run(device=dev, out=lines.append,
                                           validate=label == "single", **kw),
            all_kernels)
        print(f"cluster_simulation {label}: " + "; ".join(lines[:2]),
              flush=True)
        print(f"  {wall:.3f} s (evolve {r['wall_s']:.3f} s"
              + (f", FP64 oracle {r['golden_s']:.3f} s" if "golden_s" in r
                 else "") + f"), launches {counts}", flush=True)
        check(all(counts[k] > 0 for k in ("acc_jerk_pot", "snap")),
              f"cluster_simulation {label}: K1/K2 never launched")
        check(np.isfinite(r["de_rel"]) and abs(
            float(r["state"].time) - 0.5) < 1e-12,
            f"cluster_simulation {label}: |dE/E| {r['de_rel']}, t "
            f"{float(r['state'].time)}")
        out[label] = r
    single, rep = out["single"], out[f"replicated x{CLUSTER_SLOTS}"]
    same = bitwise_same(single["state"], rep["state"])
    gap = abs(single["overlap"] - CLUSTER_REF_OVERLAP)
    print(f"cluster_simulation defaults: replicated over {CLUSTER_SLOTS} "
          f"slots bitwise equal to single: {same}; overlap {single['overlap']:.6f}"
          f" vs the reference example's {CLUSTER_REF_OVERLAP:.3f} (gap "
          f"{gap:.4f}, tol {CLUSTER_OVERLAP_TOL}); |dE/E| single "
          f"{single['de_rel']:.3e}, replicated {rep['de_rel']:.3e}", flush=True)
    check(same, "cluster_simulation: replicated differs from single")
    check(gap <= CLUSTER_OVERLAP_TOL, f"cluster_simulation: overlap gap {gap}")

    lines = []
    r, counts, _, wall = counted(
        lambda: cluster_simulation.run(device=dev, out=lines.append,
                                       **CLUSTER_LARGE), all_kernels)
    print(f"cluster_simulation N={CLUSTER_LARGE['n']} t_end="
          f"{CLUSTER_LARGE['t_end']}: " + "; ".join(lines[:2]) + f"; evolve "
          f"{r['wall_s']:.3f} s, FP64 oracle {r['golden_s']:.3f} s, launches "
          f"{counts}", flush=True)
    check(np.isfinite(r["de_rel"]),
          f"cluster_simulation N={CLUSTER_LARGE['n']}: |dE/E| {r['de_rel']}")
    check(r["overlap"] >= 1 - CLUSTER_OVERLAP_TOL,
          f"cluster_simulation N={CLUSTER_LARGE['n']}: overlap {r['overlap']}")
    return {"single": {k: single[k] for k in ("de_rel", "overlap", "wall_s",
                                               "golden_s")},
            "replicated": {k: rep[k] for k in ("de_rel", "wall_s")},
            "bitwise": same,
            "large": {k: r[k] for k in ("de_rel", "overlap", "wall_s",
                                        "golden_s")}}


def ensemble_tour(dev, all_kernels):
    """Phase 19 (b): the scenario tour on the card at the example's
    defaults against the port's CPU readings there, then on the card and
    the CPU at ENSEMBLE_CPU_KW."""
    lines = []
    card, counts, _, wall = counted(
        lambda: ensemble_scenarios.run(device=dev, out=lines.append),
        all_kernels)
    print("\n".join(lines), flush=True)
    print(f"ensemble_scenarios defaults on the card: {wall:.3f} s, launches "
          f"{counts}", flush=True)
    check(tuple(card) == tuple(ENSEMBLE_CPU_DEFAULTS),
          f"ensemble_scenarios: scenarios {tuple(card)}")
    out = {"defaults": {}, "small": {}}
    for name, (steps, de) in ENSEMBLE_CPU_DEFAULTS.items():
        r = card[name]
        ref_steps, ref_de = ENSEMBLE_REF[name]
        in_tier = max(de, ref_de) <= DE_TIERS["fp32"]
        out["defaults"][name] = {"steps": r["steps"], "de_rel": r["de_rel"],
                                 "wall_s": r["wall_s"], "cpu_steps": steps,
                                 "ref_steps": ref_steps}
        print(f"  {name:<16} card steps {r['steps']:>5} |dE/E| "
              f"{r['de_rel']:.3e}; CPU steps {steps:>5} |dE/E| {de:.2e}; "
              f"reference steps {ref_steps:>5} |dE/E| {ref_de:.2e}"
              + ("" if in_tier else " (outside every tier: not held)"),
              flush=True)
        check(np.isfinite(r["de_rel"]), f"ensemble_scenarios {name}: "
                                        f"|dE/E| {r['de_rel']}")
        if in_tier:
            check(r["steps"] == steps, f"ensemble_scenarios {name}: "
                                       f"{r['steps']} steps, CPU {steps}")
            check(r["de_rel"] <= DE_TIERS["fp32"], f"ensemble_scenarios "
                                                   f"{name}: |dE/E| {r['de_rel']}")
    check(counts["acc_jerk_pot"] > 0 and counts["snap"] > 0,
          "ensemble_scenarios: K1/K2 never launched")

    small = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        small[str(where)] = ensemble_scenarios.run(
            device=where, out=lambda line: None, **ENSEMBLE_CPU_KW)
        print(f"ensemble_scenarios {ENSEMBLE_CPU_KW} on {where}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in ENSEMBLE_CPU_DEFAULTS:
        a, b = small[str(dev)][name], small["cpu"][name]
        out["small"][name] = {"card_steps": a["steps"], "cpu_steps": b["steps"],
                              "card_de_rel": a["de_rel"],
                              "cpu_de_rel": b["de_rel"]}
        print(f"  {name:<16} steps card {a['steps']} cpu {b['steps']}; "
              f"|dE/E| card {a['de_rel']:.3e} cpu {b['de_rel']:.3e} (tier "
              f"{DE_TIERS['fp32']:.0e})", flush=True)
        check(a["steps"] == b["steps"], f"ensemble_scenarios {name}: card "
                                        f"{a['steps']} steps, CPU {b['steps']}")
        check(max(a["de_rel"], b["de_rel"]) <= DE_TIERS["fp32"],
              f"ensemble_scenarios {name}: |dE/E| {a['de_rel']} "
              f"{b['de_rel']}")
    return out


def examples_phase(dev, all_kernels):
    """Phase 19: the two example launchers on the card."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    out = {"cluster": cluster_runs(dev, all_kernels)}
    out["ensemble"] = ensemble_tour(dev, all_kernels)
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def pm_label(job):
    return job["strategy"] + (" " + job["ring_mode"]
                              if job["strategy"] == "ring" else "") + (
        f" {job['compaction']}" if "compaction" in job else "")


def pm_spawn(world, backend, device, jobs, keep=False):
    """``jobs`` on ``world`` ranks (``mesh_runs.lm_rank``, which runs the
    strategy jobs as ``strategy_rank`` does: digests, and the tensors when
    the job's ``keep`` or else ``keep``; any LM job after them on the same
    ranks); returns the ranks' results and the spawn's wall seconds."""
    return mesh_lm_spawn(world, backend, [
        dict(j, keep=j.get("keep", keep))
        if j["kind"] in mesh_runs.STRATEGY_KINDS else j for j in jobs],
        device)


def pm_hold(tag, ranks, ref, jobs, per_rank):
    """Every rank's digests against each other's and the in-process run's
    (``ref``), and each rank's K1/K2 launches against ``per_rank(job)``;
    returns the launches by label."""
    launches = {}
    for i, job in enumerate(jobs):
        label = pm_label(job)
        want = {k: mesh_runs.digest(t) for k, t in ref[i]["tensors"].items()}
        same = all(r[i]["digests"] == want for r in ranks)
        counts = [{k: r[i]["counts"][k] for k in ("acc_jerk_pot", "snap")}
                  for r in ranks]
        launches[label] = counts
        print(f"{tag} {label:<22}: {len(ranks)} ranks bit for bit each "
              f"other and the in-process mesh: {same} ({len(want)} "
              f"tensors); launches per rank {counts[0]} (in-process "
              f"{ {k: ref[i]['counts'][k] for k in ('acc_jerk_pot', 'snap')} }"
              f"), shift rounds per rank {ranks[0][i]['counts']['shifts']} "
              f"(in-process {ref[i]['counts']['shifts']})", flush=True)
        check(same, f"{tag} {label}: a rank differs from the in-process mesh")
        for c in counts:
            for name, n in c.items():
                check(n == per_rank(job), f"{tag} {label}: {name} launched "
                      f"{n} times on a rank, expected {per_rank(job)}")
        check(all(r[i]["counts"]["shifts"] == ranks[0][i]["counts"]["shifts"]
                  for r in ranks), f"{tag} {label}: shift counts differ")
    return launches


def pm_table1(dev, p, extra_jobs=()):
    """Phase 20 (a) and (e): Table 1's size under every strategy on ``p``
    gloo ranks of the one card, and compressed_psum on the same ranks.
    ``extra_jobs`` (the later phases') run on the same ranks after these,
    so that the ranks' start is paid once; returns the readings and their
    results, per rank."""
    jobs = [dict(kind="lockstep", strategy=s_, ring_mode=m_, n=TABLE1_N,
                 seed=0, steps=PM_STEPS, dt=TABLE1_DT, dtype="fp32",
                 chips_per_card=2) for s_, m_ in PM_RUNS]
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((p, PM_PSUM_LEN)).astype(np.float32))
    x[1, 7] = 40.0  # one rank's entry sets the shared scale
    ranks, spawn_s = pm_spawn(p, "gloo", dev, jobs + [dict(kind="psum", x=x)]
                              + list(extra_jobs))
    extra = [r[len(jobs) + 1:] for r in ranks]
    ranks = [r[:len(jobs) + 1] for r in ranks]
    torch.cuda.synchronize()
    ref = mesh_runs.in_process([dev] * p, jobs)
    evals = PM_STEPS + 1
    launches = pm_hold("process mesh (a)", ranks, ref, jobs,
                       lambda j: evals * (p if j["strategy"] == "ring" else 1))
    steps = {}
    for i, job in enumerate(jobs):
        label = pm_label(job)
        want = evals * 2 * (p - 1 if job["ring_mode"] == "overlap" else p) \
            if job["strategy"] == "ring" else 0
        check(ranks[0][i]["counts"]["shifts"] == want,
              f"process mesh (a) {label}: {ranks[0][i]['counts']['shifts']} "
              f"shift rounds per rank, expected {want}")
        pm_ms = 1e3 * ranks[0][i]["times"]["step_s"]
        ip_ms = 1e3 * ref[i]["times"]["step_s"]
        steps[label] = {"process_mesh_ms": pm_ms, "in_process_ms": ip_ms,
                        "boot_process_mesh_ms":
                            1e3 * ranks[0][i]["times"]["boot_s"],
                        "boot_in_process_ms": 1e3 * ref[i]["times"]["boot_s"]}
        print(f"process mesh (a) {label:<22} N={TABLE1_N} p={p}: "
              f"{pm_ms:.3f} ms per step over {p} gloo ranks "
              f"({ranks[0][i]['times']['boot_s'] * 1e3:.3f} ms bootstrap; "
              f"{process_mesh.transport('gloo', dev)}) vs {ip_ms:.3f} ms "
              f"in-process [{dev}] * {p} ({ref[i]['times']['boot_s'] * 1e3:.3f}"
              f" ms bootstrap): {pm_ms / ip_ms:.3f}x", flush=True)
    s = ref[0]["tensors"]
    check(all(bool(torch.isfinite(s[f"state.{f}"]).all())
              for f in ("pos", "vel", "acc"))
          and tuple(s["state.pos"].shape) == (TABLE1_N, 3),
          "process mesh (a): bad state")
    # (e): the int32 sum of every rank's levels at the shared scale, here
    xd = x.to(dev)
    levels = torch.full((), 127.0, dtype=torch.float32, device=dev)
    scale = torch.clamp(torch.amax(torch.abs(xd)) / levels, min=1e-30)
    q = torch.clamp(torch.round(xd / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32).sum(dim=0, dtype=torch.int32)
    want = mesh_runs.digest(total.to(torch.float32) * scale)
    same = all(r[-1]["digests"]["sum"] == want for r in ranks)
    err = float((total.to(torch.float64) * scale.double()
                 - xd.double().sum(0)).abs().max())
    print(f"process mesh (e) compressed_psum, {p} ranks x {PM_PSUM_LEN} fp32: "
          f"every rank equals the int32 sum of the levels times the shared "
          f"scale {float(scale):.6e} computed in one process: {same}; max "
          f"|sum - exact sum| {err:.3e} (<= {p} x scale / 2 = "
          f"{p * float(scale) / 2:.3e})", flush=True)
    check(same, "process mesh (e): compressed_psum differs from the levels' "
          "int32 sum at the shared scale")
    check(err <= p * float(scale) / 2 * (1 + 1e-6),
          f"process mesh (e): compressed_psum off by {err:.3e}")
    return {"launches": launches, "steps": steps, "spawn_s": spawn_s}, extra


def pm_nccl(dev):
    """Phase 20 (c) and (d): nccl at one rank, and refused at more ranks
    than cards."""
    jobs = [dict(kind="lockstep", strategy="replicated", n=N_MAIN, seed=0,
                 steps=PM_STEPS, dt=TABLE1_DT, dtype="fp32")]
    # the rank function in a group of this process alone (a spawned rank
    # takes 12 to 17 s to start); the job twice, the first to set up the
    # communicator: the second's step is timed
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pm_") as tmp:
        with process_mesh.single_rank_group("nccl", dev):
            mesh_runs.strategy_rank(dev, jobs * 2, tmp, False)
        ranks = [r[1:] for r in mesh_runs.load_ranks(tmp, 1)]
    group_s = time.perf_counter() - t0
    ref = mesh_runs.in_process([dev], jobs)
    launches = pm_hold("process mesh (c) nccl", ranks, ref, jobs,
                       lambda j: PM_STEPS + 1)
    pm_ms = 1e3 * ranks[0][0]["times"]["step_s"]
    ip_ms = 1e3 * ref[0]["times"]["step_s"]
    print(f"process mesh (c) replicated N={N_MAIN} on one nccl rank "
          f"({process_mesh.transport('nccl', dev)}): {pm_ms:.4f} ms per "
          f"step vs {ip_ms:.4f} ms in-process", flush=True)
    world = torch.cuda.device_count() + 1
    try:
        process_mesh.spawn(mesh_runs.strategy_rank, world, "nccl", "cuda",
                           jobs, "unused")
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"process mesh (d) nccl at {world} ranks on "
          f"{torch.cuda.device_count()} card(s): refused before any group "
          f"({refused!r}); a process group exists: "
          f"{torch.distributed.is_initialized()}", flush=True)
    check(refused is not None and "cards visible" in refused
          and not torch.distributed.is_initialized(),
          f"process mesh (d): nccl at {world} ranks was not refused")
    return {"launches": launches, "step_ms": pm_ms, "in_process_ms": ip_ms,
            "group_s": group_s}


def process_mesh_phase(dev, all_kernels, extra_jobs=()):
    """Phase 20: the strategies over a process mesh.  ``extra_jobs``
    (phases 24 and 21 to 23's, in the whole run) run on the same four
    ranks after these, so that the ranks' start is paid once; their
    results come back in ``out["extra_ranks"]``, per rank."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    torch.cuda.empty_cache()  # the ranks hold their own memory
    out = {}
    out["table1"], out["extra_ranks"] = pm_table1(dev, TABLE1_P,
                                                  list(extra_jobs))
    out["nccl"] = pm_nccl(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 20 took {out['seconds']:.1f} s (spawn "
          f"{out['table1']['spawn_s']:.1f} s (a, e"
          f"{' and phases 21 to 24' if extra_jobs else ''}); (c) "
          f"{out['nccl']['group_s']:.1f} s)", flush=True)
    return out


def mesh_lm_jobs(tmp):
    """Phase 21's jobs: the collective probe, the serve and train jobs
    (the train job writes its checkpoint to ``tmp``)."""
    cfg = dataclasses.replace(lm_config.get(LM_ARCH), n_layers=MESH_DEPTH)
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, cfg.vocab_size, (MESH_SERVE_B, MESH_SERVE_S))
    data = [{k: rng.integers(0, cfg.vocab_size,
                             (MESH_TRAIN_B, MESH_TRAIN_S)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(MESH_TRAIN_STEPS)]
    return [
        dict(kind="probe"),
        # repeat: a second, warm prefill (its seconds), held bit for bit
        dict(kind="serve", cfg=dataclasses.replace(cfg, attn_impl="flash"),
             seed=21, tokens=tokens, max_len=MESH_SERVE_S + MESH_GEN,
             gen=MESH_GEN, repeat=1),
        dict(kind="train", cfg=dataclasses.replace(cfg, dtype="float32"),
             seed=21, steps=MESH_TRAIN_STEPS,
             data=data, opt={"learning_rate": TRAIN_LR}, ckpt_dir=tmp,
             moments=True, keep=("params.", "loss")),
    ]


def _fault_local_halves(rules, up):
    """Planted fault: the mLSTM's up-projection halved on each rank's
    block of "d_ff" (a local ``torch.chunk``): on model = 2, rank 0's xm
    and zg are both halves of xm, rank 1's both halves of zg."""
    from torch.distributed.tensor.experimental import local_map
    pl = list(up.placements)
    return local_map(lambda u: tuple(torch.chunk(u, 2, dim=-1)),
                     out_placements=(pl, pl), in_placements=(pl,),
                     device_mesh=rules.mesh)(up)


def _fault_rms_per_rank(norm):
    """Planted fault: an RMS norm over a row the mesh splits taken on each
    rank's part of it alone (the mLSTM's ``onorm``, Mamba2's gated norm)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def fault(x, w, eps=1e-5):
        if not (isinstance(x, DTensor) and Shard(x.ndim - 1) in x.placements):
            return norm(x, w, eps)
        # w split as x's rows, each rank's part beside its part of the row
        pl = [Shard(0) if p == Shard(x.ndim - 1) else Replicate()
              for p in x.placements]
        if not isinstance(w, DTensor):
            w = DTensor.from_local(w, x.device_mesh,
                                   [Replicate()] * len(pl), run_check=False)
        w = w.redistribute(x.device_mesh, pl)
        return local_map(lambda a, b: norm(a, b, eps),
                         out_placements=list(x.placements),
                         in_placements=(list(x.placements), pl),
                         device_mesh=x.device_mesh)(x, w)
    return fault


@contextlib.contextmanager
def planted(fault):
    """The named fault in place of the port's code while the block runs."""
    saved = lm_model._halves, lm_layers.rms_norm
    if fault == "local_chunk":
        lm_model._halves = _fault_local_halves
    elif fault == "rms_per_rank":
        lm_layers.rms_norm = _fault_rms_per_rank(lm_layers.rms_norm)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        lm_model._halves, lm_layers.rms_norm = saved


def planted_lm_rank(device, jobs, out_dir):
    """``mesh_runs.lm_rank`` with each job's ``fault`` planted while that
    job runs."""
    run = mesh_runs.run_lm_job

    def one(job, dev, meshes):
        with planted(job.get("fault")):
            return run({k: v for k, v in job.items() if k != "fault"}, dev,
                       meshes)

    mesh_runs.run_lm_job = one
    mesh_runs.lm_rank(device, jobs, out_dir)


def mesh_lm_spawn(world, backend, jobs, device="cuda"):
    """``jobs`` on ``world`` ranks (``mesh_runs.lm_rank``, or
    ``planted_lm_rank`` where a job plants a fault); the ranks' results
    and the spawn's wall seconds.  Prints rank 0's breakdown: its start,
    each job's end and the spawn's end, in seconds after the spawn
    began."""
    fn = (planted_lm_rank if any("fault" in j for j in jobs)
          else mesh_runs.lm_rank)
    with tempfile.TemporaryDirectory(prefix="mesh_lm_") as tmp:
        t0, at0 = time.perf_counter(), time.time()
        process_mesh.spawn(fn, world, backend, device, jobs, tmp)
        wall = time.perf_counter() - t0
        ranks = mesh_runs.load_ranks(tmp, world)
    times = [r["times"] for r in ranks[0]]
    print(f"mesh spawn of {world} {backend} ranks: rank 0 started at "
          f"{times[0]['rank_start_at'] - at0:.1f} s, its jobs "
          f"({', '.join(j['kind'] for j in jobs)}) ended at "
          f"{[round(t['done_at'] - at0, 1) for t in times]} s, the spawn at "
          f"{wall:.1f} s", flush=True)
    return ranks, wall


def mesh_logits_holds(tag, ranks, one, i, apart=(), tol=MESH_LOGITS_TOL,
                      ties_held=True):
    """Every rank's greedy tokens equal; over the sequences not held
    ``apart``, the prefill logits within ``tol`` of the one-device run's
    and a token that differs from it a near-tie there (read, not held,
    without ``ties_held``)."""
    want = one[i]["tensors"]
    for r, res in enumerate(ranks):
        check(res[i]["digests"]["tokens"] == ranks[0][i]["digests"]["tokens"],
              f"{tag}: rank {r}'s greedy tokens differ from rank 0's")
    got = ranks[0][i]["tensors"]
    rows = [r for r in range(want["tokens"].shape[0]) if r not in apart]
    check(2 * len(rows) >= want["tokens"].shape[0],
          f"{tag}: sequences {sorted(apart)} of "
          f"{want['tokens'].shape[0]} held apart")
    lg, toks = want["logits"][rows].float(), want["tokens"][rows]
    steps = want["step_logits"][:, rows].float()
    mine = got["tokens"][rows]
    err = float((got["logits"][rows].float() - lg).abs().max()
                / lg.abs().max())
    same = mine == toks
    ties = []
    for row, col in (~same).nonzero().tolist():
        if bool(same[row, :col].all()):     # the first difference in a row
            s_ = steps[col, row]
            ties.append(float(s_.max() - s_[mine[row, col]])
                        / float(s_.abs().max()))
    print(f"{tag} serve: prefill logits max |mesh - one| / max |one| "
          f"{err:.3e} (tol {tol:g}) over sequences {rows}; "
          f"greedy tokens equal {int(same.sum())}/{same.numel()}, first "
          f"differences at {[f'{t:.2e}' for t in ties]} of max |logit| "
          f"below the top ("
          f"{f'tol {MESH_TIE_TOL:g}' if ties_held else 'read, not held'})",
          flush=True)
    check(err <= tol, f"{tag}: logits off by {err:.3e}")
    check(not ties_held or all(t <= MESH_TIE_TOL for t in ties),
          f"{tag}: a meshed token is no near-tie of the one-device run")
    return err


def mesh_lm_serve(ranks, one, i):
    """(b) serving: every rank's tokens equal; the prefill logits within
    MESH_LOGITS_TOL of the one-device run's; a token that differs from it
    a near-tie there."""
    mesh_logits_holds("phase 21 (b)", ranks, one, i)
    launches = [res[i]["info"]["flash_per_prefill"] for res in ranks]
    print(f"mesh (b) K3 launches per meshed prefill per rank {launches} "
          f"(one device: {one[i]['info']['flash_per_prefill']}); cache on "
          f"rank 0 {ranks[0][i]['info']['cache_layout']['k']}", flush=True)
    check(all(n == MESH_DEPTH for n in launches),
          f"phase 21: K3 launched {launches} times per rank, expected "
          f"{MESH_DEPTH} (one per layer)")
    return launches


def mesh_lm_train(ranks, one, i, cfg, dev):
    """(b) training: the ranks' results equal; losses and the parameters'
    update against the one-device run."""
    for r, res in enumerate(ranks):
        check(res[i]["digests"] == ranks[0][i]["digests"],
              f"phase 21: rank {r}'s trained state differs from rank 0's")
    got, want = ranks[0][i]["tensors"], one[i]["tensors"]
    loss_err = float((got["loss"] - want["loss"]).abs().max()
                     / want["loss"].abs().max())
    base = lm_params.init_params(
        cfg, torch.Generator(dev).manual_seed(21), device=dev)
    n = out = 0
    worst_excess, gaps = -np.inf, {}
    for key, p0 in mesh_runs._flat(base).items():
        g = got[f"params.{key}"].to(dev).double()
        w = want[f"params.{key}"].to(dev).double()
        excess = (g - w).abs() - (TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL * w.abs())
        out += int((excess > 0).sum())
        n += excess.numel()
        worst_excess = max(worst_excess, float(excess.max()))
        gaps[key] = float((g - w).norm() / (w - p0.double()).norm())
    worst = max(gaps.values())
    print(f"mesh (b) train {cfg.dtype}: losses {got['loss'].tolist()} vs one "
          f"device {want['loss'].tolist()} (rel {loss_err:.3e}, tol "
          f"{TRAIN_CPU_TOL:g}); params: {out} of {n} elements outside rtol "
          f"{TRAIN_PARAM_RTOL:g} atol {TRAIN_PARAM_ATOL:g} (share tol "
          f"{TRAIN_FLIP_SHARE:g}), worst excess {worst_excess:.3e}, worst "
          f"leaf update-norm gap {worst:.3e} (tol {TRAIN_UPDATE_NORM_TOL:g}, "
          f"by leaf { {k: f'{v:.1e}' for k, v in gaps.items()} }); moments "
          f"placed as the params: "
          f"{ranks[0][i]['info']['opt_layout'] == ranks[0][i]['info']['layout']}",
          flush=True)
    check(loss_err <= TRAIN_CPU_TOL, f"phase 21: losses off by {loss_err:.3e}")
    check(out <= TRAIN_FLIP_SHARE * n,
          f"phase 21: {out} of {n} parameters outside the bound")
    check(worst_excess <= 2 * MESH_TRAIN_STEPS * TRAIN_LR,
          f"phase 21: a parameter {worst_excess:.3e} past the bound")
    check(worst <= TRAIN_UPDATE_NORM_TOL, f"phase 21: update off by {worst:.3e}")
    check(ranks[0][i]["info"]["opt_layout"] == ranks[0][i]["info"]["layout"],
          "phase 21: the moments are not placed as the params")


def mesh_lm_flash(dev):
    """K3 at the mesh's local prefill shape against its plain version,
    timed beside it, its bound and SDPA."""
    b, s, h, kv, d = (MESH_SERVE_B // MESH_SHAPE[0], MESH_SERVE_S,
                      16 // MESH_SHAPE[1], 8 // MESH_SHAPE[1], 128)
    q, k, v = flash_operands(b, s, s, h, kv, d, torch.bfloat16, dev, seed=21)
    r = flash_readings(q, k, v, True, 512, 512)
    failed = flash_failures(r, "bf16")
    check(not failed, f"phase 21 K3 at the local shape: {'; '.join(failed)}")
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
    pms = cuda_ms(lambda: fa._flash_plain(q, k, v, causal=True, block_q=512,
                                          block_k=512), 3, warmup=1)
    timed = {n: t for n, t in sdpa_backends(q, k, v).items()
             if t[0] is not None}
    lname = min(timed, key=lambda n: timed[n][0])
    bms, by = flash_bound_ms(b, s, h, kv, d, torch.bfloat16)
    print(f"mesh K3 bf16 local shape B={b} S={s} H={h} KV={kv} D={d} causal: "
          f"kernel {ms:.4f} ms  plain {pms:.4f} ms  sdpa {timed[lname][0]:.4f}"
          f" ms ({lname})  bound {bms:.4f} ms ({by})  bound/kernel "
          f"{bms / ms:.3f}; max normalised err {r['norm_err']:.3e}, "
          f"{r['elem']:.3f} of the element-wise limit, tile share "
          f"{100 * r['tile_share']:.4f}%", flush=True)
    return dict(shape=dict(b=b, s=s, h=h, kv=kv, d=d), causal=True, ms=ms,
                plain_ms=pms, bound_ms=bms, bound_by=by,
                library_ms=timed[lname][0], library=f"sdpa {lname}",
                abs_err=r["abs_err"], norm_err=r["norm_err"], elem=r["elem"],
                tile_share=r["tile_share"])


def mesh_lm_phase(dev, all_kernels, extra_jobs=(), ranks=None, ckpt=None):
    """Phase 21: the dense LM over a device mesh (``MeshRules`` on a
    ``DeviceMesh``): (a) the collectives DTensor issues, on four gloo ranks
    on the card; (b) qwen3-0.6b served and trained on the (2, 2) mesh
    against the same jobs on one device, K3 at the local shape; (c) the
    mesh's checkpoint restored on one nccl rank (this process), bit for
    bit; (d) times.  ``extra_jobs`` (phases 22 and 23's) run on the same
    ranks after these, so that the ranks' start (some 15 s) is paid once;
    their results come back in ``out["extra"]``, per rank.  ``ranks``:
    the ranks' results of ``mesh_lm_jobs(ckpt)`` and the extra jobs where
    they have run already (in the whole run, in phase 20's spawn, the
    checkpoint in ``ckpt``); else the phase spawns its own."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    torch.cuda.empty_cache()  # the ranks hold their own memory
    out = {"flash": mesh_lm_flash(dev)}
    spawn_s = None
    with contextlib.ExitStack() as stack:
        if ckpt is None:
            ckpt = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="mesh_ckpt_"))
        jobs = mesh_lm_jobs(ckpt)
        if ranks is None:
            ranks, spawn_s = mesh_lm_spawn(
                4, "gloo", [dict(j, mesh=MESH_SHAPE)
                            for j in jobs + list(extra_jobs)])
        out["extra"] = [r[len(jobs):] for r in ranks]
        ranks = [r[:len(jobs)] for r in ranks]
        probe = ranks[0][0]["info"]
        print(f"mesh (a) collectives over gloo on cuda:0 (four ranks): "
              f"{probe}", flush=True)
        check(all(r[0]["info"] == probe for r in ranks),
              "phase 21 (a): the ranks' probes differ")
        one = mesh_runs.in_process_lm(dev, [dict(jobs[1], step_logits=True),
                                            dict(jobs[2], ckpt_dir=None)])
        out["launches"] = mesh_lm_serve(ranks, [None] + one, 1)
        mesh_lm_train(ranks, [None, None] + one[1:], 2, jobs[2]["cfg"], dev)
        restore = dict(kind="restore", cfg=jobs[2]["cfg"], mesh=(1, 1),
                       ckpt_dir=ckpt, opt=jobs[2]["opt"], keep=())
        t1 = time.perf_counter()
        with process_mesh.single_rank_group("nccl", dev):
            back = mesh_runs.run_lm_job(restore, dev, {})
        back_s = time.perf_counter() - t1
        saved = ranks[0][2]["digests"]
        got = back["digests"]
        same = all(got[k] == d for k, d in saved.items()
                   if k.startswith(("params.", "m.")))
        print(f"mesh (c) checkpoint of the (2, 2) mesh restored in this "
              f"process as one nccl rank (mesh (1, 1)), step "
              f"{back['info']['step']} in {back_s:.1f} s"
              f": params and moments bit for bit: {same} "
              f"({sum(k.startswith(('params.', 'm.')) for k in saved)} "
              f"leaves)", flush=True)
        check(same, "phase 21 (c): the restored checkpoint differs")
    t = {k: [r[i]["times"] for r in ranks] for i, k in ((1, "serve"),
                                                          (2, "train"))}
    out["times"] = {
        "prefill_ms": [1e3 * x["prefill_s"] for x in t["serve"]],
        "decode_step_ms": [1e3 * x["decode_step_s"] for x in t["serve"]],
        "train_step_ms": [[1e3 * s_ for s_ in x["step_s"]]
                          for x in t["train"]],
        "one_prefill_ms": 1e3 * one[0]["times"]["prefill_s"],
        "one_decode_step_ms": 1e3 * one[0]["times"]["decode_step_s"],
        "one_train_step_ms": [1e3 * s_ for s_ in one[1]["times"]["step_s"]]}
    out["seconds"] = time.perf_counter() - t0
    print(f"mesh (d) per rank: prefill {out['times']['prefill_ms']} ms, "
          f"decode step {out['times']['decode_step_ms']} ms, train steps "
          f"{out['times']['train_step_ms']} ms; one device in-process: "
          f"prefill {out['times']['one_prefill_ms']:.3f} ms, decode step "
          f"{out['times']['one_decode_step_ms']:.3f} ms, train steps "
          f"{out['times']['one_train_step_ms']} ms", flush=True)
    spawned = (f"spawn {spawn_s:.1f} s" if spawn_s is not None
               else "its jobs ran in phase 20's spawn")
    print(f"phase 21 took {out['seconds']:.1f} s ({spawned}; "
          f"rank 0's jobs probe, serve, train and save "
          f"{[round(r['times']['job_s'], 3) for r in ranks[0]]} s; restore "
          f"{back_s:.1f} s)", flush=True)
    return out


def mesh_family_jobs():
    """Phase 22's jobs: each family's serve job, then its training job
    (rank 0 holds those against one device itself: ``against_one``)."""
    serve, train = [], []
    for run in MESH_FAMILY_RUNS:
        base = dataclasses.replace(lm_config.get(run["arch"]), **run["cut"])
        cfg = dataclasses.replace(base, param_dtype="bfloat16",
                                  attn_impl=run["attn"])
        span = run["prompt"] + run.get("patches", 0)
        serve.append(dict(
            kind="serve", cfg=cfg, seed=22, max_len=span + MESH_FAM_GEN,
            gen=MESH_FAM_GEN, repeat=1,
            **family_batch(cfg, MESH_FAM_B, run["prompt"],
                           run.get("patches", 0), run.get("frames", 0))))
        fcfg = dataclasses.replace(base, dtype="float32",
                                   **run.get("grads_cut", {}))
        rng = np.random.default_rng(22)
        data = []
        for _ in range(MESH_TRAIN_STEPS if run["train"] == "steps" else 1):
            b = {k: rng.integers(0, fcfg.vocab_size, (
                MESH_FAM_B, MESH_FAM_TRAIN_S)).astype(np.int32)
                for k in ("tokens", "labels")}
            for key in ("patches", "frames"):
                if run.get(key):
                    b[key] = rng.standard_normal(
                        (MESH_FAM_B, run[key], fcfg.d_model)).astype(
                        np.float32)
            data.append(b)
        common = dict(cfg=fcfg, seed=22, data=data, keep=("loss", "term."))
        if run["train"] == "steps":
            train.append(dict(common, kind="train", steps=MESH_TRAIN_STEPS,
                              opt={"learning_rate": TRAIN_LR},
                              against_one={"rtol": TRAIN_PARAM_RTOL,
                                           "atol": TRAIN_PARAM_ATOL}))
        else:
            train.append(dict(common, kind="grads",
                              against_one={"rtol": 0.0, "atol": 0.0}))
    return serve, train


def by_expert(top_i, dropped):
    """A token's experts in ascending order with their dropped flags: the
    set the dispatch sees (top_k's order among them moves nothing)."""
    order = top_i.long().argsort(dim=-1)
    return top_i.gather(-1, order), dropped.gather(-1, order)


def router_disagreement(pm, po, k):
    """Per token, |log p_mesh - log p_one| at most over its top k + 1
    experts on either side, and one device's (p_k - p_(k+1)) / p_k."""
    top = torch.zeros(pm.shape, dtype=torch.bool, device=pm.device)
    for p_ in (pm, po):
        top.scatter_(-1, p_.topk(k + 1, dim=-1).indices, True)
    d = (pm.clamp_min(1e-30).log() - po.clamp_min(1e-30).log()).abs()
    ps = po.sort(dim=-1, descending=True).values
    return (d * top).amax(dim=-1), (ps[..., k - 1] - ps[..., k]) / ps[..., k - 1]


def partial_router_fault(readings):
    """A ``spying`` record for ``layers.route`` on one device: per call
    over more than one token, the readings of ``mesh_route_holds`` that a
    router fed with data rank 0's partial sums (its part of d, never
    reduced over "data") would give: the largest disagreement with the
    sound router and the share of tokens taking another set of experts,
    appended to ``readings[cfg.name]``."""
    def record(args, out):
        cfg, p, x = args
        if x.shape[1] == 1:
            return
        part = x.shape[-1] // MESH_SHAPE[0]
        lg = x[..., :part] @ p["router"][:part].to(x.dtype)
        pf = torch.softmax(lg.to(torch.float32), dim=-1)
        dis, _ = router_disagreement(pf, out[0], cfg.top_k)
        fi = lm_layers.top_k(pf, cfg.top_k)[1]
        moved = (fi.sort(dim=-1).values != out[2].sort(dim=-1).values)
        readings.setdefault(cfg.name, []).append(
            (float(dis.max()), float(moved.any(-1).float().mean())))
    return record


def mesh_route_holds(tag, ranks, one, i, fault):
    """(c) MoE: each rank's routing against one device's on the same
    sequences (``routes``: per MoE layer each token's experts, the entries
    dropped and the router's probabilities), by MESH_ROUTER_TOL's rule;
    ``fault``: ``partial_router_fault``'s readings for this model, the
    least of which must lie above the limits.  Returns the sequences held apart and the
    readings."""
    ref = one[i]["info"]["routes"]
    half = MESH_FAM_B // MESH_SHAPE[0]
    n_layers, s = len(ref), ref[0][0].shape[1]
    flips, apart, worst_d = [0] * n_layers, set(), 0.0
    shares, clean_same = [], True
    for res in ranks:
        d, m = res[i]["info"]["coord"]
        rows = slice(d * half, (d + 1) * half)
        routes = res[i]["info"]["routes"]
        flipped = torch.zeros(half, dtype=torch.bool)
        same_drops = []
        for layer, (mine, theirs) in enumerate(zip(routes, ref)):
            e, dr = by_expert(*mine[:2])
            re_, rdr = by_expert(theirs[0][rows], theirs[1][rows])
            flip = (e != re_).any(-1)                        # (half, S)
            moved = flip | (dr != rdr).any(-1)
            flipped |= flip.any(-1)
            same_drops.append(~(dr != rdr).any(-1).any(-1))
            dis, _ = router_disagreement(mine[2], theirs[2][rows],
                                         mine[0].shape[-1])
            worst_d = max(worst_d, float(dis.max()))
            if m == 0:
                flips[layer] += int(flip.sum())
            for j in range(half):
                if moved[j, -1] or (layer < n_layers - 1 and moved[j].any()):
                    apart.add(d * half + j)
        clean_same &= bool(all((sd | flipped).all() for sd in same_drops))
        entries = sum(r[1].numel() for r in routes)
        shares.append((sum(int(r[1].sum()) for r in routes) / entries,
                       sum(int(r[1][rows].sum()) for r in ref) / entries))
    flip_share = max(flips) / (MESH_FAM_B * s)
    fault_d, fault_share = (min(r[k] for r in fault) for k in (0, 1))
    print(f"{tag} (c) routing: the router's disagreement max |log p_mesh - "
          f"log p_one| {worst_d:.3e} (tol {MESH_ROUTER_TOL:g}; the partial "
          f"router fault {fault_d:.3e}); tokens taking another set of "
          f"experts than on one device, per MoE layer, {flips} of "
          f"{MESH_FAM_B * s}, share {flip_share:.4f} (tol "
          f"{MESH_FLIP_SHARE:g}; the fault {fault_share:.4f}); sequences "
          f"held apart {sorted(apart)} (at most {MESH_APART}); dropped "
          f"share per rank (mesh, one device on its sequences) "
          f"{[(f'{a:.5f}', f'{b:.5f}') for a, b in shares]}; sequences "
          f"routed alike drop alike: {clean_same}", flush=True)
    check(fault_d > MESH_ROUTER_TOL and fault_share > MESH_FLIP_SHARE,
          f"{tag}: the limits do not catch the partial router fault")
    check(worst_d <= MESH_ROUTER_TOL,
          f"{tag}: the router disagrees by {worst_d:.3e}")
    check(flip_share <= MESH_FLIP_SHARE,
          f"{tag}: {flip_share:.4f} of a layer's tokens routed otherwise")
    check(len(apart) <= MESH_APART,
          f"{tag}: sequences {sorted(apart)} routed otherwise")
    check(clean_same, f"{tag}: a sequence routed alike drops otherwise")
    check(all(a == b for a, b in shares) or any(flips),
          f"{tag}: the dropped shares differ with no token routed otherwise")
    return apart, {"flips": flips, "dropped_share": shares,
                   "router_disagreement": worst_d,
                   "fault": {"router_disagreement": fault_d,
                             "flip_share": fault_share}}


def mesh_family_serve(run, cfg, ranks, one, i, fault, phase_no=22):
    """(a) to (c) for one family's serve job."""
    tag = f"phase {phase_no} {run['arch']}"
    apart, out = set(), {}
    if cfg.family == "moe":
        apart, out = mesh_route_holds(tag, ranks, one, i, fault[cfg.name])
    same = [res[i]["info"]["prefills_equal"] for res in ranks]
    print(f"{tag} (c) two meshed prefills bit for bit per rank {same}",
          flush=True)
    check(all(same), f"{tag}: two meshed prefills differ")
    out["logits_err"] = mesh_logits_holds(
        tag, ranks, one, i, apart, run.get("logits_tol", MESH_LOGITS_TOL),
        run.get("ties_held", True))
    out["apart"] = sorted(apart)
    launches = [res[i]["info"]["flash_per_prefill"] for res in ranks]
    print(f"{tag} (b) K3 launches per meshed prefill per rank {launches} "
          f"(one device: {one[i]['info']['flash_per_prefill']}); cache on "
          f"rank 0 {ranks[0][i]['info']['cache_leaves']}", flush=True)
    check(all(n == run["k3"] for n in launches),
          f"{tag}: K3 launched {launches} times per rank, expected "
          f"{run['k3']}")
    out["launches"] = launches
    return out


def mesh_family_train(run, ranks, i, phase_no=22):
    """(d) the ranks' fp32 training against one device, as rank 0 held it
    (``mesh_runs._against_one``): phase 14 (b)'s rule for Trainer or
    train-step steps, each gradient leaf for a gradient call."""
    tag = f"phase {phase_no} {run['arch']}"
    for r, res in enumerate(ranks):
        check(res[i]["digests"] == ranks[0][i]["digests"],
              f"{tag}: rank {r}'s losses differ from rank 0's")
    st = ranks[0][i]["info"]["against_one"]
    worst = max(st["leaf"].values())
    name = max(st["leaf"], key=st["leaf"].get)
    if run["train"] == "grads":
        tol = run.get("grad_tol", FAMILY_GRAD_TOL)
        print(f"{tag} (d) fp32 gradients at depth "
              f"{run['grads_cut']['n_layers']}: loss rel {st['loss_rel']:.3e}"
              f" (tol {TRAIN_CPU_TOL:g}); worst leaf max |mesh - one| / max "
              f"|one| {worst:.3e} ({name}; tol {tol:g}) over "
              f"{len(st['leaf'])} leaves", flush=True)
        check(st["loss_rel"] <= TRAIN_CPU_TOL, f"{tag}: loss off")
        check(worst <= tol, f"{tag}: gradient {name} off by {worst:.3e}")
        return {"grads": st}
    info = ranks[0][i]["info"]
    share = run.get("flip_share", TRAIN_FLIP_SHARE)
    if run.get("gap") in ("kept", "read"):
        # a flip (Adam's: a gradient within fp32 noise of 0; int8's: within
        # noise of a level's midpoint) takes a step of another size; the
        # element share counts the flips, the update gap is read over the
        # other elements
        kept = max(st["leaf_kept"].values())
        outs = sorted(st["leaf_out"].items(), key=lambda kv: -kv[1])[:3]
        print(f"{tag} (d) worst leaf update-norm gap {worst:.3e} over every "
              f"element ({name}), {kept:.3e} over those within the element "
              f"bound; the leaves with most elements outside it {outs}",
              flush=True)
        worst, name = kept, max(st["leaf_kept"], key=st["leaf_kept"].get)
    loss_tol = run.get("loss_tol", TRAIN_CPU_TOL)
    print(f"{tag} (d) fp32 train: losses rel {st['loss_rel']:.3e} (tol "
          f"{loss_tol:g}); params: {st['n_out']} of {st['n']} elements "
          f"outside rtol {TRAIN_PARAM_RTOL:g} atol {TRAIN_PARAM_ATOL:g} "
          f"(share tol {share:g}), worst excess "
          f"{st['worst_excess']:.3e}, worst leaf update-norm gap {worst:.3e} "
          f"({name}; "
          f"{'read' if run.get('gap') == 'read' else f'tol {TRAIN_UPDATE_NORM_TOL:g}'}"
          f"); moments placed as the "
          f"params: {info['opt_layout'] == info['layout']}", flush=True)
    check(st["loss_rel"] <= loss_tol, f"{tag}: losses off")
    check(st["n_out"] <= share * st["n"],
          f"{tag}: {st['n_out']} of {st['n']} parameters outside the bound")
    steps = ranks[0][i]["tensors"]["loss"].numel()
    check(st["worst_excess"] <= 2 * steps * TRAIN_LR,
          f"{tag}: a parameter past the bound")
    check(run.get("gap") == "read" or worst <= TRAIN_UPDATE_NORM_TOL,
          f"{tag}: update of {name} off")
    check(info["opt_layout"] == info["layout"],
          f"{tag}: the moments are not placed as the params")
    return {"train": st}


def mesh_family_phase(dev, all_kernels, ranks=None):
    """Phase 22: the moe (phi3.5-moe; deepseek-v2's MLA and MoE), vlm
    (qwen2-vl-2b) and audio (seamless-m4t-medium) families over the (2, 2)
    mesh of four gloo ranks on the card, against the one-device run of the
    same code: (a) the bf16 prefill logits and greedy tokens, (b) K3's
    launches per rank per prefill, (c) MoE's routing and dropped entries
    per rank, two meshed prefills bit for bit, (d) the fp32 training, (e)
    K3 at each new local shape against its plain version, timed, (f) ms
    per prefill, decode step and train step per rank beside one device.
    ``ranks``: the ranks' results of ``mesh_family_jobs`` where they have
    run already (in phase 21's spawn); else the phase spawns its own."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    out = {"flash": family_flash_holds(dev, MESH_FAM_FLASH)}
    torch.cuda.empty_cache()  # the ranks hold their own memory
    serve, train = mesh_family_jobs()
    spawn_s = None
    if ranks is None:
        ranks, spawn_s = mesh_lm_spawn(
            4, "gloo", [dict(j, mesh=MESH_SHAPE) for j in serve + train])
    t1 = time.perf_counter()
    fault = {}
    with spying(lm_layers, "route", partial_router_fault(fault)):
        one = mesh_runs.in_process_lm(dev, [dict(j, step_logits=True)
                                            for j in serve])
    one_s = time.perf_counter() - t1
    out["runs"] = {}
    for i, run in enumerate(MESH_FAMILY_RUNS):
        r = mesh_family_serve(run, serve[i]["cfg"], ranks, one, i, fault)
        j = len(serve) + i
        r.update(mesh_family_train(run, ranks, j))
        st, ot = [x[j]["times"] for x in ranks], ranks[0][j]["times"]["one"]
        key = "step_s" if run["train"] == "steps" else "grads_s"
        r["times"] = {
            "prefill_ms": [1e3 * x[i]["times"]["prefill_s"] for x in ranks],
            "decode_step_ms": [1e3 * x[i]["times"]["decode_step_s"]
                               for x in ranks],
            f"{key[:-2]}_ms": [[1e3 * v for v in np.atleast_1d(x[key])]
                               for x in st],
            "one_prefill_ms": 1e3 * one[i]["times"]["prefill_s"],
            "one_decode_step_ms": 1e3 * one[i]["times"]["decode_step_s"],
            f"one_{key[:-2]}_ms": [1e3 * v for v in np.atleast_1d(ot[key])]}
        print(f"phase 22 {run['arch']} (f) per rank / one device: "
              f"{ {k: v for k, v in r['times'].items()} }", flush=True)
        out["runs"][run["arch"]] = r
    out["seconds"] = time.perf_counter() - t0
    spawned = (f"spawn {spawn_s:.1f} s" if spawn_s is not None
               else "its jobs ran in the shared spawn")
    print(f"phase 22 took {out['seconds']:.1f} s ({spawned}, rank 0's jobs "
          f"{[round(x['times']['job_s'], 1) for x in ranks[0]]} s; one "
          f"device's serve jobs {one_s:.1f} s)", flush=True)
    return out


def mesh_ssm_jobs():
    """Phase 23's jobs: each family's serve job, its fp32 witness (one
    greedy token), each family's training job, then the gradient call of
    the runs with ``grads`` (rank 0 holds those against one device itself:
    ``against_one``), then the witness with each of the run's planted
    ``faults``.  Returns (serve jobs, the other jobs)."""
    serve, witness, train, grads, faults = [], [], [], [], []
    for run in MESH_SSM_RUNS:
        base = dataclasses.replace(lm_config.get(run["arch"]), **run["cut"])
        cfg = dataclasses.replace(base, param_dtype="bfloat16",
                                  attn_impl=run["attn"])
        serve.append(dict(
            kind="serve", cfg=cfg, seed=23,
            max_len=run["prompt"] + MESH_FAM_GEN, gen=MESH_FAM_GEN,
            repeat=1, **family_batch(cfg, MESH_FAM_B, run["prompt"])))
        witness.append(dict(serve[-1], cfg=dataclasses.replace(
            cfg, dtype="float32"), gen=1, repeat=0,
            max_len=run["prompt"] + 1, keep=("logits", "tokens")))
        faults += [dict(witness[-1], fault=f) for f in run.get("faults", ())]
        fcfg = dataclasses.replace(base, dtype="float32")
        rng = np.random.default_rng(23)
        data = [{k: rng.integers(0, fcfg.vocab_size, (
            MESH_FAM_B, MESH_FAM_TRAIN_S)).astype(np.int32)
            for k in ("tokens", "labels")} for _ in range(MESH_TRAIN_STEPS)]
        mb = MESH_FAM_B // MESH_SSM_ACCUM
        for d in data:
            for m, share in enumerate(MESH_SSM_MASKED):
                rows = d["labels"][m * mb:(m + 1) * mb]
                rows[rng.uniform(size=rows.shape) < share] = -1
        if run.get("grads"):
            grads.append(dict(kind="grads", cfg=fcfg, seed=23, data=data,
                              keep=("loss", "term."),
                              against_one={"rtol": 0.0, "atol": 0.0}))
        train.append(dict(
            kind=run["train"], cfg=fcfg, seed=23, data=data,
            steps=MESH_TRAIN_STEPS, accum=MESH_SSM_ACCUM,
            grad_compression=run.get("grad_compression", "none"),
            opt={"learning_rate": TRAIN_LR}, keep=("loss",),
            against_one={"rtol": TRAIN_PARAM_RTOL,
                         "atol": TRAIN_PARAM_ATOL}))
    return serve, witness + train + grads + faults


def rel_err(got, want):
    """max |got - want| / max |want|, in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def mesh_ssm_witness(tag, ranks, one, i, j, tol=MESH_SSM_FP32_TOL):
    """The fp32 witness (job ``j``): the meshed prefill logits in fp32
    activations against one device's, within ``tol``, and its greedy
    tokens equal; beside it one device's own distance between its bf16
    (job ``i``) and fp32 logits.  Returns (the witness's reading, that
    distance)."""
    want = one[j]["tensors"]
    err = rel_err(ranks[0][j]["tensors"]["logits"], want["logits"])
    own = rel_err(one[i]["tensors"]["logits"], want["logits"])
    same = torch.equal(ranks[0][j]["tensors"]["tokens"], want["tokens"])
    print(f"{tag} (a) witness, fp32 activations: prefill logits max |mesh "
          f"- one| / max |one| {err:.3e} (tol {tol:g}), greedy "
          f"tokens equal: {same}; one device's bf16 logits against its fp32 "
          f"ones {own:.3e}", flush=True)
    check(err <= tol, f"{tag}: the fp32 mesh is off by {err:.3e}")
    check(same, f"{tag}: the fp32 mesh's greedy tokens differ")
    return err, own


def mesh_ssm_faults(tag, ranks, one, j, first, faults, tol):
    """The witness (job ``j``) with each planted fault of ``faults`` (jobs
    ``first`` on): its fp32 prefill logits against one device's must lie
    above the witness's ``tol``, so that the limit is seen to catch them.
    Returns {fault: reading}."""
    want = one[j]["tensors"]
    out = {}
    for k, fault in enumerate(faults):
        got = ranks[0][first + k]["tensors"]
        out[fault] = rel_err(got["logits"], want["logits"])
        same = torch.equal(got["tokens"], want["tokens"])
        print(f"{tag} (a) witness with the planted fault {fault}: prefill "
              f"logits max |mesh - one| / max |one| {out[fault]:.3e} (must "
              f"exceed {tol:g}), greedy tokens equal: {same}", flush=True)
        check(out[fault] > tol, f"{tag}: the planted fault {fault} reads "
              f"{out[fault]:.3e}, within the witness's limit {tol:g}")
    return out


def mesh_ssm_perturbed(dev, job, want):
    """The witness's second source, on one device: the witness job with
    every weight moved by one fp32 ulp, up or down by a seeded draw, its
    prefill logits against the unmoved run's (``want``): how far fp32
    rounding alone moves the logits through these blocks on this card."""
    params = lm_params.init_params(
        job["cfg"], torch.Generator(dev).manual_seed(job["seed"]), device=dev)
    gen = torch.Generator(dev).manual_seed(job["seed"])
    inf = torch.tensor(float("inf"), device=dev)

    def nudge(x):
        a = x.float()
        up = torch.rand(a.shape, generator=gen, device=dev) < 0.5
        return torch.where(up, torch.nextafter(a, inf),
                           torch.nextafter(a, -inf)).cpu().numpy()
    tree = tree_util.map(nudge, params)
    del params
    got = mesh_runs.in_process_lm(dev, [dict(job, params=tree)])[0]
    return rel_err(got["tensors"]["logits"], want["logits"])


def mesh_ssm_layouts(tag, cfg, res, max_len):
    """(d) placements: the recurrent cache (the SSM states and carries on
    "cache_batch" and "heads", the conv cache on "cache_batch" and "d_ff",
    the shared block's KV as the dense KV) on rank 0 as the rules place
    its logical axes; the moments and any int8 error buffers as the
    parameters."""
    from repro_torch.launch.mesh import make_mesh
    rules = MeshRules.for_mesh(make_mesh(MESH_SHAPE, mesh_runs.LM_AXES))
    want = {}

    def walk(lay, prefix=""):
        for k, e in lay.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(e, dict):
                walk(e, path)
            elif e[1] is not int:
                want[path] = (tuple(str(p) for p in rules.placements(
                    e[0], e[2])), rules.local_shape(e[0], e[2]))
    walk(lm_model.cache_layout(cfg, MESH_FAM_B, max_len))
    got = res["serve"]["info"]["cache_leaves"]
    info = res["train"]["info"]
    same = {"cache": got == want,
            "moments": info["opt_layout"] == info["layout"],
            "errors": info.get("err_layout", info["layout"])
            == info["layout"]}
    print(f"{tag} (d) placements on rank 0: cache {got}; by the logical "
          f"axes: {same['cache']}; moments as the params: "
          f"{same['moments']}; int8 error buffers as the params: "
          f"{same['errors'] if 'err_layout' in info else 'none'}",
          flush=True)
    check(all(same.values()), f"{tag}: placed otherwise than the rules "
          f"say: {same}")
    return same


def mesh_ssm_phase(dev, all_kernels, ranks=None):
    """Phase 23: the hybrid (zamba2-7b) and ssm (xlstm-1.3b) families over
    the (2, 2) mesh of four gloo ranks on the card, against the one-device
    run of the same code: (a) the fp32 witness, the planted faults it must
    catch and its second source (one device with every weight moved by
    one ulp), the bf16 prefill logits and greedy tokens, (b) K3's
    launches per rank per prefill, (c) two meshed prefills bit for bit,
    (d) the fp32 training with accumulation (and int8
    compression for xlstm) and the placements of the cache, moments and
    error buffers, (e) K3 at zamba2's local shape against its plain
    version, timed, (f) ms per prefill, decode step and train step per
    rank beside one device.  ``ranks``: the ranks' results of
    ``mesh_ssm_jobs`` where they have run already (in phase 21's spawn);
    else the phase spawns its own."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    out = {"flash": family_flash_holds(dev, MESH_SSM_FLASH)}
    torch.cuda.empty_cache()  # the ranks hold their own memory
    serve, rest = mesh_ssm_jobs()
    spawn_s = None
    if ranks is None:
        ranks, spawn_s = mesh_lm_spawn(
            4, "gloo", [dict(j, mesh=MESH_SHAPE) for j in serve + rest])
    n = len(serve)
    t1 = time.perf_counter()
    one = mesh_runs.in_process_lm(dev, [dict(j, step_logits=True)
                                        for j in serve] + rest[:n])
    one_s = time.perf_counter() - t1
    out["runs"] = {}
    g = 3 * n          # the gradient calls follow the training jobs
    f = g + sum(1 for run in MESH_SSM_RUNS if run.get("grads"))
    for i, run in enumerate(MESH_SSM_RUNS):
        j = 2 * n + i
        tag = f"phase 23 {run['arch']}"
        wtol = (SSM_CPU_TOL_FP32 if run.get("witness") == "scan tier"
                else MESH_SSM_FP32_TOL)
        witness, own = mesh_ssm_witness(tag, ranks, one, i, n + i, wtol)
        faults = run.get("faults", ())
        read = {"faults": mesh_ssm_faults(tag, ranks, one, n + i, f, faults,
                                          wtol)}
        f += len(faults)
        if run.get("perturbed"):
            read["ulp"] = mesh_ssm_perturbed(dev, rest[i],
                                             one[n + i]["tensors"])
            print(f"{tag} (a) witness's second source, one device against "
                  f"itself with every weight moved by one ulp: prefill "
                  f"logits {read['ulp']:.3e}; the mesh's reading "
                  f"{witness:.3e} is {witness / read['ulp']:.3f} of it",
                  flush=True)
        if run.get("logits_tol") == "own":
            run = dict(run, logits_tol=MESH_SSM_OWN_RATIO * own)
        r = mesh_family_serve(run, serve[i]["cfg"], ranks, one, i, {},
                              phase_no=23)
        r.update(fp32_logits_err=witness, own_bf16_err=own, **read)
        if run.get("grads"):
            r.update(mesh_family_train(dict(
                run, train="grads", grads_cut=run["cut"],
                grad_tol=FAMILY_GRAD_TOL_SCAN[run["arch"]]), ranks, g,
                phase_no=23))
            r["grads_ms"] = [1e3 * x[g]["times"]["grads_s"] for x in ranks]
            g += 1
        r.update(mesh_family_train(run, ranks, j, phase_no=23))
        r["placed"] = mesh_ssm_layouts(
            f"phase 23 {run['arch']}", serve[i]["cfg"],
            {"serve": ranks[0][i], "train": ranks[0][j]},
            serve[i]["max_len"])
        ot = ranks[0][j]["times"]["one"]
        r["times"] = {
            "prefill_ms": [1e3 * x[i]["times"]["prefill_s"] for x in ranks],
            "decode_step_ms": [1e3 * x[i]["times"]["decode_step_s"]
                               for x in ranks],
            "train_step_ms": [[1e3 * v for v in x[j]["times"]["step_s"]]
                              for x in ranks],
            "one_prefill_ms": 1e3 * one[i]["times"]["prefill_s"],
            "one_decode_step_ms": 1e3 * one[i]["times"]["decode_step_s"],
            "one_train_step_ms": [1e3 * v for v in ot["step_s"]]}
        print(f"phase 23 {run['arch']} (f) per rank / one device: "
              f"{ {k: v for k, v in r['times'].items()} }", flush=True)
        out["runs"][run["arch"]] = r
    out["seconds"] = time.perf_counter() - t0
    spawned = (f"spawn {spawn_s:.1f} s" if spawn_s is not None
               else "its jobs ran in the shared spawn")
    print(f"phase 23 took {out['seconds']:.1f} s ({spawned}, rank 0's jobs "
          f"{[round(x['times']['job_s'], 1) for x in ranks[0]]} s; one "
          f"device's serve jobs {one_s:.1f} s)", flush=True)
    return out


def engine_jobs():
    """Phase 24's jobs by (part, label): (a) the strategy engine, (b) the
    1-D layout, (c) the fused grid, (d) the API's runners.  A rank keeps
    its digests only; the in-process runs keep the tensors."""
    jobs = {}
    for s_, c_, m_ in PE_STRATEGY:
        jobs[("a", f"{s_} {c_}" + (f" {m_}" if s_ == "ring" else ""))] = dict(
            kind="strategy_block", strategy=s_, compaction=c_, ring_mode=m_,
            scenario=BLOCK_SCENARIO, n=N_MAIN, seed=0, dtype="fp32",
            chips_per_card=2, run=dict(BLOCK_KW, n_events=PE_EVENTS))
    block = dict(BLOCK_KW, eps=4.0 / N_MAIN, n_events=LAYOUT_EVENTS,
                 max_chunks=1)
    for c_, m_, b_ in PE_LAYOUTS:
        jobs[("b", f"{c_} {m_} B={b_}")] = dict(
            kind="layout", stepper="block", mix=[("plummer", N_MAIN)],
            repeat=b_, run=dict(block, compaction=c_, bucket_mode=m_))
    jobs[("c", f"fused {FUSED_MESH[0]}x{FUSED_MESH[1]}")] = dict(
        kind="layout", stepper="block", mix=[("plummer", N_LARGE)],
        repeat=FUSED_B, mesh=FUSED_MESH, run=dict(
            FUSED_KW, eps=4.0 / N_LARGE, compaction="gather",
            n_events=FUSED_EVENTS, max_chunks=1))
    for label, extra in PE_API.items():
        jobs[("d", label)] = dict(kind="api", cfg=dict(
            scenario=BLOCK_SCENARIO, n=N_MAIN, stepper="block",
            compaction="gather", eta=BLOCK_KW["eta"], validate_ic=False,
            **PE_API_KW, **extra))
    return jobs


def pe_hold(tag, ranks, ref, i):
    """Every rank's digests against the in-process run's (``ref``, the
    same job's result there); returns the per-rank readings."""
    want = {k: mesh_runs.digest(t) for k, t in ref["tensors"].items()}
    same = all(r[i]["digests"] == want for r in ranks)
    check(same, f"{tag}: a rank differs from the in-process run")
    rows = []
    for r in ranks:
        c, t = r[i]["counts"], r[i]["times"]
        ev = max(t["events"], 1)
        rows.append({"launches": {k: c[k] for k in ("acc_jerk_pot", "snap")},
                     "ms_per_event": t["ms_per_event"],
                     "host_reads_per_event": c["host_syncs"] / ev,
                     "collectives_per_event": c["collectives"] / ev})
        for name in ("acc_jerk_pot", "snap"):
            check(c[name] > 0, f"{tag}: {name} never launched on a rank")
    ip = ref["counts"]
    print(f"{tag:<34}: {len(ranks)} ranks bit for bit the in-process run "
          f"{same} ({len(want)} tensors); ms per event per rank "
          f"{[round(x['ms_per_event'], 3) for x in rows]} vs "
          f"{ref['times']['ms_per_event']:.3f} in-process; launches per rank "
          f"{rows[0]['launches']} (in-process "
          f"{ {k: ip[k] for k in ('acc_jerk_pot', 'snap')} }); host reads "
          f"{rows[0]['host_reads_per_event']:.3f} and collectives "
          f"{rows[0]['collectives_per_event']:.3f} per event per rank "
          f"(in-process reads {ip['host_syncs'] / max(ref['times']['events'], 1):.3f})",
          flush=True)
    return rows


def pe_state(res):
    return nbody.ParticleState(**{f: res["tensors"][f"state.{f}"]
                                  for f in nbody.FIELDS})


def pe_strategy(ranks, ref, jobs, labels):
    """(a): each strategy run's ranks against the in-process engine over
    ``[dev] * PE_P`` (``ref``, phase 10 (b)'s results, which hold the
    run's events, tiles, energy and gather == none), and K1/K2 launches per
    rank: events + 1, times p for the ring."""
    out = {}
    for i, (label, job) in enumerate(zip(labels, jobs)):
        tag = f"phase 24 (a) {label}"
        rows = pe_hold(tag, ranks, ref[i], i)
        events = int(ref[i]["tensors"]["carry.n_events"])
        per = (events + 1) * (PE_P if job["strategy"] == "ring" else 1)
        for r in rows:
            for name, n in r["launches"].items():
                check(n == per, f"{tag}: {name} launched {n} times on a "
                      f"rank, expected {per}")
        out[label] = dict(rows=rows, events=events,
                          in_process_ms=ref[i]["times"]["ms_per_event"])
    return out


def _on(dev, state):
    return nbody.ParticleState(**{f: getattr(state, f).to(dev)
                                  for f in nbody.FIELDS})


def pe_api(ranks, ref, labels, first):
    """(d): every rank's report against the in-process report over
    ``[dev] * PE_P`` in every field outside the wall clock."""
    out = {}
    for k, label in enumerate(labels):
        i = first + k
        tag = f"phase 24 (d) {label}"
        rows = pe_hold(tag, ranks, ref[k], i)
        want = {f: v for f, v in ref[k]["info"]["report"].items()
                if f not in PE_WALL}
        same = [{f: v for f, v in r[i]["info"]["report"].items()
                 if f not in PE_WALL} == want for r in ranks]
        rep = ranks[0][i]["info"]["report"]
        print(f"{tag:<34}: rank reports equal the in-process report outside "
              f"the wall clock {same}; devices {rep['devices']}, steps "
              f"{rep['steps']}, |dE/E| {rep['de_rel']:.3e}, wall "
              f"{rep['wall_s']:.3f} s per rank 0 vs "
              f"{ref[k]['info']['report']['wall_s']:.3f} s in-process",
              flush=True)
        check(all(same) and rep["devices"] == PE_P,
              f"{tag}: a rank's report differs from the in-process report")
        check(rep["de_rel"] <= DE_TIERS["fp32"], f"{tag}: |dE/E|")
        out[label] = dict(rows=rows, steps=rep["steps"])
    return out


def pe_shapes(dev, all_kernels, shapes):
    """K1 and K2 at each part's most launched per-rank shape (recorded in
    the in-process runs, whose slots launch what a rank launches), against
    plain, timed beside the bound."""
    out = {}
    for part, rec in shapes.items():
        for name in ("acc_jerk_pot", "snap"):
            n_launch, key = max((v[0], k) for k, v in rec.items()
                                if k[0] == name)
            x, kw = packed(name, *rec[key][1])
            # launch_readings takes batched operands: one run is a batch of 1
            x = tuple(t if t.dim() == 3 else t[None] for t in x)
            r = launch_readings(name, x, kw, all_kernels[name])
            tgt, src = key[1], key[2]
            shape = (tgt[0] if len(tgt) == 3 else 1, tgt[-2], src[-2])
            out[(name, part)] = dict(r, launches=n_launch, shape=shape)
            print(f"{name:<13} phase 24 {part:<18} per-rank shape B={shape[0]}"
                  f" x N_t={shape[1]} x N_s={shape[2]}: kernel {r['ms']:.4f} "
                  f"ms  plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f}"
                  f" ms ({r['bound_by']})  blocks {r['blocks']}  vs plain "
                  f"max normalised err {r['max_norm_err']:.3e}", flush=True)
            check(r["max_norm_err"] <= TOL["fp32"],
                  f"{name} phase 24 {part}: {r['max_norm_err']:.3e}")
    return out


def process_engines_phase(dev, all_kernels, ranks=None, strategy_ref=None):
    """Phase 24: the N-body engines over a process mesh of PE_P gloo ranks
    on the card, each rank's results bit for bit the in-process run's: (a)
    the strategy engine, (b) the 1-D batch layout against one slot, (c)
    the fused grid, (d) the API's runners; K1/K2 at the per-rank shapes.
    ``ranks``: the ranks' results of ``engine_jobs`` where they have run
    already (in phase 20's spawn); else the phase spawns its own.
    ``strategy_ref``: phase 10 (b)'s results, (a)'s in-process engine;
    else the phase runs phase 10 (b)'s runs itself."""
    t0 = time.perf_counter()
    torch.cuda.init()  # run alone, nothing has touched the card yet
    torch.cuda.empty_cache()  # the ranks hold their own memory
    named = engine_jobs()
    jobs = list(named.values())
    spawn_s = None
    if ranks is None:
        ranks, spawn_s = pm_spawn(PE_P, "gloo", dev, jobs)
    part = {k: [i for i, (p_, _) in enumerate(named) if p_ == k]
            for k in "abcd"}
    label = [lb for _, lb in named]
    secs = {}
    t1 = time.perf_counter()
    if strategy_ref is None:
        strategy_ref = strategy_block_runs(dev, all_kernels)
    secs["a"] = time.perf_counter() - t1
    shapes = dict(strategy_ref["shapes"])
    t1 = time.perf_counter()
    ref_b = mesh_runs.in_process([dev], [jobs[i] for i in part["b"]])
    secs["b"] = time.perf_counter() - t1
    rec = {}
    t1 = time.perf_counter()
    with recording(rec):
        ref_c = mesh_runs.in_process([dev] * PE_P,
                                     [jobs[i] for i in part["c"]])
    shapes["fused slot"] = rec
    secs["c"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    ref_d = mesh_runs.in_process([dev] * PE_P, [jobs[i] for i in part["d"]])
    secs["d"] = time.perf_counter() - t1
    torch.cuda.synchronize()
    out = {"transport": process_mesh.transport("gloo", dev)}
    print(f"phase 24: {PE_P} gloo ranks, {out['transport']}", flush=True)
    out["a"] = pe_strategy([[r[i] for i in part["a"]] for r in ranks],
                           strategy_ref["ref"], [jobs[i] for i in part["a"]],
                           [label[i] for i in part["a"]])
    out["b"] = {label[i]: pe_hold(f"phase 24 (b) {label[i]}", ranks, ref_b[k],
                                  i) for k, i in enumerate(part["b"])}
    out["c"] = {label[i]: pe_hold(f"phase 24 (c) {label[i]}", ranks, ref_c[k],
                                  i) for k, i in enumerate(part["c"])}
    for k, i in enumerate(part["b"] + part["c"]):
        res = (ref_b + ref_c)[k]["tensors"]
        check(bool(torch.isfinite(res["state.pos"]).all())
              and bool((res["carry.n_events"] > 0).all()),
              f"phase 24 {label[i]}: bad state")
    out["d"] = pe_api(ranks, ref_d, [label[i] for i in part["d"]],
                      part["d"][0])
    t1 = time.perf_counter()
    out["shapes"] = pe_shapes(dev, all_kernels, shapes)
    secs["shapes"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    spawned = (f"spawn {spawn_s:.1f} s" if spawn_s is not None
               else "its jobs ran in phase 20's spawn")
    per_part = {k: round(sum(ranks[0][i]["times"]["wall_s"]
                             for i in part[k]), 1) for k in "abcd"}
    print(f"phase 24 took {out['seconds']:.1f} s ({spawned}; rank 0's jobs "
          f"by part {per_part} s; the in-process runs and readings by part "
          f"{ {k: round(v, 1) for k, v in secs.items()} } s"
          f"{'' if secs['a'] > 1 else ' (a: phase 10 (b))'})", flush=True)
    return out

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no card, "
              "nothing run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"acc_jerk_pot": nbody_force.acc_jerk_pot_packed,
               "snap": nbody_force.snap_packed}
    plains = {"acc_jerk_pot": nbody_force._acc_jerk_plain,
              "snap": nbody_force._snap_plain}
    all_kernels = dict(kernels, flash_attention=fa.flash_attention)
    bi, bj = nbody_force.DEFAULT_BLOCK_I, nbody_force.DEFAULT_BLOCK_J

    phase("1. card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    nvml = Nvml()
    idle = []
    for _ in range(IDLE_READINGS):
        idle.append(nvml.power_w())
        time.sleep(IDLE_INTERVAL_S)
    idle_w = sum(idle) / len(idle)
    limit_w = nvml.power_limit_w()
    print(f"idle power (NVML, nothing run on the card yet): mean "
          f"{idle_w:.3f} W over {IDLE_READINGS} readings {IDLE_INTERVAL_S} s "
          f"apart (min {min(idle):.3f}, max {max(idle):.3f}), "
          f"{idle_w / limit_w:.4f} of the {limit_w:.2f} W limit "
          f"({nvml.name()}); the energy model's IDLE_FRAC is "
          f"{energy.IDLE_FRAC}", flush=True)

    phase("2. build")
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)

    phase("3. kernels vs plain versions on the card")
    errs = {}

    def hold(label, name, operands, dtype):
        cdt = ops.compute_dtype_for(dtype)
        got = kernels[name](*operands, block_i=bi, block_j=bj, compute_dtype=cdt)
        batch = operands[0].shape[0] if operands[0].dim() == 3 else 0
        want = nbody_force._plain(plains[name], operands, batch, eps=1e-7,
                                  block_i=bi, block_j=bj, compute_dtype=cdt)
        torch.cuda.synchronize()
        norm_err, abs_err = compare(name, got, want, operands[0], TOL[dtype])
        errs[(label, name, dtype)] = (norm_err, abs_err)
        print(f"{label:<28} {name:<13} {dtype:<6} max normalised err "
              f"{norm_err:.3e} (tol {TOL[dtype]:.0e})  max abs err "
              f"{abs_err:.3e}", flush=True)

    tgt, src, tacc, sacc = plummer_operands(N_MAIN, 0, dev, bi, bj)
    main_ops = {"acc_jerk_pot": (tgt, src), "snap": (tgt, src, tacc, sacc)}
    for dtype in ("fp32", "mixed"):
        for name in kernels:
            hold(f"plummer {N_MAIN}", name, main_ops[name], dtype)
    r_tgt, r_src, r_tacc, r_sacc = rect_operands(3000, 10000, dev, bi, bj)
    rect_ops = {"acc_jerk_pot": (r_tgt, r_src),
                "snap": (r_tgt, r_src, r_tacc, r_sacc)}
    for dtype in ("fp32", "mixed"):
        for name in kernels:
            hold("rect 3072x10240 masked", name, rect_ops[name], dtype)
    pairs = [plummer_operands(2048, seed, dev, bi, bj) for seed in (1, 2)]
    batch_ops = [torch.stack(xs) for xs in zip(*pairs)]
    for name, k in (("acc_jerk_pot", 2), ("snap", 4)):
        hold("batch B=2 plummer 2048", name, batch_ops[:k], "fp32")
    # the lanes' partials meet in a fixed order, with no atomics
    for dtype in ("fp32", "mixed"):
        cdt = ops.compute_dtype_for(dtype)
        for name in kernels:
            first = kernels[name](*main_ops[name], block_i=bi, block_j=bj,
                                  compute_dtype=cdt)
            second = kernels[name](*main_ops[name], block_i=bi, block_j=bj,
                                   compute_dtype=cdt)
            torch.cuda.synchronize()
            same = torch.equal(first, second)
            print(f"plummer {N_MAIN} {name:<13} {dtype:<6} two launches "
                  f"give the same bits: {same}", flush=True)
            check(same, f"{name} {dtype}: two launches differ")

    phase("4. golden replays and the main path")
    for fname in ("two_body.json", "plummer16.json"):
        with open(os.path.join(ROOT, "tests", "golden", fname)) as f:
            doc = json.load(f)
        m = doc["meta"]
        for dtype in ("fp32", "mixed"):
            st = nbody.zeros_like_state(
                *(torch.tensor(doc[k], dtype=torch.float64, device=dev)
                  for k in ("pos0", "vel0", "mass")))
            out = hermite.evolve_scan(
                st, make_evaluator(order=m["order"], eps=m["eps"], dtype=dtype),
                n_steps=m["n_steps"], dt=m["dt"], order=m["order"])
            dev_pos = float(np.abs(out.pos.cpu().numpy() - np.asarray(doc["pos"])).max())
            dev_vel = float(np.abs(out.vel.cpu().numpy() - np.asarray(doc["vel"])).max())
            print(f"golden {fname:<15} {dtype:<6} max |dpos| {dev_pos:.3e} "
                  f"|dvel| {dev_vel:.3e} (tol {GOLDEN_TOL[dtype]:.0e})", flush=True)
            check(max(dev_pos, dev_vel) <= GOLDEN_TOL[dtype],
                  f"golden {fname} {dtype} off by {max(dev_pos, dev_vel):.3e}")

    launches, step_ms, main_steps = {}, {}, {}
    for dtype, t_end in (("fp32", T_END), ("mixed", T_END_MIXED)):
        for k in all_kernels.values():
            k.launches = 0
        r = nbody_run.run(n=N_MAIN, t_end=t_end, eta=ETA, seed=0, dtype=dtype,
                          device=dev)
        counts = {name: k.launches for name, k in kernels.items()}
        check(fa.flash_attention.launches == 0,
              f"main path {dtype}: the flash kernel ran on the N-body path")
        launches[dtype] = counts
        step_ms[dtype] = 1e3 * r["wall_s"] / max(r["steps"], 1)
        main_steps[dtype] = r["steps"]
        out = r["state"]
        print(f"main path {dtype}: N={N_MAIN} t={r['t']:.6f} steps={r['steps']} "
              f"evaluations={r['evals']} launches={counts} "
              f"wall={r['wall_s']:.3f} s ({step_ms[dtype]:.4f} "
              f"ms/step) |dE/E|={r['de_rel']:.3e} (tier {DE_TIERS[dtype]:.0e})",
              flush=True)
        for name, c in counts.items():
            check(c > 0, f"main path {dtype}: kernel {name} never launched")
            check(c == r["evals"], f"main path {dtype}: {name} launched {c} "
                                   f"times for {r['evals']} evaluations")
        check(abs(r["t"] - t_end) < 1e-12, f"main path {dtype} stopped at t={r['t']}")
        check(all(bool(torch.isfinite(x).all()) for x in (out.pos, out.vel, out.acc))
              and tuple(out.pos.shape) == (N_MAIN, 3), f"main path {dtype}: bad state")
        check(r["de_rel"] <= DE_TIERS[dtype],
              f"main path {dtype}: |dE/E| {r['de_rel']:.3e} > {DE_TIERS[dtype]}")

    phase("5. timings (CUDA events)")
    timings = {}
    large = plummer_operands(N_LARGE, 0, dev, bi, bj)
    shapes = {N_MAIN: main_ops,
              N_LARGE: {"acc_jerk_pot": large[:2], "snap": large}}
    for n, ops_n in shapes.items():
        for name in kernels:
            for dtype in ("fp32", "mixed"):
                cdt = ops.compute_dtype_for(dtype)
                x = ops_n[name]

                def k_call():
                    return kernels[name](*x, block_i=bi, block_j=bj, compute_dtype=cdt)

                def p_call():
                    return plains[name](*x, eps=1e-7, block_i=bi, block_j=bj,
                                        compute_dtype=cdt)

                kr = 10 if n == N_MAIN else 3
                ms = cuda_ms(k_call, kr)
                # at N_LARGE one call, its first (1 to 3.5 s each: a
                # warm-up doubled that, cut for time)
                pms = cuda_ms(p_call, 3 if n == N_MAIN else 1,
                              warmup=1 if n == N_MAIN else 0)
                bms, by = bound_ms(name, dtype, int((x[0][..., 3] != 0).sum()),
                                   x[0].shape[0], x[1].shape[1])
                timings[(name, dtype, n)] = (ms, pms, bms, by)
                print(f"{name:<13} {dtype:<6} N={n:<6} kernel {ms:.4f} ms  "
                      f"plain {pms:.4f} ms  bound {bms:.4f} ms ({by})  "
                      f"bound/kernel {bms / ms:.3f}", flush=True)

    # the block path's shapes: gathered targets against N_MAIN sources
    systems = {0: main_ops["snap"]}
    for seed in range(1, ENSEMBLE_B):
        systems[seed] = plummer_operands(N_MAIN, seed, dev, bi, bj)
    block_ops = {label: (block_operands(systems, batch, n_t, bi_s), bi_s)
                 for label, batch, n_t, bi_s in BLOCK_SHAPES}
    for label, batch, n_t, _ in BLOCK_SHAPES:
        x4, bi_s = block_ops[label]
        for name in kernels:
            x = x4[:2] if name == "acc_jerk_pot" else x4
            for dtype in ("fp32", "mixed"):
                cdt = ops.compute_dtype_for(dtype)

                def k_call():
                    return kernels[name](*x, block_i=bi_s, block_j=bj,
                                         compute_dtype=cdt)

                def p_call():
                    return nbody_force._plain(
                        plains[name], x, batch, eps=1e-7, block_i=bi_s,
                        block_j=bj, compute_dtype=cdt)

                kernels[name].blocks = {}
                ms = cuda_ms(k_call, 20)
                grids = kernels[name].blocks  # as the launcher reports
                check(len(grids) == 1, f"{name} {label}: grids {grids}")
                blocks = next(iter(grids))
                pms = cuda_ms(p_call, 1, warmup=1)
                bms, by = bound_ms(name, dtype, int((x[0][..., 3] != 0).sum()),
                                   x[0].shape[-2], x[1].shape[-1],
                                   batch=max(batch, 1))
                timings[(name, dtype, label)] = (ms, pms, bms, by, blocks)
                print(f"{name:<13} {dtype:<6} block {label:<14} N_t="
                      f"{x[0].shape[-2]:<5} N_s={N_MAIN} blocks {blocks:<3} "
                      f"kernel {ms:.4f} ms  plain {pms:.4f} ms  bound "
                      f"{bms:.4f} ms ({by})  bound/kernel {bms / ms:.3f}",
                      flush=True)

    for dtype in ("fp32", "mixed"):
        k_ms = sum(timings[(name, dtype, N_MAIN)][0] for name in kernels)
        print(f"step breakdown {dtype}: the two kernels take {k_ms:.4f} ms of "
              f"{step_ms[dtype]:.4f} ms per step ({100 * k_ms / step_ms[dtype]:.1f}%); "
              f"the rest is float64 predict/correct, packing and the host",
              flush=True)

    cfg = lm_config.get(LM_ARCH)
    lm_shape = (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    prefill = (LM_BATCH, LM_PROMPT, LM_PROMPT) + lm_shape[2:]  # b sq sk h kv d
    flash_t = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_operands(*prefill, dtype, dev)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 10)
        pms = cuda_ms(lambda: fa._flash_plain(q, k, v, causal=True,
                                              block_q=512, block_k=512),
                      3, warmup=1)
        backends = sdpa_backends(q, k, v)
        for name, (bms_, how) in backends.items():
            print(f"  sdpa {str(dtype)[6:]} backend {name}: "
                  + (f"{bms_:.4f} ms ({how})" if bms_ is not None else how),
                  flush=True)
        timed = {n: r for n, r in backends.items() if r[0] is not None}
        check(bool(timed), f"no SDPA backend accepts the {dtype} prefill")
        lname = min(timed, key=lambda n: timed[n][0])
        lms = timed[lname][0]
        bms, by = flash_bound_ms(*lm_shape, dtype)
        fma = ""
        if dtype == torch.float32:
            fma_ms = flash_bound_ms(*lm_shape, dtype, exact_fp32=True)[0]
            fma = f" (as fp32 FMAs {fma_ms:.4f} ms, bound/kernel {fma_ms / ms:.3f})"
        flash_t[dtype] = (ms, pms, lms, bms, by, lname)
        print(f"flash_attention {str(dtype)[6:]:<8} B={LM_BATCH} S={LM_PROMPT} "
              f"H={cfg.n_heads} KV={cfg.n_kv_heads} D={cfg.head_dim} causal: "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms  sdpa {lms:.4f} ms "
              f"(fastest backend {lname})  bound {bms:.4f} ms ({by})  "
              f"bound/kernel {bms / ms:.3f}{fma}", flush=True)
        del q, k, v

    phase("6. flash attention (K3) vs its plain version on the card")
    flash_errs = {}
    for label, (b, sq, sk, h, kvh, d), dtype, causal, (bq, bk) in flash_cases(
            prefill):
        q, k, v = flash_operands(b, sq, sk, h, kvh, d, dtype, dev, seed=sq + sk)
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        r = flash_readings(q, k, v, causal, bq, bk)
        flash_errs[(label, tag)] = r
        more = "" if tag == "fp32" else (
            f"  element-wise {r['elem']:.3f} of the limit  vs the kernel's "
            f"{KERNEL_KEY_TILE}-key tile: {100 * r['tile_share']:.4f}% differ "
            f"(tol {100 * TILE_SHARE_TOL:g}%)")
        print(f"flash {label:<10} {tag} B={b} Sq={sq} Sk={sk} H={h} KV={kvh} "
              f"D={d} causal={causal}: max normalised err {r['norm_err']:.3e}"
              f"  max abs err {r['abs_err']:.3e}{more}", flush=True)
        failed = flash_failures(r, tag)
        check(not failed, f"flash {label} {tag}: {'; '.join(failed)}")
        del q, k, v
    rows_sum = {}
    long_rows = {"long 8k": (1, 8192, 8192, 16, 8, 128),
                 "long 32k": (1, 32768, 32768, 16, 8, 128)}
    for (label, shape), (dtype, tag) in itertools.product(
            {"prefill": prefill, **long_rows}.items(),
            ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))):
        q, k, _ = flash_operands(*shape, dtype, dev, seed=5)
        out = fa.flash_attention(q, k, torch.ones_like(k), causal=True)
        torch.cuda.synchronize()
        err = float((out.float() - 1.0).abs().max())
        rows_sum[(label, tag)] = err
        print(f"flash rows sum to one {tag} (v = 1, {label} shape, Sk="
              f"{shape[2]}): max |out - 1| {err:.3e} (tol "
              f"{ROWS_TOL[tag]:.1e})", flush=True)
        check(err <= ROWS_TOL[tag],
              f"flash rows-sum-to-one {tag} {label}: {err:.3e}")
        del q, k, out

    phase("7. serve path: qwen3-0.6b at full width")
    serve = serve_path(cfg, dev, all_kernels)

    phase("8. block ensembles on the card")
    block = block_phase(dev, kernels, plains, block_ops, all_kernels)

    phase("9. the simulation API and CLI on the card")
    api_r = api_phase(dev, all_kernels, block, {
        "steps": main_steps["fp32"], "step_ms": step_ms["fp32"]}, nvml)

    phase("10. the distribution strategies on the card")
    strat = strategy_phase(dev, all_kernels, block, nvml)

    phase("11. the Ahmad-Cohen neighbor scheme at full size")
    nbr = neighbor_phase(dev, all_kernels)

    phase("12. the simulation server at full size")
    srv = serve_phase(dev, all_kernels)

    phase("13. the batch layouts and the fused mesh on the card")
    lay = layout_phase(dev, all_kernels)

    phase("14. training: qwen3-0.6b at full width")
    train = train_phase(dev, all_kernels)

    phase("15. serving the moe, vlm and audio families at full width")
    fam = families_phase(dev, all_kernels)

    phase("16. serving the ssm and hybrid families at full width")
    ssm_r = ssm_phase(dev, all_kernels)

    phase("17. the dry-run against real steps on the card")
    dryrun_phase(dev, all_kernels)

    phase("18. training the moe, MLA, vlm, audio, ssm and hybrid families")
    train_families_phase(dev, all_kernels)

    phase("19. the examples: cluster simulation and scenario tour")
    examples_phase(dev, all_kernels)

    phase("20. the strategies over a process mesh")
    # phases 24 and 21 to 23 run their jobs on phase 20's four ranks
    ckpt = tempfile.mkdtemp(prefix="mesh_ckpt_")
    lm_jobs, fam_jobs = mesh_lm_jobs(ckpt), sum(mesh_family_jobs(), [])
    pe_jobs = list(engine_jobs().values())
    pm = process_mesh_phase(dev, all_kernels, extra_jobs=[
        dict(j, keep=False) for j in pe_jobs] + [
        dict(j, mesh=MESH_SHAPE)
        for j in lm_jobs + fam_jobs + sum(mesh_ssm_jobs(), [])])
    n_pe = len(pe_jobs)

    phase("21. the dense LM over a device mesh")
    try:
        mesh_lm = mesh_lm_phase(dev, all_kernels, ranks=[
            r[n_pe:] for r in pm["extra_ranks"]], ckpt=ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    n_fam = len(fam_jobs)

    phase("22. the moe, vlm and audio families over a device mesh")
    mesh_fam = mesh_family_phase(dev, all_kernels, ranks=[
        r[:n_fam] for r in mesh_lm["extra"]])

    phase("23. the ssm and hybrid families over a device mesh")
    mesh_ssm = mesh_ssm_phase(dev, all_kernels, ranks=[
        r[n_fam:] for r in mesh_lm["extra"]])

    phase("24. the N-body engines over a process mesh")
    eng = process_engines_phase(dev, all_kernels, ranks=[
        r[:n_pe] for r in pm["extra_ranks"]], strategy_ref=strat["block"])

    rows = []
    for name in kernels:
        ms, pms, bms, by = timings[(name, "fp32", N_MAIN)]
        ms_l, pms_l, bms_l, _ = timings[(name, "fp32", N_LARGE)]
        ms_m, pms_m, bms_m, _ = timings[(name, "mixed", N_MAIN)]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches["fp32"][name],
            "max_abs_err": errs[(f"plummer {N_MAIN}", name, "fp32")][1],
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "n": N_MAIN, "dtype": "fp32",
            "max_norm_err": errs[(f"plummer {N_MAIN}", name, "fp32")][0],
            "tol": TOL["fp32"],
            "launches_mixed": launches["mixed"][name],
            "ms_mixed": ms_m, "plain_ms_mixed": pms_m, "bound_ms_mixed": bms_m,
            "ms_n65536": ms_l, "plain_ms_n65536": pms_l,
            "bound_ms_n65536": bms_l,
            "ms_mixed_n65536": timings[(name, "mixed", N_LARGE)][0],
            "bound_ms_mixed_n65536": timings[(name, "mixed", N_LARGE)][2],
            "launches_block_gather": block["runs"]["gather"]["counts"][name],
            "launches_block_none": block["runs"]["none"]["counts"][name],
            "launches_block_padded": block["padded"]["counts"][name],
            "launches_fixed_ensemble": block["fixed"]["counts"][name],
            "launches_adaptive_ensemble": block["adaptive"]["counts"][name],
            "launches_api_single": api_r["single"]["counts"][name],
            "launches_api_block": api_r["block"]["counts"][name],
            "launches_api_mixed": api_r["mixed"]["counts"][name],
            "blocks_per_launch_block_gather":
                block["runs"]["gather"]["blocks"],
            "launches_process_mesh": {
                f"{part} {label}": [c[name] for c in per_rank]
                for part in ("table1", "nccl")
                for label, per_rank in pm[part]["launches"].items()},
            "launches_process_engines": {
                f"{part} {label}": [r_["launches"][name] for r_ in rows_]
                for part in "bc" for label, rows_ in eng[part].items()} | {
                f"a {label}": [r_["launches"][name] for r_ in r["rows"]]
                for label, r in eng["a"].items()} | {
                f"d {label}": [r_["launches"][name] for r_ in r["rows"]]
                for label, r in eng["d"].items()},
            "process_engine_shapes": {
                f"{part_} {'x'.join(map(str, r['shape']))}": {
                    k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "pairs", "blocks",
                                      "launches", "max_norm_err",
                                      "max_abs_err")}
                for (n_, part_), r in eng["shapes"].items() if n_ == name},
            "launches_table1": {
                f"{s_} {d_}" + (f" {m_}" if m_ else ""): r["counts"][name]
                for (s_, d_, m_), r in strat["table1"].items()},
            "launches_block_strategies": {
                label: r["counts"][name]
                for label, r in strat["block"]["runs"].items()},
            "launches_cli_strategies": {
                k: strat["cli"][k]["counts"][name]
                for k in ("single", "block")},
            "launches_neighbor_ab": {
                f"{src_} {dt_}": r["counts"][name]
                for (src_, dt_), r in nbr["runs"].items()},
            "launches_server": {k: srv[k]["counts"][name]
                                for k in ("full", "neighbor")},
            "launches_batch_layouts": {
                k: r["counts"][name] for k, r in lay["batch"].items()},
            "launches_fused": {
                k: lay["fused"][k]["counts"][name]
                for k in ("fused 2x2", "1-D x2", "one slot")},
            "fused_grids": {
                k: lay["fused"][k]["grids"][name]
                for k in ("fused 2x2", "1-D x2", "one slot")},
            "fused_slot_shapes": {
                f"{label_} {'x'.join(map(str, r['shape']))}": {
                    k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "pairs", "blocks", "sms",
                                      "launches", "max_norm_err",
                                      "max_abs_err")}
                for (n_, label_), r in lay["fused"]["slot_shapes"].items()
                if n_ == name},
            "launches_mesh_server": {
                f"{s_} {l_}": r["counts"][name]
                for (s_, l_), r in lay["serve"].items()},
            "window_shapes": {
                "x".join(map(str, shape_)): v
                for (n_, shape_), v in nbr["window_timings"].items()
                if n_ == name},
            "near_max_norm_err": {
                dt_: max(e[0] for e in r["errs"].values())
                for dt_, r in nbr["near"].items()},
            "strategy_shapes": {
                label: {"ms": ms_, "bound_ms": b_, "bound_by": by_,
                        "n_t": sh_[0], "n_s": sh_[1]}
                for (n_, label), (ms_, b_, by_, sh_)
                in strat["shapes"].items() if n_ == name},
            "block_shapes": {
                f"{label} {dtype}": {
                    "ms": timings[(name, dtype, label)][0],
                    "plain_ms": timings[(name, dtype, label)][1],
                    "bound_ms": timings[(name, dtype, label)][2],
                    "bound_by": timings[(name, dtype, label)][3],
                    "blocks": timings[(name, dtype, label)][4],
                    "max_norm_err": block["holds"][(label, name, dtype)][0]}
                for label, *_ in BLOCK_SHAPES
                for dtype in ("fp32", "mixed")},
        })
    ms, pms, lms, bms, by, lname = flash_t[torch.bfloat16]
    ms32, pms32, lms32, bms32, _, lname32 = flash_t[torch.float32]
    rows.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": REPLACES["flash_attention"],
        "launches": serve["launches"],
        "max_abs_err": flash_errs[("prefill", "bf16")]["abs_err"],
        "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
        "library_ms": lms, "library": f"sdpa {lname}",
        "shape": dict(zip("b s h kv d".split(), lm_shape)), "causal": True,
        "dtype": "bf16", "max_norm_err": flash_errs[("prefill", "bf16")]["norm_err"],
        "elem_limit_used": flash_errs[("prefill", "bf16")]["elem"],
        "tol": "|kernel - plain| <= 2**-7 (|plain| + A) element-wise",
        "tile_share": flash_errs[("prefill", "bf16")]["tile_share"],
        "tile_share_tol": TILE_SHARE_TOL,
        "launches_prefill": serve["launches_prefill"],
        "launches_decode": serve["launches_decode"],
        "launches_train_serve": train["serve"]["launches"],
        "ms_fp32": ms32, "plain_ms_fp32": pms32, "library_ms_fp32": lms32,
        "library_fp32": f"sdpa {lname32}",
        "bound_ms_fp32": bms32,
        "bound_ms_fp32_as_fma": fma_ms,
        "max_norm_err_fp32": flash_errs[("prefill", "fp32")]["norm_err"],
        "max_norm_err_fp32_sk8192": flash_errs[("long 8k", "fp32")]["norm_err"],
        "max_norm_err_fp32_sk32768":
            flash_errs[("long 32k", "fp32")]["norm_err"],
        "rows_sum_err_fp32": {label: err for (label, tag), err
                              in rows_sum.items() if tag == "fp32"},
        "rows_sum_err_bf16": {label: err for (label, tag), err
                              in rows_sum.items() if tag == "bf16"},
        "launches_families": {
            arch: {"prefill": r["k3_prefill"], "decode_step": r["k3_decode"]}
            for arch, r in fam["runs"].items()},
        "family_shapes": {
            label: {k: r[k] for k in (
                "shape", "causal", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library", "abs_err", "norm_err", "elem",
                "tile_share")}
            for label, r in fam["flash"].items()},
        "launches_ssm": {
            label: {"prefill": r["k3_prefill"], "decode_step": r["k3_decode"]}
            for label, r in ssm_r["runs"].items()},
        "ssm_shapes": {
            label: {k: r.get(k) for k in (
                "shape", "causal", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library", "abs_err", "norm_err", "elem",
                "tile_share")}
            for label, r in ssm_r["flash"].items()},
        "launches_mesh_prefill_per_rank": mesh_lm["launches"],
        "mesh_local_shape": mesh_lm["flash"],
        "launches_mesh_families_prefill_per_rank": {
            arch: r["launches"] for arch, r in mesh_fam["runs"].items()},
        "mesh_family_shapes": {
            label: {k: r[k] for k in (
                "shape", "causal", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library", "abs_err", "norm_err", "elem",
                "tile_share")}
            for label, r in mesh_fam["flash"].items()},
        "launches_mesh_ssm_prefill_per_rank": {
            arch: r["launches"] for arch, r in mesh_ssm["runs"].items()},
        "mesh_ssm_shapes": {
            label: {k: r[k] for k in (
                "shape", "causal", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library", "abs_err", "norm_err", "elem",
                "tile_share")}
            for label, r in mesh_ssm["flash"].items()},
    })
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
