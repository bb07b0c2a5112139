#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line (or one per kernel or run):

1. ``device`` — the card as ``nvidia-smi`` names it, its power limit, and
   the torch/CUDA versions;
2. ``build`` — nvcc builds the eight CUDA sources of
   ``src/repro_torch/kernels/csrc`` (one nvcc each, all at once);
3. ``kernel`` — each kernel against its plain PyTorch version on the card,
   in the working dtype, on inputs drawn from a seeded generator: K1/K2
   at the paged serving path's shapes (page 16, tables covering 1024
   tokens: internlm2's 8 requests × 16 heads over 8 kv heads, hd 128,
   granite-moe's 24 heads over 8, hd 64, stablelm's 32 over 32, hd 64,
   and qwen1.5's 64 over 8, hd 128) and a smoke shape; K3 (flash
   attention) at internlm2's first prompt chunk and full prompt, a gemma3
   local layer, a zamba2 prompt (hd 64), deepseek-v2's MLA prefill (128
   heads, q/k 192 wide, V 128), whisper-base's 1,500-frame encoder and
   its cross-attention at Sq = 1 and 64, and a smoke shape; K4 (decode
   attention) at the chunked-prefill continuation, a dense batch, a
   gemma3 global layer, a windowed batch and granite-moe's dense batch
   (hd 64); K5 (grouped matmul) at the capacities the MoE code
   gives granite-moe's serving traffic (paged and dense decode, a prefill
   of each prompt length served, a 400- and a 1024-token prefill),
   deepseek-v2's (160 experts, D 5120, F 1536: the dense decode's C 32
   and a prefill's C 8) and a ragged smoke shape; K6 (the Mamba-2 SSD
   scan, f32) at mamba2 prefills
   of 32, 65, 256, 768 and 1024 tokens, a zamba2 prefill of 1024, a batch
   of 3 and a ragged smoke shape.  Kernel, plain-version and library
   (``scaled_dot_product_attention``, ``torch.bmm``; none computes K6)
   times (``time_ms``: cold, clean L2, and the window enqueued whole
   before the card reaches it, with the count of late windows), the
   bound from the bytes and operations each call needs, the achieved
   TFLOP/s and the share of the bound reached, and the host time of one
   call; for K6 also the device kernels one call launches, from
   ``torch.profiler``, whose lines a full run prints after phase 14 (the
   profiler runs after every serve phase's host times);
4. ``simulator`` — the paper's Spark-fidelity simulator
   (``repro_torch.core.spark_sim``, host only): sort, WC and grep in one
   6 GB executor under FAIR and under MURS, and each job alone; every
   field of every ``ServiceMetrics`` equal to SIM_EXPECTED (the CPU
   rehearsal's), MURS suspending and grep finishing sooner under MURS;
5. ``serve`` — internlm2-1.8b at full width (24 layers, d 2048, hd 128,
   vocab 92,544; random bf16 weights from a seed) served by the port's
   MURS engine over a paged KV pool sized to force suspensions, first
   through the paged-decode kernel, then (shorter) through its int8
   sibling.  Launch counters are zeroed just before each run and read
   just after: K1 (or K2) runs once per layer of each paged decode tick,
   K3 once per layer of each ``prefill``, K4 once per layer of each
   ``decode_step`` (the chunked-prefill continuation); every request must
   complete;
6. ``serve-gemma3`` — gemma3-1b at full width (26 layers, 5:1 local:global,
   window 512, d 1152, hd 256, one kv head, vocab 262,144, tied
   embeddings) through the same engine: every decode tick takes the
   dense path (K4 on the 4 global layers, the plain ring decode on the 22
   local ones) and every prefill runs K3 on all 26 layers;
7. ``reference`` — internlm2: one full-width decode step through K1
   against the dense step through K4 and the dense step of the plain
   versions on the same caches; gemma3: a 768-token prefill and 8 decode
   steps through K3/K4 against the same inside ``ops.plain_on_card``;
   logits within LOGIT_ATOL, and each row's argmax equal unless the
   reference's top-2 margin is under two bf16 ulps (a near-tie);
8. ``serve-cluster`` and ``migration-parity`` — the service: a front
   door (MURS shedding, a token bucket on bulk) over two replicas of
   full-width internlm2 that share its parameters on the card, each
   configured as ``serve``'s engine with a pool of its own; a seeded
   Poisson trace of two tenants (chat and bulk, 3:1); KV checkpoints
   every CLUSTER_CKPT_EVERY ticks; replica 1 slowed until the straggler
   pass migrates work off it; replica 0 crashed and restored from its
   newest checkpoint.  Every submission has one outcome, every admitted
   request completes, the door sheds and rate-limits, every migration
   lands, every restore is ``live`` or ``suffix``, each replica's newest
   checkpoint file reads back bit-equal to its snapshot, K1, K3 and K4
   run once per layer of each paged tick, ``prefill`` and
   ``decode_step``, and every count is the CPU rehearsal's
   (CLUSTER_COUNTS).  Then one request migrated mid-decode keeps the
   tokens it gets alone on one engine, or flips first at a near-tie;
9. ``serve-granite-moe`` — granite-moe-3b-a800m at full width (32 layers,
   d 1536, 24 heads, 8 KV heads, hd 64, 40 experts top-8, d_ff_expert
   512, vocab 49,155, tied embeddings) on the paged path under MURS:
   K5 runs three times per layer of every model call (``prefill``,
   ``decode_step``, ``decode_step_paged``), K1/K3/K4 once per layer of
   theirs; K5 stays at 0 in the internlm2 and gemma3 runs.  Every K5
   shape this run and the next phase launch is held to the plain version
   (the kernel phase's, or checked after the run);
10. ``reference`` — granite-moe, in f32 and in bf16: a prefill and a
   paged decode step from equal caches through the kernels and inside
   ``ops.plain_on_card``: logits, argmax and the (layer, token) top-k
   expert sets that differ between the two; in bf16 also the plain run
   with every dispatch pinned to the kernel run's gates;
11. ``serve-mamba2`` and ``serve-zamba2`` — mamba2-2.7b (64 Mamba-2
   layers, d 2560, 80 heads of 64, ds 128, vocab 50,280) and zamba2-1.2b
   ((mamba ×5, shared_attn) ×6 + mamba ×2, d 2048, ds 64, the shared
   attention 32 heads of 64, vocab 32,000) at full width on the dense
   path, under a pool of fewer requests' constant state than slots:
   K6 once per Mamba layer of every ``prefill``, zamba2's shared
   attention K3 per ``prefill`` and K4 per ``decode_step``; K1, K2 and K5
   never.  Every K6 shape they launch is held to the plain version;
12. ``reference`` — mamba2 and zamba2, in f32 and in bf16: a 1024- and a
   777-token prefill and 8 decode steps through the kernels and inside
   ``ops.plain_on_card``: logits and argmax.
13. ``serve-stablelm`` and ``serve-deepseek-v2`` — stablelm-1.6b at full
   width and depth (24 layers, d 2048, MHA 32 heads of 64, vocab
   100,352) through ``serve``'s engine with its tenants B and C on the
   paged path, over STABLELM_POOL_PAGES; deepseek-v2 at full width and
   4 of its 60 layers (d 5120, MLA over 128 heads with a 512-wide latent
   and a 64-wide rope key, 160 routed experts top-6 and 2 shared, vocab
   102,400; 60 layers do not fit one card) on serve-granite-moe's engine
   and traffic on the dense path, over DEEPSEEK_POOL_PAGES.  Every
   request completes, MURS suspends, launches as in phase 5 (K1 only on
   stablelm; K5 three per layer of every model call only on deepseek,
   every launched K5 shape held to the plain version; no K4 on
   deepseek, whose MLA decode has no kernel), and the schedule equals
   the CPU rehearsal's (STABLELM_COUNTS, DEEPSEEK_COUNTS);
14. ``reference-zoo`` — through the kernels against the plain versions
   inside ``ops.plain_on_card``: stablelm and qwen1.5-110b (full width,
   4 of 80 layers) as phase 7 does internlm2 (a paged K1 step against
   the dense K4 step and the plain step); deepseek-v2 as phase 10 does
   granite (bf16 at 4 layers, routing pinned to the kernel run's gates
   and the unpinned top-k flips counted; f32 at 2 layers, no flip); and
   whisper-base (1,500 frames) and internvl2-26b (full depth in bf16
   within INTERNVL2_BF16_LOGIT_ATOL; 4 layers in f32 within
   F32_LOGIT_ATOL; 256 patch embeddings) at the model level,
   ``prefill(extra=...)`` of a 64-token prompt and 8 decode steps, with
   their K3/K4 launch counts.
15. training — ``train-kernel``: K3's backward (``flash_attention_bwd``,
   after K3's forward saving its log-sum-exp) against autodiff of the
   plain version in f32 and bf16 at internlm2's (B 4 and the training
   microbatch B 2, S 2,048), gemma3's local, whisper's encoder and MLA's
   shapes, a second launch bit-equal, and K5's two backward
   products (dX = dY W^T, dW = X^T dY) at granite-moe's training
   capacity, timed against their bounds, the plain versions and SDPA's
   backward (with the mask and with its causal flag) or ``torch.bmm``;
   K6's backward (``ssd_scan_bwd``, f32) at mamba2's and zamba2's
   training microbatch (B 2 x S 2,048), a ragged S and a one-chunk S:
   all five gradients within SSD_BWD_RTOL of autodiff of the plain scan,
   a second launch bit-equal, timed against its operations bound and the
   plain autodiff; ``train-internlm2``: the port's ``Trainer`` on
   internlm2-1.8b at full width and depth (B 4 × S 2,048 of
   ``SHAPES["train_4k"]``, 4 steps of 2 microbatches, a checkpoint every
   2 steps in the JAX package's file format), a second Trainer resuming
   from step 4 to 6, and a 2-step int8 error-feedback
   gradient-compression run: every loss finite, K3 forward 2 × 24 ×
   microbatches × steps (the remat recomputes it), its backward 24 ×
   microbatches × steps, no decode kernel, with step seconds, tokens/s
   and peak memory; ``train-granite``: granite-moe at full width and 4 of
   32 layers, 2 steps, K5 12 times per MoE layer of every microbatch (3
   forward, 3 recomputed, 6 backward) and every launched K5 shape held to
   the plain version; ``train-mamba2``: mamba2-2.7b at full width and
   depth (64 layers), the same batch, 3 steps of 2 microbatches, K6
   2 × 64 × microbatches × steps and its backward 64 × microbatches ×
   steps, no other kernel; ``train-reference``: the loss and every
   parameter leaf's gradient through the kernels against inside
   ``ops.plain_on_card`` (internlm2, granite and mamba2 at 2 layers,
   gemma3's 6-layer unit, zamba2's unit of 5 Mamba-2 blocks and the
   shared attention, whisper-base and stablelm-1.6b whole, deepseek-v2
   and qwen1.5-110b (q/k/v biases seeded) at 1 layer, internvl2-26b at 2
   behind its patch embeddings; f32 and bf16), with K6's backward
   launched for the Mamba-2 models, K3's backward at MLA's q/k 192 and V
   128 (padded to 192 by the wrapper) and K5's backward at deepseek-v2's
   160 experts, every launched K5 and K5-backward shape of the MoE models
   held to the plain version;
   ``train-kernel-split``: the device kernels of one call of K3's and of
   K6's backward at their kernels-line cases, with each one's device
   time; ``train-deepseek``: the port's ``Trainer`` on deepseek-v2 at
   full width and 1 of 60 layers (the most one card holds with its
   AdamW moments), 2 steps at TRAIN_SEQ, launches as train-granite's
   (K3's backward at q/k 192 and V 128 padded to 192 by the wrapper,
   K5's at 160 experts), every
   launched K5 and K5-backward shape held to the plain version, with
   step seconds, tokens/s, peak memory and every cut in its line.
16. ``spmd`` — the SPMD rules on a one-card ("data", "model") mesh
   (``launch.mesh.make_debug_mesh``: a one-rank NCCL group):
   granite-moe-3b-a800m at full width and 4 layers, its parameters
   carried to the host and back onto the mesh through
   ``dist.fault.elastic_reshard`` under its train_4k rules, trained 2
   steps inside ``use_rules`` (every ``shard()`` pin of the model and the
   batch resolving its axes) between two runs with no rules: losses,
   grad norms and every parameter and moment leaf bit-equal, K3, K3's
   backward and K5 launched as in train-granite and equally; internlm2-1.8b at full
   width under its decode_32k rules, the reference phase's prefills and
   paged decode step with and without rules: logits bit-equal, K3 and K1
   once per layer of each call.  The placements' summary and the
   phase's seconds;
17. ``dryrun`` — ``python -m repro_torch.launch.dryrun`` on this
   machine's torch for DRYRUN_CELLS (internlm2-1.8b train_4k and
   granite-moe decode_32k on 16×16, granite-moe train_4k on 2×16×16),
   each in its own process over torch's fake process group: every cell
   placed as DTensors of fake local shards on the fake mesh and its
   step run on them as the per-device program, a check without compute
   on the host (``"mesh": "fake"``), as the JAX package's dry-run is.
   Each must exit 0 with its record read back, carrying collectives and
   temp memory (printed: bytes by kind, temp bytes).  Collective bytes
   cannot be measured on one card: the line says so.
18. ``dryrun-memory`` — the dry-run's memory count against the card:
   spmd's train step (granite-moe, 4 layers, B 4 × S 2,048, 2
   microbatches, remat) on the one-card NCCL mesh with the rules active,
   inside ``ops.plain_on_card()`` (the plain versions, the ops the
   dry-run counts), its peak ``torch.cuda.max_memory_allocated()`` less
   the bytes allocated at the step's entry, against the dry-run of the
   same cell on a fake 1×1 mesh: ``temp_size_in_bytes`` plus the new
   outputs (``output_size_in_bytes`` less ``alias_size_in_bytes``, the
   parameters and moments the step updates in place, allocated before
   it), within DRYRUN_MEMORY_RTOL of the measured peak; and the same
   step's peak through the kernels (printed, not checked).
19. ``examples`` — the port's three device examples
   (``examples/torch_quickstart.py``, ``torch_serve_multitenant.py``,
   ``torch_train_lm.py``), each in a process of its own on the card with
   jax and the JAX package blocked and its launch counters zeroed first:
   quickstart trains to step 20 and resumes to 25, serve_multitenant
   completes 7 of 7 under MURS, train_lm's 110 M model runs its 300
   steps and ends with a finite loss below its first; their launches
   are counted into the kernels line.

Then the ``kernels`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits 1.  Without a
CUDA device, or without the port's sources beside this file, it exits
non-zero and prints no result.

``--only kernels`` (phase 3), ``--only reference`` (phase 7), ``--only
train`` (phase 15), ``--only spmd`` (phases 16 to 18) or ``--only
examples`` (phase 19), or several,
stops after those phases and prints neither the kernels line nor the
result line.  Copied into the root of
another checkout, such as a parent commit's, the script so holds that
tree's package to its own inputs, timer and checks.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
DEV = "cuda"
N_SLOTS, MAX_SEQ, PAGE = 8, 1024, 16
POOL_PAGES = 48  # pool pages of the simulated HBM budget
#: gemma3's simulated HBM budget, in requests' worth of ring state
#: (11.5 MB each) — forces suspensions at 8 slots
GEMMA_POOL_STATES = 5.0
#: granite-moe's simulated HBM budget, in 16-token pages of its 65,536
#: B/token KV: forces a suspension (CPU rehearsal at the same byte model)
GRANITE_POOL_PAGES = 26
#: serve-granite-moe's prompt lengths: A, B and C (a 64-token shared
#: prefix and one token of its own)
GRANITE_PROMPTS = {"A": 160, "B": 32, "C": 65}
F32_ATOL = 1e-5  # kernel vs plain in f32: summation order only
LOGIT_ATOL = 0.1  # full-width logits through two attention paths
#: full-width f32 logits, kernels against plain versions: summation order
#: through 32 layers, and no routing choice may differ
F32_LOGIT_ATOL = 1e-3
#: granite-moe in bf16 without pinned routing, kernels against plain
#: versions: at most this share of (layer, token) top-k expert sets may
#: differ, and the logits at most UNPINNED_LOGIT_ATOL.  Set from the first
#: readings (9.5 % of prefill and 4.2 % of decode pairs, logits within
#: 0.080) with about twice to three times their room: a fault that
#: changes the served path's routing or expert outputs goes past them.
UNPINNED_FLIP_SHARE = 0.2
UNPINNED_LOGIT_ATOL = 0.25
#: serve-mamba2's and serve-zamba2's prompt lengths: A, B and C (a
#: 64-token shared prefix and one token of its own); A makes 32 new
#: tokens, B and C 16
SSM_PROMPTS = {"A": 768, "B": 32, "C": 65}
#: their simulated HBM budgets, in requests' worth of constant state (the
#: Mamba conv tails and SSD states; zamba2's shared-attention KV grows on
#: top): fewer than the 8 slots, so admission waits.  The counts they give
#: come from a CPU rehearsal at the same byte model
SSM_POOL_STATES = {"mamba2-2.7b": 5.0, "zamba2-1.2b": 6.0}
#: K6 against its plain version, of max |plain|: the JAX package's own
#: tolerance for its scan kernel against the sequential recurrence
#: (tests/test_kernels.py).  Both sum the running decay in the same
#: order; the contractions' f32 sums differ in order
SSD_RTOL = 1e-3
#: full-width bf16 logits of a Mamba stack, kernels against plain
#: versions: K6's f32 sums round to bf16 a ulp apart in a few elements of
#: every layer, and the recurrence carries that through every later
#: layer (64 for mamba2); set from the first readings (0.031-0.054 on
#: an H100), with about twice their room
SSM_BF16_LOGIT_ATOL = 0.125
#: serve-cluster: a front door over two replicas of full-width internlm2
#: that share one params tree on the card.  Every value below comes from
#: a CPU rehearsal of the same schedule at the same byte model (pools and
#: budgets in pages, the full model's tick costs)
CLUSTER_POOL_PAGES = 48  # each replica's pool
CLUSTER_REQUESTS = 40
CLUSTER_VOCAB = 500  # token ids of the trace
CLUSTER_RATE = 0.4  # Poisson arrivals per cluster tick
CLUSTER_PRESSURE = 0.9  # the door sheds above this projected / capacity
CLUSTER_BULK_BUCKET = (0.05, 2.0)  # bulk's token bucket: per tick, burst
CLUSTER_CKPT_EVERY = 16  # ticks between KV checkpoints
#: pages a checkpoint holds (shared prefix first): a full-width page is
#: 3.1 MB of f32 payload, and zlib, the codec where zstandard is absent,
#: writes a few MB/s of it
CLUSTER_CKPT_PAGES = 2
#: replica 1 runs CLUSTER_SLOW[1] times slower from tick CLUSTER_SLOW[0]
#: to tick CLUSTER_SLOW[2]; replica 0 crashes at CLUSTER_CRASH_TICK
CLUSTER_SLOW = (24, 4.0, 96)
CLUSTER_CRASH_TICK = 72
#: the counts the CPU rehearsal gave; the card's run must give the same
CLUSTER_COUNTS = {
    "admitted": 35, "shed": 1, "rate_limited": 4, "completed": 35,
    "ticks": 204, "suspensions": 23, "straggler_flags": 9, "migrations": 17,
    "checkpoints": 22, "restored": 1, "restore_outcomes": {"suffix": 1},
    "requeued": 16, "paged_decode_ticks": 303,
    "model_calls": {"prefill": 48, "decode_step": 565,
                    "decode_step_paged": 303},
}

#: serve-stablelm: stablelm-1.6b at full width and depth (24 layers, MHA:
#: 32 heads of 64, 196,608 B/token of KV) on ``serve``'s engine with its
#: tenants B and C, over a pool of this many 16-token pages: fewer than
#: their demand, so MURS suspends.  The counts are the CPU rehearsal's (a
#: narrow stablelm of the same depth and pages); the card's run must give
#: the same
STABLELM_POOL_PAGES = 10
STABLELM_COUNTS = {
    "suspensions": 5, "prefix_hits": 2, "ticks": 91, "paged_decode_ticks": 87,
    "chunked_prefill_ticks": 7,
    "model_calls": {"prefill": 6, "decode_step": 41, "decode_step_paged": 87},
}
#: serve-deepseek-v2: deepseek-v2 at full width and DEEPSEEK_LAYERS of its
#: 60 layers (one MoE layer is 160 x 3 x 5120 x 1536 bf16 weights, 7.5 GB;
#: 60 do not fit one card) on serve-granite-moe's engine and traffic,
#: over a pool of DEEPSEEK_POOL_PAGES pages of its 4,608 B/token of MLA
#: latents; the counts are the CPU rehearsal's
DEEPSEEK_LAYERS = 4
DEEPSEEK_POOL_PAGES = 26
DEEPSEEK_COUNTS = {
    "suspensions": 1, "prefix_hits": 2, "ticks": 139, "paged_decode_ticks": 0,
    "chunked_prefill_ticks": 3,
    "model_calls": {"prefill": 8, "decode_step": 158, "decode_step_paged": 0},
}
#: reference-zoo: deepseek-v2 in f32 at this many layers (36 GB of f32
#: weights; the served 4 would take 70 GB), qwen1.5-110b at full width
#: and QWEN_LAYERS of its 80 layers (each is 2.7 GB of bf16, and the
#: embedding and head 5 GB: 80 need 222 GB), whisper-base over
#: WHISPER_FRAMES encoder frames (30 s of audio) and internvl2-26b's
#: backbone at full depth behind its 256 patch embeddings, each with a
#: ZOO_PROMPT-token prompt and ZOO_STEPS decode steps
DEEPSEEK_F32_LAYERS = 2
QWEN_LAYERS = 4
#: internvl2-26b's bf16 logits, kernels against plain versions, through
#: its 48 layers of d 6144: each layer rounds the residual stream to bf16
#: after sums taken in other orders, and the gap grows with depth (0.065
#: at stablelm's 24 layers, 0.039 at qwen1.5's 4); set from the first
#: reading (0.108-0.122 over 9 steps on an H100, NVIDIA H100 80GB HBM3 at
#: 700 W) with twice its room.  The same model in f32 at
#: INTERNVL2_F32_LAYERS layers is held to F32_LOGIT_ATOL with no near-tie,
#: so the gap is the rounding, not the kernels
INTERNVL2_BF16_LOGIT_ATOL = 0.25
INTERNVL2_F32_LAYERS = 4
WHISPER_FRAMES = 1500
ZOO_PROMPT, ZOO_STEPS = 64, 8
#: simulator: every field of every ServiceMetrics of the paper's sort, WC
#: and grep mix in a 6 GB executor under FAIR and under MURS, and of each
#: job alone (``run_batch``), as the CPU rehearsal computed them (the
#: per-task peak live bytes as their count and the SHA-256 of their
#: sorted pairs' repr).  The simulator does no device arithmetic: equal,
#: not close
SIM_EXPECTED = {
    "fair": dict(
        jobs={
            "sort": dict(job_id='sort', submit_time=0.0,
                finish_time=540.9250424567575, gc_time=151.37504245672284,
                spills=70, spilled_bytes=11065382442.032244, oom=False,
                tasks_total=180),
            "wc": dict(job_id='wc', submit_time=0.0,
                finish_time=540.9750424567575, gc_time=151.37504245672284,
                spills=11, spilled_bytes=1743428445.7826319, oom=False,
                tasks_total=250),
            "grep": dict(job_id='grep', submit_time=0.0,
                finish_time=252.5723615281784, gc_time=66.12236152816138,
                spills=0, spilled_bytes=0.0, oom=False, tasks_total=60),
        },
        minor_gcs=59, full_gcs=9, total_gc_time=151.37504245672284, oom=False,
        min_active_tasks=2, peak_pool_used_fraction=0.8463490844994578,
        suspensions=0, sim_time=541.0250424567574,
        peak_task_live=dict(tasks=490, sha256=(
            "388cb0558289cdc3b54a71a2c3c3b94f"
            "0fbc43b26c61b9b7dbf1795634750f15")),
    ),
    "murs": dict(
        jobs={
            "sort": dict(job_id='sort', submit_time=0.0,
                finish_time=553.1228625328336, gc_time=145.7728625328057,
                spills=60, spilled_bytes=9507236531.777962, oom=False,
                tasks_total=180),
            "wc": dict(job_id='wc', submit_time=0.0,
                finish_time=502.17097094274817, gc_time=133.67097094269127,
                spills=12, spilled_bytes=1882256940.9006042, oom=False,
                tasks_total=250),
            "grep": dict(job_id='grep', submit_time=0.0,
                finish_time=211.08384588928087, gc_time=50.5838458892712,
                spills=0, spilled_bytes=0.0, oom=False, tasks_total=60),
        },
        minor_gcs=58, full_gcs=8, total_gc_time=145.7728625328057, oom=False,
        min_active_tasks=1, peak_pool_used_fraction=0.840030443672278,
        suspensions=168, sim_time=553.1728625328335,
        peak_task_live=dict(tasks=490, sha256=(
            "19615b5e552ff78ac3f5b00fd2bc875d"
            "b9cc93e9445aa1da6414dcf336c6014d")),
    ),
    "batch_sort": dict(
        jobs={
            "sort": dict(job_id='sort', submit_time=0.0,
                finish_time=290.9500154617951, gc_time=99.450015461774,
                spills=61, spilled_bytes=9848815027.208788, oom=False,
                tasks_total=180),
        },
        minor_gcs=27, full_gcs=7, total_gc_time=99.450015461774, oom=False,
        min_active_tasks=1, peak_pool_used_fraction=0.8392802450352909,
        suspensions=0, sim_time=291.0000154617951,
        peak_task_live=dict(tasks=180, sha256=(
            "6a739fc7df1ee64a0e68686e15c7f220"
            "bb6a612fb3169094632e537b3f500cc9")),
    ),
    "batch_wc": dict(
        jobs={
            "wc": dict(job_id='wc', submit_time=0.0,
                finish_time=185.09677582622646, gc_time=45.796775826218386,
                spills=11, spilled_bytes=1741265211.1396449, oom=False,
                tasks_total=250),
        },
        minor_gcs=24, full_gcs=2, total_gc_time=45.796775826218386, oom=False,
        min_active_tasks=5, peak_pool_used_fraction=0.8441081050494568,
        suspensions=0, sim_time=185.14677582622647,
        peak_task_live=dict(tasks=250, sha256=(
            "71216bc15c88eb501ebffc27335113c6"
            "901ce953d0f4756466e80d4127abbe2c")),
    ),
    "batch_grep": dict(
        jobs={
            "grep": dict(job_id='grep', submit_time=0.0,
                finish_time=64.60599999999852, gc_time=2.056, spills=0,
                spilled_bytes=0.0, oom=False, tasks_total=60),
        },
        minor_gcs=4, full_gcs=0, total_gc_time=2.056, oom=False,
        min_active_tasks=12, peak_pool_used_fraction=0.28064, suspensions=0,
        sim_time=64.65599999999851,
        peak_task_live=dict(tasks=60, sha256=(
            "ae75fb946492bf9dd4fd8f062bf4d876"
            "eec19e0c511b1fad50120f67f22630d0")),
    ),
}


# ---------------------------------------------------------------- training
#: K3's backward against autodiff of its plain version.  f32: summation
#: order only, over up to 1,500 keys or a group's heads x Sq rows whose
#: terms cancel: TRAIN_F32_ATOL x the largest |gradient|.  bf16: the
#: kernel rounds P and dS to bf16 as tensor-core operands
#: (FlashAttention-2's choice) and D from the rounded output; emulated on
#: a CPU at these masks that moves a gradient by at most one bf16 ulp of
#: the largest |gradient|: the limit is BWD_BF16_ULPS ulps
TRAIN_F32_ATOL = 1e-4
BWD_BF16_ULPS = 2
#: (name, B, H, KV, S, hd, vd, causal, window): K3's backward at the
#: training paths' shapes — internlm2's at B 4 and at the train-internlm2
#: phase's microbatch of 2, gemma3's local layer, whisper's encoder,
#: deepseek-v2's MLA (V 128 padded to q/k's 192)
TRAIN_FLASH_CASES = [
    ("internlm2", 4, 16, 8, 2048, 128, 128, True, 0),
    ("internlm2_b2", 2, 16, 8, 2048, 128, 128, True, 0),
    ("gemma3_local", 2, 4, 1, 2048, 256, 256, True, 512),
    ("whisper_encoder", 2, 8, 8, 1500, 64, 64, False, 0),
    ("mla", 2, 128, 128, 160, 192, 128, True, 0),
]
#: K6's backward against autodiff of the plain scan on the card, in f32,
#: of max |plain| (stated before the first card run, as
#: tests/test_torch_cuda.py's SSD_BWD_RTOL): the same f32 terms summed in
#: other orders; dx, dB and dC within 1e-4 (the CPU spread of the plain
#: backward against autograd is at most 3e-7), ddt and dA within 1e-3:
#: their terms, the reverse running sums of dseg, cancel (on a CPU 1.6e-5
#: for dA, and an f32 autograd against an f64 one 1.8e-4 at a chunk of
#: 256)
SSD_BWD_RTOL = {"dx": 1e-4, "ddt": 1e-3, "dA": 1e-3, "dB": 1e-4,
                "dC": 1e-4}
#: the K6 backward case in the kernels line: mamba2's training microbatch
SSD_BWD_LINE_CASE = "mamba2"
#: the previous designs' times (ms) of the two backward kernels at these
#: cases — K3's on mma.sync at every width, K6's on the CUDA cores with
#: per-head partials (PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00
#: W) — printed beside each row's own time; None where that design was
#: not timed at the shape
PARENT_BWD_MS = {
    "flash_attention_bwd": {"internlm2": 1.401, "internlm2_b2": None,
                            "gemma3_local": 0.446, "whisper_encoder": 0.285,
                            "mla": 0.237},
    "ssd_scan_bwd": {"mamba2": 6.499, "zamba2": 3.267,
                     "mamba2_ragged": 1.734, "mamba2_one_chunk": 0.587},
    # K5 twice on transposed contiguous copies, the copies included: dX +
    # dW (0.461 + 0.641 and 0.401 + 0.351)
    "grouped_matmul_bwd": {"gate_up": 1.102, "down": 0.752},
}
#: K5's backward against autodiff of K5's plain version in f32: summation
#: order only (tests/test_torch_cuda.py's F32_ATOL); in bf16 both sum in
#: f32 and round once: one bf16 ulp of the largest |gradient|
GMM_BWD_F32_ATOL = 1e-5
#: K6's backward runs its tile products as 3xTF32 on the tensor cores:
#: its second bound takes the operations at dense TF32's 495 TFLOP/s
#: (NVIDIA's data sheet) over the three TF32 products each f32 product
#: costs
TF32_PEAK_FLOPS = 495e12
TF32_PASSES = 3
#: train-mamba2: mamba2-2.7b at full width and depth (64 layers: weights,
#: gradients and AdamW moments about 16 bytes a parameter, 45 GB), the
#: train-internlm2 phase's batch, 3 steps of TRAIN_MICRO microbatches, no
#: checkpoint
MAMBA_TRAIN_STEPS = 3
#: train-internlm2: internlm2-1.8b at full width and depth, SHAPES
#: ["train_4k"] cut from a global batch of 256 to 4 and from 4,096
#: positions to 2,048 (memory and time on one card)
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS, TRAIN_RESUME_STEPS, TRAIN_MICRO, TRAIN_CKPT_EVERY = 4, 6, 2, 2
TRAIN_COMPRESSION_STEPS = 2
#: a full-width (params, AdamWState) file is 19 GB; zlib at the JAX
#: package's level 6 compresses f32 moments at about 19 MB/s (measured on
#: a CPU), minutes a file, so the phase sets the checkpoint module's
#: ZLIB_LEVEL to store them (level 0: the same file format, readable by
#: either package)
TRAIN_CKPT_ZLIB_LEVEL = 0
#: train-granite: granite-moe-3b-a800m at full width, 4 of its 32 layers
#: (time and memory: 32 layers of 40 experts train well past this
#: script's budget), the same batch and sequence, 2 steps
GRANITE_TRAIN_LAYERS = 4
GRANITE_TRAIN_STEPS = 2
#: train-deepseek: deepseek-v2-236b at full width and 1 of its 60 layers
#: (5.02 B parameters: MLA 149 M, 160 routed experts 3.78 B, 2 shared
#: 47 M, the embedding and head 1.05 B) through the Trainer, bf16
#: weights and gradients with f32 AdamW moments (12 B a parameter, 60
#: GB), DEEPSEEK_TRAIN_STEPS steps at TRAIN_SEQ with remat, one
#: microbatch of the largest batch that fits (DEEPSEEK_TRAIN_CUTS says
#: why; measured on an NVIDIA H100 80GB HBM3 at 700 W)
DEEPSEEK_TRAIN_LAYERS = 1
DEEPSEEK_TRAIN_STEPS = 2
DEEPSEEK_TRAIN_BATCH = 10
DEEPSEEK_TRAIN_MICRO = 1
DEEPSEEK_TRAIN_CUTS = {
    "microbatches": "1, not train-internlm2's 2: a second microbatch sums "
                    "the gradients in f32, 20 GB more than the 60 GB of "
                    "state, and ran out of memory at a batch of 2",
    "batch": "the largest tried that fits: 10 peaked at 73.58 GiB (4 at "
             "65.55, 8 at 68.62); 12 ran out of memory allocating its "
             "9.38 GiB of f32 logits at 69.14 GiB; 11 not tried",
}
#: train-reference: the loss and every parameter leaf's gradient through
#: the kernels against inside ``ops.plain_on_card``, per leaf
#: ||g - g_plain|| / ||g_plain||, at full width and cut depth, a batch of
#: REF_TRAIN_BATCH x REF_TRAIN_SEQ, in three precisions:
#: - f32 with ``bf16_grad`` the identity: the kernels differ from the
#:   plain versions only in the order of f32 sums, so every leaf is held
#:   to TRAIN_REF_EXACT_RTOL, as the CPU test of the same case is.  A
#:   subtly lossy backward (a bf16 rounding, a dropped block) shows here.
#: - f32: every block boundary rounds the cotangent to bf16
#:   (``bf16_grad``), where a last-bit difference of the f32 sums flips a
#:   rounding; the flips compound with depth.  The card read 1.5e-4
#:   (internlm2), 2.2e-3 (gemma3), 1.7e-4 (granite) and 1.9e-3 (whisper):
#:   each limit is about 4x its reading.
#: - bf16: the card read 0.011, 0.021, 0.095 and 0.021; the limits are
#:   about 2-3x that.  granite's is widest: a bf16 rounding difference in
#:   a router logit changes a token's top-8 experts, which moves the
#:   router's and the norms' gradients (its CPU bf16-against-f32 spread
#:   was 0.215); the exact f32 case above holds K5's backward tight.
#: A missing or wrong gradient reads near 1.
#: mamba2 (2 layers) and zamba2 (one unit: 5 Mamba-2 blocks and the
#: shared attention), stated before their first card run: in the exact
#: case 1e-3, since A_log's and dt_bias's gradients sum dA and ddt, whose
#: terms cancel (on a CPU two f32 orders of the scan's backward move
#: A_log's by 1.4e-4 of its norm); with the rounding 1e-2 and 2e-2 (on a
#: CPU, the port against the JAX package at smoke size read 1.6e-3 at 2
#: layers and 7.6e-3 at 14); in bf16 0.1 and 0.15 (the CPU read 0.019 and
#: 0.077, and each package's own bf16 gradient of zamba2 differs from its
#: f32 one by 0.10).
REF_TRAIN_BATCH, REF_TRAIN_SEQ = 2, 640
#: deepseek-v2 (1 layer), stablelm (24), qwen1.5 (1, its q/k/v biases
#: seeded) and internvl2 (2, behind its patch embeddings), set from their
#: first card run (NVIDIA H100 80GB HBM3, 700 W) with about 3-4x its
#: reading as above: exact 3.1e-6, 5.0e-6, 3.9e-6 and 5.0e-6; f32 2.5e-5,
#: 7.5e-3, 3.5e-5 and 2.4e-4; bf16 0.031 (at deepseek-v2's routed
#: ``down``: a token's expert set can differ between the paths, as
#: granite's), 0.027, 0.010 and 0.011.
TRAIN_REF_EXACT_RTOL = 1e-4
TRAIN_REF_EXACT_RTOL_SSM = 1e-3
TRAIN_REF_F32_RTOL = {"internlm2-1.8b": 6e-4, "gemma3-1b": 8e-3,
                      "granite-moe-3b-a800m": 6e-4, "whisper-base": 8e-3,
                      "mamba2-2.7b": 1e-2, "zamba2-1.2b": 2e-2,
                      "deepseek-v2-236b": 1e-4, "stablelm-1.6b": 3e-2,
                      "qwen1.5-110b": 1.5e-4, "internvl2-26b": 1e-3}
TRAIN_REF_BF16_RTOL = {"internlm2-1.8b": 0.035, "gemma3-1b": 0.062,
                       "granite-moe-3b-a800m": 0.2, "whisper-base": 0.038,
                       "mamba2-2.7b": 0.1, "zamba2-1.2b": 0.15,
                       "deepseek-v2-236b": 0.1, "stablelm-1.6b": 0.08,
                       "qwen1.5-110b": 0.035, "internvl2-26b": 0.035}
#: train-reference's depth of the models that a card cannot hold whole:
#: deepseek-v2 at 1 of 60 layers (one MoE layer is 3.97 B parameters: MLA
#: 149 M, 160 routed experts 3.78 B, 2 shared 47 M; with the embedding
#: and head's 1.05 B, 20 GB of f32, and the two paths' gradients as much
#: again each), qwen1.5-110b at 1 of 80 (3.85 B with its 2.49 B of
#: embedding and head) and internvl2-26b at 2 of 48 (1.92 B); stablelm
#: runs whole (1.64 B)
REF_TRAIN_LAYERS = {"deepseek-v2-236b": 1, "qwen1.5-110b": 1,
                    "internvl2-26b": 2}


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def with_rates(r):
    """A ``kernel`` line with its achieved rate (``tflops``, flops / ms)
    and its share of the bound (``of_bound``, bound_ms / ms)."""
    return {**r, "tflops": r["flops"] / (r["ms"] * 1e9),
            "of_bound": r["bound_ms"] / r["ms"]}


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
#: the spin between a window's flush and its start: this many times the
#: slowest host enqueue of the timed call, plus SPIN_FLOOR_MS
SPIN_MARGIN = 4
SPIN_FLOOR_MS = 0.5


class Timer:
    """What ``time_ms`` needs on the card: a 256 MB buffer (five times the
    50 MB L2), written once here, that each window's flush reads into a
    one-element sink, so that the flush leaves L2 full of clean lines and
    no window pays a write-back; the rate of ``torch.cuda._sleep``
    (cycles per ms), from one calibration timed with events; and the
    count of late windows so far."""

    def __init__(self, torch, cal_cycles=20_000_000):
        self.flush = torch.ones(64 * 2**20, dtype=torch.float32, device=DEV)
        self.sink = torch.empty((), dtype=torch.float32, device=DEV)
        self.late = 0
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cal_cycles)
        end.record()
        end.synchronize()
        self.cycles_per_ms = cal_cycles / start.elapsed_time(end)


def time_ms(torch, fn, timer, iters=30):
    """Median device time of ``fn`` over ``iters`` windows.  Before each,
    the card is idle, then runs the flush (a read of ``timer.flush``) and
    a spin (``torch.cuda._sleep``) sized to outlast the host's enqueue of
    ``start.record(); fn(); end.record()``: SPIN_MARGIN times the slowest
    of five such enqueues timed on the host, plus SPIN_FLOOR_MS.  So the
    window holds no host latency and no dirty write-back.  An event
    recorded after the spin must still be pending once the host has
    enqueued ``end.record()``; a window where it is not is late: it is
    counted in ``timer.late``, timed again with twice the spin, and never
    kept."""
    import gc

    for _ in range(3):
        fn()
    enqueue = 0.0
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        enqueue = max(enqueue, time.perf_counter() - t0)
    spin_ms = SPIN_MARGIN * enqueue * 1e3 + SPIN_FLOOR_MS
    times = []
    gc.collect()
    gc.disable()
    try:
        while len(times) < iters:
            torch.cuda.synchronize()
            torch.sum(timer.flush, dim=0, out=timer.sink)
            torch.cuda._sleep(int(spin_ms * timer.cycles_per_ms))
            spun = torch.cuda.Event()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            spun.record()
            start.record()
            fn()
            end.record()
            if spun.query():
                timer.late += 1
                spin_ms *= 2
                check(timer.late < 10 * iters, "time_ms: the card keeps "
                      "finishing the spin before the window is enqueued")
                continue
            end.synchronize()
            times.append(start.elapsed_time(end))
    finally:
        gc.enable()
    return statistics.median(times)


def host_ms(torch, fn, batches=10, calls=20):
    """Host time of one call of ``fn``: the wall time of ``calls`` calls
    issued back to back, the card not waited for, over ``calls``; the
    least of ``batches`` such batches, since other work on a shared host
    only adds time.  On a host-bound serve path this, not the device
    time, is what a call costs."""
    best = math.inf
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best * 1e3 / calls


# ----------------------------------------------------------------- kernels
def paged_case(torch, rng, *, reqs, heads, kv_heads, hd, page, width,
               dtype, zero_row=False):
    """A folded paged-decode batch as the engine builds it: each request's
    pages scattered over a pool, its table row repeated per q-head with
    the kv-head offset ``(h // G) * n_pool``."""
    n_pool = reqs * width
    perm = rng.permutation(n_pool).reshape(reqs, width)
    lens = rng.integers(1, width * page + 1, size=reqs)
    if zero_row:
        lens[-1] = 0
    hoff = np.arange(heads) // (heads // kv_heads)
    table = (perm[:, None, :] + hoff[None, :, None] * n_pool).reshape(
        reqs * heads, width
    )
    row_lens = lens.repeat(heads)
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(2**31)))
    draw = dict(device=DEV, generator=gen)
    q = torch.randn(reqs * heads, hd, **draw).to(dtype)
    k = torch.randn(kv_heads * n_pool, page, hd, **draw).to(dtype)
    v = torch.randn(kv_heads * n_pool, page, hd, **draw).to(dtype)
    t = torch.as_tensor(table, dtype=torch.int32, device=DEV)
    s = torch.as_tensor(row_lens, dtype=torch.int32, device=DEV)
    return q, k, v, t, s


def needed(table, lens, page):
    """What the batch needs the kernel to touch: the (row, page) table
    entries each row sweeps (``ceil(len / page)``, or all W pages for a
    zero-length pad row), the distinct pool pages among them, and the
    tokens attended over all rows."""
    pages = set()
    entries = tokens = 0
    tab = table.cpu().numpy()
    for r, n in enumerate(lens.cpu().numpy().tolist()):
        sweep = math.ceil(n / page) if n > 0 else tab.shape[1]
        pages.update(tab[r, :sweep].tolist())
        entries += sweep
        tokens += n if n > 0 else tab.shape[1] * page
    return entries, len(pages), tokens


def bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at the largest |x|: two roundings
    to bf16 of f32 values that differ in summation order alone differ by
    at most this much."""
    return 2.0 ** (math.floor(math.log2(x.float().abs().max().item())) - 7)


#: K1/K2's kernel-phase shapes: a smoke shape with a zero-length row,
#: internlm2's paged batch (8 requests x 16 heads over 8 kv heads, hd
#: 128), granite-moe's (24 heads over 8, hd 64), stablelm's (MHA: 32
#: heads over 32, hd 64, one head per kv group) and qwen1.5's (64 heads
#: over 8, hd 128), 64-page tables; the kernels line takes ``path``.  Each (kernel, case) draws its inputs from
#: a generator of its own, seeded by its names, so that adding a case
#: moves no other case's inputs
PAGED_CASES = {
    "smoke": dict(reqs=4, heads=4, kv_heads=4, hd=16, page=16, width=4,
                  zero_row=True),
    "path": dict(reqs=8, heads=16, kv_heads=8, hd=128, page=PAGE,
                 width=MAX_SEQ // PAGE),
    "granite_path": dict(reqs=8, heads=24, kv_heads=8, hd=64, page=PAGE,
                         width=MAX_SEQ // PAGE),
    "stablelm_path": dict(reqs=8, heads=32, kv_heads=32, hd=64, page=PAGE,
                          width=MAX_SEQ // PAGE),
    "qwen_path": dict(reqs=8, heads=64, kv_heads=8, hd=128, page=PAGE,
                      width=MAX_SEQ // PAGE),
}


def kernel_phase(torch, F, pd, ref, timer):
    """Compare and time both kernels; returns their summary entries."""
    from repro_torch.roofline.analysis import FP32_PEAK_FLOPS, HBM_BW

    # a package from before K1's grouping by kv head (a parent commit
    # timed under this script with ``--only kernels``) takes no q_per_kv
    grouped = hasattr(pd, "split_plan")
    results = {}
    for name, int8 in (("paged_decode_attention", False),
                       ("paged_decode_attention_int8", True)):
        max_err, max_tol = 0.0, 0.0
        for shape, kw in PAGED_CASES.items():
            g = kw["heads"] // kw["kv_heads"]
            rng = np.random.default_rng([SEED, *name.encode(),
                                         *shape.encode()])
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, table, lens = paged_case(
                    torch, rng, dtype=dtype, **kw
                )
                if int8:
                    from repro_torch.models.transformer import (
                        _quantize_pool_int8,
                    )

                    kc, ks = _quantize_pool_int8(k)
                    vc, vs = _quantize_pool_int8(v)
                    args = (q, kc, vc, ks, vs, table, lens)
                    wrapper = pd.paged_decode_attention_int8
                    plain = ref.paged_decode_attention_int8_ref
                else:
                    args = (q, k, v, table, lens)
                    wrapper = pd.paged_decode_attention
                    plain = ref.paged_decode_attention_ref

                def kern(*a, _fn=wrapper):
                    return _fn(*a, q_per_kv=g) if grouped else _fn(*a)

                out = kern(*args)
                gold = plain(*args)
                torch.cuda.synchronize()
                err = (out.float() - gold.float()).abs().max().item()
                atol = (F32_ATOL if dtype == torch.float32
                        else bf16_ulp(gold))
                check(torch.isfinite(out.float()).all().item(),
                      f"{name} {shape} {dtype}: non-finite output")
                check(err <= atol, f"{name} {shape} {dtype}: max err {err}"
                      f" > {atol}")
                if shape == "smoke" or dtype != torch.bfloat16:
                    continue
                max_err, max_tol = max(max_err, err), max(max_tol, atol)
                hd, page = kw["hd"], kw["page"]
                entries, distinct, tokens = needed(table, lens, page)
                # K and V of each distinct page, q in and out back (bf16),
                # the swept table entries, the lengths, and for int8 the
                # K and V scales of each distinct page
                elem = 1 if int8 else 2
                n_bytes = (distinct * 2 * page * hd * elem
                           + 2 * q.numel() * 2 + entries * 4
                           + lens.numel() * 4
                           + (2 * distinct * 4 if int8 else 0))
                bytes_s = n_bytes / HBM_BW
                ops_s = 4 * hd * tokens / FP32_PEAK_FLOPS
                # library yardstick: SDPA over the gathered, masked KV
                bh, w = table.shape
                kg = (kc.float() * ks[:, None, None] if int8 else k)[
                    table.long()].reshape(bh, 1, w * page, hd).to(q.dtype)
                vg = (vc.float() * vs[:, None, None] if int8 else v)[
                    table.long()].reshape(bh, 1, w * page, hd).to(q.dtype)
                mask = (torch.arange(w * page, device=DEV)[None, :]
                        < lens[:, None])[:, None, None, :]
                q4 = q[:, None, None, :]
                late = timer.late
                r = {
                    "ms": time_ms(torch, lambda: kern(*args), timer),
                    "plain_ms": time_ms(torch, lambda: plain(*args), timer),
                    "library_ms": time_ms(
                        torch,
                        lambda: F.scaled_dot_product_attention(
                            q4, kg, vg, attn_mask=mask),
                        timer,
                    ),
                    "host_ms": host_ms(torch, lambda: kern(*args)),
                    "bound_ms": 1e3 * max(bytes_s, ops_s),
                    "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                    "bytes": n_bytes,
                    "flops": 4 * hd * tokens,
                    "max_abs_err": err,
                }
                r["late_windows"] = timer.late - late
                emit(with_rates({"phase": "kernel", "name": name,
                                 "case": shape, "q_per_kv": g,
                                 "plan": pd.split_plan(
                                     bh, w, pd.group_rows(g),
                                     torch.cuda.get_device_properties(
                                         0).multi_processor_count)
                                 if grouped else None,
                                 **r, "tolerance": atol}))
                if shape == "path":
                    results[name] = r
        results[name]["max_abs_err"] = max_err
        emit(with_rates({"phase": "kernel", "name": name, **results[name],
                         "tolerance": {"f32": F32_ATOL,
                                       "bf16_path": max_tol}}))
    return results


# (name, B, H, KV, Sq, Sk, hd, causal, window, q_offset[, vd]): K3 at
# internlm2's first prompt chunk (the serve run's prefills are 32-65
# tokens) and full prompt, a gemma3 local layer, a zamba2 shared-attention
# prompt (hd 64, the width granite-moe's layers launch too), deepseek-v2's
# MLA prefill of serve-deepseek-v2's 160-token A prompt (128 heads, q/k
# 192 wide, V ``vd`` = 128 wide, zero-padded to 192 in the wrapper),
# whisper-base's encoder over 1,500 frames (non-causal, hd 64) and its
# cross-attention of one decode query and of a 64-token prompt against
# them, and a smoke shape whose last two rows keep no key (positions 40,
# 41 against 37 keys, window 4)
FLASH_CASES = [
    ("internlm2_chunk", 1, 16, 8, 64, 64, 128, True, 0, 0),
    ("internlm2_prompt", 1, 16, 8, 1024, 1024, 128, True, 0, 0),
    ("gemma3_local", 1, 4, 1, 1024, 1024, 256, True, 512, 0),
    ("zamba2_prompt", 1, 32, 32, 1024, 1024, 64, True, 0, 0),
    ("mla_prefill", 1, 128, 128, 160, 160, 192, True, 0, 0, 128),
    ("whisper_encoder", 1, 8, 8, 1500, 1500, 64, False, 0, 0),
    ("whisper_cross_decode", 1, 8, 8, 1, 1500, 64, False, 0, 0),
    ("whisper_cross_prompt", 1, 8, 8, 64, 1500, 64, False, 0, 0),
    ("smoke", 1, 4, 2, 37, 37, 16, True, 4, 5),
]
# (name, B, H, KV, S, hd, window, positions): K4 at the chunked-prefill
# continuation, a dense batch of 8 slots, a gemma3 global layer, the batch
# with a window of 512, granite-moe's dense batch (hd 64, 3 q-heads a kv
# head); None draws the positions in [0, S)
DECODE_CASES = [
    ("continuation", 1, 16, 8, 1024, 128, 0, [199]),
    ("dense_batch", 8, 16, 8, 1024, 128, 0, None),
    ("gemma3_global", 8, 4, 1, 1024, 256, 0, None),
    ("window_batch", 8, 16, 8, 1024, 128, 512, None),
    ("granite_dense", 8, 24, 8, 1024, 64, 0, None),
]
#: the case whose numbers go into the kernels line: the shape the
#: internlm2 serve run gives each kernel most often
LINE_CASE = {"flash_attention": "internlm2_chunk",
             "decode_attention": "continuation"}


def kept_pairs(sq, sk, causal, window, q_offset):
    """(query, key) pairs the mask keeps, and the rows that keep none."""
    pairs = empty = 0
    for i in range(sq):
        qp = q_offset + i
        lo = max(0, qp - window + 1) if window else 0
        hi = min(qp, sk - 1) if causal else sk - 1
        pairs += max(0, hi - lo + 1)
        empty += hi < lo
    return pairs, empty


def bound(n_bytes, flops, dtype, torch):
    """The least time (ms) for the bytes at HBM bandwidth and the
    operations at the dtype's peak, and which of the two binds."""
    from repro_torch.roofline.analysis import (
        FP32_PEAK_FLOPS, HBM_BW, PEAK_FLOPS,
    )

    peak = PEAK_FLOPS if dtype == torch.bfloat16 else FP32_PEAK_FLOPS
    bytes_s, ops_s = n_bytes / HBM_BW, flops / peak
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                       else "operations")


def attention_kernel_phase(torch, F, ref, timer):
    """K3 and K4 against their plain versions in bf16 (the smoke shapes in
    f32 too) at FLASH_CASES / DECODE_CASES; returns the kernels-line
    entries, from LINE_CASE."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)

    def rand(dtype, *shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    results = {}
    for name, b, h, kv, sq, sk, hd, causal, window, q_offset, *vd in (
            FLASH_CASES):
        vd = vd[0] if vd else hd
        for dtype in ((torch.float32, torch.bfloat16) if name == "smoke"
                      else (torch.bfloat16,)):
            q = rand(dtype, b, h, sq, hd)
            k = rand(dtype, b, kv, sk, hd)
            # v as the model holds it: a transposed view of [B, Sk, KV, vd]
            v = rand(dtype, b, sk, kv, vd).transpose(1, 2)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            out = flash_attention(q, k, v, **kw)
            gold = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (out.float() - gold.float()).abs().max().item()
            atol = F32_ATOL if dtype == torch.float32 else bf16_ulp(gold)
            check(torch.isfinite(out.float()).all().item(),
                  f"flash_attention {name} {dtype}: non-finite output")
            check(err <= atol, f"flash_attention {name} {dtype}: max err "
                  f"{err} > {atol}")
            if dtype != torch.bfloat16:
                continue
            pairs, empty = kept_pairs(sq, sk, causal, window, q_offset)
            # q and k read, v read and the output written, once each
            n_bytes = 2 * (b * h * sq * (hd + vd) + b * kv * sk * (hd + vd))
            flops = 2 * (hd + vd) * b * h * pairs
            bound_ms, bound_by = bound(n_bytes, flops, dtype, torch)
            # yardstick: one SDPA call on KV repeated to the q heads
            kr = ref.repeat_kv(k, h // kv)
            vr = ref.repeat_kv(v, h // kv)
            qpos = q_offset + torch.arange(sq, device=DEV)[:, None]
            kpos = torch.arange(sk, device=DEV)[None, :]
            mask = (kpos <= qpos) if causal else torch.ones_like(qpos - kpos,
                                                                 dtype=bool)
            if window:
                mask = mask & (qpos - kpos < window)
            late = timer.late
            r = {
                "phase": "kernel", "name": "flash_attention", "case": name,
                "shape": {"B": b, "H": h, "KV": kv, "Sq": sq, "Sk": sk,
                          "hd": hd, "vd": vd, "causal": causal,
                          "window": window, "q_offset": q_offset},
                "kept_pairs": pairs, "rows_without_key": empty,
                "max_abs_err": err, "tolerance_bf16": atol,
                "ms": time_ms(torch, lambda: flash_attention(q, k, v, **kw),
                              timer),
                "host_ms": host_ms(
                    torch, lambda: flash_attention(q, k, v, **kw)),
                "plain_ms": time_ms(
                    torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                    timer),
                "library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, kr, vr, attn_mask=mask), timer),
                # the same function without a mask tensor, where SDPA's
                # causal flag says it all (a square prompt from position 0)
                "library_causal_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, kr, vr, is_causal=True), timer)
                if causal and not window and not q_offset and sq == sk
                else None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": n_bytes, "flops": flops,
            }
            r["late_windows"] = timer.late - late
            emit(with_rates(r))
            results[("flash_attention", name)] = r
    for name, b, h, kv, s, hd, window, positions in DECODE_CASES:
        dtype = torch.bfloat16
        q = rand(dtype, b, h, hd)
        # k, v: layer views of a [2, n_slots, KV, S, hd] cache, as the
        # engine's caches hand them to the model
        cache = rand(dtype, 2, b, kv, s, hd)
        k, v = cache[0], cache[1]
        pos = (torch.as_tensor(positions, dtype=torch.int32, device=DEV)
               if positions is not None else
               torch.randint(0, s, (b,), generator=gen, device=DEV,
                             dtype=torch.int32))
        out = decode_attention(q, k, v, pos, window=window)
        gold = ref.decode_attention_ref(q, k, v, pos, window=window)
        torch.cuda.synchronize()
        err = (out.float() - gold.float()).abs().max().item()
        atol = bf16_ulp(gold)
        check(torch.isfinite(out.float()).all().item(),
              f"decode_attention {name}: non-finite output")
        check(err <= atol, f"decode_attention {name}: max err {err} > {atol}")
        p = pos.cpu().tolist()
        kept = [min(c, s - 1) - (max(0, c - window + 1) if window else 0) + 1
                for c in p]
        n_bytes = (2 * 2 * kv * hd * sum(kept)
                   + 2 * 2 * b * h * hd + 4 * b)
        flops = 4 * hd * h * sum(kept)
        bound_ms, bound_by = bound(n_bytes, flops, dtype, torch)
        kpos = torch.arange(s, device=DEV)[None, :]
        mask = kpos <= pos[:, None].long()
        if window:
            mask = mask & (kpos > pos[:, None].long() - window)
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]
        kr, vr = ref.repeat_kv(k, h // kv), ref.repeat_kv(v, h // kv)
        late = timer.late
        r = {
            "phase": "kernel", "name": "decode_attention", "case": name,
            "shape": {"B": b, "H": h, "KV": kv, "S": s, "hd": hd,
                      "window": window},
            "positions": p, "kept_keys": sum(kept),
            "max_abs_err": err, "tolerance_bf16": atol,
            "ms": time_ms(torch, lambda: decode_attention(
                q, k, v, pos, window=window), timer),
            "host_ms": host_ms(torch, lambda: decode_attention(
                q, k, v, pos, window=window)),
            "plain_ms": time_ms(torch, lambda: ref.decode_attention_ref(
                q, k, v, pos, window=window), timer),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kr, vr, attn_mask=mask), timer),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "flops": flops,
        }
        r["late_windows"] = timer.late - late
        emit(with_rates(r))
        results[("decode_attention", name)] = r
    return {kernel: {**results[(kernel, case)], "max_abs_err": max(
                r["max_abs_err"] for (kn, _), r in results.items()
                if kn == kernel)}
            for kernel, case in LINE_CASE.items()}


def gmm_cases(cfg):
    """(name, E, C, D, F) of K5's kernel phase at granite-moe's widths,
    with C from the MoE code's own capacity functions: decode gate/up and
    down at the paged path's batch-wide group (up to N_SLOTS rows) and
    gate/up at the dense path's N_SLOTS per-row groups folded together; a
    prefill of each prompt length serve-granite-moe sends; a 400- and a
    1024-token prefill (the 128- and 256-row blocks); a ragged shape."""
    from repro_torch.models.blocks import _capacity, _decode_capacity

    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    c_paged = _decode_capacity(cfg, N_SLOTS)
    cases = [("decode_gate_up", e, c_paged, d, f),
             ("decode_down", e, c_paged, f, d),
             ("dense_decode_gate_up", e, N_SLOTS * _decode_capacity(cfg, 1),
              d, f)]
    for s in sorted(set(GRANITE_PROMPTS.values())) + [400, 1024]:
        cases.append((f"prefill_s{s}", e, _capacity(cfg, s), d, f))
    return cases + [("smoke", 3, 5, 72, 40)]


def deepseek_gmm_cases(cfg):
    """(name, E, C, D, F) of K5 at deepseek-v2's widths (160 experts, D
    5120, F 1536), with C from the MoE code's capacity functions: the
    dense decode step's N_SLOTS per-row groups folded together (C 32) and
    a prefill of serve-deepseek-v2's longest prompt (C 8), gate/up and
    down.  Each weight operand is 2.5 GB of bf16."""
    from repro_torch.models.blocks import _capacity, _decode_capacity

    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    c_dec = N_SLOTS * _decode_capacity(cfg, 1)
    c_pre = _capacity(cfg, GRANITE_PROMPTS["A"])
    return [("deepseek_decode_gate_up", e, c_dec, d, f),
            ("deepseek_decode_down", e, c_dec, f, d),
            ("deepseek_prefill_gate_up", e, c_pre, d, f),
            ("deepseek_prefill_down", e, c_pre, f, d)]


#: the K5 case in the kernels line: the shape of two thirds of the serve
#: run's launches
GMM_LINE_CASE = "decode_gate_up"


def gmm_check(torch, ref, x, w, what):
    """K5 against its plain version on (x, w): finite, and within one bf16
    ulp of max |plain| (F32_ATOL in f32); returns (error, tolerance)."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul

    out = grouped_matmul(x, w)
    gold = ref.grouped_matmul_ref(x, w)
    torch.cuda.synchronize()
    err = (out.float() - gold.float()).abs().max().item()
    atol = F32_ATOL if x.dtype == torch.float32 else bf16_ulp(gold)
    check(torch.isfinite(out.float()).all().item(),
          f"grouped_matmul {what}: non-finite output")
    check(err <= atol, f"grouped_matmul {what}: max err {err} > {atol}")
    return err, atol


def gmm_inputs(torch, gen, dtype, e, c, d, f, x_stride=None):
    x = torch.randn(e, c, d, generator=gen, device=DEV).to(dtype)
    if x_stride is not None:
        x = torch.empty_strided((e, c, d), x_stride, dtype=dtype,
                                device=DEV).copy_(x)
    w = (torch.randn(e, d, f, generator=gen, device=DEV)
         / math.sqrt(d)).to(dtype)
    return x, w


def gmm_kernel_phase(torch, ref, timer, cases):
    """K5 against its plain version at ``cases`` in bf16 (f32 too at the
    smoke and decode gate/up shapes); returns its kernels-line entry and
    the set of (E, C, D, F, dtype) it checked."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul

    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    results, max_err, checked = {}, 0.0, set()
    for name, e, c, d, f in cases:
        dtypes = ((torch.float32, torch.bfloat16)
                  if name in ("smoke", GMM_LINE_CASE) else (torch.bfloat16,))
        for dtype in dtypes:
            x, w = gmm_inputs(torch, gen, dtype, e, c, d, f)
            err, atol = gmm_check(torch, ref, x, w, f"{name} {dtype}")
            checked.add((e, c, d, f, dtype))
            elem = x.element_size()
            n_bytes = (e * c * d + e * d * f + e * c * f) * elem
            flops = 2 * e * c * d * f
            bound_ms, bound_by = bound(n_bytes, flops, dtype, torch)
            late = timer.late
            r = {
                "phase": "kernel", "name": "grouped_matmul", "case": name,
                "dtype": str(dtype).replace("torch.", ""),
                "shape": {"E": e, "C": c, "D": d, "F": f},
                "max_abs_err": err, "tolerance": atol,
                "ms": time_ms(torch, lambda: grouped_matmul(x, w), timer),
                "plain_ms": time_ms(
                    torch, lambda: ref.grouped_matmul_ref(x, w), timer),
                "library_ms": time_ms(torch, lambda: torch.bmm(x, w), timer),
                "host_ms": host_ms(torch, lambda: grouped_matmul(x, w)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": n_bytes, "flops": flops,
            }
            r["late_windows"] = timer.late - late
            emit(with_rates(r))
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
                results[name] = r
    return {"grouped_matmul": {**results[GMM_LINE_CASE],
                               "max_abs_err": max_err}}, checked


@contextlib.contextmanager
def gmm_shapes(ops):
    """Record the (E, C, D, F, dtype, x strides) of every ``ops``
    grouped matmul made inside the block (the model calls it by this
    name); yields the set."""
    gmm = ops.grouped_matmul
    seen = set()

    def recording(x, w):
        seen.add((*x.shape, w.shape[2], x.dtype, x.stride()))
        return gmm(x, w)

    ops.grouped_matmul = recording
    try:
        yield seen
    finally:
        ops.grouped_matmul = gmm


def check_launched_gmm_shapes(torch, ref, shapes, checked, what):
    """Hold K5 to its plain version at every recorded shape (with its x
    strides) that the kernel phase did not check; emit what was done."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    new = []
    for e, c, d, f, dtype, stride in sorted(shapes, key=str):
        contiguous = stride == (c * d, d, 1)
        if contiguous and (e, c, d, f, dtype) in checked:
            continue
        x, w = gmm_inputs(torch, gen, dtype, e, c, d, f, x_stride=stride)
        err, atol = gmm_check(torch, ref, x, w, f"{what} {(e, c, d, f)} "
                              f"{dtype} x stride {stride}")
        new.append({"shape": [e, c, d, f],
                    "dtype": str(dtype).replace("torch.", ""),
                    "x_stride": list(stride), "max_abs_err": err,
                    "tolerance": atol})
    emit({"phase": "kernel-at-launched-shapes", "name": "grouped_matmul",
          "of": what, "shapes_launched": len(shapes),
          "in_kernel_phase": len(shapes) - len(new), "checked_here": new})


def count_calls(module, names):
    """Wrap ``module``'s functions ``names`` so that each call adds one to
    its entry of the returned dict (the engine calls the model through
    these names)."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        setattr(module, name, wrapped)
    return counts


# ------------------------------------------------------------------- serve
def traffic(Request, vocab, rng):
    """Three tenants: A — 4 × 200-token prompts (chunked prefill), 64 new
    tokens; B — 4 × 32-token prompts, 16 new; C — 3 requests on one shared
    64-token prefix plus a distinct token, 16 new.  A arrives one tick
    after B and C0; C1 and C2 arrive at tick 3, after C0 published its
    prefix.  Returns {arrival tick: [requests]}."""
    sched = {}

    def at(tick, req):
        sched.setdefault(tick, []).append(req)

    for i in range(4):
        at(1, Request(f"A{i}", "A", rng.integers(0, vocab, 200).tolist(), 64))
    for i in range(4):
        at(0, Request(f"B{i}", "B", rng.integers(0, vocab, 32).tolist(), 16))
    shared = rng.integers(0, vocab, 64).tolist()
    for i in range(3):
        at(0 if i == 0 else 3,
           Request(f"C{i}", "C", shared + [int(rng.integers(0, vocab))], 16))
    return sched


def serve_engine(cfg, params, tenants, int8, pool_pages=POOL_PAGES):
    """The engine under test and its arrival schedule for ``tenants``,
    over a pool of ``pool_pages`` pages."""
    from repro_torch.sched import MursConfig, MursPolicy
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    eng = ServingEngine(
        cfg, params,
        EngineConfig(
            n_slots=N_SLOTS, max_seq=MAX_SEQ,
            hbm_capacity_bytes=cfg.kv_bytes_per_token() * PAGE * pool_pages,
            policy=MursPolicy(MursConfig.for_serving(period=1.0)),
            prefix_cache=True, paged_decode_int8=int8, device=DEV,
        ),
    )
    sched = {
        t: [r for r in reqs if r.tenant in tenants]
        for t, reqs in traffic(Request, cfg.vocab,
                               np.random.default_rng(SEED)).items()
    }
    return eng, sched


def drive(eng, sched):
    """Submit on schedule and step until drained; per tick (host ms,
    produced a token, ran a chunked-prefill continuation)."""
    ticks = []

    def tokens():
        return sum(len(r.generated) for r in eng.requests.values())

    while (eng.has_pending or sched) and eng.tick < 5000:
        for r in sched.pop(eng.tick, []):
            eng.submit(r)
        tokens0 = tokens()
        chunked0 = eng.chunked_prefill_ticks
        s = time.perf_counter()
        eng.step()
        ticks.append((1e3 * (time.perf_counter() - s), tokens() > tokens0,
                      eng.chunked_prefill_ticks > chunked0))
    return ticks


def serve_run(torch, cfg, params, tenants, int8, ops, calls):
    eng, sched = serve_engine(cfg, params, tenants, int8)
    out, eng = run_and_count(torch, cfg, eng, sched, ops, calls,
                             {"int8": int8, "tenants": tenants})
    kernel = ("paged_decode_attention_int8" if int8
              else "paged_decode_attention")
    ticks = eng.paged_int8_ticks if int8 else eng.paged_decode_ticks
    check(ticks > 0, f"serve int8={int8}: no paged decode tick")
    check(out["launches"][kernel] == cfg.n_layers * ticks,
          f"{kernel}: {out['launches'][kernel]} launches != "
          f"{cfg.n_layers} layers x {ticks} ticks")
    return out


def run_and_count(torch, cfg, eng, sched, ops, calls, extra, phase="serve"):
    """Drive ``eng`` with launch and call counters zeroed just before and
    read just after; emit the run's line and check that every request
    completed and that K3 and K4 ran once per attention layer of every
    ``prefill`` and ``decode_step`` call."""
    submitted = sum(len(v) for v in sched.values())
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the main path's counts start here
    calls.update(dict.fromkeys(calls, 0))
    t0 = time.perf_counter()
    ticks = drive(eng, sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    rep = eng.report()
    decode_only = [ms for ms, dec, chk in ticks if dec and not chk]
    n_attn, n_full, n_mamba = block_counts(cfg)
    out = {
        "phase": phase, "arch": cfg.name, **extra,
        "submitted": submitted, "completed": rep.completed,
        "failed": rep.failed, "suspensions": eng.suspensions,
        "prefix_hits": eng.prefix_hits, "ticks": eng.tick,
        "paged_decode_ticks": eng.paged_decode_ticks,
        "paged_int8_ticks": eng.paged_int8_ticks,
        "chunked_prefill_ticks": eng.chunked_prefill_ticks,
        "swap_outs": eng.swap_outs,
        "tokens_generated": rep.tokens_generated,
        "wall_s": wall, "tokens_per_s": rep.tokens_generated / wall,
        "median_token_tick_ms": statistics.median(
            ms for ms, dec, _ in ticks if dec),
        "median_decode_only_tick_ms": (
            statistics.median(decode_only) if decode_only else None),
        "s_in_chunked_prefill_ticks": sum(
            ms for ms, _, chk in ticks if chk) / 1e3,
        "s_in_other_ticks": sum(
            ms for ms, _, chk in ticks if not chk) / 1e3,
        "model_calls": dict(calls),
        "launches": launches,
        "n_slots": N_SLOTS, "max_seq": MAX_SEQ,
        "hbm_capacity_bytes": eng.ecfg.hbm_capacity_bytes,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(out)
    check(rep.completed == submitted and rep.failed == 0,
          f"{phase} {extra}: {rep.completed}/{submitted} completed, "
          f"{rep.failed} failed")
    for rid, req in eng.requests.items():
        check(len(req.generated) == req.max_new_tokens
              and all(0 <= t < cfg.vocab for t in req.generated),
              f"{phase}: {rid} produced malformed tokens")
    check(calls["prefill"] > 0, f"{phase}: no prefill call")
    check(launches["flash_attention"] == n_attn * calls["prefill"],
          f"flash_attention: {launches['flash_attention']} launches != "
          f"{n_attn} attention layers x {calls['prefill']} prefill calls")
    # K6: once per Mamba layer of every prefill; none on an attention stack
    check(launches["ssd_scan"] == n_mamba * calls["prefill"],
          f"ssd_scan: {launches['ssd_scan']} launches != {n_mamba} Mamba "
          f"layers x {calls['prefill']} prefill calls")
    check(launches["decode_attention"] == n_full * calls["decode_step"],
          f"decode_attention: {launches['decode_attention']} launches != "
          f"{n_full} full-attention layers x {calls['decode_step']} "
          "decode_step calls")
    # K5: three expert products per MoE layer of every model call; none
    # on a dense stack
    n_moe = cfg.n_layers if cfg.moe is not None else 0
    n_calls = sum(calls.values())
    check(launches["grouped_matmul"] == 3 * n_moe * n_calls,
          f"grouped_matmul: {launches['grouped_matmul']} launches != 3 x "
          f"{n_moe} MoE layers x {n_calls} model calls")
    check(calls["decode_step_paged"] == eng.paged_decode_ticks,
          f"{phase}: {calls['decode_step_paged']} decode_step_paged calls "
          f"!= {eng.paged_decode_ticks} paged ticks")
    return out, eng


def block_counts(cfg):
    """(layers that attend at prefill — K3 —, layers whose decode is a
    full-attention K4 call, Mamba layers — K6 at prefill).  MLA decodes
    in its absorbed latent form, with no kernel."""
    stack = (list(cfg.block_pattern) * cfg.resolved_pattern_repeats
             + list(cfg.suffix_blocks))
    n_mamba = sum(bt == "mamba" for bt in stack)
    n_full = sum(bt in ("attn", "shared_attn") for bt in stack)
    if cfg.mla is not None:
        n_full = sum(bt == "shared_attn" for bt in stack)
    return len(stack) - n_mamba, n_full, n_mamba


# --------------------------------------------------------------- gemma3
def gemma3_traffic(Request, vocab, rng):
    """A — 2 × (768-token prompt, 32 new), A0 at tick 1 and A1 at tick 2,
    each prefilled in one K3 call whose window mask cuts; B — 4 × (48, 16)
    at tick 0; C — 3 × (64-token shared prefix + 1 token, 16 new), C0 at
    tick 0, C1 and C2 at tick 3."""
    sched = {}

    def at(tick, req):
        sched.setdefault(tick, []).append(req)

    for i in range(2):
        at(1 + i, Request(f"A{i}", "A", rng.integers(0, vocab, 768).tolist(),
                          32))
    for i in range(4):
        at(0, Request(f"B{i}", "B", rng.integers(0, vocab, 48).tolist(), 16))
    shared = rng.integers(0, vocab, 64).tolist()
    for i in range(3):
        at(0 if i == 0 else 3,
           Request(f"C{i}", "C", shared + [int(rng.integers(0, vocab))], 16))
    return sched


def gemma3_engine(cfg, params, device):
    """gemma3's engine and arrival schedule: MURS, 8 slots, max_seq 1024,
    page 16, prefix cache on, a 1024-token prefill budget, and an HBM
    budget of GEMMA_POOL_STATES requests' ring state."""
    from repro_torch.sched import MursConfig, MursPolicy
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    eng = ServingEngine(
        cfg, params,
        EngineConfig(
            n_slots=N_SLOTS, max_seq=MAX_SEQ,
            hbm_capacity_bytes=GEMMA_POOL_STATES * cfg.constant_state_bytes(),
            policy=MursPolicy(MursConfig.for_serving(period=1.0)),
            prefix_cache=True, prefill_chunk_tokens=1024, device=device,
        ),
    )
    return eng, gemma3_traffic(Request, cfg.vocab,
                               np.random.default_rng(SEED))


def serve_gemma3(torch, cfg, params, ops, calls):
    eng, sched = gemma3_engine(cfg, params, DEV)
    out, eng = run_and_count(torch, cfg, eng, sched, ops, calls, {},
                             phase="serve-gemma3")
    check(out["suspensions"] >= 1, "serve-gemma3: no suspension")
    check(out["launches"]["paged_decode_attention"] == 0,
          "serve-gemma3: the paged kernel ran on a sliding-window model")
    check(calls["decode_step"] > 0, "serve-gemma3: no decode_step call")
    return out


def paged_step_batch(torch, cfg, params):
    """The reference phase's batch: 3 requests of 40, 25 and 17 tokens,
    each prefilled (K3) into its slot of 4 dense 64-position caches, and
    one paged decode step over them and a pad row, its pages in a pool
    gathered from the slots.  Returns (lens, slots, caches, the
    prefills' logits, the ``decode_step_paged`` arguments after
    ``params`` and its keyword arguments)."""
    from repro_torch.models import init_cache, prefill

    rng = np.random.default_rng(SEED + 1)
    lens, slots, max_seq = [40, 25, 17], 4, 64
    caches = init_cache(cfg, slots, max_seq, device=DEV)
    prefill_logits = []
    for s, n in enumerate(lens):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                               device=DEV)
        logits, c = prefill(cfg, params, toks, max_seq=max_seq)
        prefill_logits.append(logits)
        for (dk, dv), (pk, pv) in zip(caches["unit"].values(),
                                      c["unit"].values()):
            dk[:, s].copy_(pk[:, 0])
            dv[:, s].copy_(pv[:, 0])
    tables, src_slot, src_idx, pid = [], [], [], 0
    for s, n in enumerate(lens):
        row = list(range(pid, pid + n // PAGE + 1))
        src_slot += [s] * len(row)
        src_idx += list(range(len(row)))
        pid += len(row)
        tables.append(row)
    n_pool = 1 << (pid - 1).bit_length()
    w = 1 << (max(map(len, tables)) - 1).bit_length()
    tab = np.zeros((slots, w), np.int32)
    for r, row in enumerate(tables):
        tab[r, :len(row)] = row
    pad = n_pool - pid
    cuda = dict(dtype=torch.int32, device=DEV)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (slots, 1)), **cuda)
    poss = torch.as_tensor(lens + [0], **cuda)
    args = (tok, caches, poss,
            torch.as_tensor([0, 1, 2, slots], **cuda),
            torch.as_tensor(tab, **cuda),
            torch.as_tensor([n + 1 for n in lens] + [0], **cuda),
            torch.as_tensor(src_slot + [0] * pad, **cuda),
            torch.as_tensor(src_idx + [0] * pad, **cuda))
    return (lens, slots, caches, prefill_logits, args,
            {"page_tokens": PAGE, "n_pool": n_pool})


def reference_phase(torch, cfg, params, ops, phase="reference"):
    """One full-width decode step through K1 against the dense step
    through K4 and the dense step of the plain versions
    (``ops.plain_on_card``), on identical caches and batch shapes (3
    requests plus one pad row / idle slot): logits within LOGIT_ATOL, and
    in each pair every row's argmax equal or the reference's (the plain
    step's, or K4's against K1) top-2 margin a near-tie."""
    from repro_torch.models import decode_step, decode_step_paged

    lens, slots, caches, _, args, kwargs = paged_step_batch(torch, cfg,
                                                            params)
    tok, poss = args[0], args[2]

    def copy():
        return {"unit": {k: (a.clone(), b.clone())
                         for k, (a, b) in caches["unit"].items()},
                "suffix": []}

    dense, plain = copy(), copy()
    logits_p, _ = decode_step_paged(cfg, params, *args, **kwargs)
    rows = torch.arange(len(lens), device=DEV)
    logits_d, _ = decode_step(cfg, params, tok, dense, poss, rows=rows)
    with unmoved_counters(ops, "reference"):
        logits_r, _ = decode_step(cfg, params, tok, plain, poss, rows=rows)
    torch.cuda.synchronize()
    a, b, r = (x[:3, 0].float() for x in (logits_p, logits_d, logits_r))
    # (pair, its logits, the reference whose top-2 margin judges a flip)
    pairs = (("paged_k1_vs_dense_k4", a, b),
             ("paged_k1_vs_dense_plain", a, r),
             ("dense_k4_vs_dense_plain", b, r))
    out = {"phase": phase, "arch": cfg.name, "rows": len(lens),
           "vocab": cfg.vocab, "shape": list(logits_p.shape),
           "max_abs_logit_diff": {}, "tolerance": LOGIT_ATOL,
           "argmax_equal": {}, "top2_margin": {}, "near_tie": {}}
    for what, x, gold in pairs:
        out["max_abs_logit_diff"][what] = (x - gold).abs().max().item()
        out["argmax_equal"][what], out["top2_margin"][what], \
            out["near_tie"][what] = argmax_margins(x, gold)
    emit(out)
    what0 = f"{phase} {cfg.name}"
    check(list(logits_p.shape) == [slots, 1, cfg.vocab], f"{what0}: shape")
    check(torch.isfinite(a).all().item() and torch.isfinite(b).all().item(),
          f"{what0}: non-finite logits")
    for what, err in out["max_abs_logit_diff"].items():
        check(err <= LOGIT_ATOL, f"{what0}: {what} logits differ by {err}")
    for what, _, _ in pairs:
        check_argmax(out["argmax_equal"][what], out["top2_margin"][what],
                     out["near_tie"][what], f"{what0} {what}")


def argmax_margins(x, gold):
    """Per row of [N, V] logits: argmax of ``x`` equal to ``gold``'s, the
    top-2 margin of ``gold``, and its near-tie limit (two bf16 ulps of
    the row's largest |logit|)."""
    top2 = gold.topk(2, dim=-1).values
    return ((x.argmax(-1) == gold.argmax(-1)).tolist(),
            (top2[:, 0] - top2[:, 1]).tolist(),
            [2 * bf16_ulp(row) for row in gold])


def check_argmax(same, margins, ties, what):
    """A row's argmax may differ only at a near-tie of the reference: a
    top-2 margin under two bf16 ulps, which two bf16 paths that round
    their f32 sums in other orders can swap."""
    for row, (eq, margin, tie) in enumerate(zip(same, margins, ties)):
        check(eq or margin < tie, f"{what} row {row}: argmax differs with "
              f"a top-2 margin of {margin} (near-tie limit {tie})")


@contextlib.contextmanager
def unmoved_counters(ops, what):
    """Run a block inside ``ops.plain_on_card`` and check that no kernel
    launch counter moved in it."""
    before = [fn.launches for fn in ops.WRAPPERS]
    with ops.plain_on_card():
        yield
    check([fn.launches for fn in ops.WRAPPERS] == before,
          f"{what}: a kernel launched inside plain_on_card")


def reference_gemma3(torch, cfg, params, ops, prompt=768, steps=8):
    """gemma3 at full width: a ``prompt``-token prefill (past the window,
    so the local rings fold) and ``steps`` decode steps (the rings are
    already wrapped) through K3/K4, and the same inside
    ``ops.plain_on_card`` on the same parameters and tokens: logits of
    every step within LOGIT_ATOL, argmax equal or a near-tie of the plain
    run's logits."""
    from repro_torch.models import decode_step, prefill

    rng = np.random.default_rng(SEED + 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, prompt + steps)),
                           device=DEV)
    poss = torch.arange(prompt, prompt + steps, dtype=torch.int32,
                        device=DEV)

    def run():
        logits, caches = prefill(cfg, params, toks[:, :prompt],
                                 max_seq=MAX_SEQ)
        out = [logits[:, -1]]
        for i in range(steps):
            logits, caches = decode_step(
                cfg, params, toks[:, prompt + i:prompt + i + 1], caches,
                poss[i:i + 1],
            )
            out.append(logits[:, 0])
        return torch.cat(out).float()

    ops.reset_launch_counts()
    kern = run()
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    with unmoved_counters(ops, "reference-gemma3"):
        plain = run()
    torch.cuda.synchronize()
    gap = (kern - plain).abs().amax(dim=-1)
    same, margins, ties = argmax_margins(kern, plain)
    out = {"phase": "reference", "arch": cfg.name, "prompt": prompt,
           "decode_steps": steps,
           "max_abs_logit_diff": gap.max().item(),
           "per_step_max_abs_logit_diff": gap.tolist(),
           "tolerance": LOGIT_ATOL, "argmax_equal": same,
           "top2_margin": margins, "near_tie": ties, "launches": launches}
    emit(out)
    check(torch.isfinite(kern).all().item(), "reference-gemma3: non-finite")
    check(launches["flash_attention"] == cfg.n_layers
          and launches["decode_attention"] == 4 * steps,
          f"reference-gemma3: launches {launches}")
    check(out["max_abs_logit_diff"] <= LOGIT_ATOL,
          f"reference-gemma3: logits differ by {out['max_abs_logit_diff']}")
    check_argmax(same, margins, ties, "reference-gemma3 step")





# ------------------------------------------------------------ granite-moe
def granite_traffic(Request, vocab, rng):
    """A — 3 × (160-token prompt, 48 new) at ticks 1, 2 and 3; B — 4 ×
    (32, 16) at tick 0; C — 3 × (64-token shared prefix + 1 token, 16
    new), C0 at tick 0, C1 and C2 at tick 3."""
    return three_tenants(Request, vocab, rng, GRANITE_PROMPTS, 48)


def three_tenants(Request, vocab, rng, prompts, a_new):
    """A — 3 × (prompts["A"] tokens, ``a_new`` new) at ticks 1, 2 and 3;
    B — 4 × (prompts["B"], 16) at tick 0; C — 3 × (a shared prefix of
    prompts["C"] - 1 tokens + 1 token, 16 new), C0 at tick 0, C1 and C2
    at tick 3."""
    sched = {}

    def at(tick, req):
        sched.setdefault(tick, []).append(req)

    for i in range(3):
        at(1 + i, Request(f"A{i}", "A", rng.integers(
            0, vocab, prompts["A"]).tolist(), a_new))
    for i in range(4):
        at(0, Request(f"B{i}", "B", rng.integers(
            0, vocab, prompts["B"]).tolist(), 16))
    shared = rng.integers(0, vocab, prompts["C"] - 1).tolist()
    for i in range(3):
        at(0 if i == 0 else 3,
           Request(f"C{i}", "C", shared + [int(rng.integers(0, vocab))], 16))
    return sched


def granite_engine(cfg, params, device, pool_pages=GRANITE_POOL_PAGES):
    """granite-moe's engine and arrival schedule: the paged path, MURS, 8
    slots, max_seq 1024, page 16, prefix cache on, a 1024-token prefill
    budget (every prompt in one ``prefill`` call) and an HBM budget of
    ``pool_pages`` pages (serve-deepseek-v2 takes the same engine and
    traffic on the dense path, with a pool of its own)."""
    from repro_torch.sched import MursConfig, MursPolicy
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    eng = ServingEngine(
        cfg, params,
        EngineConfig(
            n_slots=N_SLOTS, max_seq=MAX_SEQ,
            hbm_capacity_bytes=cfg.kv_bytes_per_token() * PAGE * pool_pages,
            policy=MursPolicy(MursConfig.for_serving(period=1.0)),
            prefix_cache=True, prefill_chunk_tokens=1024, device=device,
        ),
    )
    return eng, granite_traffic(Request, cfg.vocab,
                                np.random.default_rng(SEED))


def serve_granite(torch, cfg, params, ops, calls, ref, checked):
    eng, sched = granite_engine(cfg, params, DEV)
    with gmm_shapes(ops) as shapes:
        out, eng = run_and_count(torch, cfg, eng, sched, ops, calls, {},
                                 phase="serve-granite-moe")
    check_launched_gmm_shapes(torch, ref, shapes, checked,
                              "serve-granite-moe")
    check(out["suspensions"] >= 1, "serve-granite-moe: no suspension")
    check(out["prefix_hits"] >= 1, "serve-granite-moe: no prefix hit")
    check(eng.paged_decode_ticks > 0, "serve-granite-moe: no paged tick")
    check(out["launches"]["paged_decode_attention"]
          == cfg.n_layers * eng.paged_decode_ticks,
          f"serve-granite-moe: paged_decode_attention "
          f"{out['launches']['paged_decode_attention']} launches != "
          f"{cfg.n_layers} layers x {eng.paged_decode_ticks} paged ticks")
    return out


@contextlib.contextmanager
def routing(blocks, pinned=None):
    """Record every MoE dispatch, in call order (one call per MoE layer):
    yields a list of (gates [G, N, E], sorted top-k expert ids [G, N, k]).
    With ``pinned`` (such a list from another run) each dispatch takes the
    pinned run's gates instead of its own: the same experts and weights,
    whatever the router computed here."""
    dispatch = blocks.moe_dispatch_row
    seen = []

    def recording(x, gates, top_k, capacity):
        if pinned is not None:
            gates = pinned[len(seen)][0]
        idx = gates.sort(dim=-1, descending=True, stable=True)[1]
        seen.append((gates, idx[..., :top_k].sort(dim=-1)[0]))
        return dispatch(x, gates, top_k, capacity)

    blocks.moe_dispatch_row = recording
    try:
        yield seen
    finally:
        blocks.moe_dispatch_row = dispatch


def routing_flips(a, b, rows=None):
    """(layer, group, token) triples whose top-k expert sets differ
    between two recordings of ``routing``; ``rows`` keeps only the first
    tokens of a one-group decode dispatch (the real rows)."""
    flips = []
    for layer, ((_, x), (_, y)) in enumerate(zip(a, b)):
        if rows is not None:
            x, y = x[:, :rows], y[:, :rows]
        differ = (x != y).any(dim=-1)
        flips += [(layer, *ix) for ix in differ.nonzero().tolist()]
    return flips


def reference_granite(torch, cfg, params, ops):
    """granite-moe at full width, in f32 (the bf16 parameters cast up)
    and in bf16: a 2 × 48-token prefill, and one paged decode step of 3
    requests (40, 25, 17 tokens) plus a pad row from equal caches, through
    the kernels and inside ``ops.plain_on_card``.

    f32: logits within F32_LOGIT_ATOL, argmax equal in every row and no
    top-k choice differs.  bf16: the kernels and the plain versions round
    their f32 sums to bf16 in other orders, and a one-ulp change of a
    hidden state can swap a token's 8th and 9th expert; a swap changes
    that token's function from then on.  Every (layer, token) whose
    expert set differs is counted and reported; their share is held to
    UNPINNED_FLIP_SHARE and the logits to UNPINNED_LOGIT_ATOL.  The
    logits are held to LOGIT_ATOL in a third run: the plain versions with
    each dispatch pinned to the kernel run's gates, which holds the
    kernels' arithmetic to the plain versions' without the routing
    discontinuity.  There the argmax agrees, or the reference's top-2
    margin is below two bf16 ulps of the row's largest |logit| (a
    near-tie: random weights give near-flat logits over 49,155
    tokens)."""
    from repro_torch.models import blocks, decode_step_paged, prefill

    rng = np.random.default_rng(SEED + 5)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 48)), device=DEV)
    lens, max_seq = [40, 25, 17], 64
    seqs = [torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)), device=DEV)
            for n in lens]
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 1)),
                          dtype=torch.int32, device=DEV)
    tok[3] = 0  # the pad row carries token 0, as the engine's do
    tables, src_slot, src_idx, pid = [], [], [], 0
    for s, n in enumerate(lens):
        row = list(range(pid, pid + n // PAGE + 1))
        src_slot += [s] * len(row)
        src_idx += list(range(len(row)))
        pid += len(row)
        tables.append(row)
    n_pool = 1 << (pid - 1).bit_length()
    w = 1 << (max(map(len, tables)) - 1).bit_length()
    tab = np.zeros((4, w), np.int32)
    for r, row in enumerate(tables):
        tab[r, :len(row)] = row
    cuda = dict(dtype=torch.int32, device=DEV)
    paged_args = (
        torch.as_tensor(lens + [0], **cuda),  # poss
        torch.as_tensor([0, 1, 2, len(lens)], **cuda),  # row_slot
        torch.as_tensor(tab, **cuda),
        torch.as_tensor([n + 1 for n in lens] + [0], **cuda),  # seq_lens
        torch.as_tensor(src_slot + [0] * (n_pool - pid), **cuda),
        torch.as_tensor(src_idx + [0] * (n_pool - pid), **cuda),
    )

    for dtype in (torch.float32, torch.bfloat16):
        p = (params if dtype == torch.bfloat16 else
             _map_tensors(params, lambda t: t.float()))
        # the slots' caches, made once (through the kernels) and copied
        # for every run
        per_slot = [prefill(cfg, p, t, max_seq=max_seq)[1]["unit"]["b0"]
                    for t in seqs]
        slots = tuple(torch.cat([c[i] for c in per_slot], dim=1)
                      for i in range(2))

        def run(pin=None):
            """(prefill logits [2, V], decode logits [3, V], routing of
            the prefill, routing of the decode step)."""
            with routing(blocks, pin and pin[2]) as pre_r:
                pre, _ = prefill(cfg, p, prompt, max_seq=max_seq)
            caches = {"unit": {"b0": tuple(t.clone() for t in slots)},
                      "suffix": []}
            with routing(blocks, pin and pin[3]) as dec_r:
                dec, _ = decode_step_paged(cfg, p, tok, caches, *paged_args,
                                           page_tokens=PAGE, n_pool=n_pool)
            return pre[:, -1].float(), dec[:3, 0].float(), pre_r, dec_r

        moe_reference_runs(torch, cfg, ops, dtype, run, prompt, len(lens),
                           "reference", "reference-granite",
                           rows_of_dispatch=len(lens))
        del p, per_slot, slots
        torch.cuda.empty_cache()


def moe_reference_runs(torch, cfg, ops, dtype, run, prompt, rows, phase,
                       label, rows_of_dispatch=None):
    """The checks of an MoE model's reference phase.  ``run(pin)`` gives
    (prefill logits, decode logits of ``rows`` rows, routing of the
    prefill, routing of the decode step; ``rows_of_dispatch`` keeps the
    real rows of a one-group decode dispatch); it runs through the kernels
    (K5 must launch), inside ``ops.plain_on_card``, and there again with
    every dispatch pinned to the kernel run's gates.  f32: logits within
    F32_LOGIT_ATOL, argmax equal in every row, no routing choice differs.
    bf16: the pinned run within LOGIT_ATOL under the near-tie rule; the
    unpinned run's share of differing (layer, token) top-k sets within
    UNPINNED_FLIP_SHARE and its logits within UNPINNED_LOGIT_ATOL."""
    def k5_launches():
        return {fn.__name__: fn.launches
                for fn in ops.WRAPPERS}["grouped_matmul"]

    before = k5_launches()
    kern = run()
    check(k5_launches() > before, f"{label}: K5 did not launch")
    with unmoved_counters(ops, label):
        plain = run()
        pinned = run(pin=kern)
    torch.cuda.synchronize()
    flips = {"prefill": routing_flips(kern[2], plain[2]),
             "decode": routing_flips(kern[3], plain[3],
                                     rows=rows_of_dispatch)}
    out = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
           "dtype": str(dtype).replace("torch.", ""),
           "prefill_shape": list(prompt.shape), "decode_rows": rows,
           "routing_pairs": {"prefill": len(kern[2]) * prompt.numel(),
                             "decode": len(kern[3]) * rows},
           "routing_flip_count": {k: len(v) for k, v in flips.items()},
           "first_flip_layer": {k: min((f[0] for f in v), default=None)
                                for k, v in flips.items()},
           "routing_flips": flips,
           "tolerance": (F32_LOGIT_ATOL if dtype == torch.float32
                         else LOGIT_ATOL)}
    for name, other in (("plain", plain), ("plain_pinned", pinned)):
        for i, what in enumerate(("prefill", "decode")):
            gap = (kern[i] - other[i]).abs().amax(dim=-1)
            out[f"{what}_max_abs_logit_diff_{name}"] = gap.tolist()
            (out[f"{what}_argmax_equal_{name}"],
             out[f"{what}_top2_margin_{name}"],
             out[f"{what}_near_tie_{name}"]) = argmax_margins(kern[i],
                                                              other[i])
    emit(out)
    for i, what in enumerate(("prefill", "decode")):
        check(torch.isfinite(kern[i]).all().item(),
              f"{label} {dtype}: non-finite {what} logits")
    f32 = dtype == torch.float32
    held = "plain" if f32 else "plain_pinned"
    if f32:
        check(not flips["prefill"] and not flips["decode"],
              f"{label} f32: routing differs: {flips}")
    for what in ("prefill", "decode"):
        gaps = out[f"{what}_max_abs_logit_diff_{held}"]
        check(max(gaps) <= out["tolerance"],
              f"{label} {dtype} {what}: logits against "
              f"{held} differ by {max(gaps)}")
        # f32 allows no near-tie
        ties = out[f"{what}_near_tie_{held}"]
        check_argmax(out[f"{what}_argmax_equal_{held}"],
                     out[f"{what}_top2_margin_{held}"],
                     [0.0] * len(ties) if f32 else ties,
                     f"{label} {dtype} {what}")
        if not f32:
            share = (out["routing_flip_count"][what]
                     / out["routing_pairs"][what])
            unpinned = max(out[f"{what}_max_abs_logit_diff_plain"])
            check(share <= UNPINNED_FLIP_SHARE,
                  f"{label} bf16 {what}: {share:.3f} of "
                  f"(layer, token) expert sets differ unpinned")
            check(unpinned <= UNPINNED_LOGIT_ATOL,
                  f"{label} bf16 {what}: unpinned logits "
                  f"differ by {unpinned}")


# ------------------------------------------------------------ mamba2, zamba2
def ssd_dims(cfg):
    """(nh, hd, ds, chunk) of a Mamba-2 config's scans."""
    ssm = cfg.ssm
    return (ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state,
            ssm.chunk_size)


def ssd_cases(m_cfg, z_cfg):
    """(name, B, S, nh, hd, ds, chunk) of K6's kernel phase: mamba2
    prefills of 32, 65, 256, 768 and 1024 tokens, zamba2's of 1024, a
    batch of 3 ragged mamba2 prompts, and a ragged smoke shape."""
    cases = [(f"mamba2_s{s}", 1, s, *ssd_dims(m_cfg))
             for s in (32, 65, 256, 768, 1024)]
    cases.append(("zamba2_s1024", 1, 1024, *ssd_dims(z_cfg)))
    cases.append(("mamba2_b3_s300", 3, 300, *ssd_dims(m_cfg)))
    return cases + [("smoke", 1, 45, 3, 16, 8, 32)]


#: the K6 case in the kernels line: the shape the two serve runs give
#: the kernel most often (a B prompt's prefill)
SSD_LINE_CASE = "mamba2_s32"


def ssd_inputs(torch, gen, b, s, nh, hd, ds):
    """Model-like f32 inputs: SiLU outputs for x, B and C, dt a softplus
    of a normal, and the model's A = -exp(log(linspace(1, 16, nh)))."""
    def silu(*shape):
        return torch.nn.functional.silu(
            torch.randn(*shape, generator=gen, device=DEV))

    x = silu(b, s, nh, hd)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, nh, generator=gen, device=DEV))
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, nh, device=DEV)))
    return x, dt, A, silu(b, s, ds), silu(b, s, ds)


def ssd_check(torch, ref, args, chunk, what):
    """K6 against its plain version: finite, and within SSD_RTOL of max
    |plain|; returns (error, tolerance)."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    out = ssd_scan(*args, chunk)
    gold = ref.ssd_scan_ref(*args, chunk)
    torch.cuda.synchronize()
    err = (out - gold).abs().max().item()
    atol = SSD_RTOL * gold.abs().max().item()
    check(torch.isfinite(out).all().item(), f"ssd_scan {what}: non-finite")
    check(err <= atol, f"ssd_scan {what}: max err {err} > {atol}")
    return err, atol


def ssd_work(b, s, nh, hd, ds, chunk):
    """(bytes, operations) one scan needs: x, dt, A, B and C read once
    and y written once, in f32; C B^T over each chunk's causal pairs once
    (the heads share B and C), and per head the pairs' M x, C . H_in for
    every chunk after the first and the outgoing state of every chunk
    but the last, 2 operations a multiply-add."""
    n_bytes = 4 * (2 * b * s * nh * hd + b * s * nh + nh + 2 * b * s * ds)
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    pairs = sum(n * (n + 1) // 2 for n in lens)
    carried = sum(lens[1:]) + sum(lens[:-1])
    flops = b * (2 * pairs * ds + nh * (2 * pairs * hd
                                        + 2 * carried * hd * ds))
    return n_bytes, flops


def device_kernels(torch, fn, calls=4):
    """The device kernels one call of ``fn`` launches, as ``torch.profiler``
    sees ``calls`` back-to-back calls (warm L2): the count a call, and each
    kernel's device time a call (us), by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    us = {}
    for e in kernels:
        us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us() / calls
    return len(kernels) / calls, us


def ssd_kernel_phase(torch, ref, timer, cases):
    """K6 against its plain version in f32 at ``cases``, with the host time
    of one call; returns its kernels-line entry, the set of (B, S, nh, hd,
    ds, chunk) checked, and each case's line and call for
    ``emit_ssd_lines``.  No single PyTorch call computes the scan:
    library_ms is null."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    results, max_err, checked, pending = {}, 0.0, set(), []
    for name, b, s, nh, hd, ds, chunk in cases:
        args = ssd_inputs(torch, gen, b, s, nh, hd, ds)
        err, atol = ssd_check(torch, ref, args, chunk, name)
        checked.add((b, s, nh, hd, ds, chunk))
        max_err = max(max_err, err)
        n_bytes, flops = ssd_work(b, s, nh, hd, ds, chunk)
        bound_ms, bound_by = bound(n_bytes, flops, torch.float32, torch)
        late = timer.late
        r = {
            "phase": "kernel", "name": "ssd_scan", "case": name,
            "shape": {"B": b, "S": s, "nh": nh, "hd": hd, "ds": ds,
                      "chunk": chunk},
            "max_abs_err": err, "tolerance": atol,
            "ms": time_ms(torch, lambda: ssd_scan(*args, chunk), timer),
            "plain_ms": time_ms(
                torch, lambda: ref.ssd_scan_ref(*args, chunk), timer),
            "library_ms": None,
            "host_ms": host_ms(torch, lambda: ssd_scan(*args, chunk)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "flops": flops,
        }
        r["late_windows"] = timer.late - late
        results[name] = r
        pending.append((r, lambda a=args, c=chunk: ssd_scan(*a, c)))
    return ({"ssd_scan": {**results[SSD_LINE_CASE], "max_abs_err": max_err}},
            checked, pending)


def emit_ssd_lines(torch, pending):
    """Emit K6's ``kernel`` lines, each with the device kernels one call
    launches and their device time.  A full run calls this after its
    serve phases, so that ``torch.profiler`` runs after every host time
    they read."""
    for r, fn in pending:
        launched, kernel_us = device_kernels(torch, fn)
        emit(with_rates({**r, "device_kernels": launched,
                         "device_kernel_us": kernel_us}))


@contextlib.contextmanager
def ssd_shapes(ops):
    """Count the (B, S, nh, hd, ds, chunk) of every ``ops`` SSD scan made
    inside the block (the model calls it by this name); yields the
    dict."""
    scan = ops.ssd_scan
    seen = {}

    def recording(x, dt, A, Bm, C, chunk):
        key = (*x.shape, Bm.shape[-1], chunk)
        seen[key] = seen.get(key, 0) + 1
        return scan(x, dt, A, Bm, C, chunk)

    ops.ssd_scan = recording
    try:
        yield seen
    finally:
        ops.ssd_scan = scan


def check_launched_ssd_shapes(torch, ref, shapes, checked, what):
    """Hold K6 to its plain version at every recorded shape the kernel
    phase did not check; emit what was done and how often each shape
    ran."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    new = []
    for key in sorted(shapes):
        if key in checked:
            continue
        b, s, nh, hd, ds, chunk = key
        err, atol = ssd_check(torch, ref, ssd_inputs(torch, gen, b, s, nh,
                                                     hd, ds),
                              chunk, f"{what} {key}")
        checked.add(key)
        new.append({"shape": list(key), "max_abs_err": err,
                    "tolerance": atol})
    emit({"phase": "kernel-at-launched-shapes", "name": "ssd_scan",
          "of": what, "shapes_launched": len(shapes),
          "launches_by_shape": [[list(k), n] for k, n in
                                sorted(shapes.items())],
          "checked_here": new})


def ssm_engine(cfg, params, device):
    """mamba2's or zamba2's engine and arrival schedule: the dense path
    (neither is paged), MURS, 8 slots, max_seq 1024, page 16, prefix cache
    on, a 1024-token prefill budget (every prompt in one ``prefill``
    call, K6 on whole chunks) and an HBM budget of SSM_POOL_STATES
    requests' constant state."""
    from repro_torch.sched import MursConfig, MursPolicy
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    eng = ServingEngine(
        cfg, params,
        EngineConfig(
            n_slots=N_SLOTS, max_seq=MAX_SEQ,
            hbm_capacity_bytes=SSM_POOL_STATES[cfg.name]
            * cfg.constant_state_bytes(),
            policy=MursPolicy(MursConfig.for_serving(period=1.0)),
            prefix_cache=True, prefill_chunk_tokens=1024, device=device,
        ),
    )
    return eng, three_tenants(Request, cfg.vocab,
                              np.random.default_rng(SEED), SSM_PROMPTS, 32)


def serve_ssm(torch, cfg, params, ops, calls, ref, checked):
    phase = "serve-" + cfg.name.split("-")[0]
    eng, sched = ssm_engine(cfg, params, DEV)
    with ssd_shapes(ops) as shapes:
        out, eng = run_and_count(torch, cfg, eng, sched, ops, calls, {},
                                 phase=phase)
    check_launched_ssd_shapes(torch, ref, shapes, checked, phase)
    launches = out["launches"]
    for name in ("paged_decode_attention", "paged_decode_attention_int8",
                 "grouped_matmul"):
        check(launches[name] == 0, f"{phase}: {name} launched")
    check(calls["decode_step_paged"] == 0 and eng.paged_decode_ticks == 0,
          f"{phase}: a paged decode step on an unpaged model")
    check(launches["ssd_scan"] > 0, f"{phase}: K6 never launched")
    check(out["suspensions"] >= 1, f"{phase}: no suspension")
    return out


def reference_ssm(torch, cfg, params, ops, prompts=(1024, 777), steps=8):
    """mamba2 or zamba2 at full width, in f32 (the bf16 parameters cast
    up) and in bf16: a prefill of each prompt length (1024 tokens, four
    whole chunks; 777, a ragged last chunk) and ``steps`` decode steps,
    through the kernels (K6 at prefill; zamba2's shared attention K3 and
    K4) and inside ``ops.plain_on_card``; both decode chains start from
    the kernel prefill's caches.  f32: logits within F32_LOGIT_ATOL and
    argmax equal in every row.  bf16: logits within SSM_BF16_LOGIT_ATOL,
    and argmax equal unless the plain run's top-2 margin is under two
    bf16 ulps of the row's largest |logit|."""
    from repro_torch.models import decode_step, prefill

    rng = np.random.default_rng(SEED + 7)
    _, _, n_mamba = block_counts(cfg)
    for dtype in (torch.float32, torch.bfloat16):
        p = (params if dtype == torch.bfloat16 else
             _map_tensors(params, lambda t: t.float()))
        f32 = dtype == torch.float32
        for prompt in prompts:
            toks = torch.as_tensor(
                rng.integers(0, cfg.vocab, (1, prompt + steps)), device=DEV)
            poss = torch.arange(prompt, prompt + steps, dtype=torch.int32,
                                device=DEV)
            max_seq = prompt + steps

            def decode(caches):
                out = []
                for i in range(steps):
                    logits, caches = decode_step(
                        cfg, p, toks[:, prompt + i:prompt + i + 1], caches,
                        poss[i:i + 1])
                    out.append(logits[:, 0])
                return out

            ops.reset_launch_counts()
            pre_k, caches = prefill(cfg, p, toks[:, :prompt],
                                    max_seq=max_seq)
            launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
            start = _map_tensors(caches, lambda t: t.clone())
            kern = torch.cat([pre_k[:, -1]] + decode(caches)).float()
            with unmoved_counters(ops, f"reference-{cfg.name}"):
                pre_p, _ = prefill(cfg, p, toks[:, :prompt],
                                   max_seq=max_seq)
                plain = torch.cat([pre_p[:, -1]] + decode(start)).float()
            torch.cuda.synchronize()
            gap = (kern - plain).abs().amax(dim=-1)
            same, margins, ties = argmax_margins(kern, plain)
            out = {"phase": "reference", "arch": cfg.name,
                   "dtype": str(dtype).replace("torch.", ""),
                   "prompt": prompt, "decode_steps": steps,
                   "max_abs_logit_diff": gap.max().item(),
                   "per_row_max_abs_logit_diff": gap.tolist(),
                   "argmax_equal": same, "top2_margin": margins,
                   "near_tie": ties,
                   "tolerance": (F32_LOGIT_ATOL if f32
                                 else SSM_BF16_LOGIT_ATOL),
                   "prefill_launches": launches}
            emit(out)
            what = f"reference-{cfg.name} {out['dtype']} S {prompt}"
            check(torch.isfinite(kern).all().item(), f"{what}: non-finite")
            check(launches["ssd_scan"] == n_mamba,
                  f"{what}: {launches['ssd_scan']} K6 launches != "
                  f"{n_mamba} Mamba layers")
            check(out["max_abs_logit_diff"] <= out["tolerance"],
                  f"{what}: logits differ by {out['max_abs_logit_diff']}")
            # f32 allows no near-tie
            check_argmax(same, margins, [0.0] * len(ties) if f32 else ties,
                         what)
            del caches, start
        del p
        torch.cuda.empty_cache()


# ----------------------------------------------------------- serve-cluster
# ----------------------------------------------------------- serve-cluster
def cluster_tenants(TenantProfile):
    """chat: weight 3, prompts 16–48 tokens, 16–32 new; bulk: weight 1,
    prompts 48–64, 48–96 new.  Every prompt fits one 64-token prefill
    chunk.  Token ids 1–CLUSTER_VOCAB: the trace's random draws depend on
    the vocabulary, and a rehearsal at smoke width must draw this one."""
    return (
        TenantProfile("chat", weight=3.0, prompt_tokens=(16, 48),
                      output_tokens=(16, 32), vocab=CLUSTER_VOCAB),
        TenantProfile("bulk", weight=1.0, prompt_tokens=(48, 64),
                      output_tokens=(48, 96), vocab=CLUSTER_VOCAB),
    )


def cluster_engine(cfg, pages, device):
    """One replica's engine config, as ``serve_engine``'s: MURS, 8 slots,
    max_seq 1024, page 16, prefix cache on, paged decode."""
    from repro_torch.sched import MursConfig, MursPolicy
    from repro_torch.serve import EngineConfig

    return EngineConfig(
        n_slots=N_SLOTS, max_seq=MAX_SEQ,
        hbm_capacity_bytes=cfg.kv_bytes_per_token() * PAGE * pages,
        policy=MursPolicy(MursConfig.for_serving(period=1.0)),
        prefix_cache=True, device=device,
    )


class CheckpointLog:
    """Wraps a cluster's ``_write_checkpoint``: times each write, sums
    its modeled and on-disk bytes, and keeps each replica's newest
    snapshot to hold its file against."""

    def __init__(self, cl):
        self.seconds, self.count, self.file_bytes = 0.0, 0, 0
        self.raw_bytes, self.stored_bytes = 0.0, 0.0
        self.newest = {}
        write = cl._write_checkpoint

        def timed(replica, snap):
            t0 = time.perf_counter()
            write(replica, snap)
            self.seconds += time.perf_counter() - t0
            self.count += 1
            self.raw_bytes += snap["raw_bytes"]
            self.stored_bytes += snap["stored_bytes"]
            path = Path(cl._ckpt_dir(replica)) / f"ckpt_{cl.tick}.ckpt"
            self.file_bytes += path.stat().st_size
            self.newest[replica] = (path, snap)

        cl._write_checkpoint = timed


def check_checkpoint_file(path, snap, what):
    """Read a checkpoint back with the port's ``restore_leaves`` and
    codec: its manifest must be the snapshot's and every page payload
    bit-equal to the snapshot's, in manifest order."""
    from repro_torch.checkpoint import _msgpack, restore_leaves

    leaves, _ = restore_leaves(str(path))
    manifest = _msgpack.unpackb(leaves[0].tobytes())
    want = [{"rid": e["rid"], "pos": int(e["pos"]),
             "generated": [int(t) for t in e["generated"]],
             "pages": sorted(e["pages"])} for e in snap["reqs"]]
    check(manifest["reqs"] == want, f"{what}: manifest differs")
    payloads = [np.asarray(e["pages"][j]) for e in snap["reqs"]
                for j in sorted(e["pages"])]
    check(len(leaves) == 1 + len(payloads), f"{what}: leaf count")
    for got, ref in zip(leaves[1:], payloads):
        check(got.dtype == ref.dtype and got.shape == ref.shape
              and got.tobytes() == ref.tobytes(),
              f"{what}: a page payload differs from the snapshot")
    return len(payloads)


def serve_cluster(torch, cfg, params, ops, calls, smi):
    """The service: a front door (MURS shedding, a token bucket on bulk)
    over two replicas of ``cfg`` sharing ``params``, a seeded Poisson
    trace of chat and bulk, KV checkpoints every CLUSTER_CKPT_EVERY
    ticks, replica 1 slowed until the straggler pass migrates work off
    it, and replica 0 crashed and restored from its newest checkpoint.
    Launch and call counters are zeroed just before the run and read
    just after."""
    import gc
    import shutil
    import tempfile
    from collections import deque

    from repro_torch.sched import MursConfig, MursPolicy
    from repro_torch.serve import (
        ClusterConfig, FrontDoor, FrontDoorConfig, ServingCluster,
        TenantProfile, poisson_trace,
    )

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="cluster_ckpt_", dir=scratch)
    cl = ServingCluster(cfg, params, ClusterConfig(
        engine=lambda: cluster_engine(cfg, CLUSTER_POOL_PAGES, DEV),
        n_replicas=2, router=MursPolicy(MursConfig.for_serving()),
        checkpoint_every_ticks=CLUSTER_CKPT_EVERY, checkpoint_dir=ckpt_dir,
        checkpoint_page_budget=CLUSTER_CKPT_PAGES,
    ))
    door = FrontDoor(cl, FrontDoorConfig(
        pressure_threshold=CLUSTER_PRESSURE,
        buckets={"bulk": CLUSTER_BULK_BUCKET}))
    check(door.policy is cl.router, "serve-cluster: the door must shed "
          "with the cluster's MURS router")
    trace = deque(poisson_trace(
        cluster_tenants(TenantProfile), rate_per_tick=CLUSTER_RATE,
        n_requests=CLUSTER_REQUESTS, seed=SEED))
    ckpt = CheckpointLog(cl)
    done, dead = {}, {"paged_decode_ticks": 0, "suspensions": 0}
    mem = {}

    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the main path's counts start here
    calls.update(dict.fromkeys(calls, 0))
    t0 = time.perf_counter()
    while (trace or cl.has_pending) and cl.tick < 2000:
        while trace and trace[0].tick <= cl.tick:
            door.submit(trace.popleft().request)
        if cl.tick == CLUSTER_SLOW[0]:
            cl.set_slowdown(1, CLUSTER_SLOW[1])
        if cl.tick == CLUSTER_SLOW[2]:
            cl.set_slowdown(1, 1.0)
        if cl.tick == CLUSTER_CRASH_TICK:
            check(ckpt.newest.get(0) is not None,
                  "serve-cluster: no checkpoint of replica 0 before its crash")
            eng = cl.replicas[0]
            dead["paged_decode_ticks"] += eng.paged_decode_ticks
            dead["suspensions"] += eng.suspensions
            del eng
            torch.cuda.synchronize()
            mem["allocated_before_crash_gib"] = (
                torch.cuda.memory_allocated() / 2**30)
            mem["max_allocated_before_crash_gib"] = (
                torch.cuda.max_memory_allocated() / 2**30)
            cl.crash_replica(0)
            gc.collect()
            torch.cuda.synchronize()
            mem["allocated_after_crash_gib"] = (
                torch.cuda.memory_allocated() / 2**30)
            mem["max_allocated_after_crash_gib"] = (
                torch.cuda.max_memory_allocated() / 2**30)
        door.step()
        for eng in cl.replicas:
            for rid, r in eng.requests.items():
                if r.state == "done" and rid not in done:
                    done[rid] = (list(r.generated), r.max_new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    model_calls = dict(calls)
    rep = door.run(max_ticks=cl.tick)
    x = rep.extras
    paged_ticks = dead["paged_decode_ticks"] + sum(
        eng.paged_decode_ticks for eng in cl.replicas)
    suspensions = dead["suspensions"] + sum(
        eng.suspensions for eng in cl.replicas)
    counts = {
        "admitted": x["admitted"], "shed": x["shed"],
        "rate_limited": x["rate_limited"], "completed": rep.completed,
        "ticks": cl.tick, "suspensions": suspensions,
        "straggler_flags": x["straggler_flags"],
        "migrations": x["migrations"]["completed"],
        "checkpoints": x["checkpoint"]["saved"],
        "restored": x["checkpoint"]["restored_requests"],
        "restore_outcomes": x["checkpoint"]["outcomes"],
        "requeued": x["requeued"], "paged_decode_ticks": paged_ticks,
        "model_calls": model_calls,
    }
    checked_pages = {}
    for replica, (path, snap) in sorted(ckpt.newest.items()):
        checked_pages[replica] = check_checkpoint_file(
            path, snap, f"serve-cluster checkpoint of replica {replica}")
    shutil.rmtree(ckpt_dir)
    out = {
        "phase": "serve-cluster", "arch": cfg.name, "replicas": 2,
        "counts": counts, "wall_s": wall,
        "tokens_generated": rep.tokens_generated,
        "tokens_per_s": rep.tokens_generated / wall,
        "submitted": rep.submitted, "lost": x["lost"],
        "failed": rep.failed,
        "in_flight_unfinished": x["in_flight_unfinished"],
        "shed_by_tenant": x["shed_by_tenant"],
        "migration_raw_bytes": x["migrations"]["raw_bytes"],
        "migration_wire_bytes": x["migrations"]["wire_bytes"],
        "checkpoint_raw_bytes": ckpt.raw_bytes,
        "checkpoint_stored_bytes_modeled": ckpt.stored_bytes,
        "checkpoint_file_bytes": ckpt.file_bytes,
        "checkpoint_write_s": ckpt.seconds,
        "checkpoint_count": ckpt.count,
        "checkpoint_pages_read_back": checked_pages,
        "restored_tokens": x["checkpoint"]["restored_tokens"],
        "replayed_tokens": x["checkpoint"]["replayed_tokens"],
        "from_zero_tokens": x["checkpoint"]["from_zero_tokens"],
        "memory": mem, "launches": launches,
        "pool_pages": CLUSTER_POOL_PAGES, "nvidia_smi": smi,
    }
    emit(out)
    # every submission ends in exactly one outcome row
    rids = [o.request_id for o in rep.outcomes]
    check(len(rids) == len(set(rids)) == rep.submitted == CLUSTER_REQUESTS,
          f"serve-cluster: {len(rids)} outcome rows for {rep.submitted} "
          f"submissions")
    check(x["admitted"] + x["shed"] + x["rate_limited"] == rep.submitted,
          "serve-cluster: admitted + shed + rate-limited != submitted")
    check(x["shed"] >= 1, "serve-cluster: the door shed nothing")
    check(x["rate_limited"] >= 1, "serve-cluster: no request rate-limited")
    check(rep.completed == x["admitted"] and rep.failed == 0
          and x["lost"] == 0 and x["in_flight_unfinished"] == 0,
          f"serve-cluster: {rep.completed}/{x['admitted']} admitted "
          f"completed, {rep.failed} failed, {x['lost']} lost")
    check(sorted(done) == sorted(cl.completed),
          "serve-cluster: completions seen on the replicas differ")
    for rid, (toks, want) in done.items():
        check(len(toks) == want and all(0 <= t < cfg.vocab for t in toks),
              f"serve-cluster: {rid} produced malformed tokens")
    for rid in cl._home:
        check(sum(rid in eng.requests for eng in cl.replicas) <= 1,
              f"serve-cluster: {rid} lives on two replicas")
    check(suspensions >= 1, "serve-cluster: no suspension on a replica")
    check(x["straggler_flags"] >= 1, "serve-cluster: no straggler flag")
    m = x["migrations"]
    check(m["started"] == m["completed"] >= 1,
          f"serve-cluster: migrations {m['started']} started, "
          f"{m['completed']} completed")
    ck = x["checkpoint"]
    check(ck["saved"] >= 1 and ck["restored_requests"] >= 1,
          "serve-cluster: no checkpoint saved or no request restored")
    check(set(ck["outcomes"]) <= {"live", "suffix"},
          f"serve-cluster: restore outcomes {ck['outcomes']}")
    # a quarter of one engine's slot caches (N_SLOTS × MAX_SEQ tokens):
    # the crashed engine's must have gone with it
    slack_gib = 0.25 * N_SLOTS * MAX_SEQ * cfg.kv_bytes_per_token() / 2**30
    check(mem["allocated_after_crash_gib"]
          <= mem["allocated_before_crash_gib"] + slack_gib,
          "serve-cluster: the crashed engine's caches were not released")
    # K1 once per layer of every paged decode tick, K3 of every prefill,
    # K4 of every decode_step; K2, K5 and K6 never
    check(model_calls["decode_step_paged"] == paged_ticks,
          "serve-cluster: decode_step_paged calls != paged decode ticks")
    for name, n in (("paged_decode_attention", paged_ticks),
                    ("flash_attention", model_calls["prefill"]),
                    ("decode_attention", model_calls["decode_step"])):
        check(launches[name] == cfg.n_layers * n,
              f"serve-cluster: {name} {launches[name]} launches != "
              f"{cfg.n_layers} layers x {n}")
    for name in ("paged_decode_attention_int8", "grouped_matmul",
                 "ssd_scan"):
        check(launches[name] == 0, f"serve-cluster: {name} launched")
    check(counts == CLUSTER_COUNTS,
          f"serve-cluster: counts {counts} differ from the rehearsal's "
          f"{CLUSTER_COUNTS}")
    return out


def migration_parity(torch, cfg, params, ops):
    """One 48-token request with 32 new tokens, migrated off its home on
    a 2-replica cluster after 8 tokens, against the same request alone
    on one engine (a batch of one on both sides): the tokens must be
    equal, or the first flip a near-tie of the unmigrated run's logits."""
    from repro_torch.models import prefill
    from repro_torch.serve import (
        ClusterConfig, Request, ServingCluster, ServingEngine,
    )

    prompt = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab, 48).tolist()
    pages = (len(prompt) + 32) // PAGE + 2

    ref = ServingEngine(cfg, params, cluster_engine(cfg, pages, DEV))
    ref.submit(Request("m", "T", list(prompt), 32))
    ref.run(max_ticks=200)
    # the straggler pass stays off: against an idle replica, the one
    # serving the request always reads slow and would pull it back
    cl = ServingCluster(cfg, params, ClusterConfig(
        engine=lambda: cluster_engine(cfg, pages, DEV), n_replicas=2,
        straggler_min_samples=10**9))
    cl.submit(Request("m", "T", list(prompt), 32))
    while cl.tick < 200:
        cl.step()
        src = cl._home["m"]
        if len(cl.replicas[src].requests["m"].generated) >= 8:
            break
    check(cl.migrate("m", src), "migration-parity: the export failed")
    out = cl.run(max_ticks=300).extras
    tgt = cl._home["m"]
    got = cl.replicas[tgt].requests["m"].generated
    gold = ref.requests["m"].generated
    line = {"phase": "migration-parity", "arch": cfg.name, "source": src,
            "target": tgt, "migrated_at_token": 8,
            "migrations": out["migrations"], "tokens_equal": got == gold}
    if got != gold:
        k = next(i for i, (a, b) in enumerate(zip(got, gold)) if a != b)
        toks = torch.as_tensor([prompt + gold[:k]], device=DEV)
        with unmoved_counters(ops, "migration-parity"):
            logits, _ = prefill(cfg, params, toks, max_seq=MAX_SEQ)
        row = logits[0, -1:].float()
        _, margins, ties = argmax_margins(row, row)
        line.update({"first_flip": k, "top2_margin": margins[0],
                     "near_tie_limit": ties[0]})
    emit(line)
    if got != gold:
        check_argmax([False], [line["top2_margin"]],
                     [line["near_tie_limit"]], "migration-parity first flip")
    check(tgt != src and out["migrations"]["completed"] == 1,
          "migration-parity: the request did not migrate")
    check(len(got) == 32, "migration-parity: the request did not finish")
    return line

# --------------------------------------------------------------- simulator
def sim_fields(m):
    """A ServiceMetrics as the plain data SIM_EXPECTED holds: every field,
    with the per-task peak live bytes as their count and the SHA-256 of
    their sorted (task, bytes) pairs' repr."""
    import dataclasses
    import hashlib

    d = dataclasses.asdict(m)
    peak = d.pop("peak_task_live")
    d["peak_task_live"] = {
        "tasks": len(peak),
        "sha256": hashlib.sha256(
            repr(sorted(peak.items())).encode()).hexdigest(),
    }
    return d


def simulator_runs():
    """The simulator runs SIM_EXPECTED holds, by name."""
    from repro_torch.core import MursConfig
    from repro_torch.core.spark_sim import (
        make_grep, make_sort, make_wc, run_batch, run_service,
    )

    def mix():
        return [make_sort(), make_wc(), make_grep()]

    runs = {"fair": run_service(mix(), heap_gb=6.0, oom_is_fatal=False),
            "murs": run_service(mix(), heap_gb=6.0, murs=MursConfig(),
                                oom_is_fatal=False)}
    for jid, m in run_batch(mix(), heap_gb=6.0).items():
        runs[f"batch_{jid}"] = m
    return {name: sim_fields(m) for name, m in runs.items()}


def simulator_phase():
    """The paper's Spark-fidelity simulator (``repro_torch.core``; host
    only): every field equal to SIM_EXPECTED, and the paper's claims —
    MURS suspends, and grep, the light job, finishes sooner under MURS
    than under FAIR."""
    t0 = time.perf_counter()
    got = simulator_runs()
    emit({"phase": "simulator", "seconds": time.perf_counter() - t0,
          "runs": got})
    check(set(got) == set(SIM_EXPECTED), f"simulator: runs {sorted(got)}")
    for name, want in SIM_EXPECTED.items():
        check(got[name] == want, f"simulator {name}: {got[name]} != the "
              f"rehearsal's {want}")
    fair, murs = got["fair"], got["murs"]
    check(murs["suspensions"] > 0, "simulator: MURS never suspended")
    check(murs["jobs"]["grep"]["finish_time"]
          < fair["jobs"]["grep"]["finish_time"],
          "simulator: grep no sooner under MURS")


# ------------------------------------------------------- the rest of the zoo
def check_counts(out, expected, phase):
    """A serve run's schedule equal to the CPU rehearsal's."""
    got = {k: out[k] for k in expected}
    check(got == expected,
          f"{phase}: counts {got} != the rehearsal's {expected}")


def serve_stablelm(torch, cfg, params, ops, calls):
    """stablelm-1.6b through ``serve``'s engine (the paged path under
    MURS) with tenants B and C over STABLELM_POOL_PAGES: K1 once per layer
    of every paged tick, K3 of every ``prefill``, K4 of every
    ``decode_step``; K2, K5 and K6 never; the schedule as rehearsed."""
    phase = "serve-stablelm"
    eng, sched = serve_engine(cfg, params, ("B", "C"), False,
                              STABLELM_POOL_PAGES)
    out, eng = run_and_count(torch, cfg, eng, sched, ops, calls,
                             {"tenants": ["B", "C"],
                              "pool_pages": STABLELM_POOL_PAGES},
                             phase=phase)
    launches = out["launches"]
    check(eng.paged_decode_ticks > 0, f"{phase}: no paged decode tick")
    check(launches["paged_decode_attention"]
          == cfg.n_layers * eng.paged_decode_ticks,
          f"{phase}: paged_decode_attention "
          f"{launches['paged_decode_attention']} launches != "
          f"{cfg.n_layers} layers x {eng.paged_decode_ticks} paged ticks")
    check(launches["paged_decode_attention_int8"] == 0,
          f"{phase}: K2 launched")
    check(out["suspensions"] > 0, f"{phase}: no suspension")
    check_counts(out, STABLELM_COUNTS, phase)
    return out


def serve_deepseek(torch, cfg, params, ops, calls, ref, checked):
    """deepseek-v2 on serve-granite-moe's engine and traffic, on the dense
    path (MLA latents are not pool pages) under MURS, over
    DEEPSEEK_POOL_PAGES: K3 once per layer of every ``prefill`` (q/k 192
    wide, V 128 padded), K5 three times per layer of every model call,
    every K5 shape launched held to the plain version; K1, K2, K4 and K6
    never; the schedule as rehearsed."""
    phase = "serve-deepseek-v2"
    eng, sched = granite_engine(cfg, params, DEV, DEEPSEEK_POOL_PAGES)
    with gmm_shapes(ops) as shapes:
        out, eng = run_and_count(torch, cfg, eng, sched, ops, calls,
                                 {"pool_pages": DEEPSEEK_POOL_PAGES},
                                 phase=phase)
    check_launched_gmm_shapes(torch, ref, shapes, checked, phase)
    launches = out["launches"]
    for name in ("paged_decode_attention", "paged_decode_attention_int8",
                 "decode_attention", "ssd_scan"):
        check(launches[name] == 0, f"{phase}: {name} launched")
    check(calls["decode_step_paged"] == 0 and eng.paged_decode_ticks == 0,
          f"{phase}: a paged decode step on an MLA model")
    check(launches["flash_attention"] > 0 and launches["grouped_matmul"] > 0,
          f"{phase}: K3 or K5 never launched")
    check(out["suspensions"] > 0, f"{phase}: no suspension")
    check_counts(out, DEEPSEEK_COUNTS, phase)
    return out


def reference_deepseek(torch, cfg, params, ops):
    """deepseek-v2: a 2 x 48-token prefill, and one dense decode step of
    3 rows (40, 25 and 17 tokens, each its own dispatch group, as the
    engine's dense path runs them) from equal per-slot caches, through
    the kernels (K3 with V padded to q's width, K5 at 160 experts) and
    inside ``ops.plain_on_card``, held by ``moe_reference_runs``: in f32
    no routing choice may differ, in bf16 the plain run pinned to the
    kernel run's gates within LOGIT_ATOL and the unpinned top-k flips
    counted.  The MLA decode is plain torch on both sides."""
    from repro_torch.models import blocks, decode_step, prefill

    dtype = params["embed"]["tokens"].dtype
    rng = np.random.default_rng(SEED + 10)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 48)), device=DEV)
    lens, max_seq = [40, 25, 17], 64
    seqs = [torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)), device=DEV)
            for n in lens]
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (len(lens), 1)),
                          dtype=torch.int32, device=DEV)
    poss = torch.as_tensor(lens, dtype=torch.int32, device=DEV)
    per_slot = [prefill(cfg, params, t, max_seq=max_seq)[1]["unit"]
                for t in seqs]
    slots = {k: tuple(torch.cat([c[k][i] for c in per_slot], dim=1)
                      for i in range(2)) for k in per_slot[0]}
    del per_slot

    def run(pin=None):
        with routing(blocks, pin and pin[2]) as pre_r:
            pre, _ = prefill(cfg, params, prompt, max_seq=max_seq)
        caches = {"unit": {k: tuple(t.clone() for t in v)
                           for k, v in slots.items()}, "suffix": []}
        with routing(blocks, pin and pin[3]) as dec_r:
            dec, _ = decode_step(cfg, params, tok, caches, poss)
        return pre[:, -1].float(), dec[:, 0].float(), pre_r, dec_r

    moe_reference_runs(torch, cfg, ops, dtype, run, prompt, len(lens),
                       "reference-zoo", "reference-deepseek-v2")


def frontend_extra(torch, cfg):
    """whisper's WHISPER_FRAMES frame embeddings or internvl2's patch
    embeddings: seeded unit normals in bf16, [1, n, d_model]."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    if cfg.enc_layers:
        key, n = "frame_embeds", WHISPER_FRAMES
    else:
        key, n = "patch_embeds", cfg.vision_tokens
    return {key: torch.randn(1, n, cfg.d_model, generator=gen,
                             device=DEV).to(torch.bfloat16)}


def reference_frontend(torch, cfg, params, ops, atol=LOGIT_ATOL):
    """whisper-base or internvl2-26b at full width and depth, at the model
    level (the engine serves neither: its requests carry no ``extra``;
    ROADMAP Queue 3): ``prefill(extra=...)`` of a ZOO_PROMPT-token prompt
    and ZOO_STEPS decode steps through the kernels, then inside
    ``ops.plain_on_card``, on the same parameters and inputs.  K3 runs
    once per layer of the prefill (and in whisper once per encoder layer
    and once per decoder layer's cross-attention, there also at Sq = 1 in
    every step), K4 once per decoder layer of every step.  Logits of
    every step within ``atol``; argmax equal, or in bf16 a near-tie of
    the plain run's."""
    from repro_torch.models import decode_step, prefill

    extra = frontend_extra(torch, cfg)
    rng = np.random.default_rng(SEED + 11)
    toks = torch.as_tensor(
        rng.integers(0, cfg.vocab, (1, ZOO_PROMPT + ZOO_STEPS)), device=DEV)
    n0 = ZOO_PROMPT + extra.get("patch_embeds", toks[:, :0]).shape[1]

    def run():
        logits, caches = prefill(cfg, params, toks[:, :ZOO_PROMPT],
                                 extra=extra, max_seq=n0 + ZOO_STEPS)
        out = [logits[:, -1]]
        for i in range(ZOO_STEPS):
            t = ZOO_PROMPT + i
            logits, caches = decode_step(cfg, params, toks[:, t:t + 1],
                                         caches, n0 + i)
            out.append(logits[:, 0])
        return torch.cat(out).float()

    ops.reset_launch_counts()
    kern = run()
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    with unmoved_counters(ops, f"reference-{cfg.name}"):
        plain = run()
    torch.cuda.synchronize()
    n, cross = cfg.n_layers, bool(cfg.enc_layers)
    want = {"flash_attention": cfg.enc_layers + n + (n + n * ZOO_STEPS
                                                      if cross else 0),
            "decode_attention": n * ZOO_STEPS}
    gap = (kern - plain).abs().amax(dim=-1)
    same, margins, ties = argmax_margins(kern, plain)
    dtype = params["embed"]["tokens"].dtype
    if dtype == torch.float32:
        ties = [0.0] * len(ties)  # f32 allows no near-tie
    out = {"phase": "reference-zoo", "arch": cfg.name, "layers": n,
           "dtype": str(dtype).replace("torch.", ""),
           "enc_layers": cfg.enc_layers,
           "extra": {k: list(v.shape) for k, v in extra.items()},
           "prompt": ZOO_PROMPT, "decode_steps": ZOO_STEPS,
           "max_abs_logit_diff": gap.max().item(),
           "per_step_max_abs_logit_diff": gap.tolist(),
           "tolerance": atol, "argmax_equal": same,
           "top2_margin": margins, "near_tie": ties, "launches": launches,
           "expected_launches": want}
    emit(out)
    what = f"reference-{cfg.name} {out['dtype']}"
    check(torch.isfinite(kern).all().item(), f"{what}: non-finite logits")
    for name, count in want.items():
        check(launches[name] == count,
              f"{what}: {name} launched {launches[name]} times, not {count}")
    for name in ("paged_decode_attention", "paged_decode_attention_int8",
                 "grouped_matmul", "ssd_scan"):
        check(launches[name] == 0, f"{what}: {name} launched")
    check(out["max_abs_logit_diff"] <= atol,
          f"{what}: logits differ by {out['max_abs_logit_diff']}")
    check_argmax(same, margins, ties, f"{what} step")


def zoo_phases(torch, ARCHS, init_model, ops, calls, ref, gmm_checked):
    """serve-stablelm, serve-deepseek-v2 and reference-zoo, each model's
    weights freed before the next loads; returns the two serve runs.
    deepseek-v2 and qwen1.5 keep their full width at a cut depth."""
    import dataclasses
    import gc

    def depth(name, layers):
        return dataclasses.replace(ARCHS[name], n_layers=layers)

    def free():
        """Return a model's memory to the card before the next loads: a
        serve phase's engine holds the params and sits in reference
        cycles, which only the cycle collector frees."""
        gc.collect()
        torch.cuda.empty_cache()

    free()  # the earlier phases' engines, too
    cfg = ARCHS["stablelm-1.6b"]
    params = init_params(torch, cfg, init_model)
    stablelm = serve_stablelm(torch, cfg, params, ops, calls)
    reference_phase(torch, cfg, params, ops, phase="reference-zoo")
    del params
    free()

    for layers, dtype in ((DEEPSEEK_LAYERS, torch.bfloat16),
                          (DEEPSEEK_F32_LAYERS, torch.float32)):
        cfg = depth("deepseek-v2-236b", layers)
        params = init_params(torch, cfg, init_model, dtype=dtype)
        if dtype == torch.bfloat16:
            deepseek = serve_deepseek(torch, cfg, params, ops, calls, ref,
                                      gmm_checked)
        with gmm_shapes(ops) as shapes:
            reference_deepseek(torch, cfg, params, ops)
        check_launched_gmm_shapes(torch, ref, shapes, gmm_checked,
                                  f"reference-deepseek-v2 {dtype}")
        del params
        free()

    cfg = depth("qwen1.5-110b", QWEN_LAYERS)
    params = init_params(torch, cfg, init_model)
    reference_phase(torch, cfg, params, ops, phase="reference-zoo")
    del params
    free()

    for cfg, dtype, atol in (
            (ARCHS["whisper-base"], torch.bfloat16, LOGIT_ATOL),
            (ARCHS["internvl2-26b"], torch.bfloat16,
             INTERNVL2_BF16_LOGIT_ATOL),
            (depth("internvl2-26b", INTERNVL2_F32_LAYERS), torch.float32,
             F32_LOGIT_ATOL)):
        params = init_params(torch, cfg, init_model, dtype=dtype)
        reference_frontend(torch, cfg, params, ops, atol)
        del params
        free()
    return stablelm, deepseek


# ---------------------------------------------------------------- training
def flash_bwd_work(b, h, kv, s, hd, vd, causal, window):
    """(bytes, operations, kept pairs, rows without a key) K3's backward
    needs in bf16 at self-attention over ``s`` positions: q, o, dO, k and
    v read and dq, dk and dv written once, the LSE read; five products a
    kept pair — S and dP recomputed once, dV, dK, dQ — 2 (3 hd + 2 vd)
    operations (the kernels execute seven: the dQ kernel recomputes S and
    dP)."""
    pairs, empty = kept_pairs(s, s, causal, window, 0)
    n_bytes = (2 * (b * h * s * (2 * hd + 2 * vd)
                    + 2 * b * kv * s * (hd + vd)) + 4 * b * h * s)
    flops = 2 * (3 * hd + 2 * vd) * b * h * pairs
    return n_bytes, flops, pairs, empty


def train_kernel_phase(torch, F, ref, timer):
    """K3's backward against autodiff of its plain version at
    TRAIN_FLASH_CASES in f32 and bf16, timed in bf16.  Returns the
    kernels-line entry of K3's backward: its internlm2 case, with the
    largest bf16 error of every case."""
    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention, flash_attention_bwd,
    )

    gen = torch.Generator(device=DEV).manual_seed(SEED + 20)

    def rand(dtype, *shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    def plain_grads(fn, dout, *inputs):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return out, leaves, torch.autograd.grad(out, leaves, dout,
                                                retain_graph=True)

    results = {}
    worst = 0.0
    for name, b, h, kv, s, hd, vd, causal, window in TRAIN_FLASH_CASES:
        kw = dict(causal=causal, window=window)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q = rand(dtype, b, h, s, hd)
            k = rand(dtype, b, kv, s, hd)
            v = rand(dtype, b, s, kv, vd).transpose(1, 2)
            dout = rand(dtype, b, s, h, vd).transpose(1, 2)
            # as ops pads a narrow V for the kernel, and the output's slice
            # pads its gradient
            vp = F.pad(v, (0, hd - vd)) if vd < hd else v
            dp = F.pad(dout, (0, hd - vd)) if vd < hd else dout
            out, lse = flash_attention(q, k, vp, return_lse=True, **kw)
            got = flash_attention_bwd(q, k, vp, out, dp, lse, **kw)
            again = flash_attention_bwd(q, k, vp, out, dp, lse, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                  f"flash_attention_bwd {name} {dtype}: two launches differ")
            del again
            got = (got[0], got[1], got[2][..., :vd])
            pout, leaves, want = plain_grads(
                lambda *t: ref.flash_attention_ref(*t, **kw), dout, q, k, v)
            torch.cuda.synchronize()
            key = str(dtype).replace("torch.", "")
            errs[key] = {}
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                check(torch.isfinite(g.float()).all().item(),
                      f"flash_attention_bwd {name} {key}: non-finite {gname}")
                err = (g.float() - w.float()).abs().max().item()
                big = w.float().abs().max().item()
                atol = (TRAIN_F32_ATOL * max(big, 1.0)
                        if dtype == torch.float32
                        else BWD_BF16_ULPS * bf16_ulp(w))
                check(err <= atol, f"flash_attention_bwd {name} {key} "
                      f"{gname}: max err {err} > {atol}")
                errs[key][gname] = {"max_abs_err": err, "tolerance": atol}
            if dtype == torch.float32:
                del q, k, v, dout, vp, dp, out, lse, got, pout, leaves, want
                continue
            worst = max([worst] + [e["max_abs_err"]
                                   for e in errs[key].values()])
            n_bytes, flops, pairs, empty = flash_bwd_work(
                b, h, kv, s, hd, vd, causal, window)
            bound_ms, bound_by = bound(n_bytes, flops, dtype, torch)
            kr = ref.repeat_kv(k, h // kv).detach().clone().requires_grad_()
            vr = ref.repeat_kv(v, h // kv).detach().clone().requires_grad_()
            qs = q.detach().clone().requires_grad_()
            qpos = torch.arange(s, device=DEV)[:, None]
            kpos = torch.arange(s, device=DEV)[None, :]
            mask = None
            if causal or window:
                mask = (kpos <= qpos) if causal else torch.ones(
                    s, s, dtype=torch.bool, device=DEV)
                if window:
                    mask = mask & (qpos - kpos < window)
            lib = F.scaled_dot_product_attention(qs, kr, vr, attn_mask=mask)
            late = timer.late
            r = {
                "phase": "train-kernel", "name": "flash_attention_bwd",
                "case": name,
                "shape": {"B": b, "H": h, "KV": kv, "S": s, "hd": hd,
                          "vd": vd, "causal": causal, "window": window},
                "kept_pairs": pairs, "rows_without_key": empty,
                "errors": errs, "deterministic": True,
                "max_abs_err": max(
                    e["max_abs_err"] for e in errs[key].values()),
                "route": bwd_route(dtype, hd),
                "ms": time_ms(torch, lambda: flash_attention_bwd(
                    q, k, vp, out, dp, lse, **kw), timer),
                "parent_ms": PARENT_BWD_MS["flash_attention_bwd"][name],
                "host_ms": host_ms(torch, lambda: flash_attention_bwd(
                    q, k, vp, out, dp, lse, **kw)),
                "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
                    pout, leaves, dout, retain_graph=True), timer),
                "library_masked_ms": time_ms(
                    torch, lambda: torch.autograd.grad(
                        lib, (qs, kr, vr), dout, retain_graph=True), timer),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": n_bytes, "flops": flops,
            }
            # library_ms: the faster of SDPA's masked backward and, where
            # the mask is plain causal, its is_causal one
            r["library_ms"] = r["library_masked_ms"]
            if causal and not window:
                lib_c = F.scaled_dot_product_attention(qs, kr, vr,
                                                       is_causal=True)
                r["library_causal_ms"] = time_ms(
                    torch, lambda: torch.autograd.grad(
                        lib_c, (qs, kr, vr), dout, retain_graph=True), timer)
                r["library_ms"] = min(r["library_ms"], r["library_causal_ms"])
                del lib_c
            r["late_windows"] = timer.late - late
            emit(with_rates(r))
            results[name] = r
            del q, k, v, dout, vp, dp, out, lse, got, pout, leaves, want
            del kr, vr, qs, lib
            torch.cuda.empty_cache()

    return {**results["internlm2"], "max_abs_err": worst}


def gmm_bwd_work(e, c, d, f, elem=2):
    """((bytes, operations) of K5's backward pair, and of one of its
    products alone): the pair reads x, w and dy and writes dx and dw
    once, two products of 2 E C D F operations; a product reads its two
    operands and writes its result once (both products move E (C D + D F
    + C F) elements)."""
    xs, ws, ys = e * c * d, e * d * f, e * c * f
    return ((elem * (2 * xs + 2 * ws + ys), 4 * e * c * d * f),
            (elem * (xs + ws + ys), 2 * e * c * d * f))


def gmm_bwd_check(torch, ref, x, w, dy, what):
    """K5's backward on (x, w, dy) against autodiff of K5's plain version:
    finite, dx and dw each within one bf16 ulp of the largest |gradient|
    (GMM_BWD_F32_ATOL in f32), and two launches bit-equal; returns
    {"dx": {max_abs_err, tolerance}, "dw": {...}}."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul_bwd

    got = grouped_matmul_bwd(x, w, dy)
    again = grouped_matmul_bwd(x, w, dy)
    leaves = [t.detach().clone().requires_grad_() for t in (x, w)]
    want = torch.autograd.grad(ref.grouped_matmul_ref(*leaves), leaves, dy)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"grouped_matmul_bwd {what}: two launches differ")
    errs = {}
    for name, g, p in zip(("dx", "dw"), got, want):
        check(torch.isfinite(g.float()).all().item(),
              f"grouped_matmul_bwd {what}: non-finite {name}")
        err = (g.float() - p.float()).abs().max().item()
        atol = (GMM_BWD_F32_ATOL if x.dtype == torch.float32
                else bf16_ulp(p))
        check(err <= atol, f"grouped_matmul_bwd {what} {name}: max err "
              f"{err} > {atol}")
        errs[name] = {"max_abs_err": err, "tolerance": atol}
    return errs


def gmm_bwd_kernel_phase(torch, ref, timer, granite_cfg):
    """K5's backward (dX = dY W^T and dW = X^T dY in one launch) at
    granite's training shapes (the expert capacity of two 2,048-token
    sequences, gate/up and down) against autodiff of K5's plain version
    (gmm_bwd_check), in f32 (the CUDA-core route) and bf16 (wgmma), the
    bf16 pair timed beside torch.bmm's two products, the parent's route
    and the bounds; K5's forward at the same capacity timed beside
    torch.bmm, recorded only.  Returns the kernels-line entry: gate/up,
    with the largest bf16 error of both cases."""
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul, grouped_matmul_bwd,
    )
    from repro_torch.models.blocks import _capacity

    gen = torch.Generator(device=DEV).manual_seed(SEED + 21)

    def rand(dtype, *shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    e, c = granite_cfg.moe.num_experts, 2 * _capacity(granite_cfg, TRAIN_SEQ)
    dm, ff = granite_cfg.d_model, granite_cfg.moe.d_ff_expert
    results, worst = {}, 0.0
    for case, d, f in (("gate_up", dm, ff), ("down", ff, dm)):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            x = rand(dtype, e, c, d)
            w = (rand(torch.float32, e, d, f) / math.sqrt(d)).to(dtype)
            dy = rand(dtype, e, c, f)
            key = str(dtype).replace("torch.", "")
            errs[key] = gmm_bwd_check(torch, ref, x, w, dy, f"{case} {key}")
            if dtype == torch.float32:
                del x, w, dy
                continue
            err = max(v["max_abs_err"] for v in errs[key].values())
            worst = max(worst, err)
            (n_bytes, flops), (one_bytes, one_flops) = gmm_bwd_work(
                e, c, d, f)
            bound_ms, bound_by = bound(n_bytes, flops, dtype, torch)
            one_ms, one_by = bound(one_bytes, one_flops, dtype, torch)

            def library():
                torch.bmm(dy, w.transpose(1, 2))
                torch.bmm(x.transpose(1, 2), dy)

            late = timer.late
            r = {"phase": "train-kernel", "name": "grouped_matmul_bwd",
                 "case": case, "shape": {"E": e, "C": c, "D": d, "F": f},
                 "errors": errs, "deterministic": True, "max_abs_err": err,
                 "route": "wgmma",
                 "ms": time_ms(torch, lambda: grouped_matmul_bwd(x, w, dy),
                               timer),
                 "parent_ms": PARENT_BWD_MS["grouped_matmul_bwd"][case],
                 "host_ms": host_ms(
                     torch, lambda: grouped_matmul_bwd(x, w, dy)),
                 "plain_ms": time_ms(
                     torch, lambda: ref.grouped_matmul_bwd_ref(x, w, dy),
                     timer),
                 "library_ms": time_ms(torch, library, timer),
                 "library_dx_ms": time_ms(
                     torch, lambda: torch.bmm(dy, w.transpose(1, 2)), timer),
                 "library_dw_ms": time_ms(
                     torch, lambda: torch.bmm(x.transpose(1, 2), dy), timer),
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "bytes": n_bytes, "flops": flops,
                 "product_bound_ms": one_ms, "product_bound_by": one_by,
                 "product_bytes": one_bytes, "product_flops": one_flops,
                 # K5's forward at the training capacity, not redesigned
                 # here (sized for serving, C 4 to 256); it moves and
                 # computes what one backward product does
                 "forward": {
                     "ms": time_ms(torch, lambda: grouped_matmul(x, w),
                                   timer),
                     "library_ms": time_ms(torch, lambda: torch.bmm(x, w),
                                           timer),
                     "bound_ms": one_ms, "bound_by": one_by}}
            r["library_sum_ms"] = r["library_dx_ms"] + r["library_dw_ms"]
            r["late_windows"] = timer.late - late
            emit(with_rates(r))
            results[case] = r
            del x, w, dy
    torch.cuda.empty_cache()
    return {**results["gate_up"], "max_abs_err": worst}


def check_launched_gmm_bwd_shapes(torch, ref, shapes, what):
    """Hold K5's backward to autodiff of K5's plain version at every
    recorded forward shape (its x strides too; dy [E, C, F]
    contiguous); emit what was done."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 23)
    done = []
    for e, c, d, f, dtype, stride in sorted(shapes, key=str):
        x, w = gmm_inputs(torch, gen, dtype, e, c, d, f, x_stride=stride)
        dy = torch.randn(e, c, f, generator=gen, device=DEV).to(dtype)
        errs = gmm_bwd_check(torch, ref, x, w, dy, f"{what} {(e, c, d, f)} "
                             f"{dtype} x stride {stride}")
        done.append({"shape": [e, c, d, f],
                     "dtype": str(dtype).replace("torch.", ""),
                     "x_stride": list(stride), "errors": errs})
        del x, w, dy
    emit({"phase": "kernel-at-launched-shapes", "name": "grouped_matmul_bwd",
          "of": what, "checked_here": done})


@contextlib.contextmanager
def attention_shapes(ops):
    """Record (B, H, KV, S, q/k width, V width, the V width K3 and its
    backward receive, dtype) of every ``ops.flash_attention`` call made
    inside the block that autograd records (so K3's backward runs at it;
    the model calls it by this name); yields the set.  For a gradient the
    wrapper zero-pads a V narrower than q/k (MLA's 128) to q/k's width
    (192) before the kernels run."""
    attention = ops.flash_attention
    seen = set()

    def attend(q, k, v, **kwargs):
        if ops._needs_grad(q, k, v):
            hd, vd = q.shape[3], v.shape[-1]
            seen.add((*q.shape[:2], k.shape[1], q.shape[2], hd, vd,
                      max(hd, vd), str(q.dtype).replace("torch.", "")))
        return attention(q, k, v, **kwargs)

    ops.flash_attention = attend
    try:
        yield seen
    finally:
        ops.flash_attention = attention


def train_ssd_cases(m_cfg, z_cfg):
    """(name, B, S, nh, hd, ds, chunk) of K6's backward in train-kernel:
    mamba2's and zamba2's training microbatch (B 2 x S 2,048 of the
    train-mamba2 phase: 8 whole chunks), a ragged S (1,000: three whole
    chunks and 232 positions) and a one-chunk S (200)."""
    micro = TRAIN_BATCH // TRAIN_MICRO
    return [("mamba2", micro, TRAIN_SEQ, *ssd_dims(m_cfg)),
            ("zamba2", micro, TRAIN_SEQ, *ssd_dims(z_cfg)),
            ("mamba2_ragged", 1, 1000, *ssd_dims(m_cfg)),
            ("mamba2_one_chunk", micro, 200, *ssd_dims(m_cfg))]


def tf32_bound_ms(flops):
    """The least time (ms) for ``flops`` f32 operations run as 3xTF32
    tensor-core products (TF32_PASSES TF32 operations each)."""
    return 1e3 * flops * TF32_PASSES / TF32_PEAK_FLOPS


def ssd_bwd_work(b, s, nh, hd, ds, chunk):
    """(bytes, operations) K6's backward needs: x, dy, dt, A, B and C read
    and dx, ddt, dA, dB and dC written once, in f32; per chunk the
    scores, dC and dB of the intra terms once (the heads' dscores summed
    first: 6 ds a causal pair), and per head dM and dx (4 hd a pair),
    dC_in and G_c for every chunk after the first and S_c, the state's
    dx and v for every chunk but the last (4 and 6 hd ds a row), 2
    operations a multiply-add (``ssd_scan_bwd.cu``'s note)."""
    n_bytes = 4 * (3 * b * s * nh * hd + 2 * b * s * nh + 2 * nh
                   + 4 * b * s * ds)
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    pairs = sum(n * (n + 1) // 2 for n in lens)
    flops = b * (6 * pairs * ds + nh * (
        4 * pairs * hd + 4 * sum(lens[1:]) * hd * ds
        + 6 * sum(lens[:-1]) * hd * ds))
    return n_bytes, flops


def ssd_bwd_kernel_phase(torch, ref, timer, cases):
    """K6's backward (``ssd_scan_bwd``) against autodiff of the plain scan
    in f32 at ``cases``: all five gradients within SSD_BWD_RTOL of max
    |plain|, and a second launch bit-equal to the first; timed against
    the plain autodiff and its operations bound (no PyTorch call computes
    the scan: library_ms is null), with one call's host time.  Returns
    its kernels-line entry: the SSD_BWD_LINE_CASE case, with the largest
    error of every case."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    gen = torch.Generator(device=DEV).manual_seed(SEED + 21)
    results, worst = {}, 0.0
    names = ("dx", "ddt", "dA", "dB", "dC")
    for name, b, s, nh, hd, ds, chunk in cases:
        args = ssd_inputs(torch, gen, b, s, nh, hd, ds)
        dy = torch.randn(b, s, nh, hd, generator=gen, device=DEV)
        got = ssd_scan_bwd(*args, dy, chunk)
        again = ssd_scan_bwd(*args, dy, chunk)
        leaves = [t.detach().clone().requires_grad_() for t in args]
        y = ref.ssd_scan_ref(*leaves, chunk)
        want = torch.autograd.grad(y, leaves, dy, retain_graph=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
              f"ssd_scan_bwd {name}: two launches differ")
        errs = {}
        for gname, g, w in zip(names, got, want):
            check(torch.isfinite(g).all().item(),
                  f"ssd_scan_bwd {name}: non-finite {gname}")
            err = (g - w).abs().max().item()
            atol = SSD_BWD_RTOL[gname] * w.abs().max().item()
            check(err <= atol, f"ssd_scan_bwd {name} {gname}: max err "
                  f"{err} > {atol}")
            errs[gname] = {"max_abs_err": err, "tolerance": atol,
                           "rel_to_max": err / w.abs().max().item()}
        worst = max([worst] + [e["max_abs_err"] for e in errs.values()])
        n_bytes, flops = ssd_bwd_work(b, s, nh, hd, ds, chunk)
        bound_ms, bound_by = bound(n_bytes, flops, torch.float32, torch)
        late = timer.late
        r = {
            "phase": "train-kernel", "name": "ssd_scan_bwd", "case": name,
            "shape": {"B": b, "S": s, "nh": nh, "hd": hd, "ds": ds,
                      "chunk": chunk},
            "errors": errs, "deterministic": True,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "ms": time_ms(torch, lambda: ssd_scan_bwd(*args, dy, chunk),
                          timer),
            "parent_ms": PARENT_BWD_MS["ssd_scan_bwd"][name],
            "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
                y, leaves, dy, retain_graph=True), timer),
            "library_ms": None,
            "host_ms": host_ms(torch, lambda: ssd_scan_bwd(*args, dy,
                                                           chunk)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_3xtf32_ms": tf32_bound_ms(flops),
            "bytes": n_bytes, "flops": flops,
        }
        r["late_windows"] = timer.late - late
        emit(with_rates(r))
        results[name] = r
        del args, dy, got, again, leaves, y, want
        torch.cuda.empty_cache()
    return {**results[SSD_BWD_LINE_CASE], "max_abs_err": worst}


def bwd_split_phase(torch, ARCHS):
    """Where one call of each redesigned backward spends its time: the
    device kernels ``torch.profiler`` sees (warm L2) for K3's backward at
    its kernels-line case (internlm2, B 4, bf16) and K6's at mamba2's
    training microbatch, each kernel's device time a call (us).  Run
    after every timed phase: the profiler leaves later host launches
    slower."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd,
    )
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    gen = torch.Generator(device=DEV).manual_seed(SEED + 22)
    name, b, h, kv, s, hd, _, causal, window = TRAIN_FLASH_CASES[0]
    kw = dict(causal=causal, window=window)
    q, dout = (torch.randn(b, h, s, hd, generator=gen,
                           device=DEV).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, kv, s, hd, generator=gen, device=DEV).bfloat16()
            for _ in range(2))
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    launched, us = device_kernels(
        torch, lambda: flash_attention_bwd(q, k, v, out, dout, lse, **kw))
    emit({"phase": "train-kernel-split", "name": "flash_attention_bwd",
          "case": name, "device_kernels": launched,
          "device_kernel_us": us})
    del q, k, v, dout, out, lse
    name, b, s, nh, hd, ds, chunk = train_ssd_cases(
        ARCHS["mamba2-2.7b"], ARCHS["zamba2-1.2b"])[0]
    args = ssd_inputs(torch, gen, b, s, nh, hd, ds)
    dy = torch.randn(b, s, nh, hd, generator=gen, device=DEV)
    launched, us = device_kernels(
        torch, lambda: ssd_scan_bwd(*args, dy, chunk))
    emit({"phase": "train-kernel-split", "name": "ssd_scan_bwd",
          "case": name, "device_kernels": launched,
          "device_kernel_us": us})
    del args, dy
    torch.cuda.empty_cache()


def checkpoint_meta(path):
    """The ``meta`` map of a checkpoint file, from its first bytes
    inflated, after checking that they open the JAX package's container:
    a map of ``meta`` then ``leaves``, an array of ``n_leaves``."""
    import zlib

    from repro_torch.checkpoint import _msgpack

    with open(path, "rb") as f:
        blob = f.read(1 << 20)
    if blob[:4] == b"\x28\xb5\x2f\xfd":  # zstd, where zstandard exists
        import zstandard

        raw = zstandard.ZstdDecompressor().decompressobj().decompress(blob)
    else:
        raw = zlib.decompressobj().decompress(blob)
    head = _msgpack.header("map", 2) + _msgpack.packb("meta")
    check(raw.startswith(head), f"{path}: not the JAX package's container")
    reader = _msgpack._Reader(raw[len(head):])
    meta = reader.obj()
    rest = bytes(raw[len(head) + reader.pos:])
    check(rest.startswith(_msgpack.packb("leaves") + _msgpack.header(
        "array", meta["n_leaves"])), f"{path}: no leaves array after meta")
    return meta


def free_memory(torch):
    """Collect cycles and return cached blocks before a model loads."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def train_run(torch, ops, cfg, tcfg, phase, extra, smi, batch=TRAIN_BATCH):
    """One ``Trainer.run`` of ``cfg`` (``batch`` x TRAIN_SEQ) with every
    launch counter zeroed just before and read just after; emits the
    run's line (steps, losses, step seconds, tokens/s, peak memory) and
    checks that every loss is finite."""
    from repro_torch.configs import SHAPES
    from repro_torch.train import Trainer

    free_memory(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the main path's counts start here
    t0 = time.perf_counter()
    trainer = Trainer(cfg, SHAPES["train_4k"], tcfg, batch=batch,
                      seq=TRAIN_SEQ)
    out = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    log = out["log"]
    step_s = [m["step_time_s"] for m in log]
    tokens = batch * TRAIN_SEQ
    r = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers, **extra,
         "batch": batch, "seq": TRAIN_SEQ,
         "microbatches": 1 if tcfg.grad_compression else tcfg.microbatches,
         "steps": [m["step"] for m in log],
         "losses": [m["loss"] for m in log],
         "grad_norms": [m["grad_norm"] for m in log],
         "step_s": step_s, "tokens_per_s": [tokens / t for t in step_s],
         "wall_s": wall,
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
         "compressed_wire_bytes": trainer.compressed_wire_bytes,
         "launches": launches, "nvidia_smi": smi}
    emit(r)
    check(all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]),
          f"{phase} {extra}: a non-finite loss or grad norm")
    del trainer
    free_memory(torch)
    return r


def check_train_launches(r, n_attn, n_moe, steps, micro, phase,
                         n_mamba=0):
    """K3 forward twice per attention layer of every microbatch (the
    unit's remat recomputes it), its backward once; K5 three times per
    MoE layer forward and three in the recompute, its backward three
    times (one launch per expert product); K6 twice per Mamba-2 layer of
    the repeated unit, its backward once; no decode kernel."""
    la = r["launches"]
    want = {
        "flash_attention": 2 * n_attn * micro * steps,
        "flash_attention_bwd": n_attn * micro * steps,
        "grouped_matmul": 6 * n_moe * micro * steps,
        "grouped_matmul_bwd": 3 * n_moe * micro * steps,
        "ssd_scan": 2 * n_mamba * micro * steps,
        "ssd_scan_bwd": n_mamba * micro * steps,
        "paged_decode_attention": 0, "paged_decode_attention_int8": 0,
        "decode_attention": 0,
    }
    for name, n in want.items():
        check(la[name] == n, f"{phase}: {name} launched {la[name]} times, "
              f"predicted {n}")


def train_internlm2(torch, ARCHS, ops, smi):
    """internlm2-1.8b at full width and depth through the port's Trainer:
    TRAIN_STEPS steps of TRAIN_MICRO microbatches with a checkpoint every
    TRAIN_CKPT_EVERY; a second Trainer on the same directory that resumes
    from the last checkpoint and runs to TRAIN_RESUME_STEPS; a run with
    int8 error-feedback gradient compression (one microbatch, as the JAX
    package's compressed step; no checkpoint).  Returns the three runs."""
    import dataclasses
    import os
    import shutil

    from repro_torch.checkpoint import checkpointing
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainerConfig

    checkpointing.ZLIB_LEVEL = TRAIN_CKPT_ZLIB_LEVEL  # this process's files
    cfg = ARCHS["internlm2-1.8b"]
    root = ROOT / "build" / "chip_train"
    shutil.rmtree(root, ignore_errors=True)
    ckpt_dir = root / "internlm2"
    tcfg = TrainerConfig(
        steps=TRAIN_STEPS, microbatches=TRAIN_MICRO,
        ckpt_every=TRAIN_CKPT_EVERY, log_every=1, seed=SEED,
        ckpt_dir=str(ckpt_dir), device=DEV,
        opt=AdamWConfig(warmup_steps=1, total_steps=TRAIN_RESUME_STEPS))
    n = cfg.n_layers
    phase = "train-internlm2"
    first = train_run(torch, ops, cfg, tcfg, phase, {"run": "first"}, smi)
    check(first["steps"] == list(range(1, TRAIN_STEPS + 1)),
          f"{phase}: logged steps {first['steps']}")
    check_train_launches(first, n, 0, TRAIN_STEPS, TRAIN_MICRO, phase)
    names = sorted(os.listdir(ckpt_dir))
    want = [f"ckpt_{s}.ckpt" for s in range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1,
                                             TRAIN_CKPT_EVERY)]
    check(names == sorted(want), f"{phase}: checkpoints {names}")
    last = ckpt_dir / f"ckpt_{TRAIN_STEPS}.ckpt"
    meta = checkpoint_meta(last)
    check(meta["step"] == TRAIN_STEPS and (meta["n_leaves"] - 1) % 3 == 0,
          f"{phase}: checkpoint meta {meta}: not (params, AdamWState) at "
          f"step {TRAIN_STEPS}")
    emit({"phase": phase, "checkpoint": str(last.relative_to(ROOT)),
          "meta": meta, "bytes": last.stat().st_size,
          "zlib_level": TRAIN_CKPT_ZLIB_LEVEL})
    for name in names[:-1]:  # the resume reads the newest; keep the disk
        os.remove(ckpt_dir / name)
    second = train_run(torch, ops, cfg, dataclasses.replace(
        tcfg, steps=TRAIN_RESUME_STEPS), phase, {"run": "resume"}, smi)
    check(second["steps"] == list(range(TRAIN_STEPS + 1,
                                        TRAIN_RESUME_STEPS + 1)),
          f"{phase}: the second trainer logged {second['steps']}, not a "
          f"resume from step {TRAIN_STEPS}")
    check_train_launches(second, n, 0, TRAIN_RESUME_STEPS - TRAIN_STEPS,
                         TRAIN_MICRO, phase)
    shutil.rmtree(ckpt_dir)
    third = train_run(torch, ops, cfg, dataclasses.replace(
        tcfg, steps=TRAIN_COMPRESSION_STEPS, grad_compression=True,
        ckpt_every=10**9, ckpt_dir=str(root / "compressed")), phase,
        {"run": "grad_compression"}, smi)
    check_train_launches(third, n, 0, TRAIN_COMPRESSION_STEPS, 1, phase)
    check(third["compressed_wire_bytes"] is not None
          and cfg.param_count() < third["compressed_wire_bytes"]
          < 1.01 * cfg.param_count(),
          f"{phase}: compressed_wire_bytes {third['compressed_wire_bytes']} "
          f"for {cfg.param_count()} parameters")
    shutil.rmtree(root, ignore_errors=True)
    return [first, second, third]


def train_granite(torch, ARCHS, ops, ref, smi, gmm_checked):
    """granite-moe-3b-a800m at full width, GRANITE_TRAIN_LAYERS layers,
    GRANITE_TRAIN_STEPS steps of TRAIN_MICRO microbatches: K5 forward,
    recomputed and backward, counted; every K5 shape it launches held to
    the plain version, forward and backward."""
    import dataclasses
    import shutil

    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainerConfig

    cfg = dataclasses.replace(ARCHS["granite-moe-3b-a800m"],
                              n_layers=GRANITE_TRAIN_LAYERS,
                              pattern_repeats=None)
    root = ROOT / "build" / "chip_train"
    tcfg = TrainerConfig(
        steps=GRANITE_TRAIN_STEPS, microbatches=TRAIN_MICRO,
        ckpt_every=10**9, log_every=1, seed=SEED,
        ckpt_dir=str(root / "granite"), device=DEV,
        opt=AdamWConfig(warmup_steps=1, total_steps=GRANITE_TRAIN_STEPS))
    with gmm_shapes(ops) as shapes:
        r = train_run(torch, ops, cfg, tcfg, "train-granite", {}, smi)
    n = cfg.n_layers
    check_train_launches(r, n, n, GRANITE_TRAIN_STEPS, TRAIN_MICRO,
                         "train-granite")
    check_launched_gmm_shapes(torch, ref, shapes, gmm_checked,
                              "train-granite")
    check_launched_gmm_bwd_shapes(torch, ref, shapes, "train-granite")
    shutil.rmtree(root, ignore_errors=True)
    return r


def train_mamba2(torch, ARCHS, ops, smi):
    """mamba2-2.7b at full width and depth through the port's Trainer:
    TRAIN_BATCH x TRAIN_SEQ, MAMBA_TRAIN_STEPS steps of TRAIN_MICRO
    microbatches, no checkpoint; K6 forward twice per layer of every
    microbatch (the remat recomputes it), its backward once."""
    import shutil

    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainerConfig

    cfg = ARCHS["mamba2-2.7b"]
    root = ROOT / "build" / "chip_train"
    tcfg = TrainerConfig(
        steps=MAMBA_TRAIN_STEPS, microbatches=TRAIN_MICRO,
        ckpt_every=10**9, log_every=1, seed=SEED,
        ckpt_dir=str(root / "mamba2"), device=DEV,
        opt=AdamWConfig(warmup_steps=1, total_steps=MAMBA_TRAIN_STEPS))
    r = train_run(torch, ops, cfg, tcfg, "train-mamba2", {}, smi)
    check(r["steps"] == list(range(1, MAMBA_TRAIN_STEPS + 1)),
          f"train-mamba2: logged steps {r['steps']}")
    check_train_launches(r, 0, 0, MAMBA_TRAIN_STEPS, TRAIN_MICRO,
                         "train-mamba2", n_mamba=cfg.n_layers)
    shutil.rmtree(root, ignore_errors=True)
    return r


def train_deepseek(torch, ARCHS, ops, ref, smi, gmm_checked):
    """deepseek-v2-236b at full width and DEEPSEEK_TRAIN_LAYERS of its 60
    layers through the port's Trainer: DEEPSEEK_TRAIN_STEPS steps of
    DEEPSEEK_TRAIN_MICRO microbatches of DEEPSEEK_TRAIN_BATCH x TRAIN_SEQ
    with remat; K3 forward twice per attention layer of every microbatch
    and its backward once (at MLA's q/k 192 and V 128, which the wrapper
    pads to 192), K5 twelve times
    per MoE layer (at 160 experts); every launched K5 and K5-backward
    shape held to the plain version.  The line carries every cut."""
    import dataclasses
    import shutil

    from repro_torch.configs import SHAPES
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainerConfig

    full, shape = ARCHS["deepseek-v2-236b"], SHAPES["train_4k"]
    cfg = dataclasses.replace(full, n_layers=DEEPSEEK_TRAIN_LAYERS,
                              pattern_repeats=None)
    root = ROOT / "build" / "chip_train"
    tcfg = TrainerConfig(
        steps=DEEPSEEK_TRAIN_STEPS, microbatches=DEEPSEEK_TRAIN_MICRO,
        ckpt_every=10**9, log_every=1, seed=SEED,
        ckpt_dir=str(root / "deepseek"), device=DEV,
        opt=AdamWConfig(warmup_steps=1, total_steps=DEEPSEEK_TRAIN_STEPS))
    phase = "train-deepseek"
    cuts = {"layers": [DEEPSEEK_TRAIN_LAYERS, full.n_layers],
            "batch": [DEEPSEEK_TRAIN_BATCH, shape.global_batch],
            "seq": [TRAIN_SEQ, shape.seq_len],
            "microbatches": [DEEPSEEK_TRAIN_MICRO, TRAIN_MICRO],
            "why": DEEPSEEK_TRAIN_CUTS, "params": cfg.param_count()}
    with gmm_shapes(ops) as shapes, attention_shapes(ops) as attn:
        r = train_run(torch, ops, cfg, tcfg, phase, {"cuts": cuts}, smi,
                      batch=DEEPSEEK_TRAIN_BATCH)
    n = cfg.n_layers
    emit({"phase": phase, "attention_shapes": sorted(attn),
          "gmm_shapes": sorted([*s[:4], str(s[4]).replace("torch.", "")]
                               for s in shapes)})
    check(r["steps"] == list(range(1, DEEPSEEK_TRAIN_STEPS + 1)),
          f"{phase}: logged steps {r['steps']}")
    check_train_launches(r, n, n, DEEPSEEK_TRAIN_STEPS, DEEPSEEK_TRAIN_MICRO,
                         phase)
    mla = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
           cfg.mla.v_head_dim)
    check({s[4:7] for s in attn} == {(*mla, mla[0])},
          f"{phase}: K3's backward at {attn}, not at MLA's q/k and V "
          f"widths {mla} (V padded to q/k's)")
    check({s[0] for s in shapes} == {cfg.moe.num_experts},
          f"{phase}: K5 and its backward at {shapes}")
    check_launched_gmm_shapes(torch, ref, shapes, gmm_checked, phase)
    check_launched_gmm_bwd_shapes(torch, ref, shapes, phase)
    shutil.rmtree(root, ignore_errors=True)
    return r


def _leaf_names(tree, prefix=""):
    """Each leaf's path, in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{prefix}/{i}")]
    return [prefix]


def seeded_biases(torch, cfg, params):
    """qwen1.5's q/k/v biases initialise to zero, so their forward effect
    would go unchecked: draw them from SEED, 0.5 N(0, 1), as the CPU
    parity tests do."""
    if not cfg.qkv_bias:
        return
    gen = torch.Generator(device=DEV).manual_seed(SEED + 29)
    attn = params["layers"]["b0"]["attn"]
    for name in ("bq", "bk", "bv"):
        b = attn[name]
        b.copy_(0.5 * torch.randn(b.shape, generator=gen, device=DEV))


def train_reference_cuts(ARCHS):
    """train-reference's models, each cut in depth to what one card holds
    with three sets of f32 weights and gradients."""
    import dataclasses

    def cut(name, **kw):
        return dataclasses.replace(ARCHS[name], pattern_repeats=None, **kw)

    return [
        cut("internlm2-1.8b", n_layers=2),
        dataclasses.replace(ARCHS["gemma3-1b"], n_layers=6, pattern_repeats=1,
                            suffix_blocks=()),
        cut("granite-moe-3b-a800m", n_layers=2),
        ARCHS["whisper-base"],
        cut("mamba2-2.7b", n_layers=2),
        dataclasses.replace(ARCHS["zamba2-1.2b"], n_layers=6,
                            pattern_repeats=1, suffix_blocks=()),
        *(cut(name, n_layers=n) for name, n in REF_TRAIN_LAYERS.items()),
        ARCHS["stablelm-1.6b"],
    ]


def train_reference(torch, ARCHS, init_model, ops, ref, gmm_checked):
    """The loss and every parameter leaf's gradient through the kernels
    against inside ``ops.plain_on_card``, at full width: internlm2 and
    granite-moe at 2 layers, gemma3's 6-layer unit (5 local, 1 global),
    whisper-base whole, mamba2 at 2 layers and zamba2's unit (5 Mamba-2
    blocks and the shared attention), deepseek-v2, qwen1.5 (its q/k/v
    biases seeded) and internvl2 (its 256 patch embeddings) at
    REF_TRAIN_LAYERS, stablelm whole; in f32 parameters with
    ``bf16_grad`` the identity, in f32 and in bf16.  Every leaf has a
    non-zero gradient on both paths, within TRAIN_REF_EXACT_RTOL
    (TRAIN_REF_EXACT_RTOL_SSM for the Mamba-2 models),
    TRAIN_REF_F32_RTOL or TRAIN_REF_BF16_RTOL; K3's backward ran where
    the model attends (for MLA at q/k 192 and V 128, which the wrapper
    pads to 192), K5 and its backward where it routes (deepseek-v2's at
    160 experts; every MoE model's launched shapes held to the plain
    version), K6's backward where it scans."""
    import repro_torch.models.layers as layers
    import repro_torch.models.transformer as transformer
    from repro_torch.configs import SHAPES
    from repro_torch.data.pipeline import DataConfig, _host_batch
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves

    # the residual boundaries (transformer's name) and the Mamba-2
    # block's five (read from layers at call time)
    boundary = (transformer.bf16_grad, layers.bf16_grad)
    for cfg in train_reference_cuts(ARCHS):
        blocks = set(cfg.block_pattern) | set(cfg.suffix_blocks)
        ssm = cfg.ssm is not None
        cases = (("float32_exact", torch.float32,
                  TRAIN_REF_EXACT_RTOL_SSM if ssm else TRAIN_REF_EXACT_RTOL),
                 ("float32", torch.float32, None),
                 ("bfloat16", torch.bfloat16, None))
        for label, dtype, tol in cases:
            free_memory(torch)
            params = init_params(torch, cfg, init_model, dtype=dtype)
            seeded_biases(torch, cfg, params)
            batch = {k: torch.from_numpy(v).to(DEV) for k, v in _host_batch(
                cfg, SHAPES["train_4k"], DataConfig(seed=SEED), 0,
                batch=REF_TRAIN_BATCH, seq=REF_TRAIN_SEQ).items()}
            if label == "float32_exact":
                transformer.bf16_grad = layers.bf16_grad = lambda x: x
            try:
                ops.reset_launch_counts()
                with gmm_shapes(ops) as shapes, \
                        attention_shapes(ops) as attn:
                    loss, grads = value_and_grad(cfg, params, batch)
                torch.cuda.synchronize()
                launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
                with unmoved_counters(ops, f"train-reference {cfg.name}"):
                    p_loss, p_grads = value_and_grad(cfg, params, batch)
                torch.cuda.synchronize()
            finally:
                transformer.bf16_grad, layers.bf16_grad = boundary
            names = _leaf_names(params)
            errs = {}
            for name, g, w in zip(names, tree_leaves(grads),
                                  tree_leaves(p_grads)):
                g, w = g.float(), w.float()
                check(bool(torch.isfinite(g).all()),
                      f"train-reference {cfg.name}: {name} non-finite")
                gn, wn = g.norm().item(), w.norm().item()
                check(gn > 0 and wn > 0, f"train-reference {cfg.name} "
                      f"{label}: {name} has a zero gradient ({gn}, {wn})")
                errs[name] = (g - w).norm().item() / wn
            worst = max(errs, key=errs.get)
            if tol is None:
                tol = (TRAIN_REF_F32_RTOL if dtype == torch.float32
                       else TRAIN_REF_BF16_RTOL)[cfg.name]
            emit({"phase": "train-reference", "arch": cfg.name,
                  "layers": cfg.n_layers, "dtype": label,
                  "batch": REF_TRAIN_BATCH, "seq": REF_TRAIN_SEQ,
                  "loss": loss.item(), "plain_loss": p_loss.item(),
                  "leaves": len(errs), "max_rel_err": errs[worst],
                  "worst_leaf": worst, "tolerance": tol,
                  "rel_err": errs, "launches": launches,
                  "attention_shapes": sorted(attn)})
            del params, grads, p_grads, batch, loss, p_loss
            check(blocks == {"mamba"} or launches["flash_attention_bwd"] > 0,
                  f"train-reference {cfg.name}: K3's backward never ran")
            if cfg.mla is not None:
                mla = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                       cfg.mla.v_head_dim)
                check({s[4:7] for s in attn} == {(*mla, mla[0])},
                      f"train-reference {cfg.name}: K3's backward at "
                      f"{attn}, not at MLA's q/k and V widths {mla} (V "
                      f"padded to q/k's)")
            if cfg.moe is not None:
                check(launches["grouped_matmul"] > 0
                      and launches["grouped_matmul_bwd"] > 0
                      and {s[0] for s in shapes} == {cfg.moe.num_experts},
                      f"train-reference {cfg.name}: K5 launched "
                      f"{launches['grouped_matmul']} times and its backward "
                      f"{launches['grouped_matmul_bwd']}, at {shapes}, not "
                      f"at {cfg.moe.num_experts} experts")
            check(not ssm or launches["ssd_scan_bwd"] > 0,
                  f"train-reference {cfg.name}: K6's backward never ran")
            check(errs[worst] <= tol, f"train-reference {cfg.name} {label}: "
                  f"{worst} gradient {errs[worst]} from the plain one > {tol}")
            if cfg.moe is not None:
                check_launched_gmm_shapes(torch, ref, shapes, gmm_checked,
                                          f"train-reference {label}")
                check_launched_gmm_bwd_shapes(torch, ref, shapes,
                                              f"train-reference {label}")
    free_memory(torch)


def train_phases(torch, F, ARCHS, init_model, ops, ref, smi, gmm_checked):
    """train-kernel (K3's, K5's and K6's backward), train-internlm2,
    train-granite, train-mamba2 and train-reference; returns (the
    kernels-line entries of K3's, K5's and K6's backward, the training
    runs)."""
    free_memory(torch)
    timer = Timer(torch)
    kernels = {"flash_attention_bwd": train_kernel_phase(torch, F, ref,
                                                         timer)}
    kernels["grouped_matmul_bwd"] = gmm_bwd_kernel_phase(
        torch, ref, timer, ARCHS["granite-moe-3b-a800m"])
    kernels["ssd_scan_bwd"] = ssd_bwd_kernel_phase(
        torch, ref, timer, train_ssd_cases(ARCHS["mamba2-2.7b"],
                                           ARCHS["zamba2-1.2b"]))
    del timer
    runs = train_internlm2(torch, ARCHS, ops, smi)
    runs.append(train_granite(torch, ARCHS, ops, ref, smi, gmm_checked))
    runs.append(train_mamba2(torch, ARCHS, ops, smi))
    train_reference(torch, ARCHS, init_model, ops, ref, gmm_checked)
    runs.append(train_deepseek(torch, ARCHS, ops, ref, smi, gmm_checked))
    bwd_split_phase(torch, ARCHS)
    return kernels, runs


# ---------------------------------------------------------------- examples
#: examples: each of the port's device examples runs in a process of its
#: own through this program, which zeroes the launch counters, runs the
#: script as ``__main__`` with jax and the JAX package blocked, and
#: prints the counts on its last line.  It stores checkpoints at zlib
#: level TRAIN_CKPT_ZLIB_LEVEL, as train-internlm2 does: train_lm writes
#: a 1.3 GB file of params and f32 moments every 50 steps, which zlib's
#: level 6 (the codec where zstandard is absent) writes at about 19 MB/s
EXAMPLE_RUNNER = """
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.checkpoint import checkpointing
from repro_torch.kernels import ops
checkpointing.ZLIB_LEVEL = int(sys.argv[2])
ops.reset_launch_counts()
sys.argv = sys.argv[3:]
runpy.run_path(sys.argv[0], run_name="__main__")
print("LAUNCHES " + json.dumps({f.__name__: f.launches for f in ops.WRAPPERS}))
"""
#: the device examples, each at its defaults; train_lm (300 steps of
#: 8 x 256 on its 110 M model) checkpoints into a fresh directory
EXAMPLES = ("torch_quickstart.py", "torch_serve_multitenant.py",
            "torch_train_lm.py")
EXAMPLES_TIMEOUT_S = 300


def example_checks(name, out, la, work):
    """The outcome of one example, from its output and launch counts:
    quickstart trains to 20 and resumes to 25, 25 steps of its 2 layers
    through K3 and its backward; serve_multitenant completes 7 of 7 under
    MURS with no failure, through K1 and K3; train_lm runs its 300 steps
    of 12 layers through K3 and its backward, leaves its six checkpoints
    and ends with a finite loss below its first."""
    import re

    decode = ("paged_decode_attention", "paged_decode_attention_int8",
              "decode_attention")
    if name == "torch_quickstart.py":
        check("trained to step 20" in out and "resumed from ckpt → 25" in out,
              f"examples: {name} did not train to 20 and resume to 25")
        check(la["flash_attention"] == 2 * 2 * 25
              and la["flash_attention_bwd"] == 2 * 25
              and not any(la[k] for k in decode),
              f"examples: {name} launches {la}")
        return {}
    if name == "torch_serve_multitenant.py":
        murs = re.search(r"^MURS\s+completed (\d+)/7  failed (\d+)", out, re.M)
        check(murs is not None and murs.groups() == ("7", "0"),
              f"examples: {name} did not complete 7/7 under MURS")
        check(la["paged_decode_attention"] > 0 and la["flash_attention"] > 0
              and la["flash_attention_bwd"] == 0,
              f"examples: {name} launches {la}")
        return {}
    first = re.search(r"first logged: step (\d+)  loss (\S+)", out)
    final = re.search(r"done: step (\d+)  final loss (\S+)", out)
    check(first is not None and final is not None,
          f"examples: {name} printed no first or final loss")
    first_loss, final_loss = float(first.group(2)), float(final.group(2))
    ckpts = sorted(p.name for p in (work / "lm").iterdir())
    check(ckpts == sorted(f"ckpt_{s}.ckpt" for s in range(50, 301, 50)),
          f"examples: {name} left checkpoints {ckpts}")
    check(final.group(1) == "300" and math.isfinite(final_loss)
          and final_loss < first_loss,
          f"examples: {name} ended at step {final.group(1)} with loss "
          f"{final_loss} from {first_loss}")
    check(la["flash_attention"] == 2 * 12 * 300
          and la["flash_attention_bwd"] == 12 * 300
          and not any(la[k] for k in decode),
          f"examples: {name} launches {la}")
    return {"first_loss": first_loss, "final_loss": final_loss}


def examples_phase(smi):
    """The port's three device examples on the card, one process each, in
    turn; returns their runs (outcome, seconds and launch counts)."""
    import os
    import shutil

    work = ROOT / "build" / "chip_examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    runs = []
    for name in EXAMPLES:
        flags = (("--ckpt-dir", str(work / "lm"))
                 if name == "torch_train_lm.py" else ())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXAMPLE_RUNNER, str(SRC),
             str(TRAIN_CKPT_ZLIB_LEVEL), str(ROOT / "examples" / name),
             *flags],
            capture_output=True, text=True, timeout=EXAMPLES_TIMEOUT_S,
            cwd=ROOT, env=dict(os.environ, TMPDIR=str(work)))
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        check(proc.returncode == 0 and lines
              and lines[-1].startswith("LAUNCHES "),
              f"examples: {name} exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        la = json.loads(lines[-1][len("LAUNCHES "):])
        out = "\n".join(lines[:-1])
        r = {"phase": "examples", "example": f"examples/{name}",
             "flags": list(flags), "wall_s": wall,
             "output": lines[:-1][-12:], "launches": la,
             **example_checks(name, out, la, work), "nvidia_smi": smi}
        emit(r)
        runs.append(r)
    shutil.rmtree(work, ignore_errors=True)
    return runs


# -------------------------------------------------------------- SPMD
#: spmd-serve: internlm2's rules are those of its decode cell
SPMD_SERVE_SHAPE = "decode_32k"
#: dryrun: (arch, shape, multi-pod) cells of ``repro_torch.launch.dryrun``,
#: run at once, each in its own process, within DRYRUN_TIMEOUT_S
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k", False),
                ("granite-moe-3b-a800m", "decode_32k", False),
                ("granite-moe-3b-a800m", "train_4k", True))
DRYRUN_TIMEOUT_S = 240
#: dryrun-memory: the most the dry-run's count of the step's peak above
#: its entry may differ from the card's measured peak, relative to the
#: measured peak (written before the first run: the allocator rounds
#: each block up to 512 B and the CUDA sort, scatter and cuBLAS
#: libraries take workspace the CPU count does not see)
DRYRUN_MEMORY_RTOL = 0.10


def placement_summary(placed):
    """{placements: leaves} over a tree of DTensors."""
    from repro_torch.tree import tree_leaves

    out = {}
    for d in tree_leaves(placed):
        key = ",".join(str(p) for p in d.placements)
        out[key] = out.get(key, 0) + 1
    return out


def carry(torch, params, rules):
    """``params`` carried to the host and back onto ``rules.mesh``
    through ``elastic_reshard``: (the DTensors' local tensors, the
    placements' summary).  Every local tensor is checked bit-equal to
    its source leaf."""
    from repro_torch.dist.fault import elastic_reshard
    from repro_torch.tree import tree_leaves, tree_map

    placed = elastic_reshard(
        tree_map(lambda t: t.to("cpu", copy=True), params), rules)
    local = tree_map(lambda d: d.to_local(), placed)
    for a, b in zip(tree_leaves(local), tree_leaves(params)):
        check(a.device == b.device and torch.equal(a, b),
              "spmd: a leaf changed on its way through elastic_reshard")
    return local, placement_summary(placed)


def _rules_or_none(rules):
    from repro_torch.dist.sharding import use_rules

    return contextlib.nullcontext() if rules is None else use_rules(rules)


def spmd_train_run(torch, ops, cfg, params, batches, rules):
    """GRANITE_TRAIN_STEPS steps of ``make_train_step`` (TRAIN_MICRO
    microbatches) from ``params`` (updated in place), inside
    ``use_rules(rules)`` unless ``rules`` is None, with the launch
    counters zeroed just before and read just after.  Returns (params,
    opt state, losses, grad norms, launches)."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    step = make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=1, total_steps=GRANITE_TRAIN_STEPS),
        microbatches=TRAIN_MICRO)
    opt = adamw.init(params)
    ops.reset_launch_counts()
    losses, norms = [], []
    with _rules_or_none(rules):
        for batch in batches:
            params, opt, m = step(params, opt, dict(batch))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    return (params, opt, losses, norms,
            {fn.__name__: fn.launches for fn in ops.WRAPPERS})


def spmd_train(torch, ARCHS, init_model, ops, mesh):
    """granite-moe-3b-a800m at full width, GRANITE_TRAIN_LAYERS layers,
    carried onto ``mesh`` through ``elastic_reshard`` under its
    train_4k rules, trained GRANITE_TRAIN_STEPS steps inside
    ``use_rules`` on the local tensors, and from the same parameters
    with no rules just before and just after (so the rules run's seconds
    sit between two plain runs'): losses, grad norms, every parameter and
    moment leaf bit-equal to each plain run's, launches as
    train-granite's and equal."""
    import dataclasses

    from repro_torch.configs import SHAPES
    from repro_torch.data.pipeline import DataConfig, _host_batch
    from repro_torch.dist.presets import arch_overrides
    from repro_torch.dist.sharding import make_rules
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(ARCHS["granite-moe-3b-a800m"],
                              n_layers=GRANITE_TRAIN_LAYERS,
                              pattern_repeats=None)
    rules = make_rules(mesh, overrides=arch_overrides(cfg, mesh,
                                                      SHAPES["train_4k"]))
    free_memory(torch)
    params = init_params(torch, cfg, init_model)
    local, summary = carry(torch, params, rules)
    after = tree_map(torch.clone, params)
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in _host_batch(
        cfg, SHAPES["train_4k"], DataConfig(seed=SEED), step,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ).items()}
        for step in range(GRANITE_TRAIN_STEPS)]
    runs, seconds = [], []
    for p, r in ((params, None), (local, rules), (after, None)):
        t0 = time.perf_counter()
        runs.append(spmd_train_run(torch, ops, cfg, p, batches, r))
        seconds.append(time.perf_counter() - t0)
    ruled = runs[1]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
           "steps": GRANITE_TRAIN_STEPS, "placements": summary,
           "losses": [x.item() for x in ruled[2]],
           "grad_norms": [x.item() for x in ruled[3]],
           "rules_s": seconds[1], "plain_s": [seconds[0], seconds[2]],
           "launches": {"rules": ruled[4], "plain": runs[0][4],
                        "plain_after": runs[2][4]}}
    check(all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]),
          "spmd train: a non-finite loss or grad norm")
    n_leaves = 3 * len(tree_leaves(params)) + 1
    out["leaves_bit_equal"] = []
    for plain in (runs[0], runs[2]):
        for what, i in (("loss", 2), ("grad norm", 3)):
            check(all(torch.equal(a, b) for a, b in zip(ruled[i], plain[i])),
                  f"spmd train: the {what}es under rules and without differ")
        leaves = list(zip(tree_leaves(ruled[:2]), tree_leaves(plain[:2])))
        check(len(leaves) == n_leaves,
              f"spmd train: {len(leaves)} parameter and moment leaves")
        same = sum(bool(torch.equal(a, b)) for a, b in leaves)
        out["leaves_bit_equal"].append([same, len(leaves)])
        check(same == len(leaves), f"spmd train: {len(leaves) - same} of "
              f"{len(leaves)} parameter and moment leaves differ with rules")
    for label, la in out["launches"].items():
        check_train_launches({"launches": la}, cfg.n_layers, cfg.n_layers,
                             GRANITE_TRAIN_STEPS, TRAIN_MICRO,
                             f"spmd train ({label})")
    del params, local, after, runs, ruled, batches
    free_memory(torch)
    return out


def spmd_serve(torch, ARCHS, init_model, ops, mesh):
    """internlm2-1.8b at full width, carried onto ``mesh`` under its
    SPMD_SERVE_SHAPE rules: the reference phase's prefills (K3) and paged
    decode step (K1) inside ``use_rules`` on the local tensors, and again
    on the parameters with no rules, each from fresh caches: prefill and
    decode logits bit-equal, K3 and K1 launched once per layer of each
    call and equally."""
    from repro_torch.configs import SHAPES
    from repro_torch.dist.presets import arch_overrides
    from repro_torch.dist.sharding import make_rules
    from repro_torch.models import decode_step_paged

    cfg = ARCHS["internlm2-1.8b"]
    rules = make_rules(mesh, overrides=arch_overrides(
        cfg, mesh, SHAPES[SPMD_SERVE_SHAPE]))
    free_memory(torch)
    params = init_params(torch, cfg, init_model)
    local, summary = carry(torch, params, rules)
    runs = {}
    for label, p, r in (("rules", local, rules), ("plain", params, None)):
        ops.reset_launch_counts()
        with _rules_or_none(r):
            lens, _, _, prefills, args, kwargs = paged_step_batch(
                torch, cfg, p)
            logits, _ = decode_step_paged(cfg, p, *args, **kwargs)
        torch.cuda.synchronize()
        runs[label] = (prefills, logits,
                       {fn.__name__: fn.launches for fn in ops.WRAPPERS})
    out = {"arch": cfg.name, "layers": cfg.n_layers, "rules_shape":
           SPMD_SERVE_SHAPE, "prompts": lens, "placements": summary,
           "launches": {k: v[2] for k, v in runs.items()}}
    (pre_r, dec_r, la_r), (pre_p, dec_p, la_p) = runs["rules"], runs["plain"]
    check(all(torch.equal(a, b) for a, b in zip(pre_r, pre_p)),
          "spmd serve: prefill logits differ with rules")
    check(torch.equal(dec_r, dec_p),
          "spmd serve: paged decode logits differ with rules")
    check(bool(torch.isfinite(dec_r).all()), "spmd serve: non-finite logits")
    n = cfg.n_layers
    for label, la in (("rules", la_r), ("plain", la_p)):
        want = {"flash_attention": n * len(lens), "paged_decode_attention": n}
        for name, k in want.items():
            check(la[name] == k, f"spmd serve ({label}): {name} launched "
                  f"{la[name]} times, predicted {k}")
    check(la_r == la_p, f"spmd serve: launches {la_r} with rules, {la_p} "
          "without")
    del params, local, runs
    free_memory(torch)
    return out


def spmd_phase(torch, ARCHS, init_model, ops, smi):
    """The ``spmd`` phase: a one-card ("data", "model") mesh from
    ``make_debug_mesh`` over a one-rank group, training (spmd_train) and
    serving (spmd_serve) with the rules active against without; the
    group is destroyed after.  Emits the phase's line; returns the five
    runs' launches, for the kernels line."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy_mesh_group, make_debug_mesh

    t0 = time.perf_counter()
    mesh = make_debug_mesh(DEV)
    try:
        backend = dist.get_backend()
        train = spmd_train(torch, ARCHS, init_model, ops, mesh)
        serve = spmd_serve(torch, ARCHS, init_model, ops, mesh)
    finally:
        destroy_mesh_group()
    emit({"phase": "spmd", "mesh": {
        "shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
        "device": mesh.device_type, "backend": backend},
        "train": train, "serve": serve,
        "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    return [{"launches": la} for run in (train, serve)
            for la in run["launches"].values()]


def dryrun_phase(torch, smi, out_dir=None):
    """The ``dryrun`` phase: ``python -m repro_torch.launch.dryrun`` on
    this machine's torch for each of DRYRUN_CELLS, all at once, each in
    its own process, over the fake process group of the production
    meshes (a check without compute, on the host: no card is used).
    Each must exit 0 and its record read back without an error."""
    import os
    import shutil

    out_dir = Path(out_dir or ROOT / "build" / "chip_dryrun")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out_dir)]
        if multi_pod:
            cmd.append("--multi-pod")
        procs.append(subprocess.Popen(
            cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    cells = []
    try:
        for (arch, shape, multi_pod), proc in zip(DRYRUN_CELLS, procs):
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                log, _ = proc.communicate(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
            mesh = "2x16x16" if multi_pod else "16x16"
            path = out_dir / f"{arch}__{shape}__{mesh}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            cells.append({"arch": arch, "shape": shape, "mesh": mesh,
                          "rc": proc.returncode, "record": rec,
                          "log": log.strip().splitlines()[-2:]})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for c in cells:
        rec = c["record"]
        c["collective_bytes"] = {k: v.get("bytes") for k, v in (
            rec.get("collectives") or {}).items()}
        c["temp_size_in_bytes"] = rec.get("memory", {}).get(
            "temp_size_in_bytes")
    emit({"phase": "dryrun", "mesh": "fake", "torch": torch.__version__,
          "cells": cells, "seconds": time.perf_counter() - t0,
          "collectives_measured": "no: one card has no collective to "
                                  "measure; the bytes are counted on the "
                                  "fake mesh",
          "nvidia_smi": smi})
    for c in cells:
        what = f"dryrun {c['arch']} {c['shape']} {c['mesh']}"
        check(c["rc"] == 0, f"{what}: exit {c['rc']}: {c['log']}")
        rec = c["record"]
        check("error" not in rec and rec.get("mesh") == c["mesh"]
              and rec.get("cost", {}).get("flops", 0) > 0
              and rec.get("memory", {}).get("argument_size_in_bytes", 0) > 0,
              f"{what}: record {rec}")
        check(bool(rec.get("collectives"))
              and isinstance(c["temp_size_in_bytes"], int)
              and c["temp_size_in_bytes"] > 0,
              f"{what}: no collectives or temp memory in {rec}")
    return cells


def spmd_step_peak(torch, ops, cfg, params, batch, rules, plain):
    """The peak above its entry of one train step of ``cfg``
    (TRAIN_MICRO microbatches, remat) from ``params`` inside
    ``use_rules(rules)``, through the plain versions (``plain``) or the
    kernels: ``max_memory_allocated`` less ``memory_allocated`` at the
    step's entry, the moments allocated before it."""
    from repro_torch.dist.sharding import use_rules
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    step = make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=1, total_steps=GRANITE_TRAIN_STEPS),
        microbatches=TRAIN_MICRO)
    opt = adamw.init(params)
    free_memory(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entry = torch.cuda.memory_allocated()
    with use_rules(rules), (ops.plain_on_card() if plain
                            else contextlib.nullcontext()):
        _, _, m = step(params, opt, dict(batch))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - entry
    check(math.isfinite(m["loss"].item()), "dryrun-memory: a non-finite loss")
    del opt, m
    return peak


def dryrun_memory_phase(torch, ARCHS, init_model, ops, smi):
    """The ``dryrun-memory`` phase: spmd's train step measured on the
    card (the one-card NCCL mesh, rules active; the plain versions, then
    the kernels), then counted by the dry-run on a fake 1×1 mesh; the
    count within DRYRUN_MEMORY_RTOL of the plain step's measured peak."""
    import dataclasses

    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, _host_batch
    from repro_torch.dist.presets import arch_overrides
    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch.dryrun import program_cell
    from repro_torch.launch.mesh import (
        destroy_mesh_group,
        make_debug_mesh,
        make_fake_mesh,
    )

    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["granite-moe-3b-a800m"],
                              n_layers=GRANITE_TRAIN_LAYERS,
                              pattern_repeats=None)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    peaks = {}
    mesh = make_debug_mesh(DEV)
    try:
        rules = make_rules(mesh, overrides=arch_overrides(
            cfg, mesh, SHAPES["train_4k"]))
        free_memory(torch)
        params = init_params(torch, cfg, init_model)
        batch = {k: torch.from_numpy(v).to(DEV) for k, v in _host_batch(
            cfg, SHAPES["train_4k"], DataConfig(seed=SEED), 0,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ).items()}
        for label, plain in (("plain", True), ("kernels", False)):
            peaks[label] = spmd_step_peak(torch, ops, cfg, params, batch,
                                          rules, plain)
        del params, batch
        free_memory(torch)
    finally:
        destroy_mesh_group()
    fake = make_fake_mesh((1, 1))
    try:
        rules = make_rules(fake, overrides=arch_overrides(
            cfg, fake, SHAPES["train_4k"]))
        rec = program_cell(cfg, shape, fake, rules, rules,
                           {"microbatches": TRAIN_MICRO})
    finally:
        destroy_mesh_group()
    mem = rec["memory"]
    counted = (mem["temp_size_in_bytes"] + mem["output_size_in_bytes"]
               - mem["alias_size_in_bytes"])
    measured = peaks["plain"]
    rel = abs(counted - measured) / measured
    emit({"phase": "dryrun-memory", "arch": cfg.name,
          "layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "microbatches": TRAIN_MICRO, "mesh": "1x1",
          "measured_peak_bytes": measured,
          "kernel_path_peak_bytes": peaks["kernels"],
          "dryrun_memory": mem, "counted_peak_bytes": counted,
          "rel_err": rel, "limit": DRYRUN_MEMORY_RTOL,
          "dryrun_step_s": rec["compile_s"],
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    check(rel <= DRYRUN_MEMORY_RTOL,
          f"dryrun-memory: the dry-run counts {counted} B above the step's "
          f"entry, the card measured {measured} B ({rel:.3f} apart, limit "
          f"{DRYRUN_MEMORY_RTOL})")
    return rel


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return fn(tree)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--only", nargs="+",
        choices=("kernels", "reference", "train", "spmd", "examples"),
        help="run only these phases after the build: every kernel phase, "
             "internlm2's and gemma3's reference phases, the training "
             "phases, the spmd and dryrun phases, or the port's examples; "
             "prints no kernels or "
             "result line (to hold another tree's package, such as a "
             "parent commit's, to this script's inputs and checks)")
    only = set(ap.parse_args(argv).only or ())
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 3
    # full-precision f32 matmuls (logits, plain versions): no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models import init_model
    from repro_torch.serve import engine as engine_module

    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.build()  # one nvcc per source, all started together
    libs = [str(Path(_build.library(name)._name).relative_to(ROOT))
            for name in _build.SIGNATURES]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libs})

    m_cfg = ARCHS["granite-moe-3b-a800m"]
    s_cfg, z_cfg = ARCHS["mamba2-2.7b"], ARCHS["zamba2-1.2b"]
    if not only or "kernels" in only:
        timer = Timer(torch)
        kres = kernel_phase(torch, F, pd, ref, timer)
        kres.update(attention_kernel_phase(torch, F, ref, timer))
        gmm, gmm_checked = gmm_kernel_phase(
            torch, ref, timer,
            gmm_cases(m_cfg) + deepseek_gmm_cases(ARCHS["deepseek-v2-236b"]))
        kres.update(gmm)
        ssd, ssd_checked, ssd_lines = ssd_kernel_phase(
            torch, ref, timer, ssd_cases(s_cfg, z_cfg))
        kres.update(ssd)
        del timer
    if only:
        if "kernels" in only:
            emit_ssd_lines(torch, ssd_lines)
        if "reference" in only:
            for cfg, phase in ((ARCHS["internlm2-1.8b"], reference_phase),
                               (ARCHS["gemma3-1b"], reference_gemma3)):
                params = init_params(torch, cfg, init_model)
                phase(torch, cfg, params, ops)
                del params
                torch.cuda.empty_cache()
        if "train" in only:
            train_phases(torch, F, ARCHS, init_model, ops, ref, smi,
                         gmm_checked if "kernels" in only else set())
        if "spmd" in only:
            spmd_phase(torch, ARCHS, init_model, ops, smi)
            dryrun_phase(torch, smi)
            dryrun_memory_phase(torch, ARCHS, init_model, ops, smi)
        if "examples" in only:
            examples_phase(smi)
        return 0

    simulator_phase()

    # the engine calls the model through these names: count the calls
    calls = count_calls(engine_module,
                        ("prefill", "decode_step", "decode_step_paged"))

    cfg = ARCHS["internlm2-1.8b"]
    params = init_params(torch, cfg, init_model)
    f32 = serve_run(torch, cfg, params, ("A", "B", "C"), False, ops, calls)
    i8 = serve_run(torch, cfg, params, ("B", "C"), True, ops, calls)
    check(f32["suspensions"] > 0, "serve: the pool never forced a suspension")
    check(f32["prefix_hits"] > 0, "serve: no prefix-cache hit")
    check(f32["launches"]["decode_attention"] > 0,
          "serve: no chunked-prefill continuation through K4")
    reference_phase(torch, cfg, params, ops)
    cluster = serve_cluster(torch, cfg, params, ops, calls, smi)
    migration_parity(torch, cfg, params, ops)
    del params
    torch.cuda.empty_cache()

    g_cfg = ARCHS["gemma3-1b"]
    g_params = init_params(torch, g_cfg, init_model)
    g3 = serve_gemma3(torch, g_cfg, g_params, ops, calls)
    reference_gemma3(torch, g_cfg, g_params, ops)
    del g_params
    torch.cuda.empty_cache()

    m_params = init_params(torch, m_cfg, init_model)
    moe = serve_granite(torch, m_cfg, m_params, ops, calls, ref, gmm_checked)
    with gmm_shapes(ops) as shapes:
        reference_granite(torch, m_cfg, m_params, ops)
    check_launched_gmm_shapes(torch, ref, shapes, gmm_checked,
                              "reference-granite")
    del m_params
    torch.cuda.empty_cache()

    ssm_runs = []
    for cfg in (s_cfg, z_cfg):
        params = init_params(torch, cfg, init_model)
        ssm_runs.append(serve_ssm(torch, cfg, params, ops, calls, ref,
                                  ssd_checked))
        with ssd_shapes(ops) as shapes:
            reference_ssm(torch, cfg, params, ops)
        check_launched_ssd_shapes(torch, ref, shapes, ssd_checked,
                                  f"reference-{cfg.name}")
        del params
        torch.cuda.empty_cache()
    zoo = zoo_phases(torch, ARCHS, init_model, ops, calls, ref, gmm_checked)
    train_kernels, train_runs = train_phases(
        torch, F, ARCHS, init_model, ops, ref, smi, gmm_checked)
    kres.update(train_kernels)
    spmd_runs = spmd_phase(torch, ARCHS, init_model, ops, smi)
    dryrun_phase(torch, smi)
    dryrun_memory_phase(torch, ARCHS, init_model, ops, smi)
    free_memory(torch)
    example_runs = examples_phase(smi)
    emit_ssd_lines(torch, ssd_lines)

    replaces = {
        "paged_decode_attention": "src/repro/kernels/paged_decode.py:187",
        "paged_decode_attention_int8":
            "src/repro/kernels/paged_decode.py:132",
        "flash_attention": "src/repro/kernels/flash_attention.py:82",
        # no Pallas twin: XLA differentiates the jnp twin of K3
        "flash_attention_bwd": "src/repro/models/layers.py:101 "
                               "chunked_attention (its autodiff; no Pallas "
                               "kernel)",
        "decode_attention": "src/repro/kernels/decode_attention.py:71",
        "grouped_matmul": "src/repro/kernels/moe_gmm.py:41",
        # no Pallas twin: XLA differentiates the expert einsums
        "grouped_matmul_bwd": "src/repro/models/blocks.py:365 the expert "
                              "einsums (their autodiff; no Pallas kernel)",
        "ssd_scan": "src/repro/kernels/ssd_scan.py:83",
        # no Pallas twin: XLA differentiates the jnp twin of K6
        "ssd_scan_bwd": "src/repro/models/blocks.py:430 _ssd_scan (its "
                        "autodiff; no Pallas kernel)",
    }
    source = {
        "paged_decode_attention": "paged_decode.cu",
        "paged_decode_attention_int8": "paged_decode.cu",
        "flash_attention": "flash_attention.cu",
        "flash_attention_bwd": "flash_attention_bwd.cu",
        "decode_attention": "decode_attention.cu",
        "grouped_matmul": "grouped_matmul.cu",
        "grouped_matmul_bwd": "grouped_matmul_bwd.cu",
        "ssd_scan": "ssd_scan.cu",
        "ssd_scan_bwd": "ssd_scan_bwd.cu",
    }
    # launches on the main paths: the sum over the serving runs, the
    # training runs, the spmd runs and the examples, each counted from zero
    runs = (f32, i8, cluster, g3, moe, *ssm_runs, *zoo, *train_runs,
            *spmd_runs, *example_runs)
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{source[name]}",
         "replaces": replaces[name],
         "launches": sum(run["launches"][name] for run in runs),
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in kres.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


def init_params(torch, cfg, init_model, dtype=None):
    """Random parameters of ``cfg`` at full width from SEED, in bf16 (or
    ``dtype``)."""
    t0 = time.perf_counter()
    params = init_model(cfg, SEED, device=DEV,
                        dtype=dtype or torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim,
          "kv_groups": (cfg.n_heads // cfg.n_kv_heads if cfg.n_kv_heads
                        else None), "vocab": cfg.vocab,
          "ssm": (None if cfg.ssm is None else {
              "d_inner": cfg.ssm.d_inner(cfg.d_model),
              "heads": cfg.ssm.n_heads(cfg.d_model),
              "head_dim": cfg.ssm.head_dim, "d_state": cfg.ssm.d_state,
              "chunk": cfg.ssm.chunk_size}),
          "kv_bytes_per_token": cfg.kv_bytes_per_token(),
          "constant_state_bytes": cfg.constant_state_bytes(),
          "param_gib": sum(
              t.numel() * t.element_size() for t in _tensors(params)
          ) / 2**30,
          "seconds": time.perf_counter() - t0})
    return params


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
