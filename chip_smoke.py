#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
final line):

1. build the CUDA kernels from the repo's sources with ``nvcc`` (into
   each kernel's ``build/``): ``kernels/prox/csrc/prox_sweep.cu``,
   ``kernels/flash_attention/csrc/flash_fwd.cu`` (fp32),
   ``kernels/flash_attention/csrc/flash_fwd_sm90.cu`` (bf16), the three
   ``nvcc`` runs started together; print what ``-Xptxas
   -v`` says of both flash kernels per D (registers, shared memory,
   spills) and of every sweep-kernel instantiation (registers, spills),
   and fail if the bf16 D = 80 / 96 / 128 or the fp32 D = 128
   instantiation spills, or if the bf16 SASS (``cuobjdump -sass``) of
   D = 80, 96 or 128 lacks the wgmma of Q K^T (A from shared memory) or of
   P V (A from registers); the HGMMA shapes of each D are printed;
2. hold each kernel against its plain PyTorch version on the card:
   * the sweep-major pair: all three prox kinds, gated and ungated, S = 3
     configs x C = 10 clients, an odd d (scalar loads) and a d that is a
     multiple of 4 (float4 loads), plus bf16 storage; frozen rows bit for
     bit, live rows within ``ATOL`` / ``RTOL``; and the grouped launch over
     whole trees (the MLP's six leaves and a ragged tree of 0-D to 2-D
     leaves, one launch a call): fp32 bit for bit, bf16 within
     ``BF16_ATOL`` / ``BF16_RTOL``, frozen rows bit for bit; and the
     training path's LM-head leaf (2 x 2048 x 152064 bf16) within
     ``BF16_HEAD_ULPS`` of the plain versions, with controls (the step
     skipped, a halved alpha or beta) that must miss that limit, ungated
     and gated as the async learner runs it (a (1, 2) mask of downweight
     values: the live row held so, the frozen row bit for bit); and both
     routes of the grouped pair (16-byte vectors; element by element for
     ragged rows and misaligned views) over ``kernel.ROUTE_LEAVES``, a
     mixed tree, under each of ``kernel.ROUTE_GATES``: bf16 live rows
     within ``BF16_HEAD_ULPS``, fp32 and frozen rows bit for bit;
   * ``prox_cuda`` and ``fused_update_cuda``: three kinds, odd, float4 and
     0-d leaves, fp32 within ``ATOL`` / ``RTOL`` and bf16;
   * ``flash_attention_cuda``: fp32 and bf16, D = 64 / 80 / 96 / 128 /
     256, GQA groups 1 / 2 / 8, causal with window 0 and 128 and
     non-causal, L = 1 / 17 / 200 / 1024, within ``FLASH_TOL``; every
     bf16 case launches the tensor-core kernel (D 80 and 96 natively, no
     ``flash_fwd_padded`` count) and every fp32 case the fp32 one; the
     head dims a dtype's kernel is not built for (fp32 32 / 80 / 96, bf16
     32; D 32 at groups 1 / 8, L = 17 / 200 / 1024) through the head-dim
     route, each such launch counted under ``flash_fwd_padded`` too; and
     ``Lq != Lk`` at D 64, 80 and 96 (``FLASH_CROSS_PAIRS``: decode's one
     query and a prompt's 16 against 1024 or a ragged 1000 keys, short
     ragged pairs both ways), groups 1 / 2, non-causal and causal; the
     training forward (with ``lse``) and backward at each
     ``TRAIN_DV_PAIRS`` (D 192, DV 128) at an explicit scale, groups
     1 / 2, L = 17 / 200 / 1024, three masks, and at the
     ``deepseek-v2-lite`` cell's attention (``FLASH_MLA_SHAPE``, causal,
     the configuration's softmax scale), against the plain pair within
     ``FLASH_BWD_REL``;
3. the DEPOSITUM path: ``ROUNDS`` rounds of the paper's Fig. 4 MLP (123 ->
   64 -> 32 -> 10, 10 clients on a ring, T0 = 10, MCP prox) through
   ``repro_torch.quickstart.run_depositum`` with ``fused="require"``; each
   sweep kernel launches exactly rounds x T0 times (one grouped launch a
   step for the six leaves), stationarity
   falls from round 1, and the run matches the same run with
   ``fused="off"``: one round within ``STEP_ATOL`` / ``STEP_RTOL``, all
   rounds within ``STATE_REL`` (model, relative norm) and ``LOSS_RTOL`` /
   ``STAT_RTOL``, all 0: bit-equal; prints the drift of both;
4. the prox tree path: ``ops.prox_tree`` and ``ops.fused_update_tree`` over
   that run's final model (six leaves), one grouped launch each, bit-equal
   to the plain versions;
4a. the sweep paths (``repro_torch.training.sweep``), one grouped launch of
   each sweep kernel a step for all S configs, fused bit-equal to
   unfused after one round and after the whole run, ``sweep_run`` against
   ``sweep_run_sequential`` (each config alone through the one-config
   round) after one round within ``SWEEP_SEQ_ATOL`` / ``SWEEP_SEQ_RTOL``
   and after the whole run within ``SWEEP_SEQ_REL`` on x:
   * ``sweep_fig6``: the Fig. 6 topology grid at its published widths (MLP
     123 -> 64 -> 32 -> 10, 10 clients, complete / ring / star / torus as
     a stacked dense W (4, 10, 10), T0 = 20, MCP), 40 rounds: 800
     launches of each kernel, where the sequential run makes 3,200; both
     timed ``SWEEP_TIMING_PAIRS`` times in turns (``sweep_vs_sequential``)
     and one round of each profiled (device busy share);
   * ``sweep_fig8``: the Fig. 8 schedule grid (lazy p 0.3 / 0.6 / 1.0 and
     Chebyshev k 1 / 2 / 3, stacked per-round W (6, 30, 10, 10)), 30
     rounds;
   * ``sweep_cohort``: the cohort grid (n 8 / 32 / 128 / 512 x p 0.5 /
     1.0 padded to 512 clients, least squares), 30 rounds through the
     gated instantiation: every launch gated, the rows each round leaves
     out (and every padding row) bit for bit unchanged, each padded point
     within ``COHORT_NATIVE_REL`` of its native-size run;
4b. the compressed paths (CHOCO error feedback, ``core/compression.py``),
   every step of a compressed round through both sweep kernels:
   * ``compressed_main``: the Fig. 4 MLP point under ``topk(0.1)`` and
     ``qsgd(4)``, ``ROUNDS`` rounds each: 300 launches of each kernel,
     ``fused="require"`` bit-equal to ``"off"`` with the memory; a
     ``none`` spec bit-equal to the dense main path (no memory); one
     round's comm step on the card against the CPU from the same state
     (the same hashed draws), x within ``COMM_CPU_ATOL``;
   * ``sweep_comm``: the accuracy-vs-bytes frontier of
     ``fig_comm_frontier.py`` at its published sizes (dense, top-k 0.05 /
     0.1 / 0.25 / 0.5, QSGD 2 / 4 / 8 bits; 8 clients, D 64, T0 5, ring),
     ``COMM_ROUNDS`` rounds as one mixed-kind sweep (150 launches of each
     kernel) against its native-kind sequential runs (1,200): after one
     round within ``SWEEP_SEQ_ATOL`` / ``COMM_SEQ_RTOL``, after the run x
     within ``SWEEP_SEQ_REL``; fused = unfused bit for bit; the
     frontier's ``check`` all true; ``sweep_vs_sequential`` timed in
     turns; each kind's compression of one comm step timed on the card;
   * ``sweep_comm_mlp``: the same eight compressors on the Fig. 4 MLP
     point as an S = 8 sweep (29.8 MB of state), fused = unfused bit for
     bit;
   * ``graph_choco``: ``choco_mix`` for top-k and QSGD captured in a CUDA
     graph, each replay bit-equal to the eager call (no host sync);
   * ``round_time_comm``: round wall time and profiled device busy share
     of a top-k, a QSGD and a dense round, in turns;
5. the served path at full width: ``qwen3-1.7b`` (28 layers, d 2048, 16/8
   heads of 128, d_ff 6144, vocab 151936, bf16, untied; random weights from
   a seeded generator on the card) through ``BatchedServer`` with B = 4,
   a 1024-token prompt, 32 greedy tokens and a 2048-slot cache: the bf16
   flash kernel launches exactly once per layer, every logit is finite, and
   the prefill
   logits match the same prefill with ``flash_attention_plain`` swapped in
   within ``SERVE_LOGIT_ATOL`` / ``SERVE_LOGIT_RTOL``; prints prefill ms,
   decode ms a token, tokens/s and the peak memory of the ``generate``
   call (``torch.cuda.max_memory_allocated``);
5a. ``serve_zoo``: the zoo's decoder families at full width, bf16, random
   weights, one at a time (each freed before the next), through
   ``BatchedServer`` with B = 4, a 1024-token prompt and 32 greedy tokens
   (``ZOO_SERVE``): ``qwen2.5-14b`` (48 flash launches a prefill, D 128),
   ``minitron-4b`` (32), ``qwen3-moe-235b-a22b`` at its published width
   with its depth cut to 8 of 94 layers (``ZOO_DEPTH``; 8 launches),
   ``phi-3-vision-4.2b`` (1024 stub vision embeds before the prompt, a
   4096-slot cache; 32 launches at D 96), ``mamba2-130m``
   (attention-free: none) and ``zamba2-2.7b`` (9 shared block
   invocations at D 80), none through the head-dim route: launch counts
   exact per route, tokens in range, logits finite, every flash call of a
   prefill held against ``flash_attention_plain`` on its inputs at
   ``FLASH_TOL`` (not for mamba2); prints the end-to-end drift of the prefill logits
   against the plain attention swapped in, prefill ms, decode ms a
   token, tokens/s and peak memory of each;
5b. ``serve_encdec``: the encoder-decoder family at full width
   (``ENCDEC_SERVE``: seamless-m4t-medium, 12 + 12 layers, d 1024, 16
   heads of 64, bf16, random weights; B 4, 1024 stub frames, a 16-token
   prompt, 32 greedy tokens, 256 slots): ``launch.steps.
   build_prefill_step`` encodes the frames and runs the prompt (36 bf16
   flash launches: 12 encoder and 12 cross-attention non-causal, 12
   decoder self-attention causal), then ``BatchedServer`` feeds the prompt
   token by token against that memory and decodes (12 cross-attention
   launches a step, ``Lq = 1``: 564); every flash call of the prefill step
   and of one decode step held against ``flash_attention_plain`` at
   ``FLASH_TOL``; the drift of the step's logits against the plain
   attention swapped in, and of the server's logits after its last prompt
   token against the step's, printed, not gated; prefill ms, ms a prompt
   token, decode ms a token, tokens/s and peak memory; then the reduced
   config in fp32 on the card against the CPU (``ENCDEC_CPU``): the
   prefill step's logits and memory within ``CPU_ATOL`` / ``CPU_RTOL``,
   identical greedy tokens, the fp32 kernel 6 times a step and 2 times a
   decode step;
6. card against CPU: reduced ``qwen3-1.7b`` and reduced ``starcoder2-7b``,
   fp32, identical weights, served on the card and on the CPU (plain
   versions there; the fp32 flash kernel on the card): identical greedy
   tokens, logits within 1e-4; ``zoo_card_vs_cpu``: the same for the
   seven new architectures reduced (``ZOO_CPU``: prompt 96, a multiple of
   the reduced SSD chunk), the fp32 kernel through the head-dim route at
   D 32 for grok, qwen3-moe and zamba2;
6a. federated training (``training/train_loop.py`` through
   ``launch/train.py``'s builder, ``fused="auto"``):
   * ``train_llm``: full-width, full-depth ``qwen3-1.7b`` (2,032,264,192
     parameters, bf16, remat "full", random weights from a seed) on 2
     clients (complete), T0 4, B 2 x L 512 a client a step, one warm-up
     round then ``TRAIN_ROUNDS`` timed rounds with donated states: each
     sweep kernel launches ceil(311 / 48) = 7 times a step, attention
     trains through the bf16 flash kernels (the backward once a layer,
     client and step, the forward with its logsumexp twice under remat,
     no ``_sdpa`` dispatch), every loss is finite; prints the round walls,
     tokens/s, the peak memory beside the
     ``TRAIN_PEAK_GB`` reckoning, the caching allocator's device
     allocations in the timed rounds, one more round under
     ``torch.profiler`` (device busy share, host phases, top kernels) and
     the sweep pair's ms a step at these leaves against its bound, and
     ``TRAIN_TEL_PAIRS`` pairs of rounds in turns with ``telemetry`` on
     and off (round wall and peak memory each, every recorded metric
     finite); then
     the consensus (``mean_params``) serves
     B 2, a 64-token prompt and 8 greedy tokens through ``BatchedServer``
     (28 launches of the bf16 flash kernel, tokens in range, logits
     finite).  No full-width checkpoint is written (fp32 on disk: 8.1 GB);
   * ``train_zoo``: the zoo's other families that fit two bf16 clients on
     the card, at full width and depth, one at a time (``TRAIN_ZOO``):
     ``zamba2-2.7b``, ``mamba2-130m`` and ``seamless-m4t-medium`` (the
     last with ``TRAIN_ZOO_FRAMES`` stub frames a sample from a seeded
     generator), ``train_llm``'s cell, one warm-up and
     ``TRAIN_ZOO_ROUNDS`` timed rounds each: each sweep kernel launches
     ceil(leaves / 48) = 9 / 5 / 6 times a step (417 / 218 / 256
     leaves), held bit for bit against its plain version at each leaf
     table (``TRAIN_ZOO_ULPS``); the state bytes equal to
     ``launch/dryrun.py``'s; round walls, tokens/s, peak memory (zamba2's
     beside ``TRAIN_ZOO_PEAK_GB``), losses finite; then each consensus
     served: zamba2's through ``BatchedServer`` (9 bf16 flash launches a
     prefill at D 80, none through the head-dim route, each held against
     the plain version), mamba2's saved by ``save_checkpoint`` and served by
     ``launch.serve --ckpt`` (restored = saved bit for bit, tokens = the
     consensus served directly), seamless's through the prefill step (36
     launches) and ``BatchedServer`` (12 a decode step);
   * ``train_mla``: the (192, 128) flash kernels on their main path:
     ``deepseek-v2-lite``'s share at the benchmark cell's widths, batch
     and length (``MLA_TRAIN``: 16 heads, 8 of 64 experts, 12,800
     vocabulary rows, B 2 x L 4096, T0 4, 2 clients) at ``MLA_LAYERS`` of
     its 17 layers, one warm-up round and ``MLA_ROUNDS`` timed rounds: the
     backward once a layer, client and step, the forward with ``lse``
     twice, no ``_sdpa``, every loss finite; then the two kernels alone
     at the cell's attention (``FLASH_MLA_SHAPE``) in turns with the
     plain backward, against their bounds (2 (D + DV) and 2 (3 D + 2 DV)
     flops a visible pair and head);
   * ``train_ckpt``: reduced fp32, ``launch.train --ckpt`` then
     ``launch.serve --ckpt`` on the card: the restored params bit-equal to
     the saved consensus, the served tokens equal to serving it directly;
   * ``train_card_vs_cpu``: reduced fp32, 2 rounds from one state on the
     card and on the CPU, x / y / nu / g within ``CPU_ATOL`` /
     ``CPU_RTOL``;
   * ``train_zoo_card_vs_cpu``: the same for the reduced MoE, VLM, SSM,
     hybrid and enc-dec configs (``TRAIN_ZOO_CPU_ARCHS``, vision embeds
     and frames from a numpy seed), and the hybrid's and the enc-dec's
     consensus through a checkpoint on the card, restored bit for bit;
   the ``check`` phase also holds the grouped bf16 sweep pair at the LM
   head's leaf (2 clients x 2048 x 152064) against its plain version;
6b. the paper's baselines and remaining figures, and telemetry:
   * ``table3``: Table III at its published constants (MLP 64 -> 64 -> 32
     -> 10, 10 clients, 30 rounds, T0 5, SCAD; IID / Dir(1) / Dir(0.1);
     seeds 0 / 1 / 2 as S = 3 a cell) through ``figures.table3_run``,
     DEPOSITUM OPTION I with ``fused="require"``: each sweep kernel
     launches 3 x 30 x 5 = 450 times (OPTION II, Nesterov, runs unfused:
     the kernels cover Polyak only); the rows, ``check`` and each cell's
     wall; ``sweep_vs_sequential`` of one DEPOSITUM and one FedDR cell in
     turns (launches counted apart); both cells on the card against the
     CPU, x within ``T3_CPU_REL`` (a limit a cell), which the same cell
     with TF32 matmuls must miss;
   * ``fig5`` / ``fig7``: the two grids at their published constants
     through ``run_depositum_grid`` (four static groups of
     ``FIG_GROUP_ITERS`` steps: 1,600 launches of each kernel a figure),
     rows and ``check``;
   * ``telemetry``: the Fig. 6 sweep with ``Telemetry.jsonl`` at log_every
     1: bit-equal to the unrecorded run, four streams of 40 rows, the
     JSONL valid, ``wire_bytes`` equal to ``analysis/comm.py``,
     ceil(40 / B) host copies, 800 launches, round walls on and off in
     turns; the reduced fp32 trainer with ``telemetry=True`` bit-equal to
     off;
6c. the async runtime (``training/async_runtime.py``, ``fused="require"``:
   every learner round is one masked round whose staleness weights gate
   both sweep kernels on every step, counted in ``GATED_LAUNCH_COUNTS``):
   * ``async_throughput``: ``figures.py --fig async`` at its full size
     (least squares, 8 clients, d 512, 24 rounds, T0 2; 240 launches of
     each kernel, 192 gated): the exponential round-throughput ratio at
     least 1.3, tau 0 with zero delay ``torch.equal`` to the synchronous
     trainer, virtual times and event logs equal to the CPU's;
   * ``async_mlp``: the Fig. 4 MLP point at published widths through
     ``classification_batch_iterator`` and ``tabulate_batches``, 30
     learner rounds under exponential stragglers with drops, duplicates
     and a dead client, tau 2, downweight 0.5, telemetry on (600
     launches, all gated, from two runs; a TF32 control's 300 are
     counted apart): bounded
     staleness, the dead client's rows bit for bit, the recorded
     staleness equal to the replay, replay determinism, the CPU's event
     log, x within ``ASYNC_MLP_CPU_REL`` of the CPU's (the TF32 run
     misses it);
   * ``async_llm``, inside ``train_llm`` on its model and state: one
     warm-up and ``ASYNC_LLM_ROUNDS`` learner rounds, donated (7 gated
     launches of each kernel a step: 112): round walls, applied tokens/s,
     peak memory beside ``ASYNC_LLM_PEAK_GB``, cohorts and staleness;
     losses finite and each unapplied client's rows unchanged; the gated
     pair's ms a step against the ungated one's, in turns, each beside
     its byte bound (gated: 5 trees a live row, 4 a frozen one, 4.5 at
     [1, 0]);
   * ``async_threaded``: ``run_threaded`` on the figure's problem with a
     dead client and a deadline: every tick, bounded staleness, the dead
     client never applied (48 gated launches);
6d. the distributed backend (``training/backends.py::ShardMapBackend``):
   * ``distributed``: an NCCL process group of world size 1 (NCCL refuses
     two ranks on one device), initialised in this process from a
     ``FileStore`` and destroyed at the phase's end; ``ShardMapBackend``
     over it holds every client and runs the collectives (all_gather,
     all_reduce) on the card: the Fig. 4 MLP's ``DIST_MLP_ROUNDS`` rounds
     under a dense ring, complete, chebyshev, a cohort schedule and top-k
     0.1 through the packed ``wire_fn``, each against the same rounds on
     ``StackedVmapBackend`` (bit-equal, the largest relative L2 of a leaf
     printed, round walls; 300 launches of each kernel a run); the Fig. 6
     S = 4 sweep through the backend against the stacked sweep (bit-equal;
     800 a run); full-width ``qwen3-1.7b`` on 2 bf16 clients, the
     ``train_llm`` cell, one warm-up and ``DIST_LLM_ROUNDS`` timed rounds
     through each backend (7 launches a step), the states bit-equal (and
     every leaf within ``BF16_REL``), round walls, peaks, the state's allocation, and the
     collectives counted by ``analysis/hlo.py`` against
     ``analysis.comm.device_wire_bytes``;
   * ``dryrun``: ``launch/dryrun.py`` on ``meta`` for every architecture at
     full width, ``--mesh 1x1`` (a line each); Qwen3-1.7B's 2,032,264,192
     parameters, 2 bf16 clients fitting with the step's temporaries, and
     its state bytes at 2 clients within ``DRYRUN_REL`` of the allocation
     ``distributed`` measured and of ``train_llm``'s state;
7. one DEPOSITUM step's two grouped calls (``ops.fused_local_update``,
   ``ops.fused_tracking``) captured in a ``torch.cuda.CUDAGraph`` on static
   inputs, gated and ungated: each replay equals the eager calls bit for
   bit, also after new values are copied into the inputs;
8. time each kernel (CUDA events) against its plain version, its bound and
   (flash) ``scaled_dot_product_attention``, at its path's shapes and at a
   larger one (the sweep pair's step both as one grouped launch and as six
   single-leaf launches, in turns, with the grouped kernels' device time
   from ``torch.profiler``; one ``BANDWIDTH_LEAF`` in fp32, in bf16 on the
   16-byte route and in bf16 at d = 2^20 + 3, element by element; the fp32
   flash kernel at the served shape and
   at L = 8192), and the
   DEPOSITUM round wall time fused and unfused; the bf16 flash kernel
   at the zoo's D 80 and D 96 served shapes (``FLASH_ZOO_SHAPES``) in
   turns with the head-dim route it replaced (q, k, v zero-padded to
   D 128, the D 128 launch, the slice), SDPA and the bound at the true
   D; and the bf16 kernel
   non-causal at the enc-dec's three served shapes
   (``FLASH_ENCDEC_SHAPES``: the encoder's L 1024, the prefill's 16 and
   decode's 1 queries against 1024 memory rows); the training kernels
   at the benchmark cells' attention (``FLASH_TRAIN_SHAPE``): the bf16
   backward against its bound, its plain version (within
   ``FLASH_BWD_REL``, the plain backward given the plain forward's ``o``
   and ``lse``, which the training forward's are held to first) and
   SDPA's backward, forward + recompute + backward of one layer, and the
   forward with and without ``lse`` there and at the served shape.  Every bound reads the card's rates from the
   port's hardware model (``repro_torch.launch.mesh.HW``).

Before each path (phases 3, 4, 4a, 4b, 5, 5a, 5b, 6, 6a, 6b, 6c, 6d;
each architecture of 5a and 6, each run of 6d) every launch count is set
to 0; it is read just after.  The kernels line's launches of the two
sweep kernels sum the paths that run them (3, 4a, 4b, 6a, 6b, 6c and
6d), the flash kernels' the served
paths (5, 5a, 5b, 6 and 6a), with ``flash_fwd_padded`` the share of them
through the head-dim route (bf16: 0, every served D is native; fp32: the
reduced configs' D 32); the bf16 entry adds ``flash_fwd_train``, the
training forward's launches in ``train_llm``'s (6a) timed rounds, and the
``flash_attention_bwd`` entry (the backward, which replaces no TPU
kernel) counts its launches there; the ``flash_attention_mla_fwd`` and
``flash_attention_mla_bwd`` entries (D 192 / DV 128) count theirs in
``train_mla``'s timed rounds.  Prints JSON lines per
phase, then the card's name and power limit (from ``nvidia-smi``), then
one ``{"kernels": [...]}`` line, then as the last line ``{"ok": true,
"device": {...}}``.  Exits non-zero
with no result when CUDA is unavailable or the port's sources are not
beside the script.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ROUNDS = 30
# a client's leaves: the Fig. 4 MLP (l0.w l0.b l1.w l1.b l2.w l2.b), and a
# ragged tree (0-D to 2-D, odd and float4-able sizes)
MLP_LEAVES = ((123, 64), (64,), (64, 32), (32,), (32, 10), (10,))
RAGGED_LEAVES = ((), (3,), (10,), (8, 8), (123, 64), (1001,))
ATOL, RTOL = 1e-6, 1e-6        # kernel vs plain, fp32: same ops, same order
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2   # small bf16 cases, values ~0.1
# the LM head's bf16 leaf: the kernel and the plain version compute the same
# fp32 result and round it once, so they may differ by one ulp at most
BF16_HEAD_ULPS = 1
# Fused vs unfused on the card: the unfused step divides by the round's
# scalars on the device (a true division, as the kernel, built with
# -fmad=false, does) and does the kernel's fp32 operations in its order, so
# the two runs are bit-equal, after one round and after 300 steps.
STEP_ATOL, STEP_RTOL = 0.0, 0.0     # one round (10 steps)
STATE_REL = 0.0                # 300 steps: ||x_fused - x_unfused|| / ||x||
LOSS_RTOL, STAT_RTOL = 0.0, 0.0     # 300 steps: final loss, stationarity
# flops per element: update = momentum (3) + shift (2) + prox chain (<= 8)
UPDATE_FLOPS, TRACKING_FLOPS = 13, 3
# one bandwidth-bound leaf (S, C, d) for the timing phase
BANDWIDTH_LEAF = (4, 16, 1 << 20)
KERNEL_SOURCE = "src/repro_torch/kernels/prox/csrc/prox_sweep.cu"
FLASH_SOURCES = {
    "bfloat16": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu",
    "float32": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"}
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:34"
# the bf16 backward: it replaces no TPU kernel (the reference's flash
# kernel has none)
FLASH_BWD_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_bwd_sm90.cu")
# the flash kernels' instantiations that must not spill, and (bf16) must
# hold the wgmma of Q K^T and of P V in their SASS: the served head dims
# (bf16 D 80, 96 and 128; the card-vs-CPU path's fp32 D 128)
FLASH_SM90_CHECKED = (80, 96, 128, 192)
FP32_NO_SPILL = "flash_fwd_fp32_kernelILi128E"
# flash kernel vs plain: blockwise online softmax sums in another order
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# the benchmark cells' attention (B, L, H, KV, D), trained through the bf16
# forward with lse and the backward; the backward against its plain version
# in fp32, relative L2 (the kernel rounds P and dS to bf16 as operands)
FLASH_TRAIN_SHAPE = (2, 2048, 16, 8, 128)
FLASH_BWD_REL = 1e-2
# the training forward's row logsumexp against the plain version's (fp32 on
# the same bf16 inputs), largest absolute difference
FLASH_LSE_ATOL = 1e-4
# the deepseek-v2-lite cell's attention (B, L, H, D, DV), causal, every
# head its own key and value
FLASH_MLA_SHAPE = (2, 4096, 16, 192, 128)
# full-width prefill, flash vs plain attention: both compute the attention
# in fp32 and round it to bf16, so an element may differ by one bf16 ulp
# (2^-8 relative); 28 bf16 layers carry that into the logits (std ~1)
SERVE_LOGIT_ATOL, SERVE_LOGIT_RTOL = 0.1, 0.05
CPU_ATOL = CPU_RTOL = 1e-4     # card vs CPU, fp32 reduced models
SERVE = {"arch": "qwen3-1.7b", "batch": 4, "prompt": 1024, "new": 32,
         "cache": 2048}
# The zoo's decoder families served at full width (bf16, random weights on
# the card), one at a time: B 4, a 1024-token prompt (a multiple of the SSD
# chunk 256), 32 greedy tokens.  qwen3-moe keeps its published width and
# its depth is cut 94 -> 8 (470 GB of bf16 weights do not fit; 8 layers
# are 42.3 GB).  phi-3-vision prefills 1024 stub vision embeds before the
# prompt (L 2048), so its cache holds 4096 slots: a 2048-slot ring would
# wrap during decode.  Every flash call of a served prefill is held against
# the plain version on the same inputs at FLASH_TOL.  The end-to-end drift
# of the prefill logits against the plain attention swapped in is printed,
# not held at SERVE_LOGIT_*: on the card each call differs from the plain
# version by 1-2 bf16 ulps (38% of its outputs), which grows with depth
# (qwen2.5-14b at 12 / 28 / 48 layers: 0.105 / 0.125 / 0.158 max) and flips
# the MoE's bf16 routing (qwen3-moe: 2.46), past SERVE_LOGIT_* in 4 of 5.
ZOO_SERVE = {"batch": 4, "prompt": 1024, "new": 32, "cache": 2048}
ZOO_ARCHS = ("qwen2.5-14b", "minitron-4b", "qwen3-moe-235b-a22b",
             "phi-3-vision-4.2b", "mamba2-130m", "zamba2-2.7b")
ZOO_DEPTH = {"qwen3-moe-235b-a22b": 8}
ZOO_CACHE = {"phi-3-vision-4.2b": 4096}
# the seven new architectures reduced, fp32, card against CPU: a prompt of
# 96 (a multiple of the reduced SSD chunk 32), 8 greedy tokens
ZOO_CPU_ARCHS = ("qwen2.5-14b", "minitron-4b", "grok-1-314b",
                 "qwen3-moe-235b-a22b", "phi-3-vision-4.2b", "mamba2-130m",
                 "zamba2-2.7b")
ZOO_CPU = {"batch": 2, "prompt": 96, "new": 8, "cache": 128}
# the bf16 kernel at the zoo's two served shapes of a head dim other than
# 64 / 128 (zamba2: D 80, phi-3-vision: D 96), in turns with the head-dim
# route that served them before the kernel was built for them (zero-padded
# to D 128) and SDPA at the true D
FLASH_ZOO_SHAPES = {"zamba2_d80": (4, 1024, 32, 32, 80),
                    "phi3_d96": (4, 2048, 32, 32, 96)}
# The encoder-decoder family served at full width (seamless-m4t-medium:
# 12 + 12 layers, d 1024, 16/16 heads of 64, bf16, random weights): B 4,
# 1024 stub frame embeddings (the reference's stand-in for the speech
# frontend, ~20 s of speech at 50 Hz), a 16-token prompt (the reference
# launcher's --prompt-len), 32 greedy tokens, 256 cache slots.  The
# prefill step (launch.steps.build_prefill_step) encodes the frames and
# runs the decoder's prompt: 12 + 12 + 12 flash launches; the server then
# feeds the prompt token by token and decodes: 12 cross-attention launches
# a step (Lq 1 against the 1024 memory rows) over 16 + 31 steps.  Every
# flash call of the prefill step and of one decode step is held against
# the plain version at FLASH_TOL; the drift of the logits is printed, not
# gated (as serve_zoo's).  ENCDEC_CPU: the reduced config, fp32, card
# against CPU.
ENCDEC_SERVE = {"arch": "seamless-m4t-medium", "batch": 4, "frames": 1024,
                "prompt": 16, "new": 32, "cache": 256}
ENCDEC_CPU = {"batch": 2, "frames": 64, "prompt": 8, "new": 8, "cache": 32}
# the bf16 kernel at the enc-dec's three served shapes (B, Lq, Lk, H, KV,
# D), non-causal: the encoder's self-attention, the prefill's
# cross-attention and decode's
FLASH_ENCDEC_SHAPES = {"encdec_encoder": (4, 1024, 1024, 16, 16, 64),
                       "encdec_cross": (4, 16, 1024, 16, 16, 64),
                       "encdec_decode_cross": (4, 1, 1024, 16, 16, 64)}
# check_flash's Lq != Lk pairs (D 64, 80, 96, groups 1 and 2, causal and
# not):
# decode's one query and a prompt's 16 against 1024 memory rows and a
# ragged 1000, and short ragged pairs both ways
FLASH_CROSS_PAIRS = ((1, 1024), (16, 1024), (16, 1000), (1, 17), (17, 200),
                     (200, 17))
# The sweep paths (Fig. 6: 4 topologies, Fig. 8: 6 schedules, the cohort
# grid: 8 padded (n, p) points).  Fused and unfused sweeps do the same
# fp32 operations: bit-equal.  Sweep against sequential: a sweep runs S
# configs' gradients and gossip as batched products where the sequential
# run makes one product a config, and the two need not round alike.  One
# round (<= 20 steps) is held at the reference's test_sweep.py tolerance;
# after a whole run (800 steps for Fig. 6) the model x by relative L2
# norm, at SWEEP_SEQ_REL, a bound set before the first run on the card
# from the drift one ulp a step can reach over 800 steps of a nonconvex
# run (a fused-vs-unfused drift of 2.6e-3 after 300 steps was measured
# when the unfused step still divided by host scalars).
FIG6_ROUNDS, FIG8_ROUNDS, COHORT_ROUNDS = 40, 30, 30
SWEEP_SEQ_ATOL, SWEEP_SEQ_RTOL = 1e-6, 2e-5     # one round
SWEEP_SEQ_REL = 5e-2                            # whole run, x
COHORT_NATIVE_REL = 1e-4    # padded point vs native run (fig_cohort.py)
SWEEP_TIMING_PAIRS = 3      # sweep and sequential timed in turns
# Compressed paths.  Fused and unfused compressed rounds do the same fp32
# operations (the compressors are plain PyTorch ops on both): bit-equal.
# The frontier sweep runs every point in the mixed form, its sequential
# runs each point's native kind: the dense point then differs by the
# CHOCO arithmetic's rounding (x + (W x - x) against W x), hence rtol 1e-5
# after one round; the whole run's x at SWEEP_SEQ_REL, set before the
# first run on the card.  Card against CPU: one comm step from the same
# state, where only the mix's and the gradients' products round apart.
COMM_ROUNDS = 30
COMM_SEQ_RTOL = 1e-5
COMM_CPU_ATOL = 1e-5
# Federated training at full width through the launcher's own builder
# (launch/train.py: FederatedTrainer, fused="auto"): Qwen3-1.7B, bf16,
# remat "full", 2 clients (five bf16 trees of 4.065 GB a client: 40.65 GB
# of state; 3 clients or fp32 do not fit on 80 GB), one warm-up round,
# then TRAIN_ROUNDS timed rounds; the consensus then serves B 2, a 64-token
# prompt, 8 greedy tokens.  TRAIN_PEAK_GB: the peak reckoned from the
# trees before the first run (seven bf16 trees at once, plus activations).
TRAIN = ["--arch", "qwen3-1.7b", "--clients", "2", "--topology", "complete",
         "--batch", "2", "--seq", "512", "--t0", "4", "--alpha", "0.02",
         "--beta", "1.0", "--gamma", "0.8", "--momentum", "polyak",
         "--prox", "l1", "--lam", "1e-5", "--seed", "0"]
TRAIN_ROUNDS = 3
TRAIN_PEAK_GB = (57.0, 66.0)
# then TRAIN_TEL_PAIRS pairs of rounds in turns, one recorded
# (telemetry=True, every round) and one not: round wall and peak memory
TRAIN_TEL_PAIRS = 2
TRAIN_SERVE = {"batch": 2, "prompt": 64, "new": 8, "cache": 128}
# DeepSeek-V2-Lite's share as the benchmark cell runs it (8 of 64 experts,
# 12,800 vocabulary rows, B 2 x L 4096, T0 4, 2 bf16 clients), cut to
# MLA_LAYERS of its 17 layers (the dense one and two MoE layers) for time
MLA_TRAIN = ["--arch", "deepseek-v2-lite", "--clients", "2", "--topology",
             "complete", "--batch", "2", "--seq", "4096", "--t0", "4",
             "--seed", "0"]
MLA_LAYERS = 3
MLA_ROUNDS = 2
# the reduced fp32 trainer: launch.train --ckpt then launch.serve --ckpt,
# and 2 rounds on the card against the CPU from one state
TRAIN_REDUCED = ["--arch", "qwen3-1.7b", "--reduced", "--clients", "4",
                 "--topology", "ring", "--batch", "2", "--seq", "16",
                 "--t0", "2", "--rounds", "2", "--seed", "1"]
# Table III (table3_algorithms.py) at its published constants: 5 columns x
# 3 partitions, the 3 seeds of a cell as S = 3.  OPTION I runs the sweep
# kernels (one grouped launch a step for the 3 seeds); OPTION II is Nesterov
# momentum, which the kernels do not cover (Polyak only, in the reference
# as here), so it runs the unfused step.  Card against CPU: one DEPOSITUM
# and one FedDR cell (Dir(0.1)) from the same weights and batches, x by
# relative L2 after the cell's 150 steps, within a limit a cell.  Each
# limit lies between the sound reading and that of a control that must
# miss it: the same cell on the card with TF32 matmuls, a card-side fault
# of about a part in a thousand a product.
T3_CPU_REL = {"depositum-I": 1.2e-3, "feddr": 1e-5}
T3_TIMING_PAIRS = 2        # sweep and sequential timed in turns
# Figs. 5 and 7 at their published constants: 4 static groups of 400
# iterations each, one grouped launch a step
FIG_GROUP_ITERS = 400
# telemetry: the Fig. 6 sweep recorded at log_every 1, buffer B
TELEMETRY_BUFFER = 8
TELEMETRY_TIMING_PAIRS = 2  # on / off timed in turns
# The async runtime (training/async_runtime.py), fused="require": every
# learner round is one masked round through the gated sweep kernels.
# async_mlp: the Fig. 4 MLP point at published widths, ASYNC_MLP_ROUNDS
# learner rounds under exponential stragglers with faults and a dead
# client, tau 2, downweight 0.5.  Card against CPU: x by relative L2 after
# the run (300 steps), within ASYNC_MLP_CPU_REL, a limit set before the
# first run on the card between the sound reading and that of the same run
# on the card with TF32 matmuls, which must miss it (both predicted on the
# CPU: the matmuls computed in float64 and rounded, against TF32-rounded
# operands in every product of the forward and backward).
ASYNC_MLP_ROUNDS = 30
ASYNC_MLP_CPU_REL = 1.8e-3
# async_llm: train_llm's model and state, tau 1 downweight, 2 clients
# under exponential(1.0) stragglers; one warm-up and ASYNC_LLM_ROUNDS timed
# learner rounds, donated.  ASYNC_LLM_PEAK_GB: the peak reckoned from the
# trees before the first run: eight bf16 trees of 8.13 GB at the gated
# tracking kernel (old y, mu, g; x, nu'; g_new; y', g_kept), 65.0 GB, where
# the round without item 3's donation would hold ten (81.3 GB).
ASYNC_LLM_ROUNDS = 3
ASYNC_LLM_PEAK_GB = (64.0, 69.0)
# async_threaded: run_threaded on the async figure's problem, one dead
# client, a deadline
ASYNC_THREADED_DEADLINE_S = 30.0
# The distributed backend on one card: a world-size-1 process group
# (NCCL refuses two ranks on one device: "Duplicate GPU detected"), the
# Fig. 4 MLP's rounds under five plans through ShardMapBackend, then
# StackedVmapBackend, held bit-equal (the same operations at one rank:
# the one-rank all_gather / all_reduce are copies); top-k 0.1 packed in
# DIST_TOPK_WIRE_K slots a leaf row (its largest leaf keeps 787);
# full-width Qwen3-1.7B as train_llm's cell, one warm-up and
# DIST_LLM_ROUNDS timed rounds each way, held bit-equal, and every leaf
# within BF16_REL (the limits of tests/test_torch_trainer.py's bf16 runs).
DIST_BACKEND = "nccl"
DIST_MLP_ROUNDS = ROUNDS
DIST_TOPK_WIRE_K = 800
DIST_TRAIN = TRAIN + ["--rounds", "3"]
DIST_LLM_ROUNDS = 2
BF16_REL = {"dx": 6e-2, "y": 5e-2, "nu": 5e-2, "g": 5e-2}
# launch/dryrun.py's state bytes for Qwen3-1.7B at 2 bf16 clients against
# the allocation measured for that state
DRYRUN_REL = 0.01
# The zoo's other families trained at full width (train_zoo), one at a
# time, each freed before the next: zamba2-2.7b (the main path of this
# phase), mamba2-130m and seamless-m4t-medium, bf16, remat "full", each on
# 2 clients under TRAIN's cell (complete, T0 4, alpha 0.02, beta 1, gamma
# 0.8, Polyak, l1 1e-5, B 2 x L 512 a client a step, fused="auto",
# donated rounds): one warm-up round and TRAIN_ZOO_ROUNDS timed rounds.
# Only these three non-dense archs fit two bf16 clients on 80 GB
# (launch/dryrun.py).  The sweep pair takes ceil(leaves / MAX_LEAVES)
# grouped launches a step (TRAIN_ZOO_LAUNCHES: 417, 218 and 256 leaves,
# the smallest 80 and 24 elements) and is held against its plain version
# at each new leaf table after the warm-up round, every bf16 output within
# TRAIN_ZOO_ULPS.  The enc-dec's batches carry TRAIN_ZOO_FRAMES stub frames
# a sample from a seeded generator on the card (the LM stream has none).
# Then each consensus: zamba2's serves TRAIN_ZOO_SERVE (9 flash launches a
# prefill at D 80, none through the head-dim route, each call held against
# the plain version); mamba2's is written by save_checkpoint (0.52 GB of fp32
# npz) and served by launch.serve --ckpt (restored = saved bit for bit,
# tokens = the consensus served directly); seamless's through the prefill
# step and BatchedServer (TRAIN_ZOO_ENCDEC_SERVE: 36 flash launches a
# prefill step, 12 a decode step).  TRAIN_ZOO_PEAK_GB: zamba2's peak
# reckoned before the first run (41.27 GB of state, 16.51 GB of a step's
# temporaries, activations under remat, a 4.13 GB consensus).
TRAIN_ZOO = ("zamba2-2.7b", "mamba2-130m", "seamless-m4t-medium")
TRAIN_ZOO_LAUNCHES = {"zamba2-2.7b": 9, "mamba2-130m": 5,
                      "seamless-m4t-medium": 6}
TRAIN_ZOO_ROUNDS = 2
TRAIN_ZOO_FRAMES = 1024
TRAIN_ZOO_ULPS = 0
TRAIN_ZOO_PEAK_GB = (58.0, 66.0)
TRAIN_ZOO_SERVE = {"batch": 2, "prompt": 256, "new": 8, "cache": 512}
TRAIN_ZOO_ENCDEC_SERVE = {"batch": 2, "frames": 1024, "prompt": 16,
                          "new": 8, "cache": 64}
# train_zoo_card_vs_cpu: the reduced fp32 configs of the families that
# train only reduced on one card (MoE, VLM) and of the three above, 2
# rounds from one state on the card and on the CPU, x / y / nu / g within
# CPU_ATOL / CPU_RTOL; a VLM's vision embeds and an enc-dec's 16 frames a
# sample drawn from a numpy seed, the same on both devices
TRAIN_ZOO_CPU_ARCHS = ("qwen3-moe-235b-a22b", "grok-1-314b",
                       "phi-3-vision-4.2b", "mamba2-130m", "zamba2-2.7b",
                       "seamless-m4t-medium")
TRAIN_ZOO_CPU = ["--reduced", "--clients", "4", "--topology", "ring",
                 "--batch", "2", "--seq", "32", "--t0", "2", "--rounds", "2",
                 "--seed", "1", "--log-every", "1"]
TRAIN_ZOO_CPU_FRAMES = 16


def hw() -> dict:
    """The card's rates for every bound of this script: the port's hardware
    model, ``repro_torch.launch.mesh.HW`` (H100 SXM: ``hbm_bandwidth``,
    ``peak_flops_fp32``, ``peak_flops_bf16``)."""
    from repro_torch.launch.mesh import HW
    return HW


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in units in the last place
    (int32): their bit patterns mapped to one monotone integer line, so
    +0 and -0 are 0 apart and neighbours across zero 2."""
    import torch

    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (line(a) - line(b)).abs()


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ptxas(log: str) -> dict:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: its registers,
    shared memory, spill bytes and ptxas's other notes on it."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            cur = ln.split("'")[1]
            out[cur] = {"notes": []}
        elif cur is None:
            continue
        elif "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[cur]["stack_bytes"], out[cur]["spill_store_bytes"], \
                out[cur]["spill_load_bytes"] = nums[:3]
        elif "Used" in ln and "registers" in ln:
            out[cur]["usage"] = ln.split(":", 1)[-1].strip()
        elif "warning" in ln or "wgmma" in ln or "setmaxnreg" in ln:
            out[cur]["notes"].append(ln.strip())
    return out


def _sass_wgmma(lib) -> dict:
    """The wgmma (SASS ``HGMMA``) instructions of each instantiation of the
    bf16 flash kernel in ``lib``: {D: {"shape ss|rs": count}}, ``ss`` for A
    from shared memory (Q K^T), ``rs`` for A from registers (P V)."""
    import re
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, counts = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            d = re.search(r"flash_fwd_sm90_kernelILi(\d+)E", ln)
            counts = out.setdefault(int(d.group(1)), {}) if d else None
        m = re.search(r"HGMMA\.(\w+)\.F32\.BF16 R\d+, (\S+)", ln) \
            if counts is not None else None
        if m:
            key = f"{m.group(1)} {'ss' if 'desc' in m.group(2) else 'rs'}"
            counts[key] = counts.get(key, 0) + 1
    return out


def phase_build() -> dict:
    """The four nvcc runs started together (one thread each), then loaded;
    the flash kernels' ptxas reports, and their spill checks (the bf16
    backward's dK / dV and dQ kernels at every ``TRAIN_HEAD_DIMS`` and at
    D 192 of ``TRAIN_DV_PAIRS``); the
    sweep source's report (registers and spills of each instantiation of
    the update, tracking and prox kernels), printed."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.prox import kernel as prox
    t0 = time.perf_counter()
    jobs = (prox.build_library, lambda: flash.build_library("flash_fwd"),
            lambda: flash.build_library("flash_fwd_sm90"),
            lambda: flash.build_library("flash_bwd_sm90"))
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda job: job(), jobs))
    prox._lib()
    for name in flash.SOURCES:
        flash._kernel(name)
    sweep = _ptxas(paths[0].with_suffix(".log").read_text())
    if not sweep:
        raise AssertionError("prox_sweep.cu: no ptxas report in its log")
    sm90 = _ptxas(paths[2].with_suffix(".log").read_text())
    fp32 = _ptxas(paths[1].with_suffix(".log").read_text())
    bwd = _ptxas(paths[3].with_suffix(".log").read_text())
    checked = [("bf16", sm90, f"flash_fwd_sm90_kernelILi{D}E")
               for D in FLASH_SM90_CHECKED] + [("fp32", fp32, FP32_NO_SPILL)] \
        + [("bf16 backward", bwd, f"flash_bwd_{part}_kernelILi{D}E")
           for D in flash.TRAIN_HEAD_DIMS + tuple(
               d for d, _ in flash.TRAIN_DV_PAIRS)
           for part in ("dkdv", "dq")]
    for label, report, key in checked:
        spilling = [name for name, p in report.items() if key in name
                    and (p["spill_store_bytes"] or p["spill_load_bytes"])]
        if spilling or not any(key in name for name in report):
            raise AssertionError(f"{label} flash kernel {key}: spills or "
                                 f"is missing: {spilling or sorted(report)}")
    wgmma = _sass_wgmma(paths[2])
    for D in FLASH_SM90_CHECKED:
        kinds = wgmma.get(D, {})
        if not any(k.endswith(" ss") for k in kinds) \
                or not any(k.endswith(" rs") for k in kinds):
            raise AssertionError(f"bf16 flash kernel, D = {D}: no wgmma for "
                                 f"Q K^T or for P V in its SASS: {wgmma}")
    return {"phase": "build",
            "libraries": [str(p.relative_to(ROOT)) for p in paths],
            "seconds": time.perf_counter() - t0, "flash_sm90_wgmma": wgmma,
            "flash_sm90_ptxas": sm90, "flash_fp32_ptxas": fp32,
            "flash_bwd_ptxas": bwd,
            "sweep_ptxas": sweep,
            "sweep_spilling": sorted(n for n, p in sweep.items()
                                     if p.get("spill_store_bytes")
                                     or p.get("spill_load_bytes"))}


def _modules():
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.prox import kernel as prox
    return prox, flash


def reset_counts() -> None:
    from repro_torch.models import attention
    for m in _modules():
        m.reset_launch_counts()
    attention.DISPATCH_COUNTS.clear()


def read_counts() -> dict:
    """Every kernel's launch count, under the names of the kernels line."""
    prox, flash = _modules()
    return {"fused_update_sweep": prox.LAUNCH_COUNTS["fused_sweep"],
            "fused_tracking_sweep": prox.LAUNCH_COUNTS["tracking_sweep"],
            "prox": prox.LAUNCH_COUNTS["prox"],
            "fused_update": prox.LAUNCH_COUNTS["fused_update"],
            "flash_attention": flash.LAUNCH_COUNTS["flash_fwd_sm90"],
            "flash_attention_fp32": flash.LAUNCH_COUNTS["flash_fwd_fp32"],
            # of both kernels' launches, those through the head-dim route
            "flash_fwd_padded": flash.LAUNCH_COUNTS["flash_fwd_padded"]}


def expect_counts(path: str, counts: dict, want: dict) -> None:
    """Each kernel launched exactly ``want[name]`` times (0 if absent; the
    head-dim route's count too), and the flash wrapper's total is the sum
    of its two kernels'."""
    _, flash = _modules()
    total = counts["flash_attention"] + counts["flash_attention_fp32"]
    if flash.LAUNCH_COUNTS["flash_fwd"] != total:
        raise AssertionError(f"{path}: flash_fwd counted "
                             f"{flash.LAUNCH_COUNTS['flash_fwd']} launches, "
                             f"its routes {total}")
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, want "
                                 f"{want.get(name, 0)}")


def expect_train_flash(path: str, passes: int) -> dict:
    """Training attention went through the kernels: the backward launched
    once an attention layer, client and step (``passes``), the training
    forward twice (remat "full": forward and recompute), and no call fell
    through to ``_sdpa``; returns the three counts."""
    from repro_torch.models import attention
    _, flash = _modules()
    got = {"flash_bwd": flash.LAUNCH_COUNTS["flash_bwd"],
           "flash_fwd_train": flash.LAUNCH_COUNTS["flash_fwd_train"],
           "train_sdpa": attention.DISPATCH_COUNTS["train_sdpa"]}
    want = {"flash_bwd": passes, "flash_fwd_train": 2 * passes,
            "train_sdpa": 0}
    if got != want:
        raise AssertionError(f"{path}: training attention launched {got}, "
                             f"want {want}")
    return got


def _operands(S, C, d, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: (torch.randn((S, C, d), generator=g, device="cuda")
                  * 0.1).to(dtype)
    return mk(), mk(), mk()


def _table(S):
    from repro_torch.kernels.prox.kernel import sweep_params_table
    import torch
    return sweep_params_table(
        lam=torch.tensor([1e-3, 5e-3, 1e-2])[:S], theta=4.0,
        alpha=torch.tensor([0.05, 0.1, 0.2])[:S],
        gamma=torch.tensor([0.0, 0.5, 0.9])[:S],
        beta=torch.tensor([1.0, 0.5, 1.5])[:S], device="cuda")


def phase_check() -> dict:
    """Each kernel against its plain version; returns the worst errors."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    S, C = 3, 10
    params = _table(S)
    mask = (torch.rand((S, C), generator=torch.Generator().manual_seed(5))
            > 0.4).to(torch.float32)
    mask[1] = 0.0                      # one all-frozen config
    mask = mask.cuda()
    worst = {"fused_update_sweep": 0.0, "fused_tracking_sweep": 0.0}
    cases = 0

    def close(name, out, ref, dtype):
        atol, rtol = ((ATOL, RTOL) if dtype == torch.float32
                      else (BF16_ATOL, BF16_RTOL))
        torch.testing.assert_close(out, ref, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")
        if dtype == torch.float32:
            err = float((out - ref).abs().max()) if out.numel() else 0.0
            worst[name] = max(worst[name], err)

    for dtype, ds in ((torch.float32, (1001, 1024, 1)),
                      (torch.bfloat16, (333,))):
        for d in ds:
            for gated in (False, True):
                m = mask if gated else None
                x, y, nu = _operands(S, C, d, dtype, seed=d)
                for kind in ("l1", "mcp", "scad"):
                    xo, nuo = K.fused_update_sweep_cuda(x, y, nu, params, m,
                                                        kind=kind)
                    xr, nur = K.fused_update_sweep_plain(x, y, nu, params, m,
                                                         kind=kind)
                    torch.cuda.synchronize()
                    close("fused_update_sweep", xo, xr, dtype)
                    close("fused_update_sweep", nuo, nur, dtype)
                    if gated:
                        frozen = mask <= 0
                        assert bits_equal(xo[frozen], x[frozen]), kind
                        assert bits_equal(nuo[frozen], nu[frozen]), kind
                    cases += 1
                yo, gk = K.fused_tracking_sweep_cuda(y, nu, x, params, m)
                yr, gr = K.fused_tracking_sweep_plain(y, nu, x, params, m)
                torch.cuda.synchronize()
                close("fused_tracking_sweep", yo, yr, dtype)
                assert bits_equal(gk, gr)
                if gated:
                    frozen = mask <= 0
                    assert bits_equal(yo[frozen], y[frozen])
                    assert bits_equal(gk[frozen], x[frozen])
                cases += 1

    def grouped_equal(name, outs, refs, ins, m, dtype):
        """fp32 bit for bit, bf16 within its tolerance; frozen rows as
        the inputs ``ins``, bit for bit."""
        for out, ref, inp in zip(outs, refs, ins):
            for a, b, i in zip(out, ref, inp):
                if a.shape != i.shape or a.dtype != dtype \
                        or not a.is_contiguous():
                    raise AssertionError(f"{name}: output {tuple(a.shape)} "
                                         f"{a.dtype} for {tuple(i.shape)}")
                if dtype == torch.float32 and not bits_equal(a, b):
                    raise AssertionError(f"{name}: not bit-equal to plain")
                close(name, a, b, dtype)
                if m is not None and not bits_equal(a[m <= 0], i[m <= 0]):
                    raise AssertionError(f"{name}: a frozen row changed")

    grouped_cases = 0
    for label, leaves in (("mlp", MLP_LEAVES), ("ragged", RAGGED_LEAVES)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(len(label))
            x, y, nu = ([(torch.randn((S, C) + s, generator=g, device="cuda")
                          * 0.1).to(dtype) for s in leaves] for _ in range(3))
            for m in (None, mask):
                for kind in ("l1", "mcp", "scad"):
                    before = read_counts()
                    out = K.fused_update_sweep_grouped(x, y, nu, params, m,
                                                       kind=kind)
                    expect_counts(f"grouped {label}", read_counts(), {
                        **before, "fused_update_sweep":
                            before["fused_update_sweep"] + 1})
                    ref = K.fused_update_sweep_grouped_plain(
                        x, y, nu, params, m, kind=kind)
                    torch.cuda.synchronize()
                    grouped_equal("fused_update_sweep", out, ref, (x, nu), m,
                                  dtype)
                    grouped_cases += 1
                before = read_counts()
                out = K.fused_tracking_sweep_grouped(y, nu, x, params, m)
                expect_counts(f"grouped {label}", read_counts(), {
                    **before, "fused_tracking_sweep":
                        before["fused_tracking_sweep"] + 1})
                ref = K.fused_tracking_sweep_grouped_plain(y, nu, x, params,
                                                           m)
                torch.cuda.synchronize()
                grouped_equal("fused_tracking_sweep", out, ref, (y, x), m,
                              dtype)
                grouped_cases += 1
    # the LM head's leaf on the training path: one config's 2 client rows
    # of (2048, 152064) bf16, 311,427,072 elements a row (lead 1), under
    # the launcher's row (alpha 0.02, gamma 0.8, beta 1, lam 1e-5); x at
    # the weights' scale and y, nu at a gradient's, so that x' - x
    # (alpha |nu'| ~ 0.017) spans ~200 bf16 ulps of x.  Held at one bf16
    # rounding: each output at most BF16_HEAD_ULPS from the plain version.
    # Controls that must miss by more in most elements: the step skipped
    # (the inputs returned) and, for x', the plain version under alpha / 2
    # (a misread row), for y', under beta / 2.
    head = (2, 2048, 152064)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = (torch.randn(head, generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    y, nu = (torch.randn(head, generator=g, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    rows = {scale: K.sweep_params_table(
        lam=1e-5, theta=4.0, alpha=0.02 * scale, gamma=0.8, beta=scale,
        device="cuda") for scale in (1.0, 0.5)}
    head_ulps, head_controls = {}, {}

    def hold(name, out, ref, controls, live=slice(None)):
        """out within BF16_HEAD_ULPS of ref on the ``live`` client rows;
        each control off by more than that in over half their elements."""
        if out.shape != head or out.dtype != torch.bfloat16:
            raise AssertionError(f"{name} at the LM head: {tuple(out.shape)}"
                                 f" {out.dtype}")
        out, ref = out[live], ref[live]
        controls = {label: c[live] for label, c in controls.items()}
        d = bf16_ulps(out, ref)
        worst_ulps, n_diff = int(d.max()), int((d > 0).sum())
        head_ulps[name] = {"max_ulps": worst_ulps, "differing": n_diff}
        if worst_ulps > BF16_HEAD_ULPS:
            raise AssertionError(f"{name} at the LM head: {worst_ulps} ulps "
                                 f"from plain ({n_diff} elements differ)")
        for label, c in controls.items():
            share = float((bf16_ulps(c, ref) > BF16_HEAD_ULPS).float().mean())
            head_controls[f"{name} {label}"] = share
            if share <= 0.5:
                raise AssertionError(f"{name} at the LM head: control "
                                     f"{label!r} is within the limit in "
                                     f"{1 - share:.1%} of the elements")

    (xo,), (nuo,) = K.fused_update_sweep_grouped([x], [y], [nu], rows[1.0],
                                                 kind="l1", lead=1)
    (xr,), (nur,) = K.fused_update_sweep_grouped_plain(
        [x], [y], [nu], rows[1.0], kind="l1", lead=1)
    torch.cuda.synchronize()
    (xa,), _ = K.fused_update_sweep_grouped_plain([x], [y], [nu], rows[0.5],
                                                  kind="l1", lead=1)
    hold("x'", xo, xr, {"step skipped": x, "alpha / 2": xa})
    del xa
    hold("nu'", nuo, nur, {"step skipped": nu})
    del xo, nuo, xr, nur
    (yo,), (kept,) = K.fused_tracking_sweep_grouped([y], [nu], [x], rows[1.0],
                                                    lead=1)
    (yr,), _ = K.fused_tracking_sweep_grouped_plain([y], [nu], [x],
                                                    rows[1.0], lead=1)
    torch.cuda.synchronize()
    (yb,), _ = K.fused_tracking_sweep_grouped_plain([y], [nu], [x],
                                                    rows[0.5], lead=1)
    hold("y'", yo, yr, {"step skipped": y, "beta / 2": yb})
    if kept is not nu:
        raise AssertionError("tracking at the LM head: ungated g_kept is "
                             "not g_new")
    del yo, yr, yb, kept
    # the same leaf under the async learner's gate: a (1, 2) mask of
    # downweight values, client 0 at 0.5 (live: the kernels gate on
    # mask > 0, so it takes the full step) and client 1 at 0 (frozen).
    # The live row is held as above, with the same controls; the frozen
    # row of x', nu', y' and g_kept must be the inputs bit for bit, and the
    # live row of g_kept g_new bit for bit.
    gate = torch.tensor([[0.5, 0.0]], device="cuda")
    live, frozen = slice(0, 1), slice(1, 2)

    def frozen_equal(name, out, inp):
        if not bits_equal(out[frozen], inp[frozen]):
            raise AssertionError(f"gated {name} at the LM head: the frozen "
                                 "row changed")

    (xo,), (nuo,) = K.fused_update_sweep_grouped([x], [y], [nu], rows[1.0],
                                                 gate, kind="l1", lead=1)
    (xr,), (nur,) = K.fused_update_sweep_grouped_plain(
        [x], [y], [nu], rows[1.0], gate, kind="l1", lead=1)
    torch.cuda.synchronize()
    (xa,), _ = K.fused_update_sweep_grouped_plain([x], [y], [nu], rows[0.5],
                                                  gate, kind="l1", lead=1)
    hold("gated x'", xo, xr, {"step skipped": x, "alpha / 2": xa}, live)
    hold("gated nu'", nuo, nur, {"step skipped": nu}, live)
    frozen_equal("x'", xo, x)
    frozen_equal("nu'", nuo, nu)
    del xo, nuo, xr, nur, xa
    (yo,), (kept,) = K.fused_tracking_sweep_grouped([y], [nu], [x], rows[1.0],
                                                    gate, lead=1)
    (yr,), _ = K.fused_tracking_sweep_grouped_plain([y], [nu], [x],
                                                    rows[1.0], gate, lead=1)
    torch.cuda.synchronize()
    (yb,), _ = K.fused_tracking_sweep_grouped_plain([y], [nu], [x],
                                                    rows[0.5], gate, lead=1)
    hold("gated y'", yo, yr, {"step skipped": y, "beta / 2": yb}, live)
    frozen_equal("y'", yo, y)
    frozen_equal("g_kept", kept, x)
    if not bits_equal(kept[live], nu[live]):
        raise AssertionError("gated tracking at the LM head: the live row "
                             "of g_kept is not g_new")
    del yo, yr, yb, kept, x, y, nu
    torch.cuda.empty_cache()
    routes = _check_routes()
    return {"phase": "check", "cases": cases, "grouped_cases": grouped_cases,
            "lm_head_case": list(head), "lm_head_gate": gate.tolist(),
            "lm_head_ulps": head_ulps,
            "lm_head_controls_missed": head_controls,
            "lm_head_ulps_limit": BF16_HEAD_ULPS, "routes": routes,
            "max_abs_err": worst, "atol": ATOL, "rtol": RTOL,
            "bf16_atol": BF16_ATOL, "bf16_rtol": BF16_RTOL}


def _check_routes() -> dict:
    """Both routes of the sweep pair (16-byte vectors; element by element
    for ragged rows and misaligned views) over ``kernel.ROUTE_LEAVES``,
    one config's 2 clients (lead 1) under each of ``kernel.ROUTE_GATES``,
    against the plain versions: bf16 live rows within ``BF16_HEAD_ULPS``
    (the worst printed: both round the same fp32 result once, so 0 is
    expected), fp32 bit for bit, frozen rows bit for bit the inputs,
    g_kept's live rows g_new; one launch of each kernel a dtype a call.  Which route each leaf took is the
    host's vec flag (``leaf_tables``), printed per leaf."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    g = torch.Generator(device="cuda").manual_seed(41)
    trees = []
    for scale in (0.02, 1.0, 1.0, 1.0):   # x at the weights' scale
        leaves = []
        for d, dtype, k in K.ROUTE_LEAVES:
            view = torch.empty(2 * d + k, dtype=dtype, device="cuda")[k:]
            view = view.view(2, d)
            view.copy_(torch.randn((2, d), generator=g, device="cuda")
                       * scale)
            leaves.append(view)
        trees.append(leaves)
    x, y, nu, go = trees
    row = K.sweep_params_table(lam=1e-5, theta=4.0, alpha=0.02, gamma=0.8,
                               beta=1.0, device="cuda")
    ptrs = [(a.data_ptr(), b.data_ptr(), c.data_ptr(), 0, 0)
            for a, b, c in zip(x, y, nu)]
    words, _ = K.leaf_tables(2, [d for d, _, _ in K.ROUTE_LEAVES],
                             [dt for _, dt, _ in K.ROUTE_LEAVES], ptrs)
    # the table lists the bf16 group first (the first leaf's dtype)
    order = sorted(K.ROUTE_LEAVES, key=lambda r: r[1] != torch.bfloat16)
    vec = {f"{d} {str(dt)[6:]} +{k}": v for (d, dt, k), v in zip(
        order, words[K.LEAF_WORDS - 1::K.LEAF_WORDS])}
    for dt in ("bfloat16", "float32"):
        if {v for key, v in vec.items() if dt in key} != {0, 1}:
            raise AssertionError(f"routes: {dt} leaves do not take both "
                                 f"routes: {vec}")
    ulps = {"fused_update_sweep": 0, "fused_tracking_sweep": 0}
    cases = 0

    def held(name, outs, refs, ins, live):
        for o, r, i in zip(outs, refs, ins):
            if o.shape != i.shape or o.dtype != i.dtype:
                raise AssertionError(f"routes {name}: {tuple(o.shape)} "
                                     f"{o.dtype} for {tuple(i.shape)}")
            if not bits_equal(o[~live], i[~live]):
                raise AssertionError(f"routes {name}: a frozen row changed")
            if not live.any():
                continue
            if o.dtype == torch.float32:
                if not bits_equal(o[live], r[live]):
                    raise AssertionError(f"routes {name}: fp32 not "
                                         "bit-equal to plain")
                continue
            u = int(bf16_ulps(o[live], r[live]).max())
            ulps[name] = max(ulps[name], u)
            if u > BF16_HEAD_ULPS:
                raise AssertionError(f"routes {name}: {u} bf16 ulps from "
                                     "plain")

    for label, m in K.ROUTE_GATES.items():
        mask = None if m is None else torch.tensor([m], device="cuda")
        live = (torch.ones(2, dtype=torch.bool, device="cuda")
                if m is None else mask[0] > 0)
        for kind in ("l1", "mcp", "scad"):
            before = read_counts()
            out = K.fused_update_sweep_grouped(x, y, nu, row, mask,
                                               kind=kind, lead=1)
            expect_counts(f"routes {label}", read_counts(), {
                **before, "fused_update_sweep":
                    before["fused_update_sweep"] + 2})
            ref = K.fused_update_sweep_grouped_plain(x, y, nu, row, mask,
                                                     kind=kind, lead=1)
            torch.cuda.synchronize()
            held("fused_update_sweep", out[0], ref[0], x, live)
            held("fused_update_sweep", out[1], ref[1], nu, live)
            cases += 1
        before = read_counts()
        ys, kept = K.fused_tracking_sweep_grouped(y, nu, go, row, mask,
                                                  lead=1)
        expect_counts(f"routes {label}", read_counts(), {
            **before, "fused_tracking_sweep":
                before["fused_tracking_sweep"] + 2})
        ref_ys, _ = K.fused_tracking_sweep_grouped_plain(y, nu, go, row,
                                                         mask, lead=1)
        torch.cuda.synchronize()
        held("fused_tracking_sweep", ys, ref_ys, y, live)
        for k, gn, g_old in zip(kept, nu, go):
            if mask is None and k is not gn:
                raise AssertionError("routes: ungated g_kept is not g_new")
            if mask is not None and not (bits_equal(k[live], gn[live])
                                         and bits_equal(k[~live],
                                                        g_old[~live])):
                raise AssertionError(f"routes {label}: g_kept is not "
                                     "g_new live, g_old frozen")
        cases += 1
    del x, y, nu, go, trees
    torch.cuda.empty_cache()
    return {"cases": cases, "gates": K.ROUTE_GATES, "vec_by_leaf": vec,
            "bf16_max_ulps": ulps, "bf16_ulps_limit": BF16_HEAD_ULPS}


def phase_check_prox() -> dict:
    """prox_cuda and fused_update_cuda against their plain versions."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    g = torch.Generator(device="cuda").manual_seed(17)
    hp = dict(lam=1e-3, theta=4.0, alpha=0.1)
    worst = {"prox": 0.0, "fused_update": 0.0}
    cases = 0
    for shape, dtype in (((1001,), torch.float32), ((64, 130), torch.float32),
                         ((), torch.float32), ((3, 333), torch.bfloat16)):
        x, y, nu = ((torch.randn(shape, generator=g, device="cuda") * 0.01)
                    .to(dtype) for _ in range(3))
        for kind in ("l1", "mcp", "scad"):
            pairs = {"prox": ((K.prox_cuda(x, kind=kind, **hp),),
                              (K.prox_plain(x, kind=kind, **hp),)),
                     "fused_update": (
                         K.fused_update_cuda(x, y, nu, kind=kind, gamma=0.8,
                                             **hp),
                         K.fused_update_plain(x, y, nu, kind=kind, gamma=0.8,
                                              **hp))}
            torch.cuda.synchronize()
            for name, (outs, refs) in pairs.items():
                for out, ref in zip(outs, refs):
                    atol, rtol = ((ATOL, RTOL) if dtype == torch.float32
                                  else (BF16_ATOL, BF16_RTOL))
                    torch.testing.assert_close(
                        out, ref, atol=atol, rtol=rtol,
                        msg=lambda m: f"{name} {kind} {shape}: {m}")
                    if dtype == torch.float32:
                        worst[name] = max(worst[name], float(
                            (out - ref).abs().max()))
            cases += 1
    return {"phase": "check_prox", "cases": cases, "max_abs_err": worst,
            "atol": ATOL, "rtol": RTOL}


def phase_check_flash() -> dict:
    """flash_attention_cuda against flash_attention_plain over dtypes, head
    dims, GQA groups, masks and lengths (B = 2, 8 query heads); a head dim
    its dtype's kernel is not instantiated for (fp32 32, 80, 96; bf16 32)
    through the head-dim route, each such launch counted under
    ``flash_fwd_padded`` too, and bf16 D 80 / 96 never; and ``Lq != Lk`` at
    D 64, 80 and 96 (``FLASH_CROSS_PAIRS``), non-causal and causal; and
    the training forward and backward at each ``TRAIN_DV_PAIRS`` (D 192,
    DV 128), and at the deepseek-v2-lite cell's attention
    (``FLASH_MLA_SHAPE``, its softmax scale), against the plain pair
    within ``FLASH_BWD_REL``."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as F
    g = torch.Generator(device="cuda").manual_seed(23)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = {"cases": 0, "padded": 0, "cross": 0}
    H = 8

    def held(q32, k32, v32, label, masks):
        D = q32.shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            route_pad = D not in F.HEAD_DIMS[dtype]
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            name = str(dtype).split(".")[-1]
            for causal, window in masks:
                before = read_counts()
                out = F.flash_attention_cuda(q, k, v, causal=causal,
                                             window=window)
                route = ("flash_attention" if dtype == torch.bfloat16
                         else "flash_attention_fp32")
                pad = "flash_fwd_padded"
                expect_counts(f"flash {label} {name}", read_counts(),
                              {**before, route: before[route] + 1,
                               pad: before[pad] + route_pad})
                ref = F.flash_attention_plain(q, k, v, causal=causal,
                                              window=window)
                torch.cuda.synchronize()
                tol = FLASH_TOL[name]
                torch.testing.assert_close(
                    out, ref, atol=tol, rtol=tol,
                    msg=lambda m: (f"flash {label} {name} causal={causal} "
                                   f"window={window}: {m}"))
                worst[name] = max(worst[name], float(
                    (out.float() - ref.float()).abs().max()))
                n["cases"] += 1
                n["padded"] += route_pad

    for D in (64, 80, 96, 128, 256, 32):
        # the full sweep at every head dim of the tensor-core kernel
        route_pad = D not in F.HEAD_DIMS[torch.bfloat16]
        for group in ((1, 8) if route_pad else (1, 2, 8)):
            for L in ((17, 200, 1024) if route_pad else (1, 17, 200, 1024)):
                q32 = torch.randn((2, L, H, D), generator=g, device="cuda")
                k32, v32 = (torch.randn((2, L, H // group, D), generator=g,
                                        device="cuda") for _ in range(2))
                held(q32, k32, v32, f"D={D} group={group} L={L}",
                     ((True, 0), (True, 128), (False, 0)))
    before = n["cases"]
    cross = [(D, Lq, Lk, group) for D in (64, 80, 96)
             for Lq, Lk in FLASH_CROSS_PAIRS for group in (1, 2)]
    for D, Lq, Lk, group in cross:
        q32 = torch.randn((2, Lq, H, D), generator=g, device="cuda")
        k32, v32 = (torch.randn((2, Lk, H // group, D), generator=g,
                                device="cuda") for _ in range(2))
        held(q32, k32, v32, f"D={D} group={group} Lq={Lq} Lk={Lk}",
             ((False, 0), (True, 0)))
    n["cross"] = n["cases"] - before
    # the training kernels where v's head dim differs (multi-head latent
    # attention's 192 / 128): forward with lse and backward against the
    # plain pair at an explicit scale, within FLASH_BWD_REL
    dv_worst = 0.0
    for D, DV in F.TRAIN_DV_PAIRS:
        for group in (1, 2):
            # not L 1: one visible key gives dS = 0 but for rounding, so dq
            # and dk are rounding alone there
            for L in (17, 200, 1024):
                q, k = (torch.randn((2, L, H // (group if i else 1), D),
                                    generator=g, device="cuda").bfloat16()
                        for i in range(2))
                v = torch.randn((2, L, H // group, DV), generator=g,
                                device="cuda").bfloat16()
                do = torch.randn((2, L, H, DV), generator=g,
                                 device="cuda").bfloat16()
                for causal, window in ((True, 0), (True, 128), (False, 0)):
                    scale = 1.5896 / math.sqrt(D)
                    o, lse = F.flash_attention_fwd_train_cuda(
                        q, k, v, causal=causal, window=window, scale=scale)
                    got = (o, *F.flash_attention_bwd_cuda(
                        q, k, v, o, lse, do, causal=causal, window=window,
                        scale=scale))
                    po, plse = F.flash_attention_plain(
                        q, k, v, causal=causal, window=window, scale=scale,
                        return_lse=True)
                    want = (po, *F.flash_attention_bwd_plain(
                        q, k, v, po, plse, do, causal=causal, window=window,
                        scale=scale))
                    for a, b in zip(got, want):
                        rel = float((a.float() - b.float()).norm()
                                    / b.float().norm().clamp_min(1e-30))
                        if rel > FLASH_BWD_REL:
                            raise AssertionError(
                                f"flash D={D} DV={DV} group={group} L={L} "
                                f"causal={causal} window={window}: relative "
                                f"L2 {rel}")
                        dv_worst = max(dv_worst, rel)
                    n["cases"] += 1
    # the same at the deepseek-v2-lite cell's attention and scale
    B, L, Hm, D, DV = FLASH_MLA_SHAPE
    scale = _mla_config().softmax_scale
    q, k = (torch.randn((B, L, Hm, D), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    v, do = (torch.randn((B, L, Hm, DV), generator=g, device="cuda").bfloat16()
             for _ in range(2))
    o, lse = F.flash_attention_fwd_train_cuda(q, k, v, causal=True,
                                              scale=scale)
    got = (o, *F.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True,
                                          scale=scale))
    po, plse = F.flash_attention_plain(q, k, v, causal=True, scale=scale,
                                       return_lse=True)
    want = (po, *F.flash_attention_bwd_plain(q, k, v, po, plse, do,
                                             causal=True, scale=scale))
    mla_rel = {}
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        mla_rel[name] = float((a.float() - b.float()).norm()
                              / b.float().norm().clamp_min(1e-30))
        if mla_rel[name] > FLASH_BWD_REL:
            raise AssertionError(f"flash at the MLA cell's shape {name}: "
                                 f"relative L2 {mla_rel[name]}")
    n["cases"] += 1
    del q, k, v, do, o, lse, got, po, plse, want
    torch.cuda.empty_cache()
    return {"phase": "check_flash", "cases": n["cases"],
            "padded_cases": n["padded"], "cross_cases": n["cross"],
            "max_abs_err": worst, "tol": FLASH_TOL,
            "dv_pairs_max_rel_l2": dv_worst, "mla_cell_rel_l2": mla_rel,
            "launches": read_counts()}


def phase_main_path():
    import torch
    from repro_torch.convert import state_to_numpy
    from repro_torch.quickstart import mlp_config, run_depositum

    cfg = mlp_config(ROUNDS, fused="require")
    reset_counts()
    state, curves = run_depositum(cfg, metrics_every=ROUNDS, device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    want = ROUNDS * cfg.depositum.comm_period      # one launch a step
    expect_counts("depositum path", launches, {"fused_update_sweep": want,
                                               "fused_tracking_sweep": want})

    off_cfg = mlp_config(ROUNDS, fused="off")
    reset_counts()
    ref_state, ref_curves = run_depositum(off_cfg, metrics_every=ROUNDS,
                                          device="cuda")
    torch.cuda.synchronize()
    expect_counts("fused='off'", read_counts(), {})
    for f in ("x", "y", "nu", "g"):
        for k, v in getattr(state, f).items():
            if v.shape != getattr(ref_state, f)[k].shape \
                    or not torch.isfinite(v).all():
                raise AssertionError(f"state.{f}[{k}] bad shape or values")
    # one round: the two paths do the same fp32 operations per step
    one = {m: run_depositum(mlp_config(1, fused=m), collect_metrics=False,
                            device="cuda")[0] for m in ("require", "off")}
    one_diff = _state_diff(one["require"], one["off"])
    _assert_states_close(one["require"], one["off"], STEP_ATOL, STEP_RTOL)
    # ROUNDS rounds: the model by relative norm, the metrics relatively
    rel = _rel_l2(state, ref_state)
    if max(rel["x"].values()) > STATE_REL:
        raise AssertionError(f"fused vs unfused x drifted: {rel['x']}")
    for key, tol in (("loss", LOSS_RTOL), ("stationarity", STAT_RTOL)):
        a, b = curves[key][-1], ref_curves[key][-1]
        if not abs(a - b) <= tol * abs(b):
            raise AssertionError(f"fused vs unfused {key}: {a} vs {b}")
    again, _ = run_depositum(cfg, collect_metrics=False, device="cuda")
    drift = {"fused_vs_unfused_max_abs": _state_diff(state, ref_state),
             "fused_vs_unfused_rel_l2": rel,
             "fused_rerun_max_abs": _state_diff(state, again),
             "one_round_fused_vs_unfused_max_abs": one_diff}
    s = curves["stationarity"]
    if not (s[-1] < s[0]):
        raise AssertionError(f"stationarity did not fall: {s}")
    n_params = sum(v[0].numel() for v in state.x.values())
    assert state_to_numpy(state)["t"] == ROUNDS * cfg.depositum.comm_period
    return state, launches, {
        "phase": "main_path", "rounds": ROUNDS,
        "clients": cfg.n_clients, "params_per_client": n_params,
        "launches": launches, "want_launches": want,
        "stationarity_round1": s[0], "stationarity_last": s[-1],
        "accuracy_last": curves["accuracy"][-1],
        "loss_last": curves["loss"][-1],
        "ref_stationarity_last": ref_curves["stationarity"][-1],
        "loss_last_unfused": ref_curves["loss"][-1],
        **drift, "step_atol": STEP_ATOL, "step_rtol": STEP_RTOL,
        "state_rel": STATE_REL, "loss_rtol": LOSS_RTOL,
        "stationarity_rtol": STAT_RTOL}


def phase_tree_path(state) -> tuple[dict, dict]:
    """ops.prox_tree / ops.fused_update_tree over the DEPOSITUM run's final
    model (six (10, ...) leaves) with the Fig. 4 hyperparameters."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.kernels.prox import ops
    hp = dict(kind="mcp", lam=1e-4, alpha=0.05, theta=4.0)
    reset_counts()
    px = ops.prox_tree(state.x, **hp)
    ux, unu = ops.fused_update_tree(state.x, state.y, state.nu, gamma=0.8,
                                    **hp)
    torch.cuda.synchronize()
    launches = read_counts()
    # one grouped launch for the six leaves, each
    expect_counts("prox tree path", launches,
                  {"prox": 1, "fused_update": 1})
    worst = {"prox": 0.0, "fused_update": 0.0}
    for k in state.x:
        rp = K.prox_plain(state.x[k], **hp)
        rx, rn = K.fused_update_plain(state.x[k], state.y[k], state.nu[k],
                                      gamma=0.8, **hp)
        for name, out, ref in (("prox", px[k], rp),
                               ("fused_update", ux[k], rx),
                               ("fused_update", unu[k], rn)):
            if not bits_equal(out, ref):
                raise AssertionError(f"tree path {name} {k}: not bit-equal "
                                     "to plain")
            worst[name] = max(worst[name], float((out - ref).abs().max()))
    shapes = {k: list(v.shape) for k, v in state.x.items()}
    return launches, {"phase": "tree_path", "leaf_shapes": shapes,
                      "launches": launches, "max_abs_err": worst}


def phase_serve() -> tuple[dict, dict]:
    """Full-width qwen3-1.7b through BatchedServer (prefill + greedy decode)."""
    import torch
    import repro_torch.models.attention as attention_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.models import build_model
    from repro_torch.models.common import pad_vocab
    from repro_torch.serving import BatchedServer, ServeConfig

    cfg = get_config(SERVE["arch"])
    B, Lp, new = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params, _ = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=gen,
                            device="cuda")
    srv = BatchedServer(model, params, ServeConfig(
        max_new_tokens=new, cache_capacity=SERVE["cache"]))
    with torch.inference_mode():
        srv.prefill(prompts)               # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    toks = srv.generate(prompts)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_counts("served path", launches, {"flash_attention": cfg.n_layers})
    if toks.shape != (B, new) or not bool(
            ((toks >= 0) & (toks < pad_vocab(cfg.vocab_size))).all()):
        raise AssertionError(f"served tokens bad: {tuple(toks.shape)}")

    with torch.inference_mode():
        logits, cache = srv.prefill(prompts)
        prefill_ms = time_ms(lambda: srv.prefill(prompts), iters=5, warmup=1)
        step_logits, step_toks = [], []

        # decode writes its keys in place at slots Lp.. of the prefill's
        # cache; a repeat writes the same values, and slots past a step's
        # position are masked, so each repeat decodes the same tokens
        def decode_all():
            lg, c = logits, cache
            step_logits.clear()
            step_toks.clear()
            for _ in range(new - 1):
                nxt = torch.argmax(lg[:, -1].float(), dim=-1)
                lg, c = model.forward_decode(params, {"tokens": nxt[:, None]},
                                             c)
                step_logits.append(lg)
                step_toks.append(nxt)
        decode_ms = time_ms(decode_all, iters=3, warmup=1) / (new - 1)
        finite = bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(lg).all()) for lg in step_logits)
        if not finite:
            raise AssertionError("served logits are not all finite")
        if not torch.equal(torch.stack(step_toks, 1), toks[:, :new - 1]):
            raise AssertionError("the timed decode loop and generate() chose "
                                 "different tokens")
        # the same prefill with the plain attention swapped in
        swapped = attention_mod.flash_attention
        attention_mod.flash_attention = F.flash_attention_plain
        try:
            plain_logits, _ = srv.prefill(prompts)
        finally:
            attention_mod.flash_attention = swapped
        torch.cuda.synchronize()
    diff = (logits.float() - plain_logits.float()).abs()
    torch.testing.assert_close(logits.float(), plain_logits.float(),
                               atol=SERVE_LOGIT_ATOL, rtol=SERVE_LOGIT_RTOL,
                               msg=lambda m: f"prefill flash vs plain: {m}")
    top1 = float((logits.argmax(-1) == plain_logits.argmax(-1))
                 .float().mean())
    return launches, {
        "phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
        "params": n_params, "dtype": cfg.dtype, "batch": B,
        "prompt_len": Lp, "new_tokens": new, "cache": SERVE["cache"],
        "init_s": init_s, "launches": launches,
        "generate_s": generate_s, "tokens_per_s": B * new / generate_s,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "max_memory_allocated_gb": peak_gb,
        "prefill_flash_vs_plain_max_abs": float(diff.max()),
        "prefill_logits_max_abs": float(logits.float().abs().max()),
        "prefill_top1_agreement": top1,
        "logit_atol": SERVE_LOGIT_ATOL, "logit_rtol": SERVE_LOGIT_RTOL,
        "sample": toks[0, :8].tolist()}


def _teacher_forced_logits(model, params, prompts, toks, cap):
    """Prefill logits, then the decode logits fed ``toks`` one at a time."""
    import torch
    with torch.inference_mode():
        lg, cache = model.forward_prefill(params, {"tokens": prompts}, cap)
        out = [lg]
        for t in range(toks.shape[1] - 1):
            lg, cache = model.forward_decode(
                params, {"tokens": toks[:, t:t + 1]}, cache)
            out.append(lg)
    return torch.cat(out, dim=1)


def phase_card_vs_cpu() -> dict:
    """Reduced qwen3 and starcoder2 in fp32, the same weights on the card
    and on the CPU: identical greedy tokens, logits within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import BatchedServer, ServeConfig
    out = {}
    for arch, cap in (("qwen3-1.7b", 128), ("starcoder2-7b", 64)):
        cfg = get_config(arch, reduced=True)
        prompts = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 80)))
        params, _ = build_model(cfg, device="cpu").init(seed=3)
        toks, logits = {}, {}
        reset_counts()
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            p = params.to(dev)
            toks[dev] = BatchedServer(model, p, ServeConfig(
                max_new_tokens=8, cache_capacity=cap)).generate(prompts).cpu()
            logits[dev] = _teacher_forced_logits(
                model, p, prompts.to(dev), toks[dev].to(dev), cap).cpu()
        launches = read_counts()
        expect_counts(f"{arch} card vs cpu", launches,
                      {"flash_attention_fp32": 2 * cfg.n_layers})
        if not torch.equal(toks["cpu"], toks["cuda"]):
            raise AssertionError(f"{arch}: greedy tokens differ card vs cpu: "
                                 f"{toks['cuda'].tolist()} vs "
                                 f"{toks['cpu'].tolist()}")
        torch.testing.assert_close(logits["cuda"], logits["cpu"],
                                   atol=CPU_ATOL, rtol=CPU_RTOL,
                                   msg=lambda m: f"{arch} logits: {m}")
        out[arch] = {"prompt": list(prompts.shape), "cache": cap,
                     "window": cfg.sliding_window, "launches": launches,
                     "tokens": toks["cuda"][0].tolist(),
                     "max_abs_logit_diff": float(
                         (logits["cuda"] - logits["cpu"]).abs().max())}
    return {"phase": "card_vs_cpu", "atol": CPU_ATOL, "rtol": CPU_RTOL, **out}


def _attention_layers(cfg) -> int:
    """Flash launches a prefill makes: one a transformer layer, one a
    hybrid group's shared block, none for the attention-free SSM."""
    from repro_torch.models.hybrid import group_shape
    if cfg.family == "ssm":
        return 0
    return group_shape(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers


def _zoo_want(cfg, prefills: int, route: str) -> dict:
    """Launch counts of ``prefills`` prefills of ``cfg`` on the card through
    ``route`` ("flash_attention": bf16, "flash_attention_fp32": fp32)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as F
    dtype = torch.bfloat16 if route == "flash_attention" else torch.float32
    n = prefills * _attention_layers(cfg)
    return {route: n,
            "flash_fwd_padded": 0 if cfg.hd in F.HEAD_DIMS[dtype] else n}


def _zoo_extra(cfg, batch: int, gen, device):
    """A VLM's stub vision embeds drawn from ``gen``; None otherwise."""
    import torch
    if cfg.family != "vlm":
        return None
    return {"vision_embeds": torch.randn(
        (batch, cfg.n_vision_tokens, cfg.d_model), generator=gen,
        device=device).to(cfg.torch_dtype)}


def _serve_one(arch: str) -> tuple[dict, dict]:
    """One zoo architecture at full width through BatchedServer; returns
    (its launches, its line)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import pad_vocab
    from repro_torch.serve_drift import prefill_drift
    from repro_torch.serving import BatchedServer, ServeConfig

    cfg = get_config(arch)
    if arch in ZOO_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=ZOO_DEPTH[arch])
    B, Lp, new = ZOO_SERVE["batch"], ZOO_SERVE["prompt"], ZOO_SERVE["new"]
    cache_slots = ZOO_CACHE.get(arch, ZOO_SERVE["cache"])
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params, _ = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=gen,
                            device="cuda")
    extra = _zoo_extra(cfg, B, gen, "cuda")
    srv = BatchedServer(model, params, ServeConfig(
        max_new_tokens=new, cache_capacity=cache_slots))
    with torch.inference_mode():
        srv.prefill(prompts, extra)         # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    toks = srv.generate(prompts, extra)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_counts(f"serve_zoo {arch}", launches,
                  _zoo_want(cfg, 1, "flash_attention"))
    if toks.shape != (B, new) or not bool(
            ((toks >= 0) & (toks < pad_vocab(cfg.vocab_size))).all()):
        raise AssertionError(f"{arch}: served tokens bad: "
                             f"{tuple(toks.shape)}")

    line = {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
            "head_dim": cfg.hd if cfg.n_heads else None, "params": n_params,
            "dtype": cfg.dtype, "batch": B, "prompt_len": Lp,
            "prefill_len": Lp + (cfg.n_vision_tokens if extra else 0),
            "new_tokens": new, "cache": cache_slots, "init_s": init_s,
            "launches": launches, "generate_s": generate_s,
            "tokens_per_s": B * new / generate_s,
            "max_memory_allocated_gb": peak_gb}
    with torch.inference_mode():
        logits, cache = srv.prefill(prompts, extra)
        line["prefill_ms"] = time_ms(lambda: srv.prefill(prompts, extra),
                                     iters=3, warmup=0)
        step_toks = []

        def decode_all():
            lg, c = logits, cache
            step_toks.clear()
            for _ in range(new - 1):
                nxt = torch.argmax(lg[:, -1].float(), dim=-1)
                lg, c = model.forward_decode(params, {"tokens": nxt[:, None]},
                                             c)
                if not bool(torch.isfinite(lg).all()):
                    raise AssertionError(f"{arch}: decode logits not finite")
                step_toks.append(nxt)
        line["decode_ms_per_token"] = time_ms(decode_all, iters=1,
                                              warmup=0) / (new - 1)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: prefill logits not finite")
        if not torch.equal(torch.stack(step_toks, 1), toks[:, :new - 1]):
            raise AssertionError(f"{arch}: the timed decode loop and "
                                 "generate() chose different tokens")
        if cfg.family != "ssm":
            # every flash call of a prefill held against the plain version
            # on its inputs; the end-to-end logit drift measured, not gated
            drift = prefill_drift(srv, prompts, extra,
                                  call_tol=FLASH_TOL["bfloat16"],
                                  logit_tol=(SERVE_LOGIT_ATOL,
                                             SERVE_LOGIT_RTOL))
            if drift["flash_calls"] != _attention_layers(cfg):
                raise AssertionError(f"{arch}: {drift['flash_calls']} flash "
                                     "calls held, want "
                                     f"{_attention_layers(cfg)}")
            line.update(flash_call_tol=FLASH_TOL["bfloat16"], **drift)
    line["prefill_logits_max_abs"] = float(logits.float().abs().max())
    line["sample"] = toks[0, :8].tolist()
    del srv, params, model, logits, cache, extra
    torch.cuda.empty_cache()
    return launches, line


def phase_serve_zoo() -> tuple[dict, dict]:
    """The zoo's decoder families at full width, one at a time, each freed
    before the next; returns (launches summed over them, the line)."""
    total, lines = {}, {}
    for arch in ZOO_ARCHS:
        launches, line = _serve_one(arch)
        lines[arch] = line
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total, {"phase": "serve_zoo", "launches": total,
                   "logit_atol": SERVE_LOGIT_ATOL,
                   "logit_rtol": SERVE_LOGIT_RTOL, **lines}


def phase_serve_encdec() -> tuple[dict, dict]:
    """Full-width seamless-m4t-medium (bf16): the prefill step, then
    ``BatchedServer`` token by token against its memory; every flash call
    of the prefill step and of one decode step held against the plain
    version; then the reduced config in fp32 on the card against the CPU
    (:func:`_encdec_card_vs_cpu`).  Returns (launches of both, the line)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.common import pad_vocab
    from repro_torch.serve_drift import flash_drift
    from repro_torch.serving import BatchedServer, ServeConfig

    cfg = get_config(ENCDEC_SERVE["arch"])
    B, S, Lp, new, cap = (ENCDEC_SERVE[k] for k in ("batch", "frames",
                                                    "prompt", "new", "cache"))
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params, _ = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn((B, S, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.torch_dtype)
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=gen,
                            device="cuda")
    batch = {"frames": frames, "tokens": prompts}
    step = build_prefill_step(model, cap)
    srv = BatchedServer(model, params, ServeConfig(max_new_tokens=new,
                                                   cache_capacity=cap))
    step(params, batch)                  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, memory = step(params, batch)
    prefill_launches = read_counts()
    want_prefill = n_enc + 2 * n_dec
    want_decode = n_dec * (Lp + new - 1)
    expect_counts("serve_encdec prefill step", prefill_launches,
                  {"flash_attention": want_prefill})
    toks = srv.generate(prompts, extra={"memory": memory})
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_counts("serve_encdec", launches,
                  {"flash_attention": want_prefill + want_decode})
    if toks.shape != (B, new) or not bool(
            ((toks >= 0) & (toks < pad_vocab(cfg.vocab_size))).all()):
        raise AssertionError(f"enc-dec served tokens bad: "
                             f"{tuple(toks.shape)}")
    if memory.shape != (B, S, cfg.d_model) or not (
            bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(memory).all())):
        raise AssertionError("enc-dec prefill step: memory shape "
                             f"{tuple(memory.shape)} or values not finite")

    line = {"arch": cfg.name, "family": cfg.family,
            "layers": [n_enc, n_dec], "head_dim": cfg.hd,
            "params": n_params, "dtype": cfg.dtype, "batch": B, "frames": S,
            "prompt_len": Lp, "new_tokens": new, "cache": cap,
            "init_s": init_s, "launches": launches,
            "prefill_step_launches": prefill_launches["flash_attention"],
            "decode_launches": launches["flash_attention"]
            - prefill_launches["flash_attention"],
            "serve_s": serve_s, "tokens_per_s": B * new / serve_s,
            "max_memory_allocated_gb": peak_gb}
    extra = {"memory": memory}
    with torch.inference_mode():
        line["prefill_ms"] = time_ms(lambda: step(params, batch), iters=3,
                                     warmup=1)
        # the prompt token by token, as generate() feeds it
        srv_logits, cache = srv.prefill(prompts, extra)
        line["prompt_ms_per_token"] = time_ms(
            lambda: srv.prefill(prompts, extra), iters=1, warmup=0) / Lp
        step_toks = []

        # decode writes its keys in place at slots Lp.. of the prompt's
        # cache; a repeat writes the same values
        def decode_all():
            lg, c = srv_logits, cache
            step_toks.clear()
            for _ in range(new - 1):
                nxt = torch.argmax(lg[:, -1].float(), dim=-1)
                lg, c = model.forward_decode(params, {"tokens": nxt[:, None]},
                                             c)
                if not bool(torch.isfinite(lg).all()):
                    raise AssertionError("enc-dec decode logits not finite")
                step_toks.append(nxt)
        line["decode_ms_per_token"] = time_ms(decode_all, iters=1,
                                              warmup=0) / (new - 1)
        if not torch.equal(torch.stack(step_toks, 1), toks[:, :new - 1]):
            raise AssertionError("enc-dec: the timed decode loop and "
                                 "generate() chose different tokens")
        # every flash call held against the plain version on its inputs:
        # the prefill step's, then one decode step's; the logits' drift
        # printed, not gated
        tol = FLASH_TOL["bfloat16"]
        logit_tol = (SERVE_LOGIT_ATOL, SERVE_LOGIT_RTOL)
        drift = flash_drift(lambda: step(params, batch)[0], call_tol=tol,
                            logit_tol=logit_tol)
        nxt = toks[:, :1]
        decode_drift = flash_drift(
            lambda: model.forward_decode(params, {"tokens": nxt}, cache)[0],
            call_tol=tol, logit_tol=logit_tol)
        if (drift["flash_calls"], decode_drift["flash_calls"]) != (
                want_prefill, n_dec):
            raise AssertionError(f"enc-dec: {drift['flash_calls']} + "
                                 f"{decode_drift['flash_calls']} flash calls "
                                 f"held, want {want_prefill} + {n_dec}")
    # the server's logits after its last prompt token against the prefill
    # step's (causal flash in the step, the plain ring-cache decode in the
    # server): printed, not gated
    diff = (srv_logits.float() - logits.float()).abs()
    line.update(
        flash_call_tol=tol, prefill_step_drift=drift,
        decode_step_drift=decode_drift,
        server_vs_prefill_step_max_abs=float(diff.max()),
        server_vs_prefill_step_top1=float(
            (srv_logits.argmax(-1) == logits.argmax(-1)).float().mean()),
        prefill_logits_max_abs=float(logits.float().abs().max()),
        sample=toks[0, :8].tolist())
    del srv, params, model, logits, memory, cache, extra, srv_logits, step
    torch.cuda.empty_cache()
    cpu_launches, line["card_vs_cpu"] = _encdec_card_vs_cpu()
    total = {k: n + cpu_launches[k] for k, n in launches.items()}
    return total, {"phase": "serve_encdec", **line, "launches": total,
                   "logit_atol": SERVE_LOGIT_ATOL,
                   "logit_rtol": SERVE_LOGIT_RTOL}


def _encdec_card_vs_cpu() -> tuple[dict, dict]:
    """The reduced enc-dec in fp32, the same weights on the card and on
    the CPU: the prefill step's logits and memory within CPU_ATOL /
    CPU_RTOL, then identical greedy tokens from each device's memory; the
    fp32 kernel launches 2 + 2 + 2 times a prefill step and 2 times a
    decode step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import build_model
    from repro_torch.serving import BatchedServer, ServeConfig
    cfg = get_config(ENCDEC_SERVE["arch"], reduced=True)
    B, S, Lp, new, cap = (ENCDEC_CPU[k] for k in ("batch", "frames",
                                                  "prompt", "new", "cache"))
    rng = np.random.default_rng(2)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)),
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, Lp)))}
    params, _ = build_model(cfg, device="cpu").init(seed=3)
    got = {}
    reset_counts()
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        p = params.to(dev)
        logits, memory = build_prefill_step(model, cap)(
            p, {k: v.to(dev) for k, v in batch.items()})
        toks = BatchedServer(model, p, ServeConfig(
            max_new_tokens=new, cache_capacity=cap)).generate(
            batch["tokens"], extra={"memory": memory})
        got[dev] = (logits.cpu(), memory.cpu(), toks.cpu())
    launches = read_counts()
    n = cfg.n_encoder_layers + 2 * cfg.n_layers + cfg.n_layers * (
        Lp + new - 1)
    expect_counts("serve_encdec card vs cpu", launches,
                  {"flash_attention_fp32": n})
    for i, what in ((0, "prefill-step logits"), (1, "memory")):
        torch.testing.assert_close(got["cuda"][i], got["cpu"][i],
                                   atol=CPU_ATOL, rtol=CPU_RTOL,
                                   msg=lambda m: f"enc-dec {what}: {m}")
    if not torch.equal(got["cuda"][2], got["cpu"][2]):
        raise AssertionError(f"enc-dec: greedy tokens differ card vs cpu: "
                             f"{got['cuda'][2].tolist()} vs "
                             f"{got['cpu'][2].tolist()}")
    return launches, {
        "batch": B, "frames": S, "prompt": Lp, "new": new, "cache": cap,
        "atol": CPU_ATOL, "rtol": CPU_RTOL, "launches": launches,
        "tokens": got["cuda"][2][0].tolist(),
        "max_abs_logit_diff": float((got["cuda"][0] - got["cpu"][0])
                                    .abs().max()),
        "max_abs_memory_diff": float((got["cuda"][1] - got["cpu"][1])
                                     .abs().max())}


def phase_zoo_card_vs_cpu() -> tuple[dict, dict]:
    """The seven new architectures reduced, fp32, the same weights on the
    card and on the CPU: identical greedy tokens, teacher-forced logits
    within CPU_ATOL / CPU_RTOL; the fp32 flash kernel counted, through the
    head-dim route at D 32."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import BatchedServer, ServeConfig
    B, Lp, new, cap = (ZOO_CPU[k] for k in ("batch", "prompt", "new",
                                            "cache"))
    out, total = {}, {}
    for arch in ZOO_CPU_ARCHS:
        cfg = get_config(arch, reduced=True)
        prompts = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, Lp)))
        extra = _zoo_extra(cfg, B, torch.Generator().manual_seed(4), "cpu")
        params, _ = build_model(cfg, device="cpu").init(seed=3)
        toks, logits = {}, {}
        reset_counts()
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            p = params.to(dev)
            ex = extra and {k: v.to(dev) for k, v in extra.items()}
            toks[dev] = BatchedServer(model, p, ServeConfig(
                max_new_tokens=new, cache_capacity=cap)).generate(
                    prompts, ex).cpu()
            with torch.inference_mode():
                batch = {"tokens": prompts.to(dev), **(ex or {})}
                lg, cache = model.forward_prefill(p, batch, cap)
                seq = [lg]
                for t in range(new - 1):
                    lg, cache = model.forward_decode(p, {
                        "tokens": toks[dev][:, t:t + 1].to(dev)}, cache)
                    seq.append(lg)
            logits[dev] = torch.cat(seq, dim=1).cpu()
        launches = read_counts()
        expect_counts(f"{arch} zoo card vs cpu", launches,
                      _zoo_want(cfg, 2, "flash_attention_fp32"))
        if not torch.equal(toks["cpu"], toks["cuda"]):
            raise AssertionError(f"{arch}: greedy tokens differ card vs cpu: "
                                 f"{toks['cuda'].tolist()} vs "
                                 f"{toks['cpu'].tolist()}")
        torch.testing.assert_close(logits["cuda"], logits["cpu"],
                                   atol=CPU_ATOL, rtol=CPU_RTOL,
                                   msg=lambda m: f"{arch} logits: {m}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        out[arch] = {"head_dim": cfg.hd if cfg.n_heads else None,
                     "launches": launches, "tokens": toks["cuda"][0].tolist(),
                     "max_abs_logit_diff": float(
                         (logits["cuda"] - logits["cpu"]).abs().max())}
    return total, {"phase": "zoo_card_vs_cpu", "prompt": [B, Lp],
                   "cache": cap, "atol": CPU_ATOL, "rtol": CPU_RTOL,
                   "launches": total, **out}


def _state_diff(a, b) -> dict:
    """Max |a - b| per state variable (0.0 means bit-equal values)."""
    return {f: max(float((v - getattr(b, f)[k]).abs().max())
                   for k, v in getattr(a, f).items())
            for f in ("x", "y", "nu", "g")}


def _rel_l2(a, b) -> dict:
    """||a - b|| / ||b|| per leaf and state variable."""
    import torch
    return {f: {k: float(torch.linalg.vector_norm(v - getattr(b, f)[k])
                         / torch.linalg.vector_norm(getattr(b, f)[k]))
                for k, v in getattr(a, f).items()}
            for f in ("x", "y", "nu", "g")}


def _assert_states_close(a, b, atol, rtol) -> None:
    import torch
    for f in ("x", "y", "nu", "g"):
        for k, v in getattr(a, f).items():
            torch.testing.assert_close(v, getattr(b, f)[k], atol=atol,
                                       rtol=rtol, msg=lambda m: f"{f}.{k}: {m}")


def _bound_ms(n_elem: int, bytes_per_elem: int, flops_per_elem: int):
    t_bytes = n_elem * bytes_per_elem / hw()["hbm_bandwidth"] * 1e3
    t_ops = n_elem * flops_per_elem / hw()["peak_flops_fp32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _time_pair(fn_kernel, fn_plain, outs_equal):
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1 = time_ms(fn_plain)
    k1 = time_ms(fn_kernel)
    k2 = time_ms(fn_kernel)
    p2 = time_ms(fn_plain)
    return min(k1, k2), min(p1, p2), outs_equal()


def _device_ms(fn, names=None, iters: int = 50):
    """Device time a call of ``fn()`` spends in the kernels whose names
    hold one of ``names`` (every kernel and copy with None), from
    ``torch.profiler``; None where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0.0)
                   or getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (names is None or any(n in e.key for n in names)))
    return us / iters / 1e3 if us > 0 else None


def phase_graph() -> dict:
    """One DEPOSITUM step's two grouped calls (``ops.fused_local_update``,
    ``ops.fused_tracking``, the Fig. 4 MLP's six (10, ...) leaves) captured
    in a CUDA graph on static inputs, ungated and gated; each replay,
    after the outputs are set to NaN and, the second time, new values are
    copied into the inputs, equals the eager calls bit for bit."""
    import torch
    from repro_torch.kernels.prox import ops
    C = 10
    g = torch.Generator(device="cuda").manual_seed(37)

    def tree():
        return {f"l{i}": torch.randn((C,) + s, generator=g, device="cuda")
                * 0.1 for i, s in enumerate(MLP_LEAVES)}

    x, y, nu, gn, go = (tree() for _ in range(5))
    hp = torch.tensor([1e-4, 4.0, 0.05, 0.8, 0.5], device="cuda")
    gate = (torch.arange(C, device="cuda") % 3 != 1).to(torch.float32)
    out = {}
    for label, mask in (("ungated", None), ("gated", gate)):
        def step():
            xo, nuo = ops.fused_local_update(x, y, nu, hp, mask, kind="mcp")
            yo, gk = ops.fused_tracking(y, gn, go, hp, mask)
            return [xo, nuo, yo, gk]

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = read_counts()
        with torch.cuda.graph(graph):
            static = step()
        after = read_counts()
        captured = {k: after[k] - before[k] for k in after}
        if captured != {**{k: 0 for k in after}, "fused_update_sweep": 1,
                        "fused_tracking_sweep": 1}:
            raise AssertionError(f"graph {label}: captured {captured}")
        written = static[:3] + ([static[3]] if mask is not None else [])
        for replay in range(2):
            if replay:
                for t in (x, y, nu, gn, go):
                    for v in t.values():
                        v.copy_(torch.randn(v.shape, generator=g,
                                            device="cuda") * 0.1)
            for t in written:
                for v in t.values():
                    v.fill_(float("nan"))
            graph.replay()
            eager = step()
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(static, eager)):
                for k in a:
                    if not bits_equal(a[k], b[k]):
                        raise AssertionError(f"graph {label}, replay "
                                             f"{replay}: output {i} {k} "
                                             "differs from the eager call")
        out[label] = {"captured_launches": captured, "replays": 2}
        del graph, static
    return {"phase": "graph", **out}


def phase_timing() -> dict:
    """Kernel vs plain times at the main path's shapes (one step: the six
    leaves, S = 1, C = 10), at the sweep path's (the same leaves for S = 4
    configs, Fig. 6) and at a bandwidth-bound shape (one leaf of
    ``BANDWIDTH_LEAF``: fp32, bf16 on the 16-byte route, and bf16 at d =
    2^20 + 3, element by element; bf16 held within ``BF16_HEAD_ULPS`` of
    the plain version, fp32 at ``ATOL`` / ``RTOL``).  Each
    sweep kernel's step is timed as one grouped launch (``ms``) and as six
    single-leaf launches (``per_leaf_ms``, the first version's route), in
    turns with the plain version (the least of four timings each); ``device_ms`` is the grouped kernel's own
    time from the profiler, ``entry_ms`` (main path) the round program's
    entry point (``ops.fused_local_update`` / ``ops.fused_tracking`` on
    dicts of (10, ...) leaves)."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.kernels.prox import ops

    out = {}
    S_, C_, d_ = BANDWIDTH_LEAF
    shapes = {"main_path_step": ([(1, 10) + s for s in MLP_LEAVES],
                                 torch.float32),
              "sweep_step": ([(4, 10) + s for s in MLP_LEAVES],
                             torch.float32),
              "bandwidth": ([BANDWIDTH_LEAF], torch.float32),
              "bandwidth_bf16": ([BANDWIDTH_LEAF], torch.bfloat16),
              "ragged_bf16": ([(S_, C_, d_ + 3)], torch.bfloat16)}
    for label, (leaf_shapes, dtype) in shapes.items():
        S = leaf_shapes[0][0]
        params = _table(S) if S <= 3 else K.sweep_params_table(
            1e-4, 4.0, 0.05, 0.8, 0.5, device="cuda").expand(S, 5).contiguous()
        g = torch.Generator(device="cuda").manual_seed(len(label))
        a, b, c = ([(torch.randn(s, generator=g, device="cuda") * 0.1).to(
            dtype) for s in leaf_shapes] for _ in range(3))
        n_elem = sum(t.numel() for t in a)
        leaves = list(zip(a, b, c))
        fns = {
            "fused_update_sweep": {
                "ms": lambda: K.fused_update_sweep_grouped(
                    a, b, c, params, kind="mcp"),
                "per_leaf_ms": lambda: tuple(zip(*(
                    K.fused_update_sweep_cuda(x, y, nu, params, kind="mcp")
                    for x, y, nu in leaves))),
                "plain_ms": lambda: K.fused_update_sweep_grouped_plain(
                    a, b, c, params, kind="mcp")},
            "fused_tracking_sweep": {
                "ms": lambda: K.fused_tracking_sweep_grouped(a, b, c, params),
                "per_leaf_ms": lambda: tuple(zip(*(
                    K.fused_tracking_sweep_cuda(y, gn, go, params)
                    for y, gn, go in leaves))),
                "plain_ms": lambda: K.fused_tracking_sweep_grouped_plain(
                    a, b, c, params)}}
        if label == "main_path_step":
            hp = params[0].contiguous()
            trees = [{str(i): t[0] for i, t in enumerate(ts)}
                     for ts in (a, b, c)]
            fns["fused_update_sweep"]["entry_ms"] = \
                lambda: ops.fused_local_update(*trees, hp, kind="mcp")
            fns["fused_tracking_sweep"]["entry_ms"] = \
                lambda: ops.fused_tracking(*trees, hp)
        entry = {"leaf_shapes": leaf_shapes, "dtype": str(dtype),
                 "launches_per_call": {"ms": 1, "per_leaf_ms":
                                       len(leaf_shapes)}}
        for name, fn in fns.items():
            # every route against the plain version, fp32 at ATOL / RTOL,
            # bf16 within BF16_HEAD_ULPS
            ref = fn["plain_ms"]()
            err, ulps = 0.0, 0
            for route in ("ms", "per_leaf_ms"):
                for u_list, v_list in zip(fn[route](), ref):
                    for u, v in zip(u_list, v_list):
                        if dtype == torch.bfloat16:
                            ulps = max(ulps, int(bf16_ulps(u, v).max()))
                            if ulps > BF16_HEAD_ULPS:
                                raise AssertionError(
                                    f"{label} {name} {route}: {ulps} bf16 "
                                    "ulps from plain")
                        else:
                            torch.testing.assert_close(
                                u, v, atol=ATOL, rtol=RTOL,
                                msg=lambda m: f"{label} {name} {route}: {m}")
                        err = max(err, float((u.float() - v.float()).abs()
                                             .max()))
            del ref
            # in turns, twice over: the host's speed drifts within a run
            times = {k: [] for k in fn}
            order = ["plain_ms", "ms", "per_leaf_ms", *(
                ["entry_ms"] if "entry_ms" in fn else [])]
            for key in (order + order[::-1]) * 2:
                times[key].append(time_ms(fn[key]))
            bpe = K.sweep_trees(name == "fused_update_sweep") \
                * dtype.itemsize
            fpe = UPDATE_FLOPS if name == "fused_update_sweep" \
                else TRACKING_FLOPS
            bound, by = _bound_ms(n_elem, bpe, fpe)
            kernel = ("fused_update_kernel" if name == "fused_update_sweep"
                      else "tracking_kernel")
            ms = min(times["ms"])
            entry[name] = {
                **{k: min(v) for k, v in times.items()}, "all_ms": times,
                "device_ms": _device_ms(fn["ms"], (kernel,)),
                "bound_ms": bound, "bound_by": by,
                "share_of_bound": bound / ms,
                "per_leaf_over_grouped": min(times["per_leaf_ms"]) / ms,
                "max_abs_err": err,
                **({"max_ulps": ulps} if dtype == torch.bfloat16 else {})}
        out[label] = entry
        del a, b, c, leaves
        torch.cuda.empty_cache()
    return {"phase": "timing", **out}


def phase_timing_prox(state) -> dict:
    """prox_tree / fused_update_tree vs plain at the tree path's shapes (the
    six leaves, one grouped call each) and prox_cuda / fused_update_cuda at
    one bandwidth-bound leaf; each call's wall time (CUDA events, host work
    included) and its kernel's device time (``torch.profiler``)."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.kernels.prox import ops
    hp = dict(kind="mcp", lam=1e-4, alpha=0.05, theta=4.0)
    g = torch.Generator(device="cuda").manual_seed(29)
    big = [torch.randn(1 << 26, generator=g, device="cuda") * 0.01
           for _ in range(3)]
    out = {}
    for label, (x, y, nu) in (
            ("tree_path", (state.x, state.y, state.nu)),
            ("bandwidth", ({"x": big[0]}, {"x": big[1]}, {"x": big[2]}))):
        n_elem = sum(t.numel() for t in x.values())
        xs, ys, nus = (list(t.values()) for t in (x, y, nu))
        fns = {"prox": (
            lambda: [list(ops.prox_tree(x, **hp).values())],
            lambda: [K.prox_grouped_plain(xs, **hp)]),
            "fused_update": (
            lambda: [list(t.values()) for t in ops.fused_update_tree(
                x, y, nu, gamma=0.8, **hp)],
            lambda: list(K.fused_update_grouped_plain(xs, ys, nus,
                                                      gamma=0.8, **hp)))}

        def max_err(fk, fp):
            def err():
                a, b = fk(), fp()
                pairs = [(u, v) for pa, pb in zip(a, b)
                         for u, v in zip(pa, pb)]
                for u, v in pairs:
                    if not bits_equal(u, v):
                        raise AssertionError(f"{label} timing shapes: not "
                                             "bit-equal to plain")
                return max(float((u - v).abs().max()) for u, v in pairs)
            return err

        entry = {"leaf_shapes": [list(t.shape) for t in xs],
                 "launches_per_call": 1}
        for name, (fk, fp) in fns.items():
            k, p_, e = _time_pair(fk, fp, max_err(fk, fp))
            bpe = 8 if name == "prox" else 5 * 4
            fpe = (UPDATE_FLOPS - 5) if name == "prox" else UPDATE_FLOPS
            b, by = _bound_ms(n_elem, bpe, fpe)
            kernel = "prox_kernel" if name == "prox" else "fused_update_kernel"
            entry[name] = {"ms": k, "plain_ms": p_,
                           "device_ms": _device_ms(fk, (kernel,)),
                           "bound_ms": b, "bound_by": by,
                           "share_of_bound": b / k, "max_abs_err": e}
        out[label] = entry
    del big
    return {"phase": "timing_prox", **out}


def _flash_bound_ms(B, Lq, Lk, H, KV, D, bytes_per_elem, causal=True):
    """4 D flops a visible (i, j) pair and head (QK^T and PV): Lq Lk pairs
    non-causal; causal (no window, key j visible to query i when j <= i)
    sum_i min(i + 1, Lk).  q, k, v read once and o written once.  bf16 on
    the tensor cores, fp32 on the CUDA cores."""
    if not causal:
        pairs = Lq * Lk
    elif Lq <= Lk:
        pairs = Lq * (Lq + 1) / 2
    else:
        pairs = Lk * (Lk + 1) / 2 + (Lq - Lk) * Lk
    flops = 4.0 * B * H * D * pairs
    nbytes = (2 * B * Lq * H * D + 2 * B * Lk * KV * D) * bytes_per_elem
    peak = hw()["peak_flops_bf16" if bytes_per_elem == 2
                else "peak_flops_fp32"]
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / hw()["hbm_bandwidth"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def phase_timing_flash() -> dict:
    """Flash kernels vs the plain version vs scaled_dot_product_attention
    (enable_gqa), in turns: causal bf16 (the tensor-core kernel) and fp32
    (the CUDA-core kernel), each at the served shape and at L = 8192; bf16
    at the zoo's served D 80 and D 96 shapes (``FLASH_ZOO_SHAPES``), with
    the head-dim route (``route_ms``: q, k, v zero-padded to D 128, the
    D 128 launch at the true D's scale, the slice) in the same turns and
    the D 128 kernel alone on operands padded beforehand; and bf16
    non-causal at the enc-dec's three served shapes
    (``FLASH_ENCDEC_SHAPES``).  The plain version at fp32 L = 8192 (~4.3
    GB of scores) is timed once."""
    import math
    import torch
    import torch.nn.functional as TF
    from repro_torch.kernels.flash_attention import kernel as F
    out = {}
    g = torch.Generator(device="cuda").manual_seed(31)
    served = (SERVE["batch"], SERVE["prompt"], SERVE["prompt"], 16, 8, 128)
    long = (1, 8192, 8192, 16, 8, 128)
    square = lambda B, L, H, KV, D: (B, L, L, H, KV, D)
    for label, (B, Lq, Lk, H, KV, D), causal, dtype, iters in (
            ("served", served, True, torch.bfloat16, 20),
            ("long", long, True, torch.bfloat16, 5),
            ("served_fp32", served, True, torch.float32, 20),
            ("long_fp32", long, True, torch.float32, 5),
            *((label, square(*shape), True, torch.bfloat16, 20)
              for label, shape in FLASH_ZOO_SHAPES.items()),
            *((label, shape, False, torch.bfloat16, 50)
              for label, shape in FLASH_ENCDEC_SHAPES.items())):
        q = torch.randn((B, Lq, H, D), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((B, Lk, KV, D), generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        tname = str(dtype).split(".")[-1]
        kern = lambda: F.flash_attention_cuda(q, k, v, causal=causal)
        plain = lambda: F.flash_attention_plain(q, k, v, causal=causal)
        sdpa = lambda: TF.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True).transpose(1, 2)
        zoo = label in FLASH_ZOO_SHAPES

        def route():
            padded = (TF.pad(t, (0, 128 - D)) for t in (q, k, v))
            return F._launch(*padded, causal=causal, window=0,
                             scale=1.0 / math.sqrt(D))[..., :D].contiguous()

        a, b, c = kern(), plain(), sdpa()
        others = [("plain", b), ("sdpa", c)]
        if zoo:
            others.append(("route", route()))
        torch.cuda.synchronize()
        tol = FLASH_TOL[tname]
        for name, o in others:
            torch.testing.assert_close(
                a, o, atol=tol, rtol=tol,
                msg=lambda m: f"flash {label} kernel vs {name}: {m}")
        err = float((a.float() - b.float()).abs().max())
        del a, b, c, others
        times = {"ms": [], "plain_ms": [], "library_ms": [],
                 **({"route_ms": []} if zoo else {})}
        turns = [("plain_ms", plain), ("ms", kern), ("library_ms", sdpa),
                 ("library_ms", sdpa), ("ms", kern), ("plain_ms", plain)]
        if zoo:
            turns[3:3] = [("route_ms", route), ("route_ms", route)]
        once = label == "long_fp32"
        for name, fn in turns:
            if once and name == "plain_ms":
                if not times[name]:
                    times[name].append(time_ms(fn, iters=1, warmup=0))
                    torch.cuda.empty_cache()
                continue
            times[name].append(time_ms(fn, iters=iters, warmup=2))
        bound, by, flops = _flash_bound_ms(B, Lq, Lk, H, KV, D,
                                           q.element_size(), causal)
        ms = min(times["ms"])
        out[label] = {"shape": {"B": B, "Lq": Lq, "Lk": Lk, "H": H,
                                "KV": KV, "D": D, "dtype": tname,
                                "causal": causal},
                      "ms": ms, "plain_ms": min(times["plain_ms"]),
                      "library_ms": min(times["library_ms"]),
                      "all_ms": times, "bound_ms": bound, "bound_by": by,
                      "share_of_bound": bound / ms,
                      "tflops_per_s": flops / ms / 1e9,
                      "library_tflops_per_s":
                          flops / min(times["library_ms"]) / 1e9,
                      "vs_library": ms / min(times["library_ms"]),
                      "max_abs_err": err}
        if zoo:
            # native against the route it replaced: the whole route (pads,
            # launch, slice) and its D 128 kernel alone on operands padded
            # beforehand
            route_ms = min(times["route_ms"])
            qp, kp, vp = (TF.pad(t, (0, 128 - D)) for t in (q, k, v))
            out[label].update(
                route_ms=route_ms, vs_route=ms / route_ms,
                kernel_at_padded_d_ms=min(
                    time_ms(lambda: F.flash_attention_cuda(qp, kp, vp,
                                                           causal=True),
                            iters=iters, warmup=2) for _ in range(2)))
            del qp, kp, vp
        del q, k, v
        torch.cuda.empty_cache()
    return {"phase": "timing_flash", **out}


def phase_timing_flash_train() -> dict:
    """The training kernels at the benchmark cells' attention
    (``FLASH_TRAIN_SHAPE``, causal, bf16), in turns: the backward
    (``flash_attention_bwd_cuda``: Delta, dK / dV and dQ; ``ms``) against
    its bound (10 D flops a visible pair and head at the bf16 peak), the
    plain backward (``plain_ms``) and PyTorch SDPA's backward
    (``library_ms``, a yardstick the port never calls); forward +
    recompute + backward of one layer (``layer_ms``); the bf16 forward
    with and without ``lse`` at the served shape and at the cells'.  The
    training forward's ``o`` and ``lse`` are held against the plain
    version's in fp32 on the same inputs, and the backward against the
    plain backward given the plain ``o`` and ``lse``."""
    import torch
    import torch.nn.functional as TF
    from repro_torch.kernels.flash_attention import kernel as F
    g = torch.Generator(device="cuda").manual_seed(37)
    B, L, H, KV, D = FLASH_TRAIN_SHAPE
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(
        torch.bfloat16)
    q, k, v, do = rnd(B, L, H, D), rnd(B, L, KV, D), rnd(B, L, KV, D), \
        rnd(B, L, H, D)
    o, lse = F.flash_attention_fwd_train_cuda(q, k, v, causal=True)
    bwd = lambda: F.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                             causal=True)
    plain = lambda: F.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=True)

    def layer():
        F.flash_attention_fwd_train_cuda(q, k, v, causal=True)  # forward
        F.flash_attention_fwd_train_cuda(q, k, v, causal=True)  # recompute
        return bwd()

    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    os_ = TF.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                          enable_gqa=True)
    dos = do.transpose(1, 2)
    sdpa = lambda: torch.autograd.grad(os_, (qs, ks, vs), dos,
                                       retain_graph=True)
    got = bwd()
    f32 = [t.float() for t in (q, k, v)]
    o_ref, lse_ref = F.flash_attention_plain(*f32, causal=True,
                                             return_lse=True)
    torch.cuda.synchronize()
    tol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(
        o.float(), o_ref, atol=tol, rtol=tol,
        msg=lambda m: f"flash training forward o vs plain: {m}")
    seen = torch.isfinite(lse_ref)
    rows = lse[..., :L]
    if not (torch.equal(torch.isfinite(rows), seen)
            and bool(torch.isinf(lse[..., L:]).all())):
        raise AssertionError("flash training forward: lse is +inf on other "
                             "rows than the plain version's")
    lse_err = float((rows[seen] - lse_ref[seen]).abs().max())
    if lse_err > FLASH_LSE_ATOL:
        raise AssertionError(f"flash training forward lse vs plain: "
                             f"{lse_err} > {FLASH_LSE_ATOL}")
    err = {"o_max_abs": float((o.float() - o_ref).abs().max()),
           "lse_max_abs": lse_err}
    want = F.flash_attention_bwd_plain(*f32, o_ref, lse_ref, do.float(),
                                       causal=True)
    del f32, o_ref, lse_ref, seen, rows
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e = a.float() - b
        err[name] = {"rel_l2": float(e.norm() / b.norm()),
                     "max_abs": float(e.abs().max()),
                     "max_ref": float(b.abs().max())}
        if err[name]["rel_l2"] > FLASH_BWD_REL:
            raise AssertionError(f"flash backward {name}: {err[name]}")
    del got, want
    times = {"ms": [], "plain_ms": [], "library_ms": [], "layer_ms": []}
    for name, fn in (("plain_ms", plain), ("ms", bwd), ("library_ms", sdpa),
                     ("layer_ms", layer), ("layer_ms", layer),
                     ("library_ms", sdpa), ("ms", bwd), ("plain_ms", plain)):
        slow = name == "plain_ms"
        times[name].append(time_ms(fn, iters=3 if slow else 20,
                                   warmup=1 if slow else 3))
    fwd_bound, _, fwd_flops = _flash_bound_ms(B, L, L, H, KV, D, 2, True)
    flops = 2.5 * fwd_flops  # 10 D flops a pair where the forward makes 4 D
    bound = flops / hw()["peak_flops_bf16"] * 1e3
    ms = min(times["ms"])
    out = {"phase": "timing_flash_train",
           "shape": {"B": B, "L": L, "H": H, "KV": KV, "D": D,
                     "causal": True, "dtype": "bfloat16"},
           "ms": ms, "plain_ms": min(times["plain_ms"]),
           "library_ms": min(times["library_ms"]),
           "layer_ms": min(times["layer_ms"]), "all_ms": times,
           "bound_ms": bound, "bound_by": "operations",
           "share_of_bound": bound / ms, "tflops_per_s": flops / ms / 1e9,
           "vs_library": ms / min(times["library_ms"]), "err": err,
           "forward": {}}
    del os_, qs, ks, vs, dos
    served = (SERVE["batch"], SERVE["prompt"], 16, 8, 128)
    for label, (b, n, h, kv, d) in (("served", served),
                                    ("cell", FLASH_TRAIN_SHAPE)):
        q, k, v = rnd(b, n, h, d), rnd(b, n, kv, d), rnd(b, n, kv, d)
        fwd = {"ms": [], "lse_ms": []}
        for name, fn in (
                ("ms", lambda: F.flash_attention_cuda(q, k, v, causal=True)),
                ("lse_ms", lambda: F.flash_attention_fwd_train_cuda(
                    q, k, v, causal=True)),
                ("lse_ms", lambda: F.flash_attention_fwd_train_cuda(
                    q, k, v, causal=True)),
                ("ms", lambda: F.flash_attention_cuda(q, k, v, causal=True))):
            fwd[name].append(time_ms(fn, iters=20, warmup=3))
        bound_f, _, _ = _flash_bound_ms(b, n, n, h, kv, d, 2, True)
        out["forward"][label] = {"B": b, "L": n, "ms": min(fwd["ms"]),
                                 "lse_ms": min(fwd["lse_ms"]),
                                 "bound_ms": bound_f, "all_ms": fwd}
    torch.cuda.empty_cache()
    return out


def phase_round_time() -> dict:
    """Round wall time (host clock, synchronised), fused and unfused, in
    turns (fused, off, off, fused); no metrics inside the timed loop."""
    from repro_torch.quickstart import mlp_config, run_depositum
    walls = {"require": [], "off": []}
    for mode in ("require", "off", "off", "require"):
        _, curves = run_depositum(mlp_config(ROUNDS, fused=mode),
                                  collect_metrics=False, device="cuda")
        walls[mode].append(curves["wall_s"] / ROUNDS * 1e3)
    return {"phase": "round_time", "rounds": ROUNDS,
            "round_ms_fused": walls["require"],
            "round_ms_unfused": walls["off"]}


def _sweep_counts(path: str, want: int, gated: int = 0) -> dict:
    """The sweep kernels launched ``want`` times each and nothing else,
    ``gated`` of them through the gated instantiation."""
    prox, _ = _modules()
    launches = read_counts()
    expect_counts(path, launches, {"fused_update_sweep": want,
                                   "fused_tracking_sweep": want})
    g = {"fused_update_sweep": prox.GATED_LAUNCH_COUNTS["fused_sweep"],
         "fused_tracking_sweep": prox.GATED_LAUNCH_COUNTS["tracking_sweep"]}
    if g != {"fused_update_sweep": gated, "fused_tracking_sweep": gated}:
        raise AssertionError(f"{path}: gated launches {g}, want {gated}")
    return {**launches, "gated": g}


def _timed(fn):
    """``fn()`` on the host clock, synchronised; returns (result, s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check_sweep_pair(path, pairs, sweep1, seq1, sweep, seq) -> dict:
    """Fused = unfused bit for bit (``pairs``: (fused, unfused) states
    after one round and after the whole run); the sweep against the
    sequential run after one round within SWEEP_SEQ_ATOL / SWEEP_SEQ_RTOL
    and after the whole run, x within SWEEP_SEQ_REL by relative L2 norm;
    every value finite."""
    import torch
    for label, (a, b) in zip(("one round", "whole run"), pairs):
        for f in ("x", "y", "nu", "g"):
            for k, v in getattr(a, f).items():
                if not bits_equal(v, getattr(b, f)[k]):
                    raise AssertionError(f"{path} {label}: fused {f}.{k} is "
                                         "not bit-equal to unfused")
    _assert_states_close(sweep1, seq1, SWEEP_SEQ_ATOL, SWEEP_SEQ_RTOL)
    rel = _rel_l2(sweep, seq)
    if max(rel["x"].values()) > SWEEP_SEQ_REL:
        raise AssertionError(f"{path}: sweep vs sequential x drifted "
                             f"{rel['x']}")
    for f in ("x", "y", "nu", "g"):
        for k, v in getattr(sweep, f).items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{path}: {f}.{k} not finite")
    return {"sweep_vs_sequential_one_round_max_abs": _state_diff(sweep1,
                                                                 seq1),
            "sweep_vs_sequential_max_abs": _state_diff(sweep, seq),
            "sweep_vs_sequential_rel_l2": rel,
            "fused_vs_unfused_max_abs": _state_diff(*pairs[1])}


def phase_sweep_fig6() -> tuple[dict, dict]:
    """The paper's Fig. 6 topology grid at its published widths (MLP 123 ->
    64 -> 32 -> 10, 10 clients, complete / ring / star / torus as a stacked
    dense W (4, 10, 10), T0 = 20, MCP) for FIG6_ROUNDS rounds through
    ``sweep_run`` with ``fused="require"``: one grouped launch of each
    sweep kernel a step for all four configs, against ``fused="off"`` (bit
    for bit) and ``sweep_run_sequential`` (four one-config runs, four
    times the launches); then both timed in turns, and one sweep round and
    one sequential round profiled."""
    import dataclasses
    import torch
    from repro_torch.figures import fig6_configs
    from repro_torch.profile_round import profile_window
    from repro_torch.quickstart import grid_operands
    from repro_torch.training.sweep import (make_sweep_round, sweep_init,
                                            sweep_run, sweep_run_sequential)
    from repro_torch.core import init, local_then_comm_round

    cfgs = fig6_configs(FIG6_ROUNDS, fused="require")
    g = grid_operands(cfgs, device="cuda")
    p, dep, S, C = g.prepared, cfgs[0].depositum, len(cfgs), 10
    T0 = dep.comm_period

    def run(fn, mode, rounds=FIG6_ROUNDS):
        batches = {k: v[:rounds] for k, v in g.batches.items()}
        return fn(g.params0, p.grad_fn, dataclasses.replace(dep, fused=mode),
                  g.plan, g.hypers, batches, n_clients=C)[0]

    # one round first (it also warms both paths up for the timed runs)
    one = {m: run(sweep_run, m, 1) for m in ("require", "off")}
    seq1 = run(sweep_run_sequential, "require", 1)
    reset_counts()
    sweep, wall_sweep = _timed(lambda: run(sweep_run, "require"))
    launches = _sweep_counts("fig6 sweep", FIG6_ROUNDS * T0)
    reset_counts()
    seq, wall_seq = _timed(lambda: run(sweep_run_sequential, "require"))
    seq_launches = _sweep_counts("fig6 sequential", S * FIG6_ROUNDS * T0)
    reset_counts()
    off = run(sweep_run, "off")
    _sweep_counts("fig6 sweep, fused='off'", 0)
    checks = _check_sweep_pair("fig6", ((one["require"], one["off"]),
                                        (sweep, off)), one["require"],
                               seq1, sweep, seq)
    walls = {"sweep_s": [wall_sweep], "sequential_s": [wall_seq]}
    for _ in range(SWEEP_TIMING_PAIRS - 1):
        for key, fn in (("sequential_s", sweep_run_sequential),
                        ("sweep_s", sweep_run)):
            walls[key].append(_timed(lambda: run(fn, "require"))[1])
    ratios = [q / w for q, w in zip(walls["sequential_s"], walls["sweep_s"])]
    # one sweep round and one round of each config alone, profiled
    round_fn = make_sweep_round(p.grad_fn, dep, g.plan, batch_axis=None)
    state = sweep_init(g.params0, C, S)
    state, _ = round_fn(state, g.hypers, p.batches(0))

    def sweep_round(i):
        nonlocal state
        state, _ = round_fn(state, g.hypers, p.batches((1 + i) % FIG6_ROUNDS))

    prof_sweep = profile_window(sweep_round, 2, "cuda")
    one_cfg = [init(g.params0, C, device="cuda") for _ in range(S)]

    def seq_round(i):
        for s in range(S):
            one_cfg[s], _ = local_then_comm_round(
                one_cfg[s], p.batches((1 + i) % FIG6_ROUNDS), p.grad_fn, dep,
                g.plan.point(s), hyper=cfgs[s].depositum.hyper())

    seq_round(-1)
    prof_seq = profile_window(seq_round, 2, "cuda")
    keep = ("wall_ms_per_round", "device_busy_ms_per_round",
            "device_busy_share")
    return launches, {
        "phase": "sweep_fig6", "configs": S, "clients": C, "rounds":
        FIG6_ROUNDS, "steps": FIG6_ROUNDS * T0,
        "topologies": [c.topology for c in cfgs],
        "launches": launches, "sequential_launches": seq_launches,
        **checks, "one_round_atol": SWEEP_SEQ_ATOL,
        "one_round_rtol": SWEEP_SEQ_RTOL, "whole_run_rel_l2": SWEEP_SEQ_REL,
        "sweep_vs_sequential_walls": walls,
        "sweep_vs_sequential": ratios,
        "sweep_round_ms": [w / FIG6_ROUNDS * 1e3 for w in walls["sweep_s"]],
        "sequential_round_ms": [w / FIG6_ROUNDS * 1e3
                                for w in walls["sequential_s"]],
        "profiled_sweep_round": {k: prof_sweep[k] for k in keep},
        "profiled_sequential_round": {k: prof_seq[k] for k in keep}}


def phase_sweep_fig8() -> tuple[dict, dict]:
    """The Fig. 8 schedule grid (lazy p in {0.3, 0.6, 1.0} and Chebyshev k
    in {1, 2, 3} on a ring, densified per round and stacked: S = 6, MLP 64
    -> 64 -> 32 -> 5, 10 clients, T0 = 5, l1) for FIG8_ROUNDS rounds:
    launches, fused = unfused bit for bit, sweep against sequential."""
    import dataclasses
    from repro_torch.figures import FIG8_CLIENTS, fig8_setup
    from repro_torch.training.sweep import sweep_run, sweep_run_sequential

    f = fig8_setup(FIG8_ROUNDS, "cuda", fused="require")
    S, T0 = len(f.names), f.config.comm_period

    def run(fn, mode, rounds=FIG8_ROUNDS):
        return fn(f.params0, f.grad_fn,
                  dataclasses.replace(f.config, fused=mode), f.grid, f.hypers,
                  {k: v[:rounds] for k, v in f.batches.items()},
                  n_clients=FIG8_CLIENTS)[0]

    one = {m: run(sweep_run, m, 1) for m in ("require", "off")}
    seq1 = run(sweep_run_sequential, "require", 1)
    reset_counts()
    sweep, wall_sweep = _timed(lambda: run(sweep_run, "require"))
    launches = _sweep_counts("fig8 sweep", FIG8_ROUNDS * T0)
    reset_counts()
    seq, wall_seq = _timed(lambda: run(sweep_run_sequential, "require"))
    seq_launches = _sweep_counts("fig8 sequential", S * FIG8_ROUNDS * T0)
    off = run(sweep_run, "off")
    checks = _check_sweep_pair("fig8", ((one["require"], one["off"]),
                                        (sweep, off)), one["require"],
                               seq1, sweep, seq)
    W = f.grid.plan.W
    return launches, {
        "phase": "sweep_fig8", "schedules": f.names,
        "stacked_W": list(W.shape), "stacked_W_bytes": W.numel() * 4,
        "rounds": FIG8_ROUNDS, "launches": launches,
        "sequential_launches": seq_launches, **checks,
        "sweep_s": wall_sweep, "sequential_s": wall_seq,
        "sweep_vs_sequential": wall_seq / wall_sweep}


def phase_sweep_cohort() -> tuple[dict, dict]:
    """The cohort grid at its full sizes: n in {8, 32, 128, 512} x p in
    {0.5, 1.0} Bernoulli cohorts on rings padded to 512 clients (S = 8),
    least squares (D 32, M 16, T0 5, data from a numpy seed) for
    COHORT_ROUNDS rounds with ``fused="require"``: every step one launch
    of each kernel's gated instantiation; after each round every row its
    point's mask left out, and every padding row, is bit for bit what it
    was; gated fused = unfused bit for bit; each padded point within
    COHORT_NATIVE_REL of its native-size run (``fig_cohort.py``)."""
    import torch
    from repro_torch.figures import (COHORT_D, cohort_grad_fn, cohort_setup)
    from repro_torch.training.sweep import (make_sweep_round, sweep_init,
                                            sweep_run_sequential)

    c = {m: cohort_setup("cuda", m) for m in ("require", "off")}
    n_max, S = c["require"].n_max, len(c["require"].points)
    T0 = c["require"].config.comm_period
    params0 = {"w": torch.zeros(COHORT_D, device="cuda")}
    batch = torch.zeros((T0, 1), device="cuda")
    states, frozen_rows = {}, 0
    for mode in ("require", "off"):
        cm = c[mode]
        round_fn = make_sweep_round(cohort_grad_fn(cm.A, cm.b), cm.config,
                                    cm.grid, batch_axis=None)
        state = sweep_init(params0, n_max, S)
        reset_counts()
        after_one = None
        for r in range(COHORT_ROUNDS):
            before = state
            state, _ = round_fn(state, cm.config.hyper(), batch)
            idle = (cm.grid.sampler.mask_at(r) <= 0)
            for f in ("x", "y", "nu", "mu", "g"):
                a, b = getattr(state, f)["w"], getattr(before, f)["w"]
                if not bits_equal(a[idle], b[idle]):
                    raise AssertionError(f"cohort round {r} ({mode}): a "
                                         f"frozen row of {f} moved")
            if mode == "require":
                frozen_rows += int(idle.sum())
            after_one = state if r == 0 else after_one
        torch.cuda.synchronize()
        if mode == "require":
            launches = _sweep_counts("cohort sweep", COHORT_ROUNDS * T0,
                                     gated=COHORT_ROUNDS * T0)
        else:
            _sweep_counts("cohort sweep, fused='off'", 0)
        states[mode] = (after_one, state)
    for i, label in enumerate(("one round", "whole run")):
        a, b = states["require"][i], states["off"][i]
        for f in ("x", "y", "nu", "g"):
            if not bits_equal(getattr(a, f)["w"], getattr(b, f)["w"]):
                raise AssertionError(f"cohort {label}: gated fused {f} is "
                                     "not bit-equal to unfused")
    final = states["require"][1]
    cm = c["require"]
    rel, padded_zero = {}, True
    for s, (name, n, p, _padded, native) in enumerate(cm.points):
        ref = sweep_run_sequential(
            params0, cohort_grad_fn(cm.A[:n], cm.b[:n]), cm.config, native,
            cm.config.hyper(), torch.zeros((COHORT_ROUNDS, T0, 1),
                                           device="cuda"),
            n_clients=n)[0].x["w"][0]
        got = final.x["w"][s, :n]
        rel[name] = float((got - ref).abs().max() / ref.abs().max())
        for f in ("x", "y", "nu", "mu", "g"):
            padded_zero &= not bool(getattr(final, f)["w"][s, n:].any())
    if max(rel.values()) > COHORT_NATIVE_REL or not padded_zero:
        raise AssertionError(f"cohort: padded vs native {rel}, padding "
                             f"rows zero: {padded_zero}")
    if not torch.isfinite(final.x["w"]).all():
        raise AssertionError("cohort: x not finite")
    W = cm.grid.plan.W
    return launches, {
        "phase": "sweep_cohort", "points": [pt[0] for pt in cm.points],
        "n_max": n_max, "rounds": COHORT_ROUNDS, "stacked_W": list(W.shape),
        "stacked_W_bytes": W.numel() * 4, "launches": launches,
        "frozen_rows_checked": frozen_rows,
        "fused_vs_unfused_max_abs": _state_diff(*[states[m][1] for m in
                                                  ("require", "off")]),
        "padded_vs_native_rel": rel, "native_rel_tol": COHORT_NATIVE_REL,
        "padding_rows_zero": padded_zero}


def _comm_leaves(state) -> list:
    """(name, tensor) of every state leaf and memory leaf of a run."""
    out = [(f"{f}.{k}", v) for f in ("x", "y", "nu", "g")
           for k, v in getattr(state, f).items()]
    for var, mem in (state.comm or {}).items():
        out += [(f"comm.{var}.{f}.{k}", v) for f in ("xhat", "s")
                for k, v in getattr(mem, f).items()]
    return out


def _assert_bits_with_memory(path, a, b) -> None:
    """Every state and memory leaf of ``a`` bit-equal to ``b``'s."""
    la, lb = _comm_leaves(a), _comm_leaves(b)
    if [n for n, _ in la] != [n for n, _ in lb]:
        raise AssertionError(f"{path}: state structures differ")
    for (name, u), (_, v) in zip(la, lb):
        if not bits_equal(u, v):
            raise AssertionError(f"{path}: {name} not bit-equal")


def _state_mb(state) -> float:
    """Bytes of x, y, nu, mu, g and the memory, in MB."""
    leaves = [v for f in ("x", "y", "nu", "mu", "g")
              for v in getattr(state, f).values()]
    leaves += [v for name, v in _comm_leaves(state)
               if name.startswith("comm.")]
    return sum(v.numel() * v.element_size() for v in leaves) / 1e6


def _state_to(state, dev):
    """``state`` with every tensor (memory included) on ``dev``."""
    mv = lambda tree: {k: v.to(dev) for k, v in tree.items()}
    return state._replace(
        **{f: mv(getattr(state, f)) for f in ("x", "y", "nu", "mu", "g")},
        comm={var: type(m)(*(mv(t) for t in m))
              for var, m in state.comm.items()} if state.comm else ())


def _all_specs(device):
    """The frontier's eight compressors (ef_step 0.3), named."""
    from repro_torch.core import CompressionSpec
    from repro_torch.figures import (COMM_EF_STEP, COMM_QSGD_BITS,
                                     COMM_TOPK_RATES)
    return ([("dense", CompressionSpec.none(device=device))]
            + [(f"topk_{r}", CompressionSpec.topk(r, ef_step=COMM_EF_STEP,
                                                  device=device))
               for r in COMM_TOPK_RATES]
            + [(f"qsgd_{b}b", CompressionSpec.qsgd(b, ef_step=COMM_EF_STEP,
                                                   device=device))
               for b in COMM_QSGD_BITS])


def phase_compressed_main(dense_state) -> tuple[list, dict]:
    """The Fig. 4 MLP point (the main path's config) under ``topk(0.1)``
    and ``qsgd(4)`` for ROUNDS rounds through ``run_depositum(...,
    compress=spec)``: each sweep kernel once a step, fused = unfused bit
    for bit with the memory, every value finite; then one round on the
    card and on the CPU (the same hashed draws; its x difference is
    reported: a top-k threshold or a QSGD level can flip on an ulp of the
    gradients), and that round's comm step from the card's state on both,
    x within COMM_CPU_ATOL.  A ``none`` spec is bit-equal to
    ``dense_state`` (the main path's run) and allocates no memory."""
    import torch
    from repro_torch.core import CompressionSpec, step
    from repro_torch.quickstart import mlp_config, prepare, run_depositum
    makers = {"topk": lambda dev: CompressionSpec.topk(0.1, device=dev),
              "qsgd": lambda dev: CompressionSpec.qsgd(4, device=dev)}
    want = ROUNDS * mlp_config(ROUNDS).depositum.comm_period
    path_launches, out = [], {}
    for name, make in makers.items():
        runs = {}
        for mode in ("require", "off"):
            reset_counts()
            runs[mode] = run_depositum(mlp_config(ROUNDS, fused=mode),
                                       compress=make("cuda"),
                                       metrics_every=ROUNDS, device="cuda")
            torch.cuda.synchronize()
            launches = read_counts()
            expect_counts(f"{name} path, fused={mode!r}", launches,
                          {"fused_update_sweep": want,
                           "fused_tracking_sweep": want}
                          if mode == "require" else {})
            if mode == "require":
                path_launches.append(launches)
        (st, curves), (off, _) = runs["require"], runs["off"]
        _assert_bits_with_memory(f"{name} fused vs unfused", st, off)
        if not all(bool(torch.isfinite(v).all())
                   for _, v in _comm_leaves(st)):
            raise AssertionError(f"{name}: state or memory not finite")
        cfg1 = mlp_config(1, fused="require")
        T0 = cfg1.depositum.comm_period
        one = {dev: run_depositum(cfg1, compress=make(dev),
                                  collect_metrics=False, device=dev)[0]
               for dev in ("cuda", "cpu")}
        round_err = max(float((v.cpu() - one["cpu"].x[k]).abs().max())
                        for k, v in one["cuda"].x.items())
        p = {dev: prepare(cfg1, compress=make(dev), device=dev)
             for dev in ("cuda", "cpu")}
        st0 = p["cuda"].state
        for i in range(T0 - 1):
            st0, _ = step(st0, {k: v[i] for k, v in
                                p["cuda"].batches(0).items()},
                          p["cuda"].grad_fn, cfg1.depositum,
                          p["cuda"].mixer, is_comm_step=False)
        comm_step = {}
        for dev in ("cuda", "cpu"):
            comm_step[dev], _ = step(
                _state_to(st0, dev), {k: v[T0 - 1] for k, v in
                                      p[dev].batches(0).items()},
                p[dev].grad_fn, cfg1.depositum, p[dev].mixer)
        step_err = max(float((v.cpu() - comm_step["cpu"].x[k]).abs().max())
                       for k, v in comm_step["cuda"].x.items())
        if not step_err <= COMM_CPU_ATOL:
            raise AssertionError(f"{name}: comm step card vs CPU x differs "
                                 f"by {step_err}")
        out[name] = {"launches": path_launches[-1],
                     "loss_last": curves["loss"][-1],
                     "accuracy_last": curves["accuracy"][-1],
                     "stationarity_last": curves["stationarity"][-1],
                     "state_mb": _state_mb(st),
                     "comm_step_card_vs_cpu_x_max_abs": step_err,
                     "round_card_vs_cpu_x_max_abs": round_err}
    reset_counts()
    none_st, _ = run_depositum(mlp_config(ROUNDS, fused="require"),
                               compress=CompressionSpec.none(device="cuda"),
                               collect_metrics=False, device="cuda")
    torch.cuda.synchronize()
    none_launches = read_counts()
    expect_counts("none path", none_launches,
                  {"fused_update_sweep": want, "fused_tracking_sweep": want})
    path_launches.append(none_launches)
    if none_st.comm != ():
        raise AssertionError("a none spec allocated memory")
    _assert_bits_with_memory("none spec vs the dense path", none_st,
                             dense_state)
    return path_launches, {
        "phase": "compressed_main", "rounds": ROUNDS, **out,
        "none": {"launches": none_launches, "bit_equal_dense": True},
        "dense_state_mb": _state_mb(dense_state), "cpu_atol": COMM_CPU_ATOL}


def _compress_times(trees: dict) -> dict:
    """Each kind's ``compress`` of one comm step's x (a round key, as the
    round program draws): wall ms (CUDA events, host work included) and
    device ms (profiler), per tree in ``trees``."""
    from repro_torch.core import comm_round_keys, compress, stack_specs
    out = {}
    for label, (tree, lead) in trees.items():
        specs = dict(_all_specs("cuda"))
        if lead == 2:
            specs = {"mixed_S8": stack_specs(list(specs.values()))}
        else:
            specs.pop("dense")
        row = {}
        for name, spec in specs.items():
            key = comm_round_keys(spec, 3)[0]
            fn = lambda: compress(spec, tree, key, lead=lead)
            row[name] = {"ms": time_ms(fn, iters=50, warmup=5),
                         "device_ms": _device_ms(fn, iters=20)}
        out[label] = row
    return out


def phase_sweep_comm() -> tuple[dict, dict]:
    """The accuracy-vs-bytes frontier (``fig_comm_frontier.py``) at its
    published sizes: the eight compressors as one mixed-kind sweep for
    COMM_ROUNDS rounds with ``fused="require"`` (one grouped launch of
    each kernel a step for all eight) against ``fused="off"`` (bit for bit,
    memory included) and against each point's native-kind run through
    ``sweep_run_sequential`` (eight times the launches); the frontier's
    own rows and ``check``; both timed in turns; each kind's compression
    of one comm step timed."""
    import dataclasses
    import torch
    from repro_torch.core import stack_hypers
    from repro_torch.figures import (COMM_N, comm_check, comm_run,
                                     comm_setup)
    from repro_torch.training.sweep import sweep_run, sweep_run_sequential

    c = comm_setup("cuda", "require")
    S, T0 = len(c.points), c.config.comm_period
    hyper = c.config.hyper()
    hypers = stack_hypers([hyper] * S)

    def run_sweep(mode, rounds=COMM_ROUNDS):
        params0, grad_fn, batches, _ = c.operands(rounds)
        return sweep_run(params0, grad_fn,
                         dataclasses.replace(c.config, fused=mode), c.grid,
                         hypers, batches, n_clients=COMM_N)[0]

    def run_seq(rounds=COMM_ROUNDS):
        params0, grad_fn, batches, _ = c.operands(rounds)
        return [sweep_run_sequential(params0, grad_fn, c.config, sched,
                                     hyper, batches, n_clients=COMM_N)[0]
                for *_, sched in c.points]

    sweep1, seq1 = run_sweep("require", 1), run_seq(1)
    reset_counts()
    sweep, wall_sweep = _timed(lambda: run_sweep("require"))
    launches = _sweep_counts("frontier sweep", COMM_ROUNDS * T0)
    reset_counts()
    seq, wall_seq = _timed(run_seq)
    seq_launches = _sweep_counts("frontier sequential",
                                 S * COMM_ROUNDS * T0)
    off = run_sweep("off")
    _assert_bits_with_memory("frontier fused vs unfused", sweep, off)
    one_err, rel = {}, {}
    for s, (name, *_rest) in enumerate(c.points):
        for f in ("x", "y", "nu", "g"):
            a, b = getattr(sweep1, f)["w"][s], getattr(seq1[s], f)["w"][0]
            torch.testing.assert_close(
                a, b, atol=SWEEP_SEQ_ATOL, rtol=COMM_SEQ_RTOL,
                msg=lambda m: f"frontier {name} {f}, one round: {m}")
            one_err[f"{name}.{f}"] = float((a - b).abs().max())
        a, b = sweep.x["w"][s], seq[s].x["w"][0]
        rel[name] = float(torch.linalg.vector_norm(a - b)
                          / torch.linalg.vector_norm(b))
        if not torch.isfinite(a).all():
            raise AssertionError(f"frontier {name}: x not finite")
    if max(rel.values()) > SWEEP_SEQ_REL:
        raise AssertionError(f"frontier: sweep vs sequential x {rel}")
    rows = comm_run(COMM_ROUNDS, device="cuda", fused="require")
    check = comm_check(rows)
    if not all(check.values()):
        raise AssertionError(f"frontier check failed: {check}")
    walls = {"sweep_s": [wall_sweep], "sequential_s": [wall_seq]}
    for _ in range(SWEEP_TIMING_PAIRS - 1):
        walls["sequential_s"].append(_timed(run_seq)[1])
        walls["sweep_s"].append(_timed(lambda: run_sweep("require"))[1])
    ratios = [q / w for q, w in zip(walls["sequential_s"], walls["sweep_s"])]
    xs = {"w": sweep.x["w"]}
    times = _compress_times({"frontier_x": ({"w": xs["w"][1]}, 1),
                             "frontier_x_S8": (xs, 2)})
    keep = ("name", "bytes_per_round", "bits_per_coord", "final_loss",
            "first_loss", "final_consensus_x")
    return launches, {
        "phase": "sweep_comm", "points": [pt[0] for pt in c.points],
        "rounds": COMM_ROUNDS, "launches": launches,
        "sequential_launches": seq_launches,
        "fused_vs_unfused_bit_equal": True,
        "sweep_vs_sequential_one_round_max_abs": one_err,
        "one_round_atol": SWEEP_SEQ_ATOL, "one_round_rtol": COMM_SEQ_RTOL,
        "sweep_vs_sequential_x_rel_l2": rel,
        "whole_run_rel_l2": SWEEP_SEQ_REL,
        "rows": [{k: r[k] for k in keep} for r in rows], "check": check,
        "sweep_vs_sequential_walls": walls, "sweep_vs_sequential": ratios,
        "compress_ms": times}


def phase_sweep_comm_mlp() -> tuple[dict, dict]:
    """The frontier's eight compressors on the Fig. 4 MLP point (its data,
    model and T0 = 10) as one S = 8 sweep for ROUNDS rounds: one grouped
    launch of each kernel a step, fused = unfused bit for bit with the
    memory, every point finite; the state's size and the walls."""
    import dataclasses
    import torch
    from repro_torch.core import MixPlan, as_schedule, stack_hypers
    from repro_torch.core import stack_schedules
    from repro_torch.quickstart import mlp_config, prepare
    from repro_torch.training.sweep import sweep_run

    cfg = mlp_config(ROUNDS, fused="require")
    p = prepare(cfg, device="cuda")
    base = as_schedule(MixPlan.dense(p.W, device="cuda"))
    names, specs = zip(*_all_specs("cuda"))
    grid = stack_schedules([base.with_compression(s) for s in specs])
    S, T0 = len(specs), cfg.depositum.comm_period
    params0 = {k: v[0] for k, v in p.state.x.items()}
    batches = {"x": p.bx, "y": p.by}

    def run(mode):
        return sweep_run(params0, p.grad_fn,
                         dataclasses.replace(cfg.depositum, fused=mode),
                         grid, stack_hypers([cfg.depositum.hyper()] * S),
                         batches, n_clients=cfg.n_clients)[0]

    run("require")                                  # warm-up
    reset_counts()
    sweep, wall = _timed(lambda: run("require"))
    launches = _sweep_counts("MLP compressor sweep", ROUNDS * T0)
    off, wall_off = _timed(lambda: run("off"))
    _assert_bits_with_memory("MLP compressor sweep fused vs unfused", sweep,
                             off)
    if not all(bool(torch.isfinite(v).all()) for _, v in _comm_leaves(sweep)):
        raise AssertionError("MLP compressor sweep: not finite")
    return launches, {
        "phase": "sweep_comm_mlp", "points": list(names), "S": S,
        "rounds": ROUNDS, "state_mb": _state_mb(sweep),
        "launches": launches, "fused_vs_unfused_bit_equal": True,
        "round_ms_fused": wall / ROUNDS * 1e3,
        "round_ms_unfused": wall_off / ROUNDS * 1e3,
        "compress_ms": _compress_times({"mlp_x_S8": (sweep.x, 2)})}


def phase_graph_choco() -> dict:
    """``choco_mix`` of the Fig. 4 MLP's x (six (10, ...) leaves) over a
    ring, top-k(0.1) and QSGD(4), captured in a CUDA graph on static
    inputs: each replay, after the outputs are set to NaN and, the second
    time, new values are copied into the inputs, equals the eager call bit
    for bit.  A capture fails on any host sync, so this shows the exchange
    has none."""
    import torch
    from repro_torch.core import (CommMemory, CompressionSpec, MixPlan,
                                  apply_mix, choco_mix, comm_round_keys)
    from repro_torch.core.topology import mixing_matrix
    C = 10
    g = torch.Generator(device="cuda").manual_seed(41)
    plan = MixPlan.dense(mixing_matrix("ring", C), device="cuda")

    def tree():
        return {f"l{i}": torch.randn((C,) + s, generator=g, device="cuda")
                * 0.1 for i, s in enumerate(MLP_LEAVES)}

    x, xhat, s = tree(), tree(), tree()
    out = {}
    for name, spec in (("topk", CompressionSpec.topk(0.1, device="cuda")),
                       ("qsgd", CompressionSpec.qsgd(4, device="cuda"))):
        key = comm_round_keys(spec, 2)[0]

        def call():
            o, m = choco_mix(spec, lambda t: apply_mix(plan, t), x,
                             CommMemory(xhat, s), key)
            return [o, m.xhat, m.s]

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = read_counts()
        with torch.cuda.graph(graph):
            static = call()
        if read_counts() != before:
            raise AssertionError(f"graph {name}: a counted kernel launched")
        for replay in range(2):
            if replay:
                for t in (x, xhat, s):
                    for v in t.values():
                        v.copy_(torch.randn(v.shape, generator=g,
                                            device="cuda") * 0.1)
            for t in static:
                for v in t.values():
                    v.fill_(float("nan"))
            graph.replay()
            eager = call()
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(static, eager)):
                for k in a:
                    if not bits_equal(a[k], b[k]):
                        raise AssertionError(f"graph {name}, replay "
                                             f"{replay}: output {i} {k} "
                                             "differs from the eager call")
        out[name] = {"replays": 2, "bit_equal": True}
        del graph, static
    return {"phase": "graph_choco", **out}


def phase_round_time_comm() -> dict:
    """Round wall time (host clock, synchronised, ROUNDS rounds, no
    metrics) of the Fig. 4 MLP point fused, dense / top-k(0.1) / QSGD(4),
    in turns (dense, topk, qsgd, qsgd, topk, dense); then 3 rounds of each
    profiled after 2 warm-up (``profile_window``): wall and device busy ms
    a round, the busy share."""
    from repro_torch.core import CompressionSpec, local_then_comm_round
    from repro_torch.profile_round import profile_window
    from repro_torch.quickstart import mlp_config, prepare, run_depositum
    makers = {"dense": lambda: None,
              "topk": lambda: CompressionSpec.topk(0.1, device="cuda"),
              "qsgd": lambda: CompressionSpec.qsgd(4, device="cuda")}
    walls = {k: [] for k in makers}
    for name in ("dense", "topk", "qsgd", "qsgd", "topk", "dense"):
        _, curves = run_depositum(mlp_config(ROUNDS, fused="require"),
                                  compress=makers[name](),
                                  collect_metrics=False, device="cuda")
        walls[name].append(curves["wall_s"] / ROUNDS * 1e3)
    prof = {}
    keep = ("wall_ms_per_round", "device_busy_ms_per_round",
            "device_busy_share", "host_phase_ms_per_round")
    for name, make in makers.items():
        cfg = mlp_config(5, fused="require")
        p = prepare(cfg, compress=make(), device="cuda")
        state = p.state

        def advance(r):
            nonlocal state
            state, _ = local_then_comm_round(state, p.batches(r), p.grad_fn,
                                             cfg.depositum, p.mixer)

        for r in range(2):
            advance(r)
        window = profile_window(lambda i: advance(2 + i), 3, "cuda")
        prof[name] = {k: window[k] for k in keep}
    return {"phase": "round_time_comm", "rounds": ROUNDS,
            "round_ms": walls, "profiled": prof}


def _gb(nbytes) -> float:
    return nbytes / 1e9


def phase_train_llm() -> tuple[dict, dict, dict, dict]:
    """Full-width Qwen3-1.7B trained by DEPOSITUM on 2 bf16 clients through
    launch/train.py's builder (FederatedTrainer, fused="auto", donated
    rounds), then ``phase_async_llm`` on the same model and state, then
    the consensus served through BatchedServer.  Returns its launches and
    line, and the async phase's."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.kernels.prox.ops import (fused_local_update,
                                              fused_tracking,
                                              hyper_param_vec)
    from repro_torch.launch import train
    from repro_torch.models.common import pad_vocab
    from repro_torch.profile_round import profile_window
    from repro_torch.serving import BatchedServer, ServeConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    args = train.parse_args(TRAIN + ["--rounds", str(1 + TRAIN_ROUNDS)])
    trainer, cfg, state, it = train.build(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v[0].numel() for v in state.x.values())
    n_leaves = len(state.x)
    state_gb = _gb(sum(v.numel() * v.element_size() for f in
                       ("x", "y", "nu", "mu", "g")
                       for v in getattr(state, f).values()))
    init_peak_gb = _gb(torch.cuda.max_memory_allocated() - base)
    per_step = -(-n_leaves // K.MAX_LEAVES)
    T0 = args.t0

    reset_counts()
    t0 = time.perf_counter()
    state, hist = trainer.run(state, it, 1, donate=True)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    warm = read_counts()
    expect_counts("train_llm warm-up", warm, {
        "fused_update_sweep": per_step * T0,
        "fused_tracking_sweep": per_step * T0})
    losses = [hist[-1]["loss"]]

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                  "num_sync_all_streams")
    stats0 = torch.cuda.memory_stats()
    walls = []
    for _ in range(TRAIN_ROUNDS):
        t0 = time.perf_counter()
        state, hist = trainer.run(state, it, 1, donate=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(hist[-1]["loss"])
    launches = read_counts()
    peak_gb = _gb(torch.cuda.max_memory_allocated() - base)
    stats1 = torch.cuda.memory_stats()
    allocator = {k: stats1.get(k, 0) - stats0.get(k, 0) for k in alloc_keys}
    expect_counts("train_llm", launches, {
        "fused_update_sweep": per_step * T0 * TRAIN_ROUNDS,
        "fused_tracking_sweep": per_step * T0 * TRAIN_ROUNDS})
    attn_launches = expect_train_flash(
        "train_llm", cfg.n_layers * args.clients * T0 * TRAIN_ROUNDS)
    tokens = args.clients * args.batch * args.seq * T0

    # recorded rounds in turns with unrecorded ones: round wall and peak
    # memory with round_values on the full-width state
    from repro_torch.obs import DEFAULT_METRICS, Telemetry
    tel = {"off": {"round_ms": [], "peak_gb": []},
           "on": {"round_ms": [], "peak_gb": []}}
    reset_counts()
    for turn in range(TRAIN_TEL_PAIRS):
        for key in (("off", "on") if turn % 2 == 0 else ("on", "off")):
            trainer.telemetry = Telemetry.memory() if key == "on" else None
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, hist = trainer.run(state, it, 1, donate=True)
            torch.cuda.synchronize()
            tel[key]["round_ms"].append((time.perf_counter() - t0) * 1e3)
            tel[key]["peak_gb"].append(
                _gb(torch.cuda.max_memory_allocated() - base))
            losses.append(hist[-1]["loss"])
            if key == "on":
                # the run's one recorded row (its final round, off cadence),
                # numbered by the state's own round count: a run on a state
                # that has trained already merges none into ``history``
                events = trainer.telemetry.events(0)
                want_round = state.t // T0
                bad = [m for m in DEFAULT_METRICS if not events or
                       not abs(events[-1].get(m, float("nan")))
                       < float("inf")]
                if (len(events) != 1 or events[0]["round"] != want_round
                        or bad):
                    raise AssertionError(
                        f"train_llm telemetry: want one row of round "
                        f"{want_round}, every metric finite ({bad} not): "
                        f"{events}")
                tel["recorded"] = events[0]
    trainer.telemetry = None
    tel_launches = read_counts()
    expect_counts("train_llm telemetry", tel_launches, {
        "fused_update_sweep": per_step * T0 * 2 * TRAIN_TEL_PAIRS,
        "fused_tracking_sweep": per_step * T0 * 2 * TRAIN_TEL_PAIRS})

    # one more round under torch.profiler: device busy share, host time
    # in the annotated phases, the costliest kernels
    box = [state]

    def advance(_):
        box[0], h = trainer.run(box[0], it, 1, donate=True)
        losses.append(h[-1]["loss"])

    del state
    profiled = profile_window(advance, 1, "cuda", top=12)
    state = box.pop()
    if not all(l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"train_llm: a loss is not finite: {losses}")

    # the sweep pair at these leaves: one step's two grouped calls (device
    # time by CUDA events) against their bound, state and outputs in place
    hp = hyper_param_vec(trainer.cfg.depositum.hyper(), device="cuda")
    tree_bytes = sum(v.numel() * v.element_size() for v in state.x.values())
    sweep = {}
    reset_counts()
    fns = {"fused_update_sweep": lambda: fused_local_update(
               state.x, state.y, state.nu, hp, kind="l1"),
           "fused_tracking_sweep": lambda: fused_tracking(
               state.y, state.g, state.nu, hp)}
    for name, fn in fns.items():
        ms = time_ms(fn, iters=5, warmup=1)
        bound = (K.sweep_trees(name == "fused_update_sweep") * tree_bytes
                 / hw()["hbm_bandwidth"] * 1e3)
        sweep[name] = {"ms": ms, "bound_ms": bound,
                       "share_of_bound": bound / ms,
                       "launches_per_call": per_step}
        torch.cuda.empty_cache()

    # the async learner on this model and state (its own launches, line)
    async_launches, async_line, state = phase_async_llm(
        trainer, state, it, args, base)

    mean = trainer.mean_params(state)
    del state, fns
    torch.cuda.empty_cache()
    ts = TRAIN_SERVE
    srv = BatchedServer(trainer.model, mean, ServeConfig(
        max_new_tokens=ts["new"], cache_capacity=ts["cache"]))
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (ts["batch"], ts["prompt"]),
                            generator=gen, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    toks = srv.generate(prompts)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = read_counts()
    expect_counts("train_llm serve", serve_launches,
                  {"flash_attention": cfg.n_layers})
    with torch.inference_mode():
        logits, _ = srv.prefill(prompts)
    if toks.shape != (ts["batch"], ts["new"]) or not bool(
            ((toks >= 0) & (toks < pad_vocab(cfg.vocab_size))).all()):
        raise AssertionError(f"train_llm: served tokens bad {toks.shape}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("train_llm: served logits are not finite")
    del srv, mean, logits
    torch.cuda.empty_cache()
    path = {k: warm[k] + launches[k] + tel_launches[k] for k in launches}
    path["flash_attention"] += serve_launches["flash_attention"]
    return (path, {
        "phase": "train_llm", "arch": cfg.name, "layers": cfg.n_layers,
        "params": n_params, "leaves": n_leaves, "dtype": cfg.dtype,
        "remat": cfg.remat, "remat_policy": cfg.remat_policy,
        "clients": args.clients, "topology": args.topology,
        "batch": args.batch, "seq": args.seq, "t0": T0,
        "fused": trainer.cfg.depositum.fused, "init_s": init_s,
        "warmup_round_s": warmup_s, "round_ms": walls,
        "tokens_per_round": tokens,
        "tokens_per_s": [tokens / w * 1e3 for w in walls],
        "losses": losses, "state_gb": state_gb,
        "init_peak_gb": init_peak_gb, "train_peak_gb": peak_gb,
        "predicted_peak_gb": list(TRAIN_PEAK_GB),
        "card_gb": _gb(torch.cuda.get_device_properties(0).total_memory),
        "launches_warmup": warm, "launches_timed": launches,
        "telemetry": tel, "launches_telemetry": tel_launches,
        "launches_per_step": per_step, "allocator_timed": allocator,
        "attention_launches_timed": attn_launches,
        "profiled_round": profiled, "sweep_step": sweep,
        "serve": {"batch": ts["batch"], "prompt": ts["prompt"],
                  "new_tokens": ts["new"], "generate_s": serve_s,
                  "launches": serve_launches, "sample": toks[0].tolist()}},
        async_launches, async_line)


def _assert_restores(path: str, ck: str, mean) -> int | None:
    """The checkpoint ``ck`` restored on the card into the family's module
    (its ``init`` on ``meta``) equals the module ``mean`` it was written
    from, dtype and bits, leaf by leaf; returns the saved step."""
    from repro_torch.models import build_model
    from repro_torch.training import restore_checkpoint
    restored, step = restore_checkpoint(
        ck, build_model(mean.cfg, device="meta").init()[0], device="cuda")
    for (k, a), (_, b) in zip(restored.named_parameters(),
                              mean.named_parameters()):
        if a.dtype != b.dtype or not bits_equal(a, b):
            raise AssertionError(f"{path}: {k} restored != saved")
    return step


def phase_train_ckpt() -> tuple[dict, dict]:
    """launch.train --ckpt then launch.serve --ckpt on the card (reduced
    fp32): the restored params bit-equal to the saved consensus, the
    served tokens equal to serving the consensus directly."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import build_model

    cfg = get_config("qwen3-1.7b", reduced=True)
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "consensus.npz")
        reset_counts()
        trainer, state, hist = train.main(TRAIN_REDUCED + ["--ckpt", ck])
        torch.cuda.synchronize()
        train_launches = read_counts()
        steps = int(state.t)
        expect_counts("train_ckpt", train_launches, {
            "fused_update_sweep": steps, "fused_tracking_sweep": steps})
        mean = trainer.mean_params(state)
        step = _assert_restores("train_ckpt", ck, mean)
        reset_counts()
        served = serve.main(["--arch", "qwen3-1.7b", "--reduced", "--ckpt",
                             ck, "--batch", "2", "--prompt-len", "8",
                             "--max-new", "6"])
        serve_launches = read_counts()
        expect_counts("train_ckpt serve", serve_launches,
                      {"flash_attention_fp32": cfg.n_layers})
    direct = serve.generate(build_model(cfg, device="cuda"), mean, batch=2,
                            prompt_len=8, max_new=6)
    if not torch.equal(served, direct):
        raise AssertionError("train_ckpt: served tokens differ from the "
                             "consensus served directly")
    path = {k: train_launches[k] + serve_launches[k] for k in train_launches}
    return path, {"phase": "train_ckpt", "arch": cfg.name, "steps": steps,
                  "step": step, "losses": [h["loss"] for h in hist],
                  "launches": path, "tokens": served[0].tolist()}


def phase_train_card_vs_cpu() -> tuple[dict, dict]:
    """Reduced fp32 trainer, 2 rounds from one state on the card and on the
    CPU (kernels there, plain versions here): x, y, nu, g within
    CPU_ATOL / CPU_RTOL, losses within CPU_RTOL."""
    import copy
    import torch
    from repro_torch.launch import train

    runs, launches = {}, None
    args = train.parse_args(TRAIN_REDUCED)
    for dev in ("cpu", "cuda"):
        args.device = dev
        trainer, cfg, _, it = train.build(args)
        if dev == "cpu":
            module, _ = trainer.model.init(args.seed)
            start = copy.deepcopy(module)
        state = trainer.state_from_params(copy.deepcopy(start).to(dev))
        if dev == "cuda":
            reset_counts()
        state, hist = trainer.run(state, it, args.rounds)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_counts()
        runs[dev] = (state, [h["loss"] for h in hist])
    (cs, cl), (gs, gl) = runs["cpu"], runs["cuda"]
    diff = {}
    for f in ("x", "y", "nu", "g"):
        a, b = getattr(gs, f), getattr(cs, f)
        for k in a:
            torch.testing.assert_close(a[k].cpu(), b[k], atol=CPU_ATOL,
                                       rtol=CPU_RTOL,
                                       msg=lambda m: f"{f}/{k}: {m}")
        diff[f] = max(float((a[k].cpu() - b[k]).abs().max()) for k in a)
    torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl), atol=0,
                               rtol=CPU_RTOL)
    steps = int(gs.t)
    expect_counts("train_card_vs_cpu", launches, {
        "fused_update_sweep": steps, "fused_tracking_sweep": steps})
    return launches, {"phase": "train_card_vs_cpu", "steps": steps,
                      "atol": CPU_ATOL, "rtol": CPU_RTOL,
                      "max_abs_diff": diff, "losses_card": gl,
                      "losses_cpu": cl, "launches": launches}



def _with_arch(argv: list, arch: str) -> list:
    """``argv`` with the value of ``--arch`` replaced by ``arch``."""
    i = argv.index("--arch")
    return argv[:i + 1] + [arch] + argv[i + 2:]


def _with_extras(it, cfg, frames: int, draw):
    """The LM batch iterator with a VLM's vision embeds or an enc-dec's
    ``frames`` stub frames a sample added, ``draw(shape)`` giving them."""
    for b in it:
        lead = tuple(b["tokens"].shape[:3])
        if cfg.family == "vlm":
            b["vision_embeds"] = draw(lead + (cfg.n_vision_tokens,
                                              cfg.d_model))
        if cfg.family == "encdec":
            b["frames"] = draw(lead + (frames, cfg.d_model))
        yield b


def _hold_sweep_pair(trainer, state) -> dict:
    """One step's two grouped calls at the state's leaf table against the
    plain versions leaf by leaf, on the same inputs: every bf16 output
    within TRAIN_ZOO_ULPS (fp32 bit for bit).  The launches are a check's,
    not the path's."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.kernels.prox.ops import (fused_local_update,
                                              fused_tracking,
                                              hyper_param_vec)
    dep = trainer.cfg.depositum
    hp = hyper_param_vec(dep.hyper(), device="cuda")
    table = hp[None]
    worst = {"fused_update_sweep": 0, "fused_tracking_sweep": 0}
    differing = dict(worst)

    def hold(name, k, out, ref):
        if out.dtype == torch.bfloat16:
            d = bf16_ulps(out, ref)
            u, n = int(d.max()), int((d > 0).sum())
        else:
            u = n = 0 if bits_equal(out, ref) else 1
        worst[name] = max(worst[name], u)
        differing[name] += n
        if u > TRAIN_ZOO_ULPS:
            raise AssertionError(f"{name} at leaf {k}: {u} ulps from plain "
                                 f"({n} elements differ)")

    xs, nus = fused_local_update(state.x, state.y, state.nu, hp,
                                 kind=dep.prox_name)
    for k in state.x:
        rx, rnu = K.fused_update_sweep_grouped_plain(
            [state.x[k]], [state.y[k]], [state.nu[k]], table,
            kind=dep.prox_name, lead=1)
        hold("fused_update_sweep", k, xs[k], rx[0])
        hold("fused_update_sweep", k, nus[k], rnu[0])
    del xs, nus, rx, rnu
    ys, _ = fused_tracking(state.y, state.g, state.nu, hp)
    for k in state.y:
        ry, _ = K.fused_tracking_sweep_grouped_plain(
            [state.y[k]], [state.g[k]], [state.nu[k]], table, lead=1)
        hold("fused_tracking_sweep", k, ys[k], ry[0])
    del ys, ry
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"max_ulps": worst, "differing": differing,
            "ulps_limit": TRAIN_ZOO_ULPS}


def _train_zoo_arch(arch: str):
    """Full-width DEPOSITUM rounds of ``arch`` on 2 bf16 clients; returns
    (launches, line, trainer, consensus module)."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.launch import dryrun, train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    args = train.parse_args(_with_arch(TRAIN, arch)
                            + ["--rounds", str(1 + TRAIN_ZOO_ROUNDS)])
    trainer, cfg, state, it = train.build(args)
    gen = torch.Generator(device="cuda").manual_seed(5)
    it = _with_extras(it, cfg, TRAIN_ZOO_FRAMES, lambda shape: torch.randn(
        shape, generator=gen, device="cuda").to(cfg.torch_dtype))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v[0].numel() for v in state.x.values())
    n_leaves = len(state.x)
    smallest = min(v[0].numel() for v in state.x.values())
    per_step = -(-n_leaves // K.MAX_LEAVES)
    if per_step != TRAIN_ZOO_LAUNCHES[arch]:
        raise AssertionError(f"train_zoo {arch}: {n_leaves} leaves take "
                             f"{per_step} launches a step, want "
                             f"{TRAIN_ZOO_LAUNCHES[arch]}")
    state_bytes = sum(v.numel() * v.element_size() for f in
                      ("x", "y", "nu", "mu", "g")
                      for v in getattr(state, f).values())
    dry = dryrun.run_one(arch, "train_4k", mesh="1x1",
                         n_clients=args.clients)
    if state_bytes != dry["state_bytes_per_device"]:
        raise AssertionError(f"train_zoo {arch}: state {state_bytes} bytes, "
                             f"the dry run's {dry['state_bytes_per_device']}")
    T0 = args.t0
    want = lambda rounds: {"fused_update_sweep": per_step * T0 * rounds,
                           "fused_tracking_sweep": per_step * T0 * rounds}

    reset_counts()
    t0 = time.perf_counter()
    state, hist = trainer.run(state, it, 1, donate=True)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    warm = read_counts()
    expect_counts(f"train_zoo {arch} warm-up", warm, want(1))
    losses = [hist[-1]["loss"]]
    pair = _hold_sweep_pair(trainer, state)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls = []
    for _ in range(TRAIN_ZOO_ROUNDS):
        t0 = time.perf_counter()
        state, hist = trainer.run(state, it, 1, donate=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(hist[-1]["loss"])
    launches = read_counts()
    expect_counts(f"train_zoo {arch}", launches, want(TRAIN_ZOO_ROUNDS))
    peak_gb = _gb(torch.cuda.max_memory_allocated() - base)
    if not all(l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"train_zoo {arch}: a loss is not finite: "
                             f"{losses}")
    steps = int(state.t)
    mean = trainer.mean_params(state)
    del state
    torch.cuda.empty_cache()
    tokens = args.clients * args.batch * args.seq * T0
    path = {k: warm[k] + launches[k] for k in launches}
    return path, {
        "arch": arch, "family": cfg.family, "layers": cfg.n_layers,
        "params": n_params, "leaves": n_leaves,
        "smallest_leaf": smallest, "dtype": cfg.dtype, "remat": cfg.remat,
        "clients": args.clients, "batch": args.batch, "seq": args.seq,
        "t0": T0, "steps": steps, "init_s": init_s,
        "warmup_round_s": warmup_s, "round_ms": walls,
        "tokens_per_round": tokens,
        "tokens_per_s": [tokens / w * 1e3 for w in walls],
        "losses": losses, "state_bytes": state_bytes,
        "dryrun_state_bytes": dry["state_bytes_per_device"],
        "train_peak_gb": peak_gb, "launches_per_step": per_step,
        "launches": path, "sweep_pair_vs_plain": pair,
        **({"frames": TRAIN_ZOO_FRAMES} if cfg.family == "encdec" else {}),
        **({"predicted_peak_gb": list(TRAIN_ZOO_PEAK_GB)}
           if arch == "zamba2-2.7b" else {})}, trainer, mean


def _serve_trained(cfg, model, mean) -> tuple[dict, dict]:
    """The trained consensus of a decoder family through BatchedServer
    (TRAIN_ZOO_SERVE): the flash launches of one prefill, each call of a
    prefill held against the plain version."""
    import torch
    from repro_torch.models.common import pad_vocab
    from repro_torch.serve_drift import prefill_drift
    from repro_torch.serving import BatchedServer, ServeConfig
    ts = TRAIN_ZOO_SERVE
    srv = BatchedServer(model, mean, ServeConfig(
        max_new_tokens=ts["new"], cache_capacity=ts["cache"]))
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (ts["batch"], ts["prompt"]),
                            generator=gen, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    toks = srv.generate(prompts)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = read_counts()
    expect_counts(f"train_zoo {cfg.name} serve", launches,
                  _zoo_want(cfg, 1, "flash_attention"))
    if toks.shape != (ts["batch"], ts["new"]) or not bool(
            ((toks >= 0) & (toks < pad_vocab(cfg.vocab_size))).all()):
        raise AssertionError(f"train_zoo {cfg.name}: served tokens bad")
    line = {**ts, "generate_s": generate_s, "launches": launches,
            "sample": toks[0].tolist()}
    if _attention_layers(cfg):
        drift = prefill_drift(srv, prompts, call_tol=FLASH_TOL["bfloat16"],
                              logit_tol=(SERVE_LOGIT_ATOL, SERVE_LOGIT_RTOL))
        if drift["flash_calls"] != _attention_layers(cfg):
            raise AssertionError(f"train_zoo {cfg.name}: "
                                 f"{drift['flash_calls']} flash calls held")
        line.update(flash_call_tol=FLASH_TOL["bfloat16"], drift=drift)
    with torch.inference_mode():
        logits, _ = srv.prefill(prompts)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"train_zoo {cfg.name}: logits not finite")
    return launches, line


def _serve_ckpt(cfg, model, mean, steps: int) -> tuple[dict, dict]:
    """The consensus saved as ``launch.train --ckpt`` saves it, then
    served by ``launch.serve --ckpt``: restored bit-equal to the saved
    module, the served tokens equal to serving the consensus directly."""
    import tempfile
    import torch
    from repro_torch.launch import serve
    from repro_torch.training import save_checkpoint
    ts = TRAIN_ZOO_SERVE
    argv = ["--arch", cfg.name, "--batch", str(ts["batch"]), "--prompt-len",
            str(ts["prompt"]), "--max-new", str(ts["new"]), "--cache",
            str(ts["cache"])]
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "consensus.npz")
        t0 = time.perf_counter()
        save_checkpoint(ck, mean, step=steps)
        save_s = time.perf_counter() - t0
        ck_gb = _gb(os.path.getsize(ck))
        t0 = time.perf_counter()
        step = _assert_restores(f"train_zoo {cfg.name}", ck, mean)
        restore_s = time.perf_counter() - t0
        reset_counts()
        served = serve.main(argv + ["--ckpt", ck])
        launches = read_counts()
    expect_counts(f"train_zoo {cfg.name} serve --ckpt", launches,
                  _zoo_want(cfg, 1, "flash_attention"))
    direct = serve.generate(model, mean, batch=ts["batch"],
                            prompt_len=ts["prompt"], max_new=ts["new"],
                            cache=ts["cache"])
    if not torch.equal(served, direct):
        raise AssertionError(f"train_zoo {cfg.name}: tokens served from the "
                             "checkpoint differ from the consensus's")
    return launches, {"ckpt_gb": ck_gb, "step": step, "save_s": save_s,
                      "restore_s": restore_s, "launches": launches,
                      "restored_bit_equal": True, "tokens_equal": True,
                      "sample": served[0].tolist()}


def _serve_trained_encdec(cfg, model, mean) -> tuple[dict, dict]:
    """The enc-dec's consensus: the prefill step over stub frames (36
    flash launches), then BatchedServer from its memory (12 a step), every
    call of the prefill step held against the plain version."""
    import torch
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.common import pad_vocab
    from repro_torch.serve_drift import flash_drift
    from repro_torch.serving import BatchedServer, ServeConfig
    B, S, Lp, new, cap = (TRAIN_ZOO_ENCDEC_SERVE[k] for k in (
        "batch", "frames", "prompt", "new", "cache"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {"frames": torch.randn((B, S, cfg.d_model), generator=gen,
                                   device="cuda").to(cfg.torch_dtype),
             "tokens": torch.randint(0, cfg.vocab_size, (B, Lp),
                                     generator=gen, device="cuda")}
    step = build_prefill_step(model, cap)
    want_prefill = cfg.n_encoder_layers + 2 * cfg.n_layers
    reset_counts()
    t0 = time.perf_counter()
    logits, memory = step(mean, batch)
    prefill_launches = read_counts()
    expect_counts("train_zoo enc-dec prefill step", prefill_launches,
                  {"flash_attention": want_prefill})
    toks = BatchedServer(model, mean, ServeConfig(
        max_new_tokens=new, cache_capacity=cap)).generate(
        batch["tokens"], extra={"memory": memory})
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    expect_counts("train_zoo enc-dec serve", launches, {
        "flash_attention": want_prefill + cfg.n_layers * (Lp + new - 1)})
    if toks.shape != (B, new) or not bool(
            ((toks >= 0) & (toks < pad_vocab(cfg.vocab_size))).all()):
        raise AssertionError("train_zoo enc-dec: served tokens bad")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(memory).all())):
        raise AssertionError("train_zoo enc-dec: prefill not finite")
    drift = flash_drift(lambda: step(mean, batch)[0],
                        call_tol=FLASH_TOL["bfloat16"],
                        logit_tol=(SERVE_LOGIT_ATOL, SERVE_LOGIT_RTOL))
    if drift["flash_calls"] != want_prefill:
        raise AssertionError(f"train_zoo enc-dec: {drift['flash_calls']} "
                             "flash calls held")
    return launches, {**TRAIN_ZOO_ENCDEC_SERVE, "serve_s": serve_s,
                      "launches": launches,
                      "prefill_step_launches":
                          prefill_launches["flash_attention"],
                      "flash_call_tol": FLASH_TOL["bfloat16"],
                      "drift": drift, "sample": toks[0].tolist()}


def _mla_config():
    """``deepseek-v2-lite`` as the benchmark cell holds it (8 of 64
    experts, 12,800 vocabulary rows) at ``MLA_LAYERS`` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v2-lite"),
                               n_layers=MLA_LAYERS, experts_held=8,
                               vocab_size=12800)


def phase_train_mla() -> dict:
    """The (192, 128) flash kernels on their main path, then alone at the
    cell's attention; see ``train_mla`` in the module docstring."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cut = _mla_config()
    args = train.parse_args(MLA_TRAIN + ["--rounds", "1"])
    get_config = train.get_config
    train.get_config = lambda arch, reduced=False: cut
    try:
        trainer, cfg, state, it = train.build(args)
    finally:
        train.get_config = get_config
    state, hist = trainer.run(state, it, 1, donate=True)      # warm-up
    torch.cuda.synchronize()
    losses = [hist[-1]["loss"]]
    reset_counts()
    walls = []
    for _ in range(MLA_ROUNDS):
        t0 = time.perf_counter()
        state, hist = trainer.run(state, it, 1, donate=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(hist[-1]["loss"])
    launches = expect_train_flash(
        "train_mla", cfg.n_layers * args.clients * args.t0 * MLA_ROUNDS)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_mla: losses {losses}")
    peak_gb = _gb(torch.cuda.max_memory_allocated() - base)
    del trainer, state, it, hist
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(41)
    B, L, H, D, DV = FLASH_MLA_SHAPE
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16)
    q, k, v, do = rnd(B, L, H, D), rnd(B, L, H, D), rnd(B, L, H, DV), \
        rnd(B, L, H, DV)
    scale = cut.softmax_scale
    fwd = lambda: F.flash_attention_fwd_train_cuda(q, k, v, causal=True,
                                                   scale=scale)
    o, lse = fwd()
    bwd = lambda: F.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                             causal=True, scale=scale)
    plain = lambda: F.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=True, scale=scale)
    times = {"fwd_ms": [], "bwd_ms": [], "plain_bwd_ms": []}
    for name, fn in (("plain_bwd_ms", plain), ("bwd_ms", bwd),
                     ("fwd_ms", fwd), ("fwd_ms", fwd), ("bwd_ms", bwd),
                     ("plain_bwd_ms", plain)):
        slow = name == "plain_bwd_ms"
        times[name].append(time_ms(fn, iters=3 if slow else 20,
                                   warmup=1 if slow else 3))
    pairs = B * H * L * (L + 1) / 2
    peak = hw()["peak_flops_bf16"]
    bound = {"fwd_ms": 2 * (D + DV) * pairs / peak * 1e3,
             "bwd_ms": 2 * (3 * D + 2 * DV) * pairs / peak * 1e3}
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return {"phase": "train_mla", "layers": cfg.n_layers,
            "clients": args.clients, "batch": args.batch, "seq": args.seq,
            "t0": args.t0, "rounds": MLA_ROUNDS, "round_ms": walls,
            "losses": losses, "peak_gb": peak_gb, "launches": launches,
            "shape": {"B": B, "L": L, "H": H, "D": D, "DV": DV,
                      "causal": True, "scale": scale},
            "fwd_ms": min(times["fwd_ms"]), "bwd_ms": min(times["bwd_ms"]),
            "plain_bwd_ms": min(times["plain_bwd_ms"]), "all_ms": times,
            "bound_ms": bound, "bound_by": "operations",
            "share_of_bound": {n: bound[n] / min(times[n]) for n in bound}}


def phase_train_zoo() -> tuple[dict, dict]:
    """The TRAIN_ZOO archs trained at full width on 2 bf16 clients, one at
    a time, each consensus then served; returns (launches summed over
    them, the line)."""
    import torch
    total, lines = {}, {}
    for arch in TRAIN_ZOO:
        path, line, trainer, mean = _train_zoo_arch(arch)
        cfg = trainer.model.cfg
        if cfg.family == "encdec":
            served, line["serve"] = _serve_trained_encdec(
                cfg, trainer.model, mean)
        elif cfg.family == "ssm":
            served, line["serve_ckpt"] = _serve_ckpt(
                cfg, trainer.model, mean, line["steps"] // line["t0"])
        else:
            served, line["serve"] = _serve_trained(cfg, trainer.model, mean)
        del trainer, mean
        torch.cuda.empty_cache()
        for k in path:
            total[k] = total.get(k, 0) + path[k] + served[k]
        lines[arch] = line
    return total, {"phase": "train_zoo", "launches": total, **lines}


def phase_train_zoo_card_vs_cpu() -> tuple[dict, dict]:
    """The TRAIN_ZOO_CPU_ARCHS reduced, fp32: 2 rounds from one state on
    the card (kernels) and on the CPU (plain versions), x / y / nu / g
    within CPU_ATOL / CPU_RTOL and the losses within CPU_RTOL; then the
    hybrid's and the enc-dec's consensus through a checkpoint on the
    card, restored bit for bit."""
    import copy
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.launch import train
    from repro_torch.training import save_checkpoint

    out, total = {}, {}
    for arch in TRAIN_ZOO_CPU_ARCHS:
        args = train.parse_args(["--arch", arch] + TRAIN_ZOO_CPU)
        runs = {}
        for dev in ("cpu", "cuda"):
            args.device = dev
            trainer, cfg, _, it = train.build(args)
            rng = np.random.default_rng(6)
            it = _with_extras(it, cfg, TRAIN_ZOO_CPU_FRAMES,
                              lambda shape, dev=dev: torch.from_numpy(
                                  rng.standard_normal(shape).astype(
                                      np.float32)).to(dev))
            if dev == "cpu":
                start, _ = trainer.model.init(args.seed)
            state = trainer.state_from_params(copy.deepcopy(start).to(dev))
            if dev == "cuda":
                reset_counts()
            state, hist = trainer.run(state, it, args.rounds)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_counts()
            runs[dev] = (trainer, state, [h["loss"] for h in hist])
        (_, cs, cl), (gtr, gs, gl) = runs["cpu"], runs["cuda"]
        diff = {}
        for f in ("x", "y", "nu", "g"):
            a, b = getattr(gs, f), getattr(cs, f)
            for k in a:
                torch.testing.assert_close(
                    a[k].cpu(), b[k], atol=CPU_ATOL, rtol=CPU_RTOL,
                    msg=lambda m: f"{arch} {f}/{k}: {m}")
            diff[f] = max(float((a[k].cpu() - b[k]).abs().max()) for k in a)
        torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl),
                                   atol=0, rtol=CPU_RTOL)
        steps = int(gs.t) * -(-len(gs.x) // K.MAX_LEAVES)
        expect_counts(f"train_zoo_card_vs_cpu {arch}", launches, {
            "fused_update_sweep": steps, "fused_tracking_sweep": steps})
        line = {"leaves": len(gs.x), "launches": launches,
                "max_abs_diff": diff, "losses_card": gl, "losses_cpu": cl}
        if cfg.family in ("hybrid", "encdec"):
            mean = gtr.mean_params(gs)
            with tempfile.TemporaryDirectory() as tmp:
                ck = str(Path(tmp) / "consensus.npz")
                save_checkpoint(ck, mean, step=args.rounds)
                _assert_restores(f"train_zoo_card_vs_cpu {arch}", ck, mean)
            line["ckpt_round_trip_bit_equal"] = True
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        out[arch] = line
    return total, {"phase": "train_zoo_card_vs_cpu", "atol": CPU_ATOL,
                   "rtol": CPU_RTOL, "launches": total, **out}


def _x_rel(a: dict, b: dict) -> float:
    """Relative L2 of a whole x tree (a on the card, b anywhere)."""
    import torch
    num = sum(float(torch.sum((a[k].double().cpu() - b[k].double().cpu())
                              ** 2)) for k in a)
    den = sum(float(torch.sum(b[k].double().cpu() ** 2)) for k in a)
    return (num / den) ** 0.5


def phase_table3() -> tuple[dict, dict]:
    """Table III at its published constants through ``figures.table3_run``
    on the card, DEPOSITUM OPTION I with ``fused="require"``: each sweep
    kernel launches 3 partitions x 30 rounds x T0 5 = 450 times (one
    grouped launch a step for the three seeds; OPTION II runs unfused).
    Then, counted apart, ``sweep_vs_sequential`` of one DEPOSITUM and one
    FedDR cell (Dir(0.1)) timed in turns, and both cells on the CPU
    against the card from the same weights and batches."""
    import torch
    from repro_torch import figures as F

    reset_counts()
    rows, wall = _timed(lambda: F.table3_run(device="cuda",
                                             fused="require"))
    want = len(F.T3_PARTITIONS) * F.T3_ROUNDS * F.T3_T0
    launches = _sweep_counts("table3", want)
    check = F.table3_check(rows)
    theta = F.T3_PARTITIONS["Dir(0.1)"]
    timing, seq_launches = {}, {}
    for alg in ("depositum-I", "feddr"):
        walls = {"sweep_s": [], "sequential_s": []}
        for turn in range(T3_TIMING_PAIRS):
            order = (("sequential_s", True), ("sweep_s", False))
            for key, seq in (order if turn % 2 == 0 else order[::-1]):
                reset_counts()
                cell = F.table3_cell(alg, theta, sequential=seq,
                                     device="cuda", fused="require")
                walls[key].append(cell["wall_s"])
                n = read_counts()["fused_update_sweep"]
                seq_launches[f"{alg} {key}"] = n
        timing[alg] = {**walls, "sweep_vs_sequential": [
            q / w for q, w in zip(walls["sequential_s"], walls["sweep_s"])]}
    dep_steps = F.T3_ROUNDS * F.T3_T0
    if seq_launches != {"depositum-I sequential_s": 3 * dep_steps,
                        "depositum-I sweep_s": dep_steps,
                        "feddr sequential_s": 0, "feddr sweep_s": 0}:
        raise AssertionError(f"table3 timing launches {seq_launches}")
    cpu_vs_card = {}
    for alg, limit in T3_CPU_REL.items():
        card = F.table3_cell(alg, theta, device="cuda", fused="require")
        cpu = F.table3_cell(alg, theta, device="cpu", fused="require")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = F.table3_cell(alg, theta, device="cuda",
                                    fused="require")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        for k, v in card["x"].items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"table3 {alg}: x.{k} not finite")
        cpu_vs_card[alg] = {
            "x_rel_l2": _x_rel(card["x"], cpu["x"]), "limit": limit,
            "tf32_control_x_rel_l2": _x_rel(control["x"], cpu["x"]),
            "accs_card": card["accs"], "accs_cpu": cpu["accs"]}
    for alg, tie in cpu_vs_card.items():
        if not tie["x_rel_l2"] <= tie["limit"] < tie["tf32_control_x_rel_l2"]:
            raise AssertionError(f"table3 {alg}: card vs CPU x, sound and "
                                 f"control readings against the limit: "
                                 f"{cpu_vs_card}")
    return launches, {
        "phase": "table3", "seconds": wall, "launches": launches,
        "want_launches": want,
        "rows": [{k: v for k, v in r.items() if not k.startswith("_")
                  or k.endswith("_mean")} for r in rows],
        "cell_wall_s": {r["partition"]: {a: r[f"_{a}_wall_s"]
                                         for a in F.T3_ALGS} for r in rows},
        "check": check, "sweep_vs_sequential": timing,
        "timing_launches": seq_launches, "card_vs_cpu": cpu_vs_card}


def _phase_fig(name: str, run, check) -> tuple[dict, dict]:
    """One of Figs. 5 / 7 at its published constants through
    ``run_depositum_grid`` (four static groups, ``FIG_GROUP_ITERS`` steps
    each), ``fused="require"``: 4 x 400 launches of each sweep kernel."""
    import math
    reset_counts()
    rows, wall = _timed(lambda: run(FIG_GROUP_ITERS, device="cuda",
                                    fused="require"))
    launches = _sweep_counts(name, len(rows) * FIG_GROUP_ITERS)
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("final_loss", "final_acc")):
            raise AssertionError(f"{name}: non-finite row {r}")
    return launches, {
        "phase": name, "seconds": wall, "launches": launches,
        "groups": len({r["sweep_group_id"] for r in rows}),
        "group_wall_s": [r["sweep_group_wall_s"] for r in rows],
        "rows": [{k: v for k, v in r.items() if k != "curves"}
                 for r in rows], "check": check(rows)}


def phase_fig5() -> tuple[dict, dict]:
    from repro_torch import figures as F
    return _phase_fig("fig5", F.fig5_run, F.fig5_check)


def phase_fig7() -> tuple[dict, dict]:
    from repro_torch import figures as F
    return _phase_fig("fig7", F.fig7_run, F.fig7_check)


def phase_telemetry() -> tuple[dict, dict]:
    """The Fig. 6 sweep (S = 4, FIG6_ROUNDS rounds, ``fused="require"``)
    with ``Telemetry.jsonl`` recording every round: the final state bit
    for bit the unrecorded run's; four streams of FIG6_ROUNDS rows whose
    JSONL passes ``validate_jsonl``; ``wire_bytes`` equal to
    ``analysis/comm.py``; the buffer copied to the host ceil(rounds / B)
    times (each copy flushes all four streams); 800 launches of each sweep
    kernel; round walls on and off in turns.  Then the reduced fp32
    trainer with ``telemetry=True`` against off, bit for bit."""
    import copy
    import math
    import torch
    from repro_torch.analysis.comm import round_wire_bytes
    from repro_torch.figures import fig6_configs
    from repro_torch.launch import train
    from repro_torch.obs.metrics import MetricSpec
    from repro_torch.obs.record import Telemetry
    from repro_torch.obs.sinks import validate_jsonl
    from repro_torch.quickstart import grid_operands
    from repro_torch.training.sweep import sweep_run

    cfgs = fig6_configs(FIG6_ROUNDS, fused="require")
    g = grid_operands(cfgs, device="cuda")
    dep, S, C = cfgs[0].depositum, len(cfgs), cfgs[0].n_clients
    spec = MetricSpec(buffer=TELEMETRY_BUFFER)
    path = ROOT / "chiprun_out" / "telemetry_fig6.jsonl"
    if path.exists():
        path.unlink()

    def run(tel=None):
        return sweep_run(g.params0, g.prepared.grad_fn, dep, g.plan,
                         g.hypers, g.batches, n_clients=C, telemetry=tel)[0]

    off = run()                                   # also the warm-up
    tel = Telemetry.jsonl(str(path), spec)
    reset_counts()
    on, wall_on = _timed(lambda: run(tel))
    launches = _sweep_counts("telemetry", FIG6_ROUNDS * dep.comm_period)
    tel.close()
    for f in ("x", "y", "nu", "mu", "g"):
        for k, v in getattr(on, f).items():
            if not bits_equal(v, getattr(off, f)[k]):
                raise AssertionError(f"telemetry: {f}.{k} on != off")
    rows = list(range(1, FIG6_ROUNDS + 1))
    sink = tel.memory_sink
    if sink.configs() != list(range(S)) or any(
            sink.rounds(s) != rows for s in range(S)):
        raise AssertionError("telemetry: streams are not 4 x 40 rows")
    n_events = validate_jsonl(str(path), spec.names)
    if n_events != S * FIG6_ROUNDS:
        raise AssertionError(f"telemetry: {n_events} JSONL events")
    d = sum(v[0, 0].numel() for v in on.x.values())
    wire = {}
    for s in range(S):
        want = float(round_wire_bytes(g.plan.point(s), d, n=C))
        got = set(sink.stream("wire_bytes", s))
        if got != {want}:
            raise AssertionError(f"telemetry: wire_bytes {got} != {want}")
        wire[cfgs[s].topology] = want
    want_copies = math.ceil(FIG6_ROUNDS / TELEMETRY_BUFFER)
    if tel.host_copies != want_copies:
        raise AssertionError(f"telemetry: {tel.host_copies} host copies, "
                             f"want {want_copies}")
    walls = {"on_s": [wall_on], "off_s": []}
    for turn in range(TELEMETRY_TIMING_PAIRS):
        order = (("off_s", None), ("on_s", True))
        for key, on_flag in (order if turn % 2 == 0 else order[::-1]):
            if key == "on_s" and len(walls["on_s"]) >= TELEMETRY_TIMING_PAIRS:
                continue
            t = Telemetry(spec) if on_flag else None
            walls[key].append(_timed(lambda: run(t))[1])
    round_ms = {k: [w / FIG6_ROUNDS * 1e3 for w in v]
                for k, v in walls.items()}
    last = {n: sink.stream(n, 0)[-1] for n in spec.names}

    # the reduced fp32 trainer, recorded and not, from one state
    args = train.parse_args(TRAIN_REDUCED)
    states, trainers = {}, {}
    start = None
    reset_counts()
    for flag in (False, True):
        trainer, _, _, it = train.build(args)
        if start is None:
            module, _ = trainer.model.init(args.seed)
            start = copy.deepcopy(module)
        if flag:
            trainer.telemetry = Telemetry.memory()
        state = trainer.state_from_params(copy.deepcopy(start).to("cuda"))
        states[flag], hist = trainer.run(state, it, args.rounds)
        trainers[flag] = (trainer, hist)
    torch.cuda.synchronize()
    trainer_launches = read_counts()
    steps = 2 * args.rounds * args.t0
    expect_counts("telemetry trainer", trainer_launches, {
        "fused_update_sweep": steps, "fused_tracking_sweep": steps})
    for f in ("x", "y", "nu", "mu", "g"):
        for k, v in getattr(states[True], f).items():
            if not bits_equal(v, getattr(states[False], f)[k]):
                raise AssertionError(f"telemetry trainer: {f}.{k} on != off")
    tr_on, hist_on = trainers[True]
    events = tr_on.telemetry.events(0)
    if [e["round"] for e in events] != [h["round"] for h in hist_on] \
            or "consensus_x" not in hist_on[-1]:
        raise AssertionError(f"telemetry trainer: events {events}")
    total = {k: launches[k] + trainer_launches[k] for k in launches
             if k != "gated"}
    return total, {
        "phase": "telemetry", "configs": S, "rounds": FIG6_ROUNDS,
        "log_every": 1, "buffer": TELEMETRY_BUFFER, "launches": launches,
        "events": n_events, "host_copies": tel.host_copies,
        "want_host_copies": want_copies, "wire_bytes": wire,
        "final_round_config0": last, "jsonl": str(path.relative_to(ROOT)),
        "round_ms": round_ms,
        "overhead": [a / b - 1.0 for a, b in zip(round_ms["on_s"],
                                                 round_ms["off_s"])],
        "trainer": {"rounds": args.rounds, "launches": trainer_launches,
                    "events": len(events),
                    "consensus_x_last": hist_on[-1]["consensus_x"],
                    "host_copies": tr_on.telemetry.host_copies}}


TREES = ("x", "y", "nu", "mu", "g")


def _async_checks(path, events, state, init, dead, tau) -> dict:
    """The async invariants of one run: bounded staleness and exactly-once
    applies over its event log, every tick there, the dead clients never
    applied and their rows of every tree bit for bit ``init``'s, every
    tree finite.  Returns the run's replayed cohorts and staleness."""
    import torch
    from repro_torch.core import (check_bounded_staleness, replay_cohorts,
                                  replay_staleness)
    check_bounded_staleness(events, tau)
    ticks = [e["round"] for e in events if e["type"] == "tick"]
    cohorts = replay_cohorts(events)
    if ticks != list(range(len(cohorts))):
        raise AssertionError(f"{path}: ticks {ticks}")
    if any(c in cohort for cohort in cohorts for c in dead):
        raise AssertionError(f"{path}: a dead client {dead} was applied")
    for f in TREES:
        for k, v in getattr(state, f).items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{path}: {f}.{k} not finite")
            for c in dead:
                if not torch.equal(v[c], getattr(init, f)[k][c]):
                    raise AssertionError(f"{path}: dead client {c} moved "
                                         f"in {f}.{k}")
    return {"cohort_sizes": [len(c) for c in cohorts],
            "staleness": replay_staleness(events),
            "applies": sum(e["type"] == "apply" for e in events),
            "rejects": sum(e["type"] == "reject" for e in events),
            "drops": sum(e["type"] == "drop" for e in events)}


def _copy_state(state):
    return state._replace(**{f: {k: v.clone() for k, v in
                                 getattr(state, f).items()} for f in TREES})


def phase_async_throughput() -> tuple[dict, dict]:
    """``figures.py --fig async`` at its full size on the card with
    ``fused="require"`` (one leaf: one launch of each sweep kernel a step;
    24 rounds x T0 2 a run, five runs, the four async ones gated): the
    exponential ratio at least the reference's headline, tau 0 with zero
    delay ``torch.equal`` to the synchronous trainer, and every row's
    virtual times and event log equal to the same code's on the CPU."""
    from repro_torch import figures as F

    reset_counts()
    rows, wall = _timed(lambda: F.async_run(F.ASYNC_ROUNDS, device="cuda",
                                            fused="require"))
    steps = F.ASYNC_ROUNDS * F.ASYNC_T0
    launches = _sweep_counts("async_throughput", 5 * steps, gated=4 * steps)
    check = F.async_check(rows)
    cpu = F.async_run(F.ASYNC_ROUNDS, device="cpu", fused="require")
    keys = ("distribution", "async_virtual_time", "sync_virtual_time",
            "events")
    same = [all(a.get(k) == b.get(k) for k in keys)
            for a, b in zip(rows, cpu)]
    if not (check["zero_sync_equal"] and check["headline_met"]
            and len(rows) == len(cpu) == 4 and all(same)):
        raise AssertionError(f"async_throughput: check {check}, card = CPU "
                             f"{same}")
    return launches, {
        "phase": "async_throughput", "seconds": wall, "launches": launches,
        "rows": [{k: v for k, v in r.items() if k != "events"}
                 for r in rows],
        "check": check, "card_equals_cpu": same}


def _async_mlp_setup(device: str):
    """(trainer, initial state, batch_fn) of the async MLP cell: the Fig. 4
    Polyak point (``quickstart.mlp_config``: MLP 123 -> 64 -> 32 -> 10, 10
    clients on a ring, batch 32, T0 10, MCP) through
    ``classification_batch_iterator`` and ``tabulate_batches``, under
    exponential(1.0) stragglers with drops and duplicates at 0.05 and
    client 3 dead, tau 2, downweight 0.5, telemetry on."""
    from repro_torch.core import StragglerModel
    from repro_torch.data import make_classification
    from repro_torch.models.classifier import MODELS, ce_loss, init_params
    from repro_torch.models.registry import Model
    from repro_torch.obs import Telemetry
    from repro_torch.quickstart import mlp_config
    from repro_torch.training import (AsyncConfig, AsyncTrainer,
                                      TrainerConfig,
                                      classification_batch_iterator,
                                      tabulate_batches)

    ec = mlp_config(ASYNC_MLP_ROUNDS, fused="require")
    ds = make_classification(
        n_samples=ec.n_samples, n_features=ec.n_features,
        n_classes=ec.n_classes, n_clients=ec.n_clients, theta=ec.theta,
        seed=ec.seed)
    net = MODELS["mlp"](ec.n_features, ec.n_classes, ec.hidden).to(device)
    model = Model(
        cfg=None, init=lambda seed: (init_params(net, seed, device=device),
                                     None),
        forward_train=None, loss=lambda p, b: (ce_loss(net, p, b), {}),
        forward_decode=None, init_decode_cache=None)
    tcfg = TrainerConfig(n_clients=ec.n_clients, topology=ec.topology,
                         depositum=ec.depositum, log_every=1)
    sm = StragglerModel.exponential(1.0, ec.n_clients, seed=0).with_faults(
        p_drop=0.05, p_dup=0.05, dead=(3,))
    tr = AsyncTrainer(model, tcfg, straggler=sm,
                      async_cfg=AsyncConfig(tau=2, mode="downweight",
                                            decay=0.5),
                      telemetry=Telemetry.memory(), device=device)
    bf = tabulate_batches(classification_batch_iterator(
        ds, tcfg, ec.batch, seed=ec.seed, device=device), ASYNC_MLP_ROUNDS)
    return tr, tr.init_state(ec.seed), bf


def phase_async_mlp() -> tuple[dict, dict]:
    """The async MLP cell (``_async_mlp_setup``) on the card, twice, and
    once more with TF32 matmuls, every round through the gated sweep
    kernels (10 launches each a round, all gated; the path's launches
    are the two sound runs', the control's are counted apart): bounded
    staleness, client 3's rows bit for bit, the recorded ``staleness``
    stream equal to ``replay_staleness`` of the log; the second run's
    events and state
    equal to the first's (replay determinism); the same cell on the CPU
    with the same event log and virtual time, x within
    ``ASYNC_MLP_CPU_REL``, which the TF32 run must miss."""
    import numpy as np
    import torch
    from repro_torch.core import replay_staleness

    runs = []
    reset_counts()
    for tf32 in (False, False, True):
        if tf32:
            # the path's launches are the two sound runs'; the TF32
            # control's are counted apart
            T0 = runs[0][0].cfg.depositum.comm_period
            want = len(runs) * ASYNC_MLP_ROUNDS * T0
            launches = _sweep_counts("async_mlp", want, gated=want)
            reset_counts()
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            tr, state0, bf = _async_mlp_setup("cuda")
            init = _copy_state(state0)
            (state, hist), wall = _timed(
                lambda: tr.run(state0, bf, ASYNC_MLP_ROUNDS))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        runs.append((tr, state, hist, wall, init))
    want = ASYNC_MLP_ROUNDS * T0
    control_launches = _sweep_counts("async_mlp TF32 control", want,
                                     gated=want)
    tr, state, hist, wall, init = runs[0]
    summary = _async_checks("async_mlp", tr.events, state, init, (3,), 2)
    recorded = tr.telemetry.stream("staleness")
    replayed = replay_staleness(tr.events)
    if [np.float32(v) for v in recorded] != [np.float32(v)
                                             for v in replayed]:
        raise AssertionError(f"async_mlp: recorded staleness {recorded}, "
                             f"replayed {replayed}")
    if not any(v > 0 for v in replayed):
        raise AssertionError("async_mlp: no stale apply; vacuous")
    tr2, state2 = runs[1][0], runs[1][1]
    replay_equal = tr2.events == tr.events and all(
        torch.equal(v, getattr(state2, f)[k]) for f in TREES
        for k, v in getattr(state, f).items())
    tr_cpu, s0, bf = _async_mlp_setup("cpu")
    cpu, _ = tr_cpu.run(s0, bf, ASYNC_MLP_ROUNDS)
    rel = _x_rel(state.x, cpu.x)
    control = _x_rel(runs[2][1].x, cpu.x)
    losses = [h["loss"] for h in hist]
    if not (replay_equal and tr_cpu.events == tr.events
            and tr_cpu.virtual_time == tr.virtual_time
            and all(np.isfinite(losses))):
        raise AssertionError(f"async_mlp: replay {replay_equal}, card = CPU "
                             f"events {tr_cpu.events == tr.events}, "
                             f"losses {losses}")
    if ASYNC_MLP_CPU_REL is None or not rel <= ASYNC_MLP_CPU_REL < control:
        raise AssertionError(f"async_mlp: card vs CPU x {rel}, TF32 control "
                             f"{control}, limit {ASYNC_MLP_CPU_REL}")
    return launches, {
        "phase": "async_mlp", "rounds": ASYNC_MLP_ROUNDS,
        "run_s": [r[3] for r in runs], "launches": launches,
        "tf32_control_launches": control_launches,
        "virtual_time": tr.virtual_time, **summary,
        "recorded_staleness": recorded, "losses": losses,
        "replay_equal": replay_equal, "card_vs_cpu_x_rel": rel,
        "tf32_control_x_rel": control, "limit": ASYNC_MLP_CPU_REL}


def _row_prints(state, rows) -> dict:
    """A fingerprint of each client row of every leaf: the int64 sum of
    the row's raw 16-bit words (any change of one element's bits changes
    it)."""
    import torch
    return {(f, k, c): int(v[c].reshape(-1).view(torch.int16).to(
        torch.int32).sum(dtype=torch.int64))
        for f in TREES for k, v in getattr(state, f).items() for c in rows}


def phase_async_llm(trainer, state, it, args, base) -> tuple:
    """``AsyncTrainer`` on ``train_llm``'s model, config and state
    (full-width Qwen3-1.7B, 2 bf16 clients, T0 4): exponential(1.0)
    stragglers, tau 1, downweight; one warm-up and ``ASYNC_LLM_ROUNDS``
    timed learner rounds in one donated run, every step through the gated
    sweep pair (7 launches each a step).  Each round's wall (synchronised)
    and cohort, the caching allocator's work in it; a client left out of
    a round keeps its rows of all five trees (their fingerprints,
    ``_row_prints``); losses finite; the peak memory beside
    ``ASYNC_LLM_PEAK_GB``.  Then, counted apart, the gated sweep pair at
    these leaves against the ungated one (ms, bound).  Returns (launches,
    line, state)."""
    import dataclasses
    import math

    import torch
    from repro_torch.core import StragglerModel
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.kernels.prox.ops import (fused_local_update,
                                              fused_tracking,
                                              hyper_param_vec)
    from repro_torch.training import (AsyncConfig, AsyncTrainer,
                                      tabulate_batches)

    n, T0 = args.clients, args.t0
    rounds = 1 + ASYNC_LLM_ROUNDS
    cfg = dataclasses.replace(trainer.cfg, depositum=dataclasses.replace(
        trainer.cfg.depositum, fused="require"))
    atr = AsyncTrainer(trainer.model, cfg,
                       straggler=StragglerModel.exponential(1.0, n, seed=0),
                       async_cfg=AsyncConfig(tau=1, mode="downweight"),
                       device="cuda")
    # the synchronous trainer's template (the module on meta) and its
    # gradients: a second state_from_params would hold another state
    atr._template, atr._grad_fn = trainer._template, trainer._grad_fn
    bf = tabulate_batches(it, rounds)
    record = []
    apply_cohort = atr._apply_cohort

    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free")

    def observed(st, carry, cohort, batch_fn, force, hp=None,
                 donate=False):
        frozen = [c for c in range(n) if c not in cohort]
        before = _row_prints(st, frozen)
        torch.cuda.synchronize()
        stats0 = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        out = apply_cohort(st, carry, cohort, batch_fn, force, hp, donate)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        stats1 = torch.cuda.memory_stats()
        loss = out[1].get("ce", out[1].get("loss"))
        record.append({"cohort": sorted(cohort), "round_ms": wall,
                       "staleness": out[3],
                       "loss": float(torch.mean(loss.float())),
                       "allocator": {k: stats1.get(k, 0) - stats0.get(k, 0)
                                     for k in alloc_keys},
                       "frozen_kept": _row_prints(out[0], frozen) == before})
        return out

    atr._apply_cohort = observed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, _ = atr.run(state, bf, rounds, donate=True)
    torch.cuda.synchronize()
    peak_gb = _gb(torch.cuda.max_memory_allocated() - base)
    per_step = -(-len(state.x) // K.MAX_LEAVES)
    want = per_step * T0 * rounds
    launches = _sweep_counts("async_llm", want, gated=want)
    losses = [r["loss"] for r in record]
    if not all(math.isfinite(v) for v in losses) or not all(
            r["frozen_kept"] for r in record) or len(record) != rounds:
        raise AssertionError(f"async_llm: losses {losses}, rounds {record}")
    tokens = [len(r["cohort"]) * args.batch * args.seq * T0 for r in record]
    timed = record[1:]

    # the gated pair at these leaves (the weights of rounds 1-3: client 1
    # frozen) against the ungated one, in turns: one step's two grouped
    # calls by CUDA events, the state in place; each against the trees it
    # moves (kernel.sweep_trees: 4.5 gated at [1, 0])
    hp = hyper_param_vec(cfg.depositum.hyper(), device="cuda")
    gate = torch.tensor([1.0, 0.0], device="cuda")
    tree_bytes = sum(v.numel() * v.element_size() for v in state.x.values())
    fns = {"fused_update_sweep": lambda m: fused_local_update(
               state.x, state.y, state.nu, hp, m, kind="l1"),
           "fused_tracking_sweep": lambda m: fused_tracking(
               state.y, state.g, state.nu, hp, m)}
    live = float((gate > 0).float().mean())
    trees = {(name, gated): K.sweep_trees(name == "fused_update_sweep",
                                          live if gated else None)
             for name in fns for gated in (False, True)}
    sweep = {}
    for name, fn in fns.items():
        for gated in (False, True, True, False):
            key = f"{name} {'gated' if gated else 'ungated'}"
            ms = time_ms(lambda: fn(gate if gated else None), iters=5,
                         warmup=1)
            bound = (trees[name, gated] * tree_bytes
                     / hw()["hbm_bandwidth"] * 1e3)
            sweep.setdefault(key, {"ms": [], "bound_ms": bound,
                                   "trees": trees[name, gated]})["ms"].append(
                ms)
            torch.cuda.empty_cache()
    for t in sweep.values():
        t["share_of_bound"] = t["bound_ms"] / min(t["ms"])
    return launches, {
        "phase": "async_llm", "clients": n, "t0": T0, "tau": 1,
        "mode": "downweight", "warmup_round_ms": record[0]["round_ms"],
        "round_ms": [r["round_ms"] for r in timed],
        "applied_tokens_per_s": [t / r["round_ms"] * 1e3
                                 for t, r in zip(tokens[1:], timed)],
        "cohorts": [r["cohort"] for r in record],
        "staleness": [r["staleness"] for r in record],
        "events": [{k: e[k] for k in ("type", "round", "client",
                                      "work_round")} | (
                   {"weight": e["weight"]} if "weight" in e else {})
                   for e in atr.events if e["type"] in ("apply", "reject")],
        "frozen_rows_kept": [r["frozen_kept"] for r in record],
        "allocator": [r["allocator"] for r in record],
        "losses": losses, "peak_gb": peak_gb, "sweep_step": sweep,
        "predicted_peak_gb": list(ASYNC_LLM_PEAK_GB),
        "launches": launches, "launches_per_step": per_step}, state


def phase_async_threaded() -> tuple[dict, dict]:
    """``run_threaded`` on the async figure's problem (least squares, 8
    clients, d 512, T0 2) under its exponential stragglers with client 5
    dead, tau 2, ``deadline_s`` ``ASYNC_THREADED_DEADLINE_S``: every tick
    there, bounded staleness, client 5 never applied and its rows
    unchanged; the actors only sleep and post, every launch (one gated
    launch of each sweep kernel a step) on this thread."""
    from repro_torch import figures as F
    from repro_torch.training import (AsyncConfig, AsyncTrainer,
                                      tabulate_batches)

    R = F.ASYNC_ROUNDS
    model, cfg, batches = F.async_problem(R, device="cuda", fused="require")
    sm = F.async_distributions()["exponential"].with_faults(dead=(5,))
    tr = AsyncTrainer(model, cfg, straggler=sm,
                      async_cfg=AsyncConfig(tau=F.ASYNC_TAU), device="cuda")
    state0 = tr.init_state(0)
    init = _copy_state(state0)
    reset_counts()
    (state, events), wall = _timed(lambda: tr.run_threaded(
        state0, tabulate_batches(iter(batches), R), R,
        deadline_s=ASYNC_THREADED_DEADLINE_S))
    launches = _sweep_counts("async_threaded", R * F.ASYNC_T0,
                             gated=R * F.ASYNC_T0)
    summary = _async_checks("async_threaded", events, state, init, (5,),
                            F.ASYNC_TAU)
    if len(summary["cohort_sizes"]) != R:
        raise AssertionError(f"async_threaded: {summary}")
    return launches, {"phase": "async_threaded", "seconds": wall,
                      "deadline_s": ASYNC_THREADED_DEADLINE_S,
                      "launches": launches, **summary}


def _nccl_group():
    """A world-size-1 NCCL process group on this card, initialised in this
    process from a FileStore in a fresh directory; returns the directory
    (the caller destroys the group and removes it)."""
    import tempfile
    import torch
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group(
        DIST_BACKEND, store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1,
        **({"device_id": torch.device("cuda", 0)}
           if DIST_BACKEND == "nccl" else {}))
    return tmp


def _dist_mlp(mesh) -> tuple[dict, dict]:
    """The Fig. 4 MLP's rounds under five plans through ``ShardMapBackend``
    (a one-rank group holding all ten clients), then through
    ``StackedVmapBackend``: round walls, launches, states held against
    each other."""
    import torch
    from repro_torch.core import (CohortSampler, CompressionSpec, MixPlan,
                                  MixSchedule, as_schedule,
                                  local_then_comm_round)
    from repro_torch.quickstart import mlp_config, prepare
    from repro_torch.training.backends import StackedVmapBackend, get_backend

    cfg = mlp_config(DIST_MLP_ROUNDS, fused="require")
    dep, C = cfg.depositum, cfg.n_clients
    p = prepare(cfg, device="cuda")
    W = MixPlan.dense(p.W, device="cuda")
    topk = CompressionSpec.topk(0.1, wire_k=DIST_TOPK_WIRE_K, device="cuda")
    plans = {
        "dense_ring": W,
        "complete": MixPlan.complete(),
        "chebyshev": MixPlan.chebyshev(W, 2),
        "cohort": MixSchedule.cohort(W, CohortSampler.bernoulli(
            0.7, C, seed=3, device="cuda")),
        "topk_0.1_wire": as_schedule(W).with_compression(topk),
    }
    shard = get_backend("shard_map", mesh=mesh, n_clients=C)
    stacked = StackedVmapBackend()
    out, launches = {}, {"fused_update_sweep": 0, "fused_tracking_sweep": 0}
    T0 = dep.comm_period
    # one untimed round: the group's first collectives warm up here
    local_then_comm_round(prepare(cfg, device="cuda").state, p.batches(0),
                          p.grad_fn, dep, shard.mixer_for(W))
    for name, plan in plans.items():
        comp = plan.compress if isinstance(plan, MixSchedule) else None
        runs = {}
        for turn in ("shard", "stacked"):
            be = shard if turn == "shard" else stacked
            mixer = be.mixer_for(plan)
            if name == "topk_0.1_wire" and turn == "shard" \
                    and mixer.wire_fn is None:
                raise AssertionError("distributed: top-k gets no wire_fn")
            state = prepare(cfg, compress=comp, device="cuda").state
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in range(DIST_MLP_ROUNDS):
                state, _ = local_then_comm_round(state, p.batches(r),
                                                 p.grad_fn, dep, mixer)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / DIST_MLP_ROUNDS
            got = read_counts()
            expect_counts(f"distributed {name} {turn}", got, {
                "fused_update_sweep": DIST_MLP_ROUNDS * T0,
                "fused_tracking_sweep": DIST_MLP_ROUNDS * T0})
            for k in launches:
                launches[k] += got[k]
            runs[turn] = {"state": state, "round_ms": [wall]}
        a, b = runs["shard"]["state"], runs["stacked"]["state"]
        rel = max(max(v.values()) for v in _rel_l2(a, b).values())
        bits = all(bits_equal(v, getattr(b, f)[k]) for f in
                   ("x", "y", "nu", "g") for k, v in getattr(a, f).items())
        if not bits:
            raise AssertionError(f"distributed {name}: shard vs stacked "
                                 f"not bit-equal (max rel L2 {rel})")
        if not all(torch.isfinite(v).all() for v in a.x.values()):
            raise AssertionError(f"distributed {name}: x not finite")
        out[name] = {"bit_equal": bits, "max_rel_l2": rel,
                     "round_ms_shard": runs["shard"]["round_ms"],
                     "round_ms_stacked": runs["stacked"]["round_ms"],
                     "wall_ratio": runs["shard"]["round_ms"][0]
                     / runs["stacked"]["round_ms"][0]}
    return launches, out


def _dist_fig6(mesh) -> tuple[dict, dict]:
    """The Fig. 6 S = 4 stacked-W sweep through the backend against the
    stacked sweep."""
    import torch
    from repro_torch.figures import fig6_configs
    from repro_torch.quickstart import grid_operands
    from repro_torch.training.backends import get_backend
    from repro_torch.training.sweep import sweep_run

    cfgs = fig6_configs(FIG6_ROUNDS, fused="require")
    g = grid_operands(cfgs, device="cuda")
    dep, C = cfgs[0].depositum, cfgs[0].n_clients
    be = get_backend("shard_map", mesh=mesh, n_clients=C)
    outs, walls = {}, {}
    launches = {"fused_update_sweep": 0, "fused_tracking_sweep": 0}
    for name, backend in (("shard", be), ("stacked", None)):
        reset_counts()
        st, wall = _timed(lambda: sweep_run(
            g.params0, g.prepared.grad_fn, dep, g.plan, g.hypers, g.batches,
            n_clients=C, backend=backend)[0])
        got = _sweep_counts(f"distributed fig6 {name}",
                            FIG6_ROUNDS * dep.comm_period)
        for k in launches:
            launches[k] += got[k]
        outs[name], walls[name] = st, wall
    rel = max(max(v.values()) for v in _rel_l2(outs["shard"],
                                                outs["stacked"]).values())
    bits = all(bits_equal(v, getattr(outs["stacked"], f)[k])
               for f in ("x", "y", "nu", "g")
               for k, v in getattr(outs["shard"], f).items())
    if not bits:
        raise AssertionError(f"distributed fig6: not bit-equal (max rel L2 "
                             f"{rel})")
    return launches, {"S": len(cfgs), "rounds": FIG6_ROUNDS,
                      "bit_equal": bits, "max_rel_l2": rel,
                      "wall_s": walls}


def _dist_llm(mesh) -> tuple[dict, dict]:
    """Full-width Qwen3-1.7B, 2 bf16 clients, the train_llm cell (complete
    plan, T0 4, B 2 x L 512): one warm-up and DIST_LLM_ROUNDS timed rounds
    through ``ShardMapBackend``, then the same through
    ``StackedVmapBackend`` from the same inputs; states held within
    ``BF16_REL``, walls, peaks, launches and the counted collective bytes
    against ``device_wire_bytes``."""
    import torch
    from repro_torch.analysis.comm import device_wire_bytes
    from repro_torch.analysis.hlo import counting, parse_collectives
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.launch import train
    from repro_torch.training.backends import StackedVmapBackend, get_backend

    args = train.parse_args(DIST_TRAIN)
    res, finals, x0 = {}, None, None
    launches = {"fused_update_sweep": 0, "fused_tracking_sweep": 0}
    for name in ("shard", "stacked"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if name == "shard":
            be = counting(get_backend("shard_map", mesh=mesh,
                                      n_clients=args.clients))
            counter = be.axis
        else:
            be, counter = StackedVmapBackend(), None
        trainer, cfg, state, it = train.build(args, backend=be)
        torch.cuda.synchronize()
        state_alloc = torch.cuda.memory_allocated() - base
        if x0 is None:
            x0 = {k: v[0].to("cpu") for k, v in state.x.items()}
        n_leaves = len(state.x)
        per_step = -(-n_leaves // K.MAX_LEAVES)
        reset_counts()
        state, hist = trainer.run(state, it, 1, donate=True)
        torch.cuda.synchronize()
        losses = [hist[-1]["loss"]]
        if counter is not None:
            counter.reset()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(DIST_LLM_ROUNDS):
            t0 = time.perf_counter()
            state, hist = trainer.run(state, it, 1, donate=True)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(hist[-1]["loss"])
        peak = torch.cuda.max_memory_allocated() - base
        got = read_counts()
        T0 = args.t0
        expect_counts(f"distributed llm {name}", got, {
            "fused_update_sweep": per_step * T0 * (1 + DIST_LLM_ROUNDS),
            "fused_tracking_sweep": per_step * T0 * (1 + DIST_LLM_ROUNDS)})
        for k in launches:
            launches[k] += got[k]
        if not all(l == l and abs(l) < float("inf") for l in losses):
            raise AssertionError(f"distributed llm {name}: loss {losses}")
        res[name] = {"round_ms": walls, "losses": losses,
                     "state_alloc_gb": _gb(state_alloc),
                     "peak_gb": _gb(peak), "launches_per_step": per_step}
        if counter is not None:
            d = sum(v[0].numel() for v in state.x.values())
            colls = parse_collectives(counter)
            res[name]["collectives_per_round"] = {
                k: {"count": v["count"] / DIST_LLM_ROUNDS,
                    "bytes": v["bytes"] / DIST_LLM_ROUNDS}
                for k, v in colls.items()}
            res[name]["device_wire_bytes"] = device_wire_bytes(
                trainer.plan, d, args.clients, be.axis.size)
        if name == "shard":
            # to the host: the stacked run needs the card's memory
            finals = {f: {k: v.to("cpu") for k, v in
                          getattr(state, f).items()}
                      for f in ("x", "y", "nu", "g")}
        else:
            rels, bits = _llm_rel(finals, state, x0)
        del trainer, state, it
    del finals
    if not bits:
        raise AssertionError(f"distributed llm: shard vs stacked not "
                             f"bit-equal (max rel L2 a leaf {rels})")
    for f, limit in BF16_REL.items():
        if not rels[f] <= limit:
            raise AssertionError(f"distributed llm: {f} rel {rels[f]} > "
                                 f"{limit}")
    return launches, {"arch": cfg.name, "clients": args.clients,
                      "topology": args.topology, "t0": args.t0,
                      "batch": args.batch, "seq": args.seq,
                      "rel_l2": rels, "bf16_rel": BF16_REL,
                      "bit_equal": bits, **res}


def _llm_rel(host: dict, state, x0: dict) -> tuple[dict, bool]:
    """The largest relative L2 of a leaf of a host state (the shard run's)
    against a state on the card (the stacked run's), a variable each, on
    the card (x as its move from ``x0``), and whether every leaf is
    bit-equal."""
    import torch
    rels, bits = {}, True
    for f, key in (("x", "dx"), ("y", "y"), ("nu", "nu"), ("g", "g")):
        rels[key] = 0.0
        for k, w in getattr(state, f).items():
            v = host[f][k].to(w.device)
            bits = bits and bits_equal(v, w)
            v, w = v.float(), w.float()
            if f == "x":
                x = x0[k].to(w.device).float()
                v, w = v - x, w - x
            num = float(torch.sum((v - w) ** 2))
            den = float(torch.sum(w ** 2))
            rels[key] = max(rels[key], (num / max(den, 1e-30)) ** 0.5)
            del v, w
    return rels, bits


def phase_distributed() -> tuple[dict, dict]:
    """The distributed backend on the card: a world-size-1 NCCL process
    group (FileStore, in this process), ``ShardMapBackend`` over it holding
    every client, against ``StackedVmapBackend``: the Fig. 4 MLP under
    five plans, the Fig. 6 S = 4 sweep, and full-width Qwen3-1.7B on 2
    bf16 clients.  The group is destroyed at the end."""
    import shutil
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_client_mesh

    tmp = _nccl_group()
    try:
        mesh = make_client_mesh()
        if dist.get_backend() != DIST_BACKEND or mesh.shape != {"clients": 1}:
            raise AssertionError(f"distributed: {dist.get_backend()} "
                                 f"{mesh.shape}")
        mlp_launches, mlp = _dist_mlp(mesh)
        fig6_launches, fig6 = _dist_fig6(mesh)
        llm_launches, llm = _dist_llm(mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: mlp_launches[k] + fig6_launches[k] + llm_launches[k]
                for k in mlp_launches}
    return launches, {"phase": "distributed", "backend": DIST_BACKEND,
                      "world_size": 1, "mlp": mlp, "fig6": fig6, "llm": llm,
                      "launches": launches}


def phase_dryrun(measured_state_gb: float, train_state_gb: float) -> dict:
    """What ``python -m repro_torch.launch.dryrun --arch all --mesh 1x1``
    reckons for every arch at full width on ``meta`` (a line each), and
    Qwen3-1.7B's state at 2 bf16 clients against the allocation measured
    for it (``phase_distributed``) and ``train_llm``'s state bytes."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rows = [dryrun.run_one(arch, "train_4k", mesh="1x1")
            for arch in list_archs()]
    for r in rows:
        emit({"phase": "dryrun_arch", **{k: r[k] for k in (
            "arch", "params", "dtype", "tree_bytes_per_client", "n_trees",
            "n_clients", "state_bytes_per_device",
            "clients_fit_per_device", "collective_bytes_per_device")},
            "dominant": r["roofline"]["dominant"],
            "step_lower_bound_s": r["roofline"]["step_lower_bound_s"]})
    if [r["arch"] for r in rows] != list_archs():
        raise AssertionError("dryrun: not every arch")
    q = dryrun.run_one("qwen3-1.7b", "train_4k", mesh="1x1", n_clients=2)
    pred_gb = _gb(q["state_bytes_per_device"])
    rel = {"measured_alloc": abs(pred_gb - measured_state_gb)
           / measured_state_gb,
           "train_llm_state": abs(pred_gb - train_state_gb) / train_state_gb}
    if not max(rel.values()) <= DRYRUN_REL:
        raise AssertionError(f"dryrun: {pred_gb} GB vs measured "
                             f"{measured_state_gb} / {train_state_gb}")
    if q["params"] != 2_032_264_192 or q["clients_fit_per_device"] != 2:
        raise AssertionError(f"dryrun qwen3: {q['params']} params, "
                             f"{q['clients_fit_per_device']} clients fit")
    return {"phase": "dryrun", "archs": len(rows), "mesh": "1x1",
            "qwen3_params": q["params"], "qwen3_state_gb": pred_gb,
            "measured_state_alloc_gb": measured_state_gb,
            "train_llm_state_gb": train_state_gb, "rel": rel,
            "rel_limit": DRYRUN_REL,
            "clients_fit": q["clients_fit_per_device"],
            "step_temp_gb_per_client": _gb(
                q["step_temp_bytes_per_device"] / 2),
            "seconds": time.perf_counter() - t0}


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found beside the "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    emit(phase_build())
    check = phase_check()
    emit(check)
    check_prox = phase_check_prox()
    emit(check_prox)
    check_flash = phase_check_flash()
    emit(check_flash)
    emit(phase_graph())
    emit(phase_graph_choco())
    state, launches, main_path = phase_main_path()
    emit(main_path)
    tree_launches, tree = phase_tree_path(state)
    emit(tree)
    sweep_launches = [launches]
    for phase in (phase_sweep_fig6, phase_sweep_fig8, phase_sweep_cohort):
        path_launches, line = phase()
        emit(line)
        sweep_launches.append(path_launches)
        torch.cuda.empty_cache()
    comm_launches, compressed = phase_compressed_main(state)
    emit(compressed)
    sweep_launches += comm_launches
    for phase in (phase_sweep_comm, phase_sweep_comm_mlp):
        path_launches, line = phase()
        emit(line)
        sweep_launches.append(path_launches)
    serve_launches, serve = phase_serve()
    emit(serve)
    torch.cuda.empty_cache()
    card_vs_cpu = phase_card_vs_cpu()
    emit(card_vs_cpu)
    zoo_launches, serve_zoo = phase_serve_zoo()
    emit(serve_zoo)
    encdec_launches, serve_encdec = phase_serve_encdec()
    emit(serve_encdec)
    zoo_cpu_launches, zoo_card_vs_cpu = phase_zoo_card_vs_cpu()
    emit(zoo_card_vs_cpu)
    torch.cuda.empty_cache()
    llm_launches, llm, async_llm_launches, async_llm = phase_train_llm()
    emit(llm)
    emit(async_llm)
    train_paths = [llm_launches, async_llm_launches]
    torch.cuda.empty_cache()
    train_zoo_launches, train_zoo = phase_train_zoo()
    emit(train_zoo)
    train_paths.append(train_zoo_launches)
    torch.cuda.empty_cache()
    train_mla = phase_train_mla()
    emit(train_mla)
    for phase in (phase_train_ckpt, phase_train_card_vs_cpu,
                  phase_train_zoo_card_vs_cpu):
        path_launches, line = phase()
        emit(line)
        train_paths.append(path_launches)
        torch.cuda.empty_cache()
    sweep_launches += train_paths
    dist_launches, distributed = phase_distributed()
    emit(distributed)
    sweep_launches.append(dist_launches)
    torch.cuda.empty_cache()
    emit(phase_dryrun(distributed["llm"]["shard"]["state_alloc_gb"],
                      llm["state_gb"]))
    for phase in (phase_table3, phase_fig5, phase_fig7, phase_telemetry,
                  phase_async_throughput, phase_async_mlp,
                  phase_async_threaded):
        path_launches, line = phase()
        emit(line)
        sweep_launches.append(path_launches)
        torch.cuda.empty_cache()
    timing = phase_timing()
    emit(timing)
    timing_prox = phase_timing_prox(state)
    emit(timing_prox)
    timing_flash = phase_timing_flash()
    emit(timing_flash)
    timing_train = phase_timing_flash_train()
    emit(timing_train)
    emit(phase_round_time())
    emit(phase_round_time_comm())

    step = timing["main_path_step"]
    prox_src = "src/repro/kernels/prox/kernel.py"
    kernels = []
    for name, line in (("fused_update_sweep", 267),
                       ("fused_tracking_sweep", 296)):
        t = step[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{prox_src}:{line}",
            "launches": sum(n[name] for n in sweep_launches),
            "max_abs_err": max(check["max_abs_err"][name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    for name, line in (("prox", 123), ("fused_update", 157)):
        t = timing_prox["tree_path"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{prox_src}:{line}",
            "launches": tree_launches[name],
            "max_abs_err": max(check_prox["max_abs_err"][name],
                               tree["max_abs_err"][name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    # bf16 on the served paths (the zoo's too); fp32 on the card-vs-CPU
    # paths; "flash_fwd_padded": those of them through the head-dim route,
    # by dtype (bf16 0: the zoo's D 80 and 96 run natively, as each path's
    # expect_counts holds; fp32 the reduced configs' D 32)
    fp32_launches = sum(card_vs_cpu[arch]["launches"]["flash_attention_fp32"]
                        for arch in ("qwen3-1.7b", "starcoder2-7b")) + sum(
        n["flash_attention_fp32"] for n in train_paths) \
        + zoo_cpu_launches["flash_attention_fp32"] \
        + encdec_launches["flash_attention_fp32"]
    bf16_launches = serve_launches["flash_attention"] + sum(
        n["flash_attention"] for n in train_paths) \
        + zoo_launches["flash_attention"] + encdec_launches["flash_attention"]
    padded = {"bfloat16": zoo_launches["flash_fwd_padded"]
              + train_zoo_launches["flash_fwd_padded"],
              "float32": zoo_cpu_launches["flash_fwd_padded"]}
    # the bf16 kernel's error at the route's and the enc-dec's timed shapes
    timed_err = max(timing_flash[label]["max_abs_err"]
                    for label in (*FLASH_ZOO_SHAPES, *FLASH_ENCDEC_SHAPES))
    # the training forward (bf16, with lse) and the backward: their
    # launches in train_llm's timed rounds
    train_attn = llm["attention_launches_timed"]
    for name, dtype, launched, t, err in (
            ("flash_attention", "bfloat16", bf16_launches,
             timing_flash["served"],
             max(timed_err, timing_train["err"]["o_max_abs"])),
            ("flash_attention_fp32", "float32", fp32_launches,
             timing_flash["served_fp32"], 0.0)):
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCES[dtype],
            "replaces": FLASH_REPLACES, "launches": launched,
            "flash_fwd_padded": padded[dtype],
            **({"flash_fwd_train": train_attn["flash_fwd_train"]}
               if dtype == "bfloat16" else {}),
            "max_abs_err": max(check_flash["max_abs_err"][dtype],
                               t["max_abs_err"], err),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    t = timing_train
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": FLASH_BWD_SOURCE, "replaces": None,
        "launches": train_attn["flash_bwd"],
        "max_abs_err": max(t["err"][g]["max_abs"] for g in ("dq", "dk", "dv")),
        "max_rel_l2": max(t["err"][g]["rel_l2"] for g in ("dq", "dk", "dv")),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # D 192 / DV 128 (multi-head latent attention): the training forward
    # with lse and the backward, launched in train_mla's timed rounds
    t = train_mla
    for name, key, launches in (
            ("flash_attention_mla_fwd", "fwd_ms",
             t["launches"]["flash_fwd_train"]),
            ("flash_attention_mla_bwd", "bwd_ms", t["launches"]["flash_bwd"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": FLASH_SOURCES["bfloat16"] if key == "fwd_ms"
            else FLASH_BWD_SOURCE, "replaces": None, "launches": launches,
            "max_rel_l2": max(check_flash["dv_pairs_max_rel_l2"],
                              *check_flash["mla_cell_rel_l2"].values()),
            "ms": t[key], "plain_ms": t["plain_bwd_ms"] if key == "bwd_ms"
            else None, "bound_ms": t["bound_ms"][key],
            "bound_by": t["bound_by"], "library_ms": None})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
