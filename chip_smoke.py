#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GYM on one CUDA card.

    python3 chip_smoke.py [--seed N] [--reps N]
                          [--phases gym,grid,skew,logdepth,wire,snapshot,joinserve,mesh,lm,moe,ssm,whisper,train,dryrun]

Run from the root of a checkout on a machine with a CUDA card (sm_90a,
an H100) and the CUDA toolkit.  In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the Hopper kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once) and prints the build time, ptxas's register
   and spill report, and the count of tensor-core MMA instructions in the
   flash kernels' SASS (``cuobjdump -sass``; it must not be 0);
3. holds each gym CUDA kernel exactly equal to its plain PyTorch version
   on the card at edge cases (n=0, all-INT32_MAX keys, -1 probes, p=7 and
   p=8, a top-bit seed; for the sorted probe also every early out, valid
   lengths 0, 1 and off the splitter stride, a 2^20-key run of equal keys,
   n off the tile, 70000 segments, an empty join key (every range a whole
   segment) and three distinct keys at 2^20-2^22 probes a segment; for the
   semijoin probe's bitmap path also
   a bound off 32, probes at 0 and bound - 1, the largest bound that fits
   one block's shared memory and one bit past it, which must take the hash
   path, and more segments than SMs, and, in a child process, that a key
   outside [0, bound) traps), and the flash attention kernel within stated
   tolerances of its plain version over head widths, dtypes, GQA groups,
   masks, softcaps and ragged shapes, with fully masked rows exactly 0;
4. (phase ``gym``) drives the port's join path — default ``gym()`` (hash
   engine, DYM-d, fused, calibrated, dense wire) with the ``'cuda'``
   backend — on S_8, C_8 and TC_9 at the ``benchmarks/bench_shuffle.py``
   sizes and at a real size (about 2^20 tuples per relation at p=8, 8-9 M
   input tuples per query, made with vectorized numpy from ``--seed``).
   Each run's rows, schema and ledger must equal a run with the
   ``'torch'`` backend (the plain versions) on the card, the real-size
   row sets must equal an independent numpy join, and every gym kernel
   must have launched, every ``semijoin_probe`` launch on its bitmap path
   (the launches are printed per path, ``bitmap`` / ``hash``);
5. (phase ``grid``) drives ``GymConfig(strategy="grid")`` — the paper's
   skew-proof Lemma 8/10 engine — on the same families, sizes and data,
   with the same checks but no warm repeat (the time limit; the peak is
   the cold run's), and prints its comm beside the hash engine's;
   the semijoin probe's launches are split by path and by the ``bound``
   passed, and no launch whose bound fits the bitmap may take the hash
   path;
6. (phase ``skew``) drives ``GymConfig(strategy="hybrid")`` — the
   heavy-hitter engine — beside the hash and grid engines: the five
   families of ``benchmarks/bench_skew.py`` (p = 8, seed 23,
   ``max_cap_tuples=1<<18``), the planted heavy key ``S_8_heavy`` at the
   gym phase's real S_8 scale (hub ``SKEW_REAL_HUB`` = 2^20 rows, 80% of
   them on one A_1 value, spokes 2^18 extra rows), and the gym phase's
   real S_8 under ``hybrid`` as a uniform control.  Each run's rows,
   schema and ledger must equal the ``'torch'`` backend's (the control's
   through the gym phase's hash run, which that phase holds to
   ``'torch'``; a run of its own when the gym phase did not run); the
   engines must give one row set, the real-size rows the
   numpy join's; ``hybrid`` must make no retry, and on ``S_8_heavy`` ship
   fewer padded slots than ``hash`` with heavy tuples; the control must
   equal the gym phase's hash run record for record; no semijoin launch
   with a bound the bitmap holds may take the hash path.  Each run prints
   rows, comm, shuffle tuples, padded slots, the heavy/light split, the
   flagged destinations, retries, dispatches, launches (per kernel and per
   semijoin path) and cold seconds (no warm repeat: the time limit);
7. (phase ``logdepth``) drives the paper's log-depth path: C_16 (about 256
   tuples a relation) under ``chain_ghd(16)``, ``gym_loggta`` (Log-GTA,
   whose cross bags hold about 2^24 tuples) and ``acq_mr`` (Log-GTA'),
   TC_15 under ``gym_loggta``, and ``shares_join`` on the Table-2 query;
   each run's rows, schema and ledger must equal the ``'torch'`` backend's,
   the rows the numpy join's, and the largest materialized bag the numpy
   count; it prints rounds, comm, the largest bag, peak device memory and
   cold seconds (no warm repeat: the time limit).  Every gym kernel must launch on each of the grid
   and logdepth phases;
8. (phase ``wire``) drives ``GymConfig(wire_format="packed")`` — the
   bit-packed exchange, whose codec runs the ``wire_encode`` /
   ``wire_decode`` kernels — and ``GymConfig(plan="auto")``: S_8, C_8 and
   TC_9 at bench size under ``hash``, ``grid`` and ``hybrid`` (``'cuda'``
   == ``'torch'`` in rows, schema and every record; rows, comm, retries
   and useful bytes equal to the dense run, payload bytes below it); the
   gym phase's real-size data under ``hash`` (cold and warm seconds,
   payload bytes and peak device memory against the gym phase's dense
   run — at most ``WIRE_PEAK_RATIO_MAX`` times it — rows == numpy); and
   ``plan="auto"`` with the packed wire on the bench and real families
   and the skew phase's real ``S_8_heavy``, whose chosen plan key must
   equal the advisor's on the host from the same statistics, with every
   gym and codec kernel launched (the plan keeps the ``'cuda'`` backend).
   Before any phase the codec kernels are held exactly equal to the plain
   versions at edge cases (arity 0, negative 32-bit columns, c off a
   multiple of 8 and c = 0, empty and full buckets, row_bits 2 to 257,
   the golden fixture ``tests/fixtures/wire_s8_packed.npz``).  With both
   sizes, the gym phase's dense counts must equal those from before the
   packed wire (``DENSE_BASELINE``);
9. (phase ``snapshot``) drives ``GymDriver.save`` / ``load``: at bench
   size the reference's snapshot scenarios (``examples/gym_fault_tolerance.py``
   — C_6, seed 9, p = 4, a snapshot after each of 4 steps — and its
   snapshot tests: a plain chain, a warm caps cache, the hybrid engine,
   the packed wire, two ``plan="auto"`` plans, a pinned backend and a
   post-completion snapshot), each snapshotted mid-query and resumed in a
   fresh driver built with another config, on ``'cuda'`` and on
   ``'torch'``: the resumed rows must equal the uninterrupted run's and
   the numpy join, resumed ``'cuda'`` must equal resumed ``'torch'``
   record for record, and the card's snapshot must resume on the CPU
   (``device="cpu"``, the ``'torch'`` backend) to the same rows and
   records — or be refused there when it pins ``'cuda'``.  At real size
   the gym phase's C_8 is snapshotted after materialization and half its
   DYM rounds, finished (rows and records == the gym phase's run), then
   the snapshot is resumed by a fresh driver and finished again: rows ==
   numpy join, comm, rounds and retries == the gym phase's run; it prints
   the snapshot's bytes, the save seconds, the time to resume (the fresh
   driver's set-up and the load) and the launches;
10. (phase ``joinserve``) drives the multi-tenant join server
   (``serve.JoinServer``, cross-request fused dispatch) on
   ``benchmarks/bench_serve.py``'s mix — ``zipf_mix`` of S_8, C_8 and TC_9,
   p = 8, ``GymConfig(strategy="hash", seed=23)``, a shared ``CapsCache``.
   At bench size (``max_in_flight=8``) the ``'cuda'`` server must equal the
   ``'torch'`` server per ticket (rows, schema, every record, admit and
   finish ticks) and in its ``ServerLedger``, every ticket its standalone
   ``gym()`` in rows and comm, with 0 retries and dispatches saved.  At
   real size (the gym phase's data) ``max_in_flight`` is the largest (at
   most 8) whose reckoned peak stays under ``SERVE_PEAK_SHARE_MAX`` of the
   card's memory (the in-flight queries' live sets plus the larger of the
   largest solo transient and one tick's merged payloads, each measured
   by a solo run a family driven through ``step_gen``); each
   ticket's rows must equal the numpy join and its comm the gym phase's
   run, with 0 retries, dispatches saved, the measured peak under that
   share, every gym kernel launched and every semijoin launch on the
   bitmap path; it prints the drain's seconds and queries/s beside the
   sequential estimate (the gym phase's warm seconds over the mix),
   per-ticket latency in ticks and seconds (p50/p99), the fusion counters,
   the server's dispatches against the standalone runs' and the peak;
11. (phase ``mesh``) drives the gym's production runtime, ``gym(...,
   spmd=SPMD(p, mesh=mesh))``, one process a reducer
   (``launch/mesh.py::spawn_reducers``): ``MESH_P`` = 8 gloo ranks sharing
   the card (NCCL takes one card a rank; each block crosses through pinned
   host memory) on S_8, C_8 and TC_9 at bench size under ``grid``,
   ``hybrid`` and the packed wire, on C_8 under ``hash`` (the joinserve
   drain runs the other two families under ``hash``), and on the real C_8 under
   ``hash``; then, once those ranks have stopped, an NCCL mesh over every
   visible card (p = the card count; with one card, one rank in this
   process through ``make_reducer_mesh``) on the bench families under
   ``hash``.  C_8 under ``hash`` is driven through a snapshot: ``save`` on
   the mesh at its middle round, finished, then resumed (at bench size in
   a fresh mesh driver and by the single-process ``'cuda'`` driver, the
   real 273.7 MB one reloaded into the same driver).  Both meshes also
   run the other entry points on them: ``shares_join`` on the logdepth
   phase's S_5, ``gym_loggta`` on its TC_15 and on the bench C_8,
   ``acq_mr`` on the bench C_8, a ``JoinServer`` drain of the joinserve
   phase's bench mix, and one ``int8_allreduce`` of a 2^26-element f32
   shard a rank.  Every rank's rows, schema, records, retries and output
   must equal the single-process ``'cuda'`` run at the same p and seed
   (the gym, wire, logdepth, snapshot and joinserve phases' runs, reused;
   run here when those phases did not run), each resumed finish the single
   process' resume, each mesh snapshot file the single-process snapshot at
   the same cursor array for array, each served ticket and the
   ``ServerLedger``'s counts the single-process server's, the all-reduce
   the leading-axis form bit for bit, the NCCL ranks' rows the numpy join
   too, and every rank must launch every gym kernel its entry point uses,
   each semijoin probe on its bitmap path.  The gloo ranks start up beside
   the script's single-process reference runs and drive nothing before
   those end.  It prints each query's slowest wall and set-up seconds,
   each rank's share of the wall inside the exchanges and inside the host
   reads' gathers, each rank's launches, the snapshots' save and load
   seconds and bytes, the drain's seconds and queries/s, the all-reduce's
   ms and bytes, and the phase's seconds split into spawn, host set-up
   and run.  The gloo ranks then train (the LM mesh entry,
   ``lm_mesh_rank``): a ``(2, 4)`` ``("data", "model")`` mesh over the
   same 8 ranks (``launch/mesh.py::make_debug_mesh``) holds smollm-360m
   at full width, 2 of its 32 layers (bf16, seed weights, AdamW) placed by
   the reference's sharding rules (``launch/shardings.py``), and one step
   of ``train/step.py::make_mesh_train_step`` runs on 8 x 256 tokens (each
   rank its data slice).  Gates: every rank's loss and grad norm equal,
   and within the train phase's accumulation tolerances of the single
   process' step that rank 0 runs from the same state and batch with the
   mesh's two data slices as its two microbatches, its gated MLPs' products
   split on the mesh's 4 model shards as the mesh splits them
   (``split_products``), the updated parameters too (the single process'
   step with one product a weight, and the same with one microbatch, a
   control, are printed beside it); then the same step in f32, held with
   the same tolerances to the single process with one product a weight;
   each rank's resident bytes (its local shards)
   equal the dry run's per-device argument bytes for that mesh
   (``launch/dryrun.py::mesh_cells``); the checkpoint saved on ``(2, 4)``
   restores onto ``(8, 1)`` and, after the spawn, onto this process,
   every leaf bit-equal; each rank's ``torch.cuda.max_memory_allocated``
   in the step, less what it held that is not the step's, within
   ``DRYRUN_PEAK_RATIO`` of rank 0's per-device peak in the dry run's
   fake-PG ``meta`` trace of the same cell (``launch/dryrun.py::mesh_trace``).
   The step is the partitioned one: each layer gathers its data-axis
   shards inside its (rematerialized) call and computes on its ``"model"``
   shards where the split allows it (smollm-360m's 15 heads on 4 do not
   split, so its attention computes replicated; its MLP splits).  Then
   the same ranks serve (``lm_serve_rank``, ``serve/mesh.py::MeshServer``):
   the same model in f32, the TP-only placement, its 5 K/V heads on
   a ``"model"`` of 4 splitting the cache on the sequence; 2 x 256 prompt
   tokens and 8 greedy tokens, which must equal rank 0's single-process
   ``generate`` with logits within ``MESH_SERVE_LOGIT_REL`` of its
   largest.  It prints each rank's step wall and collective
   seconds and shard bytes, both entries' collective bytes by kind, and
   the checkpoint's save and load seconds;
12. (phase ``lm``) drives the port's LM serving path — ``generate`` over
   ``DecoderLM.prefill`` and ``decode_step`` — on gemma2-9b at full width
   and depth in bf16 with random weights from ``--seed``: a batch of two
   4608-token prompts, 16 greedy tokens, the ``'cuda'`` backend.  The
   flash kernel must launch exactly 42 times per ``generate`` (once per
   layer, in prefill), and the per-step logits must agree with a
   teacher-forced replay through the ``'torch'`` backend on the card;
13. (phase ``moe``) drives the Mixture-of-Experts path on grok-1-314b at
   its published widths in bf16 (random weights from ``--seed``), the
   depth cut from 64 layers to ``MOE_LAYERS``: two 2048-token prompts and
   16 greedy tokens through ``generate`` with the ``'cuda'`` backend, on
   the dense route (capacity factor 1.25) and on the calibrated route
   under ``MoEPlan.sound(4096, 2, 8)`` over the same tensors
   (``DecoderLM.with_config``), each cold (and warm with ``--profile
   moe``, which also profiles both routes).  The flash kernel must
   launch once per layer a ``generate`` (D = 128), the calibrated route
   must route t*k pairs and drop 0 in every MoE call, the dense route's
   drops must equal a host bincount of its own router decisions against
   its capacity, and each route's logits must meet the ``lm`` phase's rule
   against a ``'torch'`` replay teacher-forced in its tokens and its
   expert choices; each MoE call's router logits in the replay must meet
   the same rule against the run's, and a token whose own choice differs
   must sit at a near-tie (its top-k margin within twice that change).
   One layer's MoE block
   alone at 4096 tokens: both routes without drops (capacity factor e, the
   plan from ``calibrate_moe``) agree within ``MOE_ROUTE_TOL`` with equal
   stats; on ``benchmarks/bench_moe.py``'s zipf-hot mix the dense route
   drops exactly the host's count (more than 0) and the calibrated route
   under ``calibrate_moe(threshold=1.5)`` flags a heavy expert and drops
   0.  Reduced kimi-k2 takes one train step per route with
   ``moe_metrics`` on the card, held to the same step on the CPU.  It
   prints prefill seconds, decode ms a step, tokens/s, peak device
   memory, the pairs routed, dropped and heavy per layer, the layer's warm
   ms and its ledger bytes, and times the flash kernel at grok's call;
14. (phase ``ssm``) drives the port's SSM, xLSTM and hybrid serving path
   at full width and depth in bf16 (random weights from ``--seed``):
   xlstm-125m (12 layers, 9 mLSTM and 3 sLSTM) on two 2048-token prompts
   and zamba2-7b (81 layers: 75 Mamba2, the shared attention block at 6
   positions) on two 4096-token prompts, 16 greedy tokens each through
   ``generate`` with the ``'cuda'`` backend, cold (no warm repeat: the
   script's time limit).  The flash
   kernel must launch exactly once per shared position a ``generate`` (6
   for zamba2, D = 112, in prefill; 0 for xlstm), no gym kernel, and the
   logits must meet the ``lm`` phase's margin rule against a
   teacher-forced ``'torch'`` replay (xlstm, which has no attention,
   the whole rule).  An f32 copy of each model from the same seed then
   prefills all but the last 48 prompt tokens (xlstm's 2000 are off its
   256-token chunk, so the mLSTM's gate padding runs) and decodes those
   48 teacher-forced, and the last step's logits must meet the 5% rule
   against the whole prompt's prefill; zamba2's f32 copy also repeats
   the cold run and the replay under the whole rule (``SSM_TAIL`` says
   why f32; ``--profile ssm`` prints the bf16 prefill-then-decode
   figure).  Each bf16 model is then held to its f32 copy on the prompt
   (``SSM_LAYER_TOL``): each layer's update in prefill and in one decode
   step on the f32 layer's input, per block kind, and the prefill logits'
   median gap; a control with 4-bit weights must fail every one of those
   limits.  Each model runs its ``long_500k`` decode cell (the port's
   ``SHAPES`` and ``cell_enabled``; before the f32 copy):
   batch 1, ``init_caches(1, 524288, 524288 - 16)`` with zamba2's six shared
   positions' claimed K/V prefixes filled with seeded random bf16 and the
   recurrent states zero, one cold and 15 timed steps; the logits must be
   finite, zamba2's last shared layer's attention at the last step must
   agree with an f32 softmax over 64K-key slices, and the peak must stay
   under 0.9 of the card and within 10% of its reckoning.  It prints prefill
   seconds, decode ms a step, tokens/s and peaks, one sLSTM and one mLSTM
   layer's warm prefill (host ms, device ms and device operations a
   position), and times the flash kernel at zamba2's call;
15. (phase ``whisper``) drives the port's encoder-decoder serving path,
   ``generate_whisper`` over ``WhisperModel.prefill`` and ``decode_step``,
   on whisper-small at full width and depth in bf16 (random weights and
   frames from ``--seed``), with the ``'cuda'`` backend: (a) 32 x 1500
   frames (whisper's 30-s window, ``SHAPES["prefill_32k"]``'s batch), 32
   greedy tokens, cold (no warm repeat: the script's time limit): the
   flash kernel must launch 396 times a
   ``generate`` (the 12 encoder layers, then each decoder layer's
   cross-attention in the BOS step and in each of 31 decode steps, at one
   query a sequence), the logits must meet the margin rule against a
   teacher-forced ``'torch'`` replay, and on an f32 copy the 5% rule for
   the replay and for the teacher-forced decode against the decoder's full
   forward over the same tokens; (b) ``prefill_32k`` with the batch cut to
   4 (4 x 32768 frames, 4 decode steps), cold and warm, the recorded
   encoder call held once to the plain version; (c) ``decode_32k`` with
   the batch cut to 48: ``init_caches(48, 32768, 64)``, the cross K/V
   seeded random bf16, 8 decode steps; the logits must be finite and the
   peak within ``WHISPER_PEAK_MARGIN`` of its reckoning.  It prints
   prefill seconds, decode ms a step, tokens/s and peaks, and times the
   flash kernel at (a)'s encoder call and (c)'s cross call;
16. (phase ``train``) drives the port's LM training path on smollm-360m
   at full width and depth in bf16 (random weights from ``--seed``, AdamW
   with f32 moments, batch 8 x 2048 tokens, so every layer's attention
   takes the chunked scan): the data pipeline's corpus join
   (``eligible_docs``) on the card's ``'cuda'`` backend must equal the
   ``'torch'`` backend and a numpy oracle at the default corpus and at
   2^20 docs, with every gym kernel launched; chunked attention at the
   real shape must match the dense plain version in output and q/k/v
   gradients within ``TRAIN_ATTN_TOL`` with a lower backward peak; step
   0's loss and gradient norm must match a dense (``TRAIN_LOSS_RTOL``,
   ``TRAIN_GNORM_RTOL``) and a no-remat run; four steps on one batch must
   lower the loss; a checkpoint after them must restore bit for bit into
   a fresh model and optimizer and give the same next loss; ``accum=2``
   must match ``accum=1`` (f32, the reference test's tolerances, see
   ``TRAIN_FEW``); ``launch/train.py`` runs two steps with ``--ckpt``,
   the flash kernel launches 0 times in all of it, a ``'cuda'``-backend
   loss refuses the kernel in a child process, and ``launch/serve.py
   --ckpt`` serves the trained checkpoint with the kernel once per layer.
   It prints the warm step seconds (median of three), tokens/s, peak
   memory, the checkpoint's bytes and save/load seconds, the model FLOPs
   a step as a share of the bf16 peak, and with ``--profile train`` one
   profiled step's device busy share and top device work;
17. (phase ``dryrun``) runs nothing new on the card: it reckons on
   ``meta`` with ``launch/dryrun.py::run_cell`` the runs the earlier
   phases measured
   (``DRYRUN_WITNESSES``: gemma2-9b's prefill at 2 x 4608,
   whisper-small's (b) and (c), zamba2-7b's long_500k decode and
   smollm-360m's train step), and holds each against its measurement: the
   measured peak, less what the script held that is not the cell's, within
   ``DRYRUN_PEAK_RATIO`` of the reckoned peak, the flops at least the model
   flops (gemma2-9b's prefill: the hand count), the flash operator's fake
   once per attention call in a prefill; it prints each witness's mfu and
   bound_over_measured (the reckoned bound over the measured warm
   seconds), names a witness whose
   phase did not run as skipped, and prints the flash wrapper's host us a
   call through the operator;
18. times each kernel at the largest inputs its path gave it (CUDA events,
   L2 flushed before each launch) beside its plain version, one PyTorch
   library call where one computes the same function, and its bound,
   prints the sorted probe's census of that call (the share of probes its
   early outs answer, the share of padding keys) and the semijoin probe's
   (the share of -1 probes and of padding keys, the hit rate, the largest
   valid key + 1 against ``bound``, duplicate keys), times the semijoin
   probe's hash path at the same call, splits the bitmap path's device
   time between its two kernels (``torch.profiler``), and prints beside it
   an elementwise pass over the same probe and mask bytes and the
   wrapper's host time a call.

TF32 is off for matrix products and cuDNN (set explicitly below), so f32
products on the card run in full f32.  The second-to-last line is one
JSON object describing the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and the exit
code is nonzero.  Without a CUDA card the script exits nonzero before
printing anything.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# the port's one count of a flash call's work and of the H100 SXM peaks
# (NVIDIA data sheet: HBM bandwidth, the dense bf16 tensor-core rate)
from repro_torch.kernels.flash_attention import visible_pairs  # noqa: E402
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS_BF16  # noqa: E402

# the 32-bit non-tensor-core rate as the integer-operation ceiling
INT32_OPS_PER_S = 67e12
I32MAX = 2**31 - 1

GYM_SOURCE = "src/repro_torch/csrc/gym_kernels.cu"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
WIRE_SOURCE = "src/repro_torch/csrc/wire_codec.cu"
GYM_KERNELS = ("hash_partition", "semijoin_probe", "sorted_probe_ranges")
WIRE_KERNELS = ("wire_encode", "wire_decode")
KERNELS = {
    # kernel name -> the TPU kernel (file:line of its body) it replaces
    "hash_partition": "src/repro/kernels/hash_partition.py:49",
    "semijoin_probe": "src/repro/kernels/semijoin_probe.py:33",
    "sorted_probe_ranges": "src/repro/kernels/sorted_probe.py:40",
    "flash_attention": "src/repro/kernels/flash_attention.py:34",
    # the packed wire's codec has no TPU kernel: the reference computes it
    # with XLA element-wise operations; these are its functions
    "wire_encode": "src/repro/relational/wire.py:164",
    "wire_decode": "src/repro/relational/wire.py:188",
}
# the dense gym phase's counts before the packed wire was ported (bench and
# real size, PERF.md section 6): dispatches and padded slots of the
# real-size runs, and the gym kernels' launches over the phase's 'cuda' runs
DENSE_BASELINE = {
    "dispatches": {"S_8": 45, "C_8": 53, "TC_9": 38},
    "padded": {"S_8": 1945113472, "C_8": 374343680, "TC_9": 295700352},
    "launches": {"hash_partition": 740, "semijoin_probe": 120, "sorted_probe_ranges": 156},
}
# the wire phase: packed peak device memory at most this multiple of dense's
WIRE_PEAK_RATIO_MAX = 1.25
# the log-depth phase: C_16 on real_chain(16, ident=LOGDEPTH_IDENT,
# extra=64, domain=4096), about 256 tuples a relation, so that Log-GTA's
# cross bag pi_A4(R4) x pi_A6(R6) x pi_A8(R8) holds about 256^3 = 2^24
# tuples; Assumption 3's default per-shard ceiling (64 M, M = 4 IN / p)
# is far below that bag, so both backends get this explicit one
LOGDEPTH_IDENT = 192
LOGDEPTH_MAX_CAP = 2**25
# the least tuples Log-GTA's and Log-GTA''s largest C_16 bag must hold,
# so that the phase keeps its real device state
LOGDEPTH_MIN_BAG = 16_000_000
# the LM serving phase: gemma2-9b at full width and depth
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS = "gemma2-9b", 2, 4608, 16
# the paths `--profile` names (any other name is a gym family)
PROFILE_PATHS = ("lm", "moe", "ssm", "whisper", "train")
# flash kernel vs its plain version: f32 both accumulate in f32 and differ
# in summation order only; bf16 both round an f32 result once, a value on
# a rounding boundary may land one or two bf16 ulps apart (2**-7 relative
# each), and the kernel's tensor-core product rounds the weights P to bf16
# (2**-9 relative each); the bf16 bound is two ulps at |o| in [1, 2),
# absolute at |o| <= 1, relative above
FLASH_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
# LM logits, 'cuda' backend vs teacher-forced 'torch' backend: the two
# prefills differ only in attention's summation order and the kernel's
# bf16 weights P, whose roundings then travel through 42 layers of bf16
# activations
LM_LOGIT_REL_TOL = 5e-2


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ data
def real_chain(n: int, *, ident: int, extra: int, domain: int, seed: int):
    """C_n matching database: identity links on [0, ident) plus ``extra``
    random links over [ident, domain) per relation (as chain_data_sparse,
    vectorized)."""
    rng = np.random.default_rng(seed)
    out = {}
    iden = np.repeat(np.arange(ident, dtype=np.int32)[:, None], 2, axis=1)
    for i in range(1, n + 1):
        rnd = rng.integers(ident, domain, (extra, 2)).astype(np.int32)
        out[f"R{i}"] = unique_rows(np.concatenate([iden, rnd]))
    return out


def real_star(n: int, *, hub_rows: int, spoke_extra: int, domain: int, seed: int):
    """S_n: a (hub_rows, n-1) hub over [0, domain/2); each spoke matches
    every hub value as (v, v % 7) plus ``spoke_extra`` non-matching rows
    (as star_data_sparse, vectorized)."""
    rng = np.random.default_rng(seed)
    hub = rng.integers(0, domain // 2, (hub_rows, n - 1)).astype(np.int32)
    out = {"S": unique_rows(hub)}
    for i in range(1, n):
        vals = np.unique(hub[:, i - 1])
        rows = np.stack([vals, vals % 7], 1)
        ext = np.stack([
            rng.integers(domain // 2, domain, spoke_extra),
            rng.integers(0, 7, spoke_extra),
        ], 1)
        out[f"R{i}"] = unique_rows(np.concatenate([rows, ext]).astype(np.int32))
    return out


def real_star_heavy(n: int, *, hub_rows: int, heavy_share: float, spoke_extra: int,
                    domain: int, seed: int):
    """S_n with a planted heavy hitter: ``heavy_share`` of the hub rows
    carry A_1 = 0, the other columns uniform over [0, domain/2); spokes as
    ``real_star`` (as star_data_heavy, vectorized)."""
    rng = np.random.default_rng(seed)
    half = domain // 2
    k = int(hub_rows * heavy_share)
    a1 = np.concatenate([np.zeros(k, np.int64), rng.integers(1, half, hub_rows - k)])
    cols = [a1] + [rng.integers(0, half, hub_rows) for _ in range(n - 2)]
    hub = np.stack(cols, 1).astype(np.int32)
    out = {"S": unique_rows(hub)}
    for i in range(1, n):
        vals = np.unique(hub[:, i - 1])
        rows = np.stack([vals, vals % 7], 1)
        ext = np.stack([
            rng.integers(half, domain, spoke_extra),
            rng.integers(0, 7, spoke_extra),
        ], 1)
        out[f"R{i}"] = unique_rows(np.concatenate([rows, ext]).astype(np.int32))
    return out


def real_tc(n_tri: int, *, ident: int, extra: int, domain: int, seed: int):
    """TC_n: identity triangles on [0, ident) plus random links."""
    return real_chain(3 * n_tri, ident=ident, extra=extra, domain=domain, seed=seed)


def row_key(a) -> np.ndarray:
    """One int64 per row of the 2-D integer array ``a`` whose order is the
    rows' lexicographic order (equal rows, equal keys): each column's
    offsets from its minimum (or, where their span would not fit, its
    dense codes from a 1-D ``np.unique``), folded column by column and
    re-densified before the product could pass 2^62.  ``np.unique(axis=0)``
    sorts rows as structured records, several times slower at these sizes."""
    key, size = np.zeros(len(a), np.int64), 1
    for col in np.asarray(a).T:
        if len(col) == 0:
            continue
        lo = int(col.min())
        span = int(col.max()) - lo + 1
        if span < 2**31:  # offsets keep the column's order: no sort needed
            codes = col.astype(np.int64) - lo
        else:
            vals, codes = np.unique(col, return_inverse=True)
            span = len(vals)
        if size * span >= 2**62:
            dense, key = np.unique(key, return_inverse=True)
            size = len(dense)
        key = key * span + codes.reshape(-1)
        size *= span
    return key


def unique_rows(a) -> np.ndarray:
    """``np.unique(a, axis=0)`` of a 2-D integer array (the same rows, order
    and dtype), through ``row_key``."""
    a = np.asarray(a)
    if len(a) == 0:
        return a
    key = row_key(a)
    order = np.argsort(key)  # equal keys are equal rows: any one of them will do
    key = key[order]
    return a[order[np.concatenate([[True], key[1:] != key[:-1]])]]


def np_join(a, a_schema, b, b_schema):
    """Independent vectorized natural join: dense key codes, sort and
    searchsorted, then expand the match ranges."""
    shared = [x for x in a_schema if x in b_schema]
    b_keep = [i for i, x in enumerate(b_schema) if x not in a_schema]
    out_schema = tuple(a_schema) + tuple(b_schema[i] for i in b_keep)
    ak = a[:, [a_schema.index(x) for x in shared]].astype(np.int64)
    bk = b[:, [b_schema.index(x) for x in shared]].astype(np.int64)
    codes = row_key(np.concatenate([ak, bk]))
    ca, cb = codes[: len(a)], codes[len(a):]
    order = np.argsort(cb)  # rows come out in any order: callers sort them
    cbs = cb[order]
    # sorted needles: each search starts where the last one ended
    oa = np.argsort(ca)
    lo, hi = np.empty(len(ca), np.int64), np.empty(len(ca), np.int64)
    lo[oa] = np.searchsorted(cbs, ca[oa], "left")
    hi[oa] = np.searchsorted(cbs, ca[oa], "right")
    cnt = hi - lo
    ai = np.repeat(np.arange(len(a)), cnt)
    start = np.repeat(lo - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    bj = order[start + np.arange(len(ai))]
    out = np.empty((len(ai), a.shape[1] + len(b_keep)), np.result_type(a, b))
    out[:, :a.shape[1]] = a[ai]
    out[:, a.shape[1]:] = b[:, b_keep][bj]
    return out, out_schema


def np_answer(q, data):
    """The query answer by folding ``np_join`` over the atoms, in the
    query's output column order, lexicographically sorted."""
    atoms = list(q.atoms)
    out = np.asarray(data[atoms[0].rel], np.int64)
    schema = tuple(atoms[0].attrs)
    for at in atoms[1:]:
        out, schema = np_join(out, schema, np.asarray(data[at.rel], np.int64), tuple(at.attrs))
    out = out[:, [schema.index(x) for x in q.output_attrs]]
    out = unique_rows(out) if len(out) else out.reshape(0, len(q.output_attrs))
    return out


# ------------------------------------------------------------ kernel phase
def kernel_edge_checks(torch, K, ref, dev):
    """Each CUDA kernel exactly equal to its plain version at edge cases."""
    rng = np.random.default_rng(7)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    n_checks = 0
    # probes: n=0, all-INT32_MAX keys, -1 probes, empty key table
    cases = []
    q = rng.integers(-1, 50, (6, 300)).astype(np.int32)
    k = rng.integers(0, 50, (6, 200)).astype(np.int32)
    k[:, 150:] = I32MAX
    k[2] = I32MAX  # an all-padding segment
    q[3] = -1  # invalid probes
    cases += [(q, k), (q[:, :0], k), (q, k[:, :0]), (np.full((2, 5), -1, np.int32), np.full((2, 7), I32MAX, np.int32))]
    for qq, kk in cases:
        tq, tk = t(qq), t(kk)
        check(torch.equal(K.semijoin_probe(tq, tk, use_cuda=True), ref.semijoin_probe_ref(tq, tk)),
              f"semijoin_probe != plain at q{qq.shape} keys{kk.shape}")
        ks = torch.sort(tk, dim=-1).values.contiguous()
        lo, hi = K.sorted_probe_ranges(tq, ks, use_cuda=True)
        rlo, rhi = ref.sorted_probe_ranges_ref(tq, ks)
        check(torch.equal(lo, rlo) and torch.equal(hi, rhi),
              f"sorted_probe_ranges != plain at q{qq.shape} keys{kk.shape}")
        n_checks += 2
    # hashing: p=7 and p=8, top-bit seeds, negative keys, n=0, zero columns
    rows = rng.integers(-(2**31), 2**31 - 1, (4, 513, 3), dtype=np.int64).astype(np.int32)
    valid = rng.random((4, 513)) < 0.8
    seeds = t(np.array([0, 2**31, 2**32 - 1, 7919], np.int64))
    for p in (7, 8):
        for nk in (0, 1, 3):
            r, v = t(rows[..., :nk]), t(valid)
            check(torch.equal(K.hash_partition(r, v, p, seeds, use_cuda=True),
                              ref.hash_partition_ref(r, v, p, seeds)),
                  f"hash_partition != plain at p={p} nk={nk}")
            n_checks += 1
        r0, v0 = t(rows[:, :0]), t(valid[:, :0])
        check(K.hash_partition(r0, v0, p, seeds, use_cuda=True).shape == (4, 0), "n=0 hash")
    torch.cuda.synchronize()
    return n_checks


def sorted_probe_edge_checks(torch, K, ref, dev):
    """The sorted-probe kernel exactly equal to its plain version where its
    design branches: probes below the first key (-1, INT32_MIN + 1) and
    above the last valid one; m_eff = 0, 1, fewer than the splitters, and
    not a multiple of the splitter stride; one run of equal keys filling a
    2^20-key segment; n off the 1024-probe tile and off 4 (the scalar
    path); more than 65535 segments (the grid's y limit)."""
    rng = np.random.default_rng(13)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731

    def sorted_keys(b, m, meff, hi):
        k = np.full((b, m), I32MAX, np.int32)
        for i, e in enumerate(meff):
            k[i, :e] = np.sort(rng.integers(-50, hi, e))
        return k

    def probes(b, n, hi):
        q = rng.integers(-60, hi + 60, (b, n)).astype(np.int32)
        q[:, ::7] = -1
        q[:, 3::11] = -(2**31) + 1
        q[:, 5::13] = I32MAX - 1
        return q

    n_checks = 0

    def one(q, k, what):
        nonlocal n_checks
        tq, tk = t(q), t(k)
        lo, hi = K.sorted_probe_ranges(tq, tk, use_cuda=True)
        rlo, rhi = ref.sorted_probe_ranges_ref(tq, tk)
        check(torch.equal(lo, rlo) and torch.equal(hi, rhi),
              f"sorted_probe_ranges != plain: {what} q{q.shape} keys{k.shape}")
        n_checks += 1
        return lo, hi

    # m_eff 0, 1, < 1024 splitters, a stride that does not divide m_eff
    k = sorted_keys(4, 4096, [0, 1, 700, 4096], 3000)
    for n in (4096, 1027, 4099, 3):
        one(probes(4, n, 3000), k, f"m_eff 0/1/700/4096 n={n}")
    k = sorted_keys(2, 2**21, [2**20 + 12345, 2**21 - 1], 2**22)
    one(probes(2, 2**16 + 2, 2**22), k, "m_eff 2^20+12345 and 2^21-1")
    one(probes(2, 2**16, 2**22), k, "m_eff 2^20+12345 and 2^21-1, n a multiple of the tile")
    # one run of equal keys filling a whole 2^20-key segment
    k = np.full((2, 2**20), 5, np.int32)
    k[1, 2**19:] = I32MAX
    q = np.tile(np.array([5, 4, 6, -1, 5, I32MAX - 1, -(2**31) + 1], np.int32), (2, 150))
    lo, hi = one(q, k, "a run of 2^20 equal keys")
    check(int((hi - lo)[0, 0]) == 2**20 and int((hi - lo)[1, 0]) == 2**19,
          "sorted_probe_ranges: the equal run's multiplicity")
    # more segments than a grid's y dimension takes
    one(probes(70000, 6, 40), sorted_keys(70000, 3, rng.integers(0, 4, 70000), 40),
        "70000 segments")
    # the cross joins of the grid and log-depth phases: an empty join key
    # ranks every valid row 0, so every probe's range is its whole segment
    # (2^22 probes a segment against 2^10 keys, as the last step of a
    # 3-way cross bag; 2^12 against 2^21 keys); and segments of a few
    # distinct keys
    for n, m in ((2**22, 2**10), (2**12, 2**21)):
        meff = np.array([m, m // 8, 1, 0, m - 1, 3, m // 2 + 1, 2])
        k = np.zeros((8, m), np.int32)
        k[np.arange(m)[None, :] >= meff[:, None]] = I32MAX
        q = np.zeros((8, n), np.int32)
        q[:, ::9] = -1
        lo, hi = one(q, k, f"an empty join key, {n} probes against {m} keys")
        check(np.array_equal((hi - lo)[:, [1, 8]].cpu().numpy(), np.repeat(meff[:, None], 2, axis=1))
              and int(lo[:, [1, 8]].abs().max()) == 0,
              "sorted_probe_ranges: an empty-key probe's range is not its whole segment")
    for n, m in ((2**20, 2**20), (2**22, 2**12)):
        k = np.sort(rng.integers(0, 3, (8, m)), axis=1).astype(np.int32)
        k[:, m - m // 5:] = I32MAX
        k[3] = 1
        one(rng.integers(-1, 4, (8, n)).astype(np.int32), k, f"3 distinct keys, n={n} m={m}")
    torch.cuda.synchronize()
    return n_checks


def bitmap_edge_checks(torch, K, ref, dev):
    """The semijoin probe's bitmap path exactly equal to its plain version:
    a bound off 32 and off the 128-bit row, probes at 0, bound - 1 and -1,
    an all-padding segment, n = 0 and m = 0, n off 4, more segments than
    SMs, the largest bound one block's shared memory takes and one bit past
    it, which must take the hash path.  Each call's path is checked by the
    launch counts."""
    from repro_torch.kernels.semijoin_probe import MAX_BITMAP_BITS

    rng = np.random.default_rng(17)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_checks = 0
    for b, n, m, bound in ((3, 1003, 517, 1520), (5, 4096, 4096, 8192), (4, 0, 300, 300),
                           (4, 300, 0, 300), (2, 2**16 + 3, 2**13, 2**16 + 3 + 2**13),
                           (2 * sms + 7, 517, 129, 646), (3, 2**15 + 1, 2**14, MAX_BITMAP_BITS),
                           (3, 2**15 + 1, 2**14, MAX_BITMAP_BITS + 1)):
        keys = rng.integers(0, bound, (b, m)).astype(np.int32)
        keys[:, m // 2:] = I32MAX
        keys[1] = I32MAX  # an all-padding segment
        if m > 2:
            keys[0, :2] = (0, bound - 1)
            keys[-1, :2] = (bound - 32, bound - 33)
        q = rng.integers(-1, bound, (b, n)).astype(np.int32)
        if n > 4:
            q[:, :4] = (0, bound - 1, -1, bound - 32)
        q[:, 5::7] = -1
        tq, tk = t(q), t(keys)
        K.reset_launch_counts()
        got = K.semijoin_probe(tq, tk, bound=bound, use_cuda=True)
        torch.cuda.synchronize()
        path = "bitmap" if bound <= MAX_BITMAP_BITS else "hash"
        check(torch.equal(got, ref.semijoin_probe_ref(tq, tk)),
              f"semijoin_probe {path} path != plain at q{q.shape} keys{keys.shape} bound={bound}")
        check(K.semijoin_probe_path_counts()[path] == int(b * n > 0),
              f"semijoin_probe bound={bound}: {K.semijoin_probe_path_counts()}, not the {path} path")
        n_checks += 1
    return n_checks


TRAP_CHILD = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops as K
q = torch.arange(-1, 100, dtype=torch.int32, device="cuda").reshape(1, 101)
keys = torch.tensor([[3, 100, 2**31 - 1]], dtype=torch.int32, device="cuda")
mask = K.semijoin_probe(q, keys, bound=100)
torch.cuda.synchronize()
print("mask", int(mask.sum()))
"""


def start_bitmap_trap():
    """Start ``bitmap_trap_check``'s child process, which imports torch
    while the other edge checks run."""
    return subprocess.Popen([sys.executable, "-c", TRAP_CHILD, os.path.join(HERE, "src")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def bitmap_trap_check(proc) -> str:
    """A key outside [0, bound) must stop the bitmap build with a trap, not
    return a mask: run in a child process (``start_bitmap_trap``), whose
    CUDA context it loses."""
    out, err = proc.communicate(timeout=300)
    check(proc.returncode != 0 and "mask" not in out,
          f"semijoin_probe: a key >= bound did not trap: {out[-500:]}")
    check("CUDA error" in err, f"semijoin_probe trap child failed otherwise: {err[-2000:]}")
    return err.strip().splitlines()[-1][:120]


def semijoin_census(torch, q, keys, bound, mask):
    """What the recorded call's data asks of the semijoin probe: the share
    of -1 probes, of probes outside [-1, bound) (the promise allows none),
    of padding keys, the hit rate, the largest valid key + 1 against
    ``bound``, and the keys that repeat one of their segment."""
    valid = keys != I32MAX
    ks = torch.sort(keys, dim=1).values
    dup = int(((ks[:, 1:] == ks[:, :-1]) & (ks[:, 1:] != I32MAX)).sum()) if keys.shape[1] > 1 else 0
    return dict(
        probes=q.numel(), minus_one_probes=float((q == -1).float().mean()),
        probes_outside=float(((q < -1) | (q >= bound)).float().mean()),
        valid_keys=int(valid.sum()), padding_keys=1.0 - float(valid.float().mean()),
        hit_rate=float(mask.float().mean()),
        valid_key_min=int(torch.where(valid, keys, I32MAX).min()) if keys.numel() else None,
        valid_key_max_plus_1=int(torch.where(valid, keys, -1).max()) + 1 if keys.numel() else 0,
        bound=bound, duplicate_keys=dup,
    )


def bitmap_kernel_split(torch, fn, flush, reps: int = 5):
    """Device ms a call of the bitmap path spends in each of its kernels
    (``torch.profiler`` over ``reps`` calls, L2 flushed before each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    split = {"bitmap_build_kernel": 0.0, "bitmap_probe_kernel": 0.0}
    for e in prof.events():
        for name in split:
            if e.device_type == DeviceType.CUDA and name in e.name:
                split[name] += e.time_range.elapsed_us() / 1e3 / reps
    return split


def wrapper_host_us(torch, SP, calls: int = 2000) -> float:
    """Host microseconds a bitmap-path call of the semijoin wrapper takes
    (at a tiny shape, so that the card keeps up with the launches)."""
    q = torch.zeros((4, 64), dtype=torch.int32, device="cuda")
    for _ in range(50):
        SP.semijoin_probe(q, q, bound=128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        SP.semijoin_probe(q, q, bound=128)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def sorted_probe_census(torch, q, keys):
    """What the recorded call's data asks of the sorted probe: the share of
    probes answered by an early out (below the first key or in an empty
    segment; above the last valid key) and the share of padding keys."""
    meff = (keys != I32MAX).sum(dim=1)
    first = keys[:, 0:1]
    last = keys.gather(1, (meff - 1).clamp(min=0)[:, None].long())
    below = (q < first) | (meff[:, None] == 0)
    above = ~below & (q > last)
    return dict(
        probes=q.numel(), below_first=float(below.float().mean()),
        above_last=float(above.float().mean()),
        searched=float((~below & ~above).float().mean()),
        valid_keys=int(meff.sum()),
        padding_keys=1.0 - float(meff.sum()) / max(1, keys.numel()),
    )


def sass_mma_count(lib_path) -> int:
    """Tensor-core MMA instructions (HGMMA, HMMA) in the flash kernels'
    SASS, by ``cuobjdump -sass`` of the built library; -1 without it."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return -1
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    n, in_flash = 0, False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            in_flash = "flash_attention" in line
        elif in_flash and ("HGMMA" in line or "HMMA" in line):
            n += 1
    return n


class Recorder:
    """Wraps a kernel wrapper to keep (clones of) the largest inputs the
    main path gave it, keyword arguments too (the semijoin probe's
    ``bound``); the wrapped call still launches the kernel."""

    def __init__(self, torch, mod, attr):
        self.torch, self.mod, self.attr = torch, mod, attr
        self.orig = getattr(mod, attr)
        self.best = None
        self.kw = {}
        self.size = -1
        setattr(mod, attr, self)

    def __call__(self, *args, **kw):
        size = sum(a.numel() for a in args if isinstance(a, self.torch.Tensor))
        if size > self.size:
            self.size = size
            self.best = tuple(a.clone() if isinstance(a, self.torch.Tensor) else a for a in args)
            self.kw = dict(kw)
        return self.orig(*args, **kw)

    def restore(self):
        setattr(self.mod, self.attr, self.orig)


def time_cold(torch, fn, reps: int, flush) -> float:
    """Mean ms per call, CUDA events around each call, L2 flushed first."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def kernel_timing(torch, K, ref, recorded, launches, reps):
    """Time each kernel at its recorded main-path inputs (``recorded``:
    name -> (arguments, keyword arguments)); compare with its plain version
    there.  Returns the kernel records of the JSON line."""
    from repro_torch.kernels import hash_partition as HP
    from repro_torch.kernels import semijoin_probe as SP
    from repro_torch.kernels import sorted_probe as SO

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.int32, device=dev)  # > 50 MB L2
    plain_reps = max(1, min(reps, 5))  # the plain versions take 46-580 ms a call
    out = []
    # -- hash_partition
    keys, valid, p, seeds = recorded["hash_partition"][0]
    b, n, nk = keys.shape
    got = HP.hash_partition(keys, valid, p, seeds)
    want = ref.hash_partition_ref(keys, valid, p, seeds)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    nbytes = keys.numel() * 4 + valid.numel() + seeds.numel() * 4 + b * n * 4
    ops = b * n * (10 * (nk + 1) + 2 * nk + 2)
    out.append(dict(
        name="hash_partition", shape=f"keys {tuple(keys.shape)} p={p}",
        ms=time_cold(torch, lambda: HP.hash_partition(keys, valid, p, seeds), reps, flush),
        plain_ms=time_cold(torch, lambda: ref.hash_partition_ref(keys, valid, p, seeds), plain_reps, flush),
        library_ms=None, max_abs_err=err, nbytes=nbytes, ops=ops,
    ))
    # -- semijoin_probe (library yardstick: torch.isin on segment-offset keys)
    (q, keys), kw = recorded["semijoin_probe"]
    bound = kw.get("bound")
    check(SP.uses_bitmap(bound), f"semijoin_probe's recorded call has bound {bound}: not the bitmap path")
    got = SP.semijoin_probe(q, keys, bound=bound)
    want = ref.semijoin_probe_ref(q, keys)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    hgot = SP.semijoin_probe(q, keys)
    check(torch.equal(hgot, want), "semijoin_probe's hash path != plain at the recorded call")
    census = semijoin_census(torch, q, keys, bound, want)
    print(f"semijoin_probe census of the recorded call: {census}", flush=True)
    check(census["probes_outside"] == 0.0 and census["valid_key_max_plus_1"] <= bound
          and (census["valid_key_min"] is None or census["valid_key_min"] >= 0),
          "semijoin_probe's recorded call breaks the bound promise")
    seg = torch.arange(q.shape[0], device=dev, dtype=torch.int64)[:, None] << 32
    # padding keys move below every probe so they never match
    q64 = q.long() + seg
    k64 = torch.where(keys == I32MAX, -(2**62), keys.long() + seg)
    check(torch.equal(torch.isin(q64, k64), want), "torch.isin yardstick disagrees")
    nbytes = q.numel() * 4 + keys.numel() * 4 + q.numel()
    ops = 30 * (q.numel() + keys.numel())
    bitmap = lambda: SP.semijoin_probe(q, keys, bound=bound)  # noqa: E731
    ms = time_cold(torch, bitmap, reps, flush)
    hash_ms = time_cold(torch, lambda: SP.semijoin_probe(q, keys), reps, flush)
    split = bitmap_kernel_split(torch, bitmap, flush)
    # what the bytes alone cost: an elementwise pass that reads each probe
    # and writes one byte for it, as the probe kernel does
    mask_out = torch.empty_like(want)
    stream_ms = time_cold(torch, lambda: torch.eq(q, -1, out=mask_out), reps, flush)
    print(f"semijoin_probe at the recorded call: bitmap path {ms:.5f} ms "
          f"(device ms by kernel, torch.profiler: {split}), hash path {hash_ms:.5f} ms "
          f"(launched without bound); torch.eq(q, -1) over the same probe and mask "
          f"bytes {stream_ms:.5f} ms; the wrapper's host work "
          f"{wrapper_host_us(torch, SP):.3f} us a call", flush=True)
    out.append(dict(
        name="semijoin_probe",
        shape=f"q {tuple(q.shape)} keys {tuple(keys.shape)} bound={bound}",
        ms=ms,
        plain_ms=time_cold(torch, lambda: ref.semijoin_probe_ref(q, keys), plain_reps, flush),
        library_ms=time_cold(torch, lambda: torch.isin(q64, k64), reps, flush),
        max_abs_err=err, nbytes=nbytes, ops=ops,
    ))
    # -- sorted_probe_ranges (library yardstick: batched torch.searchsorted)
    q, keys = recorded["sorted_probe_ranges"][0]
    lo, hi = SO.sorted_probe_ranges(q, keys)
    rlo, rhi = ref.sorted_probe_ranges_ref(q, keys)
    err = max(
        int((lo.long() - rlo.long()).abs().max()) if lo.numel() else 0,
        int((hi.long() - rhi.long()).abs().max()) if hi.numel() else 0,
    )
    check(torch.equal(torch.searchsorted(keys, q, side="left").int(), rlo), "searchsorted yardstick")

    def lib():
        torch.searchsorted(keys, q, side="left")
        torch.searchsorted(keys, q, side="right")

    census = sorted_probe_census(torch, q, keys)
    print(f"sorted_probe_ranges census of the recorded call: {census}", flush=True)
    m = keys.shape[1]
    # probes read once, lo and hi written once, the valid keys read once:
    # the function never needs a padding key
    nbytes = q.numel() * 12 + census["valid_keys"] * 4
    # the searches these probes need: a lower bound and a gallop for each
    # probe no early out answers, a few compares for every probe
    searched = round(census["searched"] * q.numel())
    ops = 4 * q.numel() + searched * 2 * 4 * max(1, m.bit_length())
    out.append(dict(
        name="sorted_probe_ranges", shape=f"q {tuple(q.shape)} keys {tuple(keys.shape)}",
        ms=time_cold(torch, lambda: SO.sorted_probe_ranges(q, keys), reps, flush),
        plain_ms=time_cold(torch, lambda: ref.sorted_probe_ranges_ref(q, keys), plain_reps, flush),
        library_ms=time_cold(torch, lib, reps, flush),
        max_abs_err=err, nbytes=nbytes, ops=ops,
    ))
    recs = []
    for r in out:
        t_bytes = r["nbytes"] / HBM_BW * 1e3
        t_ops = r["ops"] / INT32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        print(
            f"kernel {r['name']}: {r['shape']} kernel_ms={r['ms']:.5f} "
            f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']} "
            f"bound_ms={bound:.6f} ({'bytes' if t_bytes >= t_ops else 'operations'}: "
            f"{r['nbytes']} B, {r['ops']} int ops) share_of_bound={bound / r['ms']:.4f} "
            f"max_abs_err={r['max_abs_err']} launches={launches[r['name']]}",
            flush=True,
        )
        check(r["max_abs_err"] == 0, f"{r['name']} disagrees with its plain version")
        recs.append({
            "name": r["name"], "route": "cuda", "source": GYM_SOURCE,
            "replaces": KERNELS[r["name"]], "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"],
        })
    return recs


# --------------------------------------------------------------- main path
@functools.lru_cache(maxsize=None)
def families(seed: int, real: bool):
    """S_8, C_8 and TC_9 with their GHDs and data, built once per process
    (the gym and grid phases drive the same data)."""
    from repro_torch.core import queries as Q
    from repro_torch.data import synthetic as D

    if not real:  # benchmarks/bench_shuffle.py sizes
        return {
            "S_8": (Q.star_query(8), Q.star_ghd(8),
                    D.star_data_sparse(8, domain=64, hub_rows=256, spoke_extra=64, seed=21)),
            "C_8": (Q.chain_query(8), Q.chain_ghd(8),
                    D.chain_data_sparse(8, domain=256, ident=64, extra=192, seed=24)),
            "TC_9": (Q.triangle_chain_query(3), Q.triangle_chain_ghd(3),
                     D.tc_data_sparse(3, domain=128, ident=32, extra=96, seed=22)),
        }
    return {
        "S_8": (Q.star_query(8), Q.star_ghd(8),
                real_star(8, hub_rows=2**20, spoke_extra=2**18, domain=2**22, seed=seed)),
        "C_8": (Q.chain_query(8), Q.chain_ghd(8),
                real_chain(8, ident=2**19, extra=2**19, domain=2**22, seed=seed + 1)),
        "TC_9": (Q.triangle_chain_query(3), Q.triangle_chain_ghd(3),
                 real_tc(3, ident=2**19, extra=2**19, domain=2**22, seed=seed + 2)),
    }


@functools.lru_cache(maxsize=None)
def real_answer(seed: int, fam: str):
    """The numpy join of a real-size family, computed once per process
    (the gym and grid phases check the same data)."""
    q, _, data = families(seed, True)[fam]
    return np_answer(q, data)


def peak_reset(torch) -> int:
    """Start a peak-memory window: returns the bytes already allocated
    (the recorders' kept inputs, say), which the run's peak is taken
    above, so a run's figure is the device memory it allocated itself."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def run_gym(torch, gym_mod, q, g, data, backend, strategy="hash"):
    cfg = gym_mod.GymConfig(strategy=strategy, seed=23, local_backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, schema, led = gym_mod.gym(q, data, ghd=g, p=8, config=cfg, device="cuda")
    torch.cuda.synchronize()
    return rows, schema, led, time.perf_counter() - t0


def main_path(torch, seed: int, sizes=("bench", "real"), strategy="hash", audit=None,
              hash_summary=None, warm: bool = True):
    """Drive default ``gym()`` (``strategy="hash"``, the gym phase) or
    ``GymConfig(strategy="grid")`` (the grid phase) over S_8/C_8/TC_9.  The
    gym phase requires every semijoin probe launch on its bitmap path; the
    grid phase's semijoins may pass a larger ``bound`` and then take the
    hash path, so ``audit`` (a ``SemijoinAudit``) checks there that no
    launch within the bitmap's bound took it.  ``hash_summary``: the gym
    phase's summary, whose comm the grid phase prints beside its own.
    ``warm``: repeat each 'cuda' run warm (the peak is then the warm run's,
    else the cold one's)."""
    from repro_torch.core import gym as gym_mod
    from repro_torch.kernels import ops as K

    phase = "gym" if strategy == "hash" else strategy
    summary = {}
    totals = {k: 0 for k in GYM_KERNELS}
    totals.update({"semijoin_probe/bitmap": 0, "semijoin_probe/hash": 0})
    for size in sizes:
        t0 = time.perf_counter()
        fams = families(seed, real=(size == "real"))
        n_in = {f: sum(len(v) for v in d.values()) for f, (_, _, d) in fams.items()}
        print(f"data {size}: built in {time.perf_counter() - t0:.2f} s; input tuples {n_in}", flush=True)
        for fam, (q, g, data) in fams.items():
            K.reset_launch_counts()
            if audit is not None:
                audit.reset()
            base = peak_reset(torch)
            rows, schema, led, cold = run_gym(torch, gym_mod, q, g, data, "cuda", strategy)
            per_run = {k: K.launch_counts()[k] for k in GYM_KERNELS}
            per_run.update({f"semijoin_probe/{k}": v
                            for k, v in K.semijoin_probe_path_counts().items()})
            check(K.launch_counts()["flash_attention"] == 0, "gym launched flash_attention")
            check(all(K.launch_counts()[k] == 0 for k in WIRE_KERNELS), "dense gym launched the codec")
            rows2, led2, warm_s = rows, led, None
            if warm:
                base = peak_reset(torch)
                rows2, _, led2, warm_s = run_gym(torch, gym_mod, q, g, data, "cuda", strategy)
            peak = torch.cuda.max_memory_allocated() - base
            for k in GYM_KERNELS:
                totals[k] += K.launch_counts()[k]
            for k, v in K.semijoin_probe_path_counts().items():
                totals[f"semijoin_probe/{k}"] += v
            K.reset_launch_counts()
            audited = audit.counts() if audit is not None else None
            trows, tschema, tled, tsec = run_gym(torch, gym_mod, q, g, data, "torch", strategy)
            check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
            recs = [dataclasses.asdict(r) for r in led.records]
            check(tuple(schema) == tuple(tschema) == tuple(q.output_attrs), f"{fam} {size}: schema")
            check(np.array_equal(rows, trows), f"{fam} {size}: cuda rows != torch rows")
            check(recs == [dataclasses.asdict(r) for r in tled.records], f"{fam} {size}: ledger records")
            check(led.retries == tled.retries and led.output_tuples == tled.output_tuples,
                  f"{fam} {size}: retries/output")
            check(np.array_equal(rows, rows2) and recs == [dataclasses.asdict(r) for r in led2.records],
                  f"{fam} {size}: warm run differs")
            check(rows.shape == (led.output_tuples, len(q.output_attrs)), f"{fam} {size}: shape")
            check(all(per_run[k] > 0 for k in GYM_KERNELS),
                  f"{fam} {size}: a kernel never launched {per_run}")
            if audit is None:
                check(per_run["semijoin_probe/hash"] == 0,
                      f"{fam} {size}: a semijoin_probe launch took the hash path {per_run}")
            else:
                audit.check(f"{phase} {fam} {size}")
            if size == "real":
                want = real_answer(seed, fam)
                check(np.array_equal(rows.astype(np.int64), want), f"{fam} real: rows != numpy join")
                check(led.output_tuples > 0, f"{fam} real: empty answer")
            hash_comm = ""
            if strategy != "hash":
                hs = (hash_summary or {}).get(f"{fam}/{size}")
                hash_comm = f" hash_engine_comm={hs['comm'] if hs else 'not run'}"
                hash_comm += f" semijoin_audit={audited}"
            print(
                f"{phase} {fam} {size}: inputs={n_in[fam]} out={led.output_tuples} "
                f"cold_s={cold:.4f} warm_s={'not run' if warm_s is None else f'{warm_s:.4f}'} "
                f"torch_backend_s={tsec:.4f} "
                f"rounds={led.rounds} dispatches={led.measured_dispatches} "
                f"measure_dispatches={led.measure_dispatches} retries={led.retries} "
                f"comm={led.comm_tuples}{hash_comm} padded_slots={led.padded_slots} "
                f"payload_bytes={led.payload_bytes} warm_peak_bytes={peak} "
                f"launches_per_run={per_run} cuda==torch rows+ledger: yes"
                + (" rows==numpy join: yes" if size == "real" else ""),
                flush=True,
            )
            summary[f"{fam}/{size}"] = dict(cold_s=cold, warm_s=warm_s, out=led.output_tuples,
                                            dispatches=led.measured_dispatches,
                                            rounds=led.rounds, retries=led.retries,
                                            comm=led.comm_tuples, padded=led.padded_slots,
                                            payload_bytes=led.payload_bytes, peak=peak,
                                            records=recs, launches=per_run,
                                            result=gym_result(rows, schema, led))
    return summary, totals


def profile_queries(torch, seed: int, fams, out_dir: str) -> None:
    """One profiled real-size query per family: host-side set-up
    (dedup, scatter, upload) timed apart from the run and from reading the
    rows back, ``torch.profiler`` over the run, the device's busy share,
    and the top kernels by device time (the operator table goes to
    ``out_dir``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.gym import GymConfig, GymDriver
    from repro_torch.relational.spmd import SPMD

    os.makedirs(out_dir, exist_ok=True)
    all_fams = families(seed, real=True)
    for fam in fams:
        q, g, data = all_fams[fam]
        cfg = GymConfig(strategy="hash", seed=23, local_backend="cuda")
        for _ in range(2):  # the second, warm, run is the profiled one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv = GymDriver(q, g, data, SPMD(8, device="cuda"), cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = drv.run()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                out.to_numpy()
            t3 = time.perf_counter()
        # device time = the kernels and copies the card ran (one stream, so
        # they do not overlap); launch-queue stalls are reported apart
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        stall_us = sum(e.time_range.elapsed_us() for e in dev_events
                       if e.name == "Command Buffer Full")
        busy_us = sum(e.time_range.elapsed_us() for e in dev_events
                      if e.name != "Command Buffer Full")
        ka = prof.key_averages()
        with open(os.path.join(out_dir, f"profile_{fam}.txt"), "w") as f:
            f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
        kern = {}
        for e in dev_events:
            if e.name != "Command Buffer Full":
                kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
        print(
            f"profile {fam} real (warm, profiled): setup_s={t1 - t0:.4f} "
            f"run_s={t2 - t1:.4f} rows_to_host_s={t3 - t2:.4f} "
            f"device_busy_s={busy_us / 1e6:.4f} device_busy_share_of_run={busy_us / 1e6 / (t2 - t1):.4f} "
            f"launch_queue_full_s={stall_us / 1e6:.4f}", flush=True,
        )
        for name, us in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {name[:70]:70s} device_ms={us / 1e3:.3f}", flush=True)


# ------------------------------------------------- grid and log-depth paths
class SemijoinAudit:
    """Wraps the semijoin probe's wrapper to split its launches by path and
    by the ``bound`` the caller passed: a launch whose bound fits the bitmap
    (``MAX_BITMAP_BITS``) must never take the hash path."""

    def __init__(self, SP, K):
        self.SP, self.K = SP, K
        self.orig = SP.semijoin_probe
        SP.semijoin_probe = self
        self.reset()

    def reset(self):
        self.tally = {"bitmap": 0, "hash": 0, "hash_bound_fits": 0, "hash_no_bound": 0}
        self.max_bound = 0

    def __call__(self, q, keys, bound=None):
        before = self.K.semijoin_probe_path_counts()
        out = self.orig(q, keys, bound=bound)
        after = self.K.semijoin_probe_path_counts()
        for path in ("bitmap", "hash"):
            self.tally[path] += after[path] - before[path]
        hashed = after["hash"] - before["hash"]
        if bound is None:
            self.tally["hash_no_bound"] += hashed
        else:
            self.max_bound = max(self.max_bound, bound)
            if bound <= self.SP.MAX_BITMAP_BITS:
                self.tally["hash_bound_fits"] += hashed
        return out

    def counts(self):
        return dict(self.tally, max_bound=self.max_bound)

    def check(self, what: str) -> None:
        check(self.tally["hash_bound_fits"] == 0 and self.tally["hash_no_bound"] == 0,
              f"{what}: a semijoin_probe launch took the hash path with a bound the "
              f"bitmap holds, or with none: {self.counts()}")

    def restore(self):
        self.SP.semijoin_probe = self.orig


class BagRecorder:
    """Wraps ``PhysicalExecutor.materialize`` to keep the largest bag
    (valid tuples, per-shard capacity) each materialization produced."""

    def __init__(self, physical):
        self.cls = physical.PhysicalExecutor
        self.orig = self.cls.materialize
        self.largest = (0, 0)
        rec = self

        def materialize(exe, ghd, base, node_schema, ledger):
            out = rec.orig(exe, ghd, base, node_schema, ledger)
            for t in out[0].values():
                rec.largest = max(rec.largest, (int(t.valid.sum().item()), t.cap))
            return out

        self.cls.materialize = materialize

    def restore(self):
        self.cls.materialize = self.orig


def np_bag_sizes(q, plan, data):
    """Tuples of each bag of ``plan`` — the join of the projections of
    lam(v) onto chi(v) — counted with numpy: a product of the projections'
    sizes where they share no attribute, else a fold of ``np_join``."""
    sizes = {}
    atoms = {a.alias: a for a in q.atoms}
    for v in plan.nodes():
        parts = []
        for alias in sorted(plan.lam[v]):
            at = atoms[alias]
            keep = [x for x in at.attrs if x in plan.chi[v]]
            rows = np.asarray(data[at.rel], np.int64)[:, [at.attrs.index(x) for x in keep]]
            parts.append((unique_rows(rows), tuple(keep)))
        attrs = [x for _, sch in parts for x in sch]
        if len(attrs) == len(set(attrs)):
            sizes[v] = int(np.prod([len(r) for r, _ in parts]))
            continue
        out, schema = parts[0]
        for rows, sch in parts[1:]:
            out, schema = np_join(out, schema, rows, sch)
        sizes[v] = len(unique_rows(out)) if len(out) else 0
    return sizes


def logdepth_workloads(seed: int):
    """The log-depth phase's plans: (name, query, data, entry point,
    keyword arguments, the plan the entry point runs, the least tuples its
    largest bag must hold)."""
    from repro_torch.core import acq_mr as A
    from repro_torch.core import gym as G
    from repro_torch.core import queries as Q
    from repro_torch.core.loggta import log_gta
    from repro_torch.core.loggta_prime import log_gta_prime
    from repro_torch.data import synthetic as D

    q16, g16 = Q.chain_query(16), Q.chain_ghd(16)
    d16 = real_chain(16, ident=LOGDEPTH_IDENT, extra=64, domain=4096, seed=seed + 3)
    tc, gtc = Q.triangle_chain_query(5), Q.triangle_chain_ghd(5)
    dtc = D.tc_data_sparse(5, domain=128, ident=32, extra=96, seed=22)
    g16c, gtcc = g16.make_complete(q16), gtc.make_complete(tc)
    return [
        ("C_16 chain_ghd(16)", q16, d16, G.gym, dict(ghd=g16), g16c, 0),
        ("C_16 Log-GTA (gym_loggta)", q16, d16, A.gym_loggta, dict(ghd=g16),
         log_gta(g16c, q16), LOGDEPTH_MIN_BAG),
        ("C_16 Log-GTA' (acq_mr)", q16, d16, A.acq_mr, dict(ghd=g16),
         log_gta_prime(g16c, q16), LOGDEPTH_MIN_BAG),
        ("TC_15 Log-GTA (gym_loggta)", tc, dtc, A.gym_loggta, dict(ghd=gtc), log_gta(gtcc, tc), 0),
    ]


def logdepth_phase(torch, seed: int, audit):
    """The paper's log-depth path on the card: C_16 under chain_ghd(16),
    GYM(Log-GTA) and ACQ-MR (GYM on Log-GTA'), TC_15 under GYM(Log-GTA),
    and the one-round Shares baseline on the Table-2 query.  Each: 'cuda'
    == 'torch' in rows, schema and records, rows == the numpy join.
    Returns (summary, launches over the phase's 'cuda' runs)."""
    from repro_torch.core import gym as G
    from repro_torch.core import physical
    from repro_torch.core import queries as Q
    from repro_torch.core import shares as S
    from repro_torch.data import synthetic as D
    from repro_torch.kernels import ops as K

    totals = {k: 0 for k in GYM_KERNELS}
    summary = {}

    def tally():
        for k in GYM_KERNELS:
            totals[k] += K.launch_counts()[k]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    bags = BagRecorder(physical)
    try:
        for name, q, data, entry, kw, plan, min_bag in logdepth_workloads(seed):
            want = np_answer(q, data)
            want_bag = max(np_bag_sizes(q, plan, data).values())

            def run(backend):
                cfg = G.GymConfig(seed=23, local_backend=backend, max_cap_tuples=LOGDEPTH_MAX_CAP)
                return entry(q, data, p=8, config=cfg, device="cuda", **kw)

            K.reset_launch_counts()
            audit.reset()
            bags.largest = (0, 0)
            torch.cuda.reset_peak_memory_stats()
            (rows, schema, led), cold = timed(lambda: run("cuda"))
            peak = torch.cuda.max_memory_allocated()
            bag = bags.largest
            per_run = {k: K.launch_counts()[k] for k in GYM_KERNELS}
            audited = audit.counts()
            audit.check(f"logdepth {name}")
            tally()
            K.reset_launch_counts()
            (trows, tschema, tled), tsec = timed(lambda: run("torch"))
            check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
            recs = [dataclasses.asdict(r) for r in led.records]
            check(tuple(schema) == tuple(tschema) == tuple(q.output_attrs), f"{name}: schema")
            check(np.array_equal(rows, trows), f"{name}: cuda rows != torch rows")
            check(recs == [dataclasses.asdict(r) for r in tled.records], f"{name}: ledger records")
            check((led.retries, led.output_tuples) == (tled.retries, tled.output_tuples),
                  f"{name}: retries/output")
            check(np.array_equal(rows.astype(np.int64), want) and len(want) > 0,
                  f"{name}: rows != numpy join")
            check(bag[0] == want_bag, f"{name}: largest bag {bag[0]} != numpy's {want_bag}")
            check(bag[0] >= min_bag, f"{name}: largest bag {bag[0]} < {min_bag} tuples")
            print(
                f"logdepth {name}: inputs={sum(len(v) for v in data.values())} "
                f"out={led.output_tuples} depth={plan.depth} "
                f"largest_bag_tuples={bag[0]} (per-shard cap {bag[1]}; numpy: {want_bag}) "
                f"peak_device_bytes={peak} cold_s={cold:.4f} "
                f"torch_backend_s={tsec:.4f} rounds={led.rounds} comm={led.comm_tuples} "
                f"dispatches={led.measured_dispatches} measure_dispatches={led.measure_dispatches} "
                f"retries={led.retries} padded_slots={led.padded_slots} "
                f"launches_per_run={per_run} semijoin_audit={audited} "
                "cuda==torch rows+ledger: yes rows==numpy join: yes", flush=True,
            )
            summary[name] = dict(rounds=led.rounds, comm=led.comm_tuples, bag=bag[0], peak=peak,
                                 cold_s=cold, launches=per_run, result=gym_result(rows, schema, led))
    finally:
        bags.restore()
    # the Table-2 query under the one-round Shares baseline
    q, data = Q.star_query(5), D.star_data_sparse(5, seed=1)
    K.reset_launch_counts()
    (rows, schema, led), cold = timed(lambda: S.shares_join(q, data, p=8, seed=2, device="cuda"))
    per_run = {k: K.launch_counts()[k] for k in GYM_KERNELS}
    tally()
    K.reset_launch_counts()
    trows, tschema, tled = S.shares_join(q, data, p=8, seed=2, local_backend="torch", device="cuda")
    check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
    check(np.array_equal(rows, trows) and tuple(schema) == tuple(tschema),
          "shares: cuda rows != torch rows")
    check([dataclasses.asdict(r) for r in led.records] == [dataclasses.asdict(r) for r in tled.records],
          "shares: ledger records")
    check(np.array_equal(rows.astype(np.int64), np_answer(q, data)), "shares: rows != numpy join")
    print(f"logdepth S_5 Shares (shares_join): out={led.output_tuples} rounds={led.rounds} "
          f"comm={led.comm_tuples} retries={led.retries} cold_s={cold:.4f} "
          f"launches_per_run={per_run} cuda==torch rows+ledger: yes rows==numpy join: yes",
          flush=True)
    summary["S_5 Shares"] = dict(rounds=led.rounds, comm=led.comm_tuples, launches=per_run,
                                 result=gym_result(rows, schema, led))
    return summary, totals


# ------------------------------------------------------------ skew phase
SKEW_ENGINES = ("hash", "grid", "hybrid")
# benchmarks/bench_skew.py's capacity ceiling for its bench-size families
SKEW_BENCH_MAX_CAP = 1 << 18
# the real S_8_heavy's hub rows (its spokes' extra rows a quarter of it):
# the gym phase's real S_8 scale
SKEW_REAL_HUB = 2**20


@functools.lru_cache(maxsize=None)
def skew_families(seed: int, real: bool):
    """The skew phase's instances: at bench size the five families of
    ``benchmarks/bench_skew.py`` (their own seeds), at real size the
    planted heavy key at the gym phase's S_8 scale (from ``seed``)."""
    from repro_torch.core import queries as Q
    from repro_torch.data import synthetic as D

    star = (Q.star_query(8), Q.star_ghd(8))
    chain = (Q.chain_query(8), Q.chain_ghd(8))
    if not real:
        return {
            "S_8_z0": star + (D.star_data_zipf(8, domain=64, hub_rows=256, spoke_extra=32, s=0.0, seed=31),),
            "S_8_z11": star + (D.star_data_zipf(8, domain=64, hub_rows=256, spoke_extra=32, s=1.1, seed=31),),
            "C_8_z0": chain + (D.chain_data_zipf(8, domain=96, rows=192, s=0.0, seed=34),),
            "C_8_z11": chain + (D.chain_data_zipf(8, domain=96, rows=192, s=1.1, seed=34),),
            "S_8_heavy": star + (D.star_data_heavy(8, domain=64, hub_rows=256, heavy_share=0.8,
                                                   spoke_extra=16, seed=5),),
        }
    return {"S_8_heavy": star + (real_star_heavy(8, hub_rows=SKEW_REAL_HUB, heavy_share=0.8,
                                                 spoke_extra=SKEW_REAL_HUB // 4, domain=2**22,
                                                 seed=seed),)}


@functools.lru_cache(maxsize=None)
def skew_answer(seed: int, fam: str):
    """The numpy join of a real-size skew family, computed once per
    process (the skew and wire phases check the same data)."""
    q, _, data = skew_families(seed, True)[fam]
    return np_answer(q, data)


class HeavyRecorder:
    """Wraps ``PhysicalExecutor._measure_stage`` to sum the heavy
    destinations its measures flagged and count the hybrid-routed groups."""

    def __init__(self, physical):
        self.cls = physical.PhysicalExecutor
        self.orig = self.cls._measure_stage
        self.reset()
        rec = self

        def measure_stage(exe, groups, resolve, pending=None):
            out = rec.orig(exe, groups, resolve, pending)
            for m in out[0]:
                if m is not None:
                    rec.n_heavy += m.n_heavy
                    rec.routed += int(m.hybrid_routed)
            return out

        self.cls._measure_stage = measure_stage

    def reset(self):
        self.n_heavy = 0
        self.routed = 0

    def restore(self):
        self.cls._measure_stage = self.orig


def skew_phase(torch, seed: int, audit, gym_summary=None, sizes=("bench", "real")):
    """The hybrid engine beside hash and grid on the skew families (see
    the module doc).  Returns (summary, launches over the phase's 'cuda'
    runs)."""
    from repro_torch.core import gym as G
    from repro_torch.core import physical
    from repro_torch.kernels import ops as K

    totals = {k: 0 for k in GYM_KERNELS}
    totals.update({"semijoin_probe/bitmap": 0, "semijoin_probe/hash": 0})
    summary = {}

    def run(q, g, data, backend, strategy, max_cap):
        cfg = G.GymConfig(strategy=strategy, seed=23, local_backend=backend, max_cap_tuples=max_cap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.gym(q, data, ghd=g, p=8, config=cfg, device="cuda")
        torch.cuda.synchronize()
        return out + (time.perf_counter() - t0,)

    def drive(name, q, g, data, strategy, max_cap, want=None, twin=True):
        """A cold 'cuda' run and a 'torch' run, checked against each other
        (and ``want``, the numpy join at real size); None when both
        backends hit the ceiling.  No warm repeat: the script's time limit
        (bench-size seconds measure launch and host overhead; real-size
        warm runs were 0.95-1.07x the cold ones, PERF.md section 6).
        ``twin=False`` leaves out the 'torch' run where the caller holds
        the 'cuda' run to records that the 'torch' backend already gave."""
        K.reset_launch_counts()
        audit.reset()
        heavy.reset()
        try:
            rows, schema, led, cold = run(q, g, data, "cuda", strategy, max_cap)
        except physical.CapacityCeiling as e:
            check(strategy == "hash", f"{name} {strategy}: {e}")
            try:
                run(q, g, data, "torch", strategy, max_cap)
            except physical.CapacityCeiling:
                print(f"skew {name} {strategy}: CapacityCeiling on both backends ({e})", flush=True)
                return None
            raise SmokeFailure(f"{name} {strategy}: only the 'cuda' backend hit the ceiling")
        per_run = {k: K.launch_counts()[k] for k in GYM_KERNELS}
        per_run.update({f"semijoin_probe/{k}": v for k, v in K.semijoin_probe_path_counts().items()})
        flagged, routed = heavy.n_heavy, heavy.routed
        audited = audit.counts()
        audit.check(f"skew {name} {strategy}")
        recs = [dataclasses.asdict(r) for r in led.records]
        for k in GYM_KERNELS:
            totals[k] += K.launch_counts()[k]
        for k, v in K.semijoin_probe_path_counts().items():
            totals[f"semijoin_probe/{k}"] += v
        check(tuple(schema) == tuple(q.output_attrs), f"{name} {strategy}: schema")
        tsec = None
        if twin:
            K.reset_launch_counts()
            trows, tschema, tled, tsec = run(q, g, data, "torch", strategy, max_cap)
            check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
            check(tuple(schema) == tuple(tschema), f"{name} {strategy}: schema")
            check(np.array_equal(rows, trows), f"{name} {strategy}: cuda rows != torch rows")
            check(recs == [dataclasses.asdict(r) for r in tled.records],
                  f"{name} {strategy}: ledger records")
            check((led.retries, led.output_tuples) == (tled.retries, tled.output_tuples),
                  f"{name} {strategy}: retries/output")
        check(all(per_run[k] > 0 for k in GYM_KERNELS), f"{name} {strategy}: a kernel never launched")
        if want is not None:
            check(np.array_equal(rows.astype(np.int64), want) and len(want) > 0,
                  f"{name} {strategy}: rows != numpy join")
        print(
            f"skew {name} {strategy}: out={led.output_tuples} comm={led.comm_tuples} "
            f"shuffle_tuples={led.shuffle_tuples} padded_slots={led.padded_slots} "
            f"heavy_tuples={led.heavy_tuples} light_tuples={led.light_tuples} "
            f"n_heavy={flagged} hybrid_routed_groups={routed} retries={led.retries} "
            f"rounds={led.rounds} dispatches={led.measured_dispatches} "
            f"measure_dispatches={led.measure_dispatches} cold_s={cold:.4f} "
            f"torch_backend_s={'not run' if tsec is None else f'{tsec:.4f}'} "
            f"launches_per_run={per_run} semijoin_audit={audited} "
            + ("cuda==torch rows+ledger: yes" if twin else "no 'torch' twin")
            + (" rows==numpy join: yes" if want is not None else ""),
            flush=True,
        )
        summary[f"{name}/{strategy}"] = dict(
            out=led.output_tuples, comm=led.comm_tuples, padded=led.padded_slots,
            heavy=led.heavy_tuples, retries=led.retries, dispatches=led.measured_dispatches,
            n_heavy=flagged, cold_s=cold, launches=per_run,
        )
        return rows, led

    heavy = HeavyRecorder(physical)
    try:
        for size in sizes:
            real = size == "real"
            for fam, (q, g, data) in skew_families(seed, real).items():
                name = f"{fam} {size}"
                want = skew_answer(seed, fam) if real else None
                res = {e: drive(name, q, g, data, e, None if real else SKEW_BENCH_MAX_CAP, want)
                       for e in SKEW_ENGINES}
                sets = [unique_rows(r[0].astype(np.int64)) for r in res.values() if r]
                check(all(np.array_equal(x, sets[0]) for x in sets), f"{name}: engines disagree on rows")
                hyb = res["hybrid"][1]
                check(hyb.retries == 0, f"{name}: hybrid made {hyb.retries} retries")
                if fam == "S_8_heavy":
                    check(hyb.heavy_tuples > 0, f"{name}: no heavy tuples under hybrid")
                    if res["hash"] is not None:
                        check(hyb.padded_slots < res["hash"][1].padded_slots,
                              f"{name}: hybrid padded {hyb.padded_slots} >= hash "
                              f"{res['hash'][1].padded_slots}")
        if "real" in sizes:
            # the uniform control: the gym phase's real S_8 under hybrid must
            # be the hash engine's run, record for record.  That run's
            # records are the 'torch' backend's (the gym phase holds them
            # so), so the control needs no 'torch' twin of its own then
            q, g, data = families(seed, True)["S_8"]
            hs = (gym_summary or {}).get("S_8/real")
            rows, led = drive("S_8 real (uniform control)", q, g, data, "hybrid", None,
                              real_answer(seed, "S_8"), twin=hs is None)
            if hs is None:  # the gym phase did not run: run its hash query here
                hrows, _, hled, _ = run(q, g, data, "cuda", "hash", None)
                hs = dict(records=[dataclasses.asdict(r) for r in hled.records])
            check([dataclasses.asdict(r) for r in led.records] == hs["records"],
                  "uniform control: hybrid records != the hash run's")
            check(led.heavy_tuples == 0, "uniform control: heavy tuples on uniform data")
            print(f"skew S_8 real (uniform control): hybrid == hash record for record "
                  f"(comm={led.comm_tuples} padded_slots={led.padded_slots} "
                  f"dispatches={led.measured_dispatches} heavy_tuples=0)"
                  + ("" if hs.get("result") is None else
                     "; the hash run's records are the gym phase's, == its 'torch' run's"),
                  flush=True)
    finally:
        heavy.restore()
    return summary, totals


# ------------------------------------------------------------ packed wire
def wire_edge_checks(torch, dev):
    """The codec kernels' bytes exactly equal to the plain bit-plane
    version's, and decode the exact inverse, at edge cases: arity 0,
    negative 32-bit columns, c off a multiple of 8 and c = 0, empty and
    full buckets, row_bits from 2 to 1 + 8 * 32, many segments, and the
    golden fixture's bytes."""
    from repro_torch.kernels import wire_codec as WC
    from repro_torch.relational import wire as W

    rng = np.random.default_rng(11)
    n_checks = 0
    cases = [((), 5, 37, "random"), ((32, 32), 3, 64, "random"), ((6,) * 7, 8, 33, "random"),
             ((6,) * 7, 8, 0, "random"), ((5, 1, 17), 4, 40, "empty"), ((5, 1, 17), 4, 40, "full"),
             ((21,) * 7, 64, 4099, "random")]
    cases += [((b,) * k, 3, 24, "random") for b, k in ((1, 1), (3, 1), (31, 1), (32, 1), (7, 5),
                                                        (32, 4), (32, 8))]
    for col_bits, segs, c, occ in cases:
        cols = []
        for nb in col_bits:
            lo = -(2**31) if nb == 32 else 0
            cols.append(rng.integers(lo, 2**nb if nb < 32 else 2**31, (segs, c)).astype(np.int32))
        buf = np.stack(cols, -1) if cols else np.zeros((segs, c, 0), np.int32)
        valid = {"empty": np.zeros((segs, c), bool), "full": np.ones((segs, c), bool)}.get(
            occ, rng.random((segs, c)) < 0.6)
        fmt = W.WireFormat(col_bits)
        tb, tv = torch.from_numpy(buf).to(dev), torch.from_numpy(valid).to(dev)
        got = WC.wire_encode(tb, tv, fmt)
        check(torch.equal(got, W.wire_encode(tb, tv, fmt)),
              f"wire_encode != plain at bits {col_bits} segments {segs} c {c} {occ}")
        b2, v2 = WC.wire_decode(got, fmt, c)
        check(torch.equal(b2, tb) and torch.equal(v2, tv),
              f"wire_decode does not invert encode at bits {col_bits} c {c} {occ}")
        n_checks += 2
    z = np.load(os.path.join(HERE, "tests", "fixtures", "wire_s8_packed.npz"))
    fmt = W.WireFormat(tuple(int(b) for b in z["col_bits"]))
    packed = torch.from_numpy(z["wire"]).to(dev)
    b2, v2 = WC.wire_decode(packed, fmt, int(z["c_out"]))
    pb, pv = W.wire_decode(packed, fmt, int(z["c_out"]))
    check(torch.equal(b2, pb) and torch.equal(v2, pv), "wire_decode != plain on the golden fixture")
    check(torch.equal(WC.wire_encode(b2, v2, fmt), packed), "wire_encode != the golden fixture bytes")
    torch.cuda.synchronize()
    return n_checks + 2


def advisor_key(q, g, data, wire_format, p=8, deduped=False):
    """The plan ``GymConfig(plan="auto")`` should choose, computed on the
    host from the same statistics ``GymDriver`` uses (``deduped``: every
    relation is already a set, as ``real_chain``/``real_star`` make them,
    so the distinct counts are the row counts)."""
    from repro_torch.core import optimizer as O
    from repro_torch.core.costs import DEFAULT_DISPATCH_OVERHEAD_SLOTS
    from repro_torch.relational.wire import WirePolicy, wire_gain

    rows = {a.alias: (np.asarray(data[a.rel], np.int32) if deduped
                      else unique_rows(np.asarray(data[a.rel], np.int32))) for a in q.atoms}
    stats = {a.rel: int(rows[a.alias].shape[0]) for a in q.atoms}
    skew = {a.rel: O.skew_share(rows[a.alias]) for a in q.atoms}
    pol = WirePolicy.from_columns([(a.attrs, rows[a.alias]) for a in q.atoms])
    wg = wire_gain([pol.format_for(a.attrs) for a in q.atoms]) if wire_format == "packed" else 1.0
    return O.choose_plan(
        q, stats, profile=O.MachineProfile(p=p, dispatch_overhead=DEFAULT_DISPATCH_OVERHEAD_SLOTS),
        hand_ghd=g, local_backend=None, calibrate_shuffle=True, skew=skew,
        calibrate_options=(True, False), wire_gain=wg,
    ).key


def wire_phase(torch, seed: int, audit, gym_summary=None, sizes=("bench", "real")):
    """The packed wire and the plan advisor (see the module doc).  Returns
    (summary, launches over the phase's 'cuda' runs, recorded codec calls)."""
    from repro_torch.core import gym as G
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import wire_codec as WC
    from repro_torch.relational.spmd import SPMD

    kernels = GYM_KERNELS + WIRE_KERNELS
    totals = {k: 0 for k in kernels}
    summary = {}

    def run(q, g, data, backend, **cfg):
        """One query: (rows, schema, ledger, seconds, the chosen plan's key,
        engine and backend, the executor's backend).  Nothing of the
        driver is kept, so its device tables are freed before the next."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv = G.GymDriver(q, g, data, SPMD(8, device="cuda"),
                          G.GymConfig(seed=23, local_backend=backend, **cfg))
        out = drv.run()
        rows = out.to_numpy()
        torch.cuda.synchronize()
        plan = None if drv.plan is None else (
            drv.plan.key, drv.plan.engine, drv.plan.local_backend, drv.executor.local_backend)
        return rows, out.schema, drv.ledger, time.perf_counter() - t0, plan

    def counted(fn):
        K.reset_launch_counts()
        audit.reset()
        res = fn()
        per = {k: K.launch_counts()[k] for k in kernels}
        for k in kernels:
            totals[k] += per[k]
        return res, per

    def same(a, b, what):
        check(tuple(a[1]) == tuple(b[1]), f"{what}: schema")
        check(np.array_equal(a[0], b[0]), f"{what}: rows")
        check([dataclasses.asdict(r) for r in a[2].records] == [dataclasses.asdict(r) for r in b[2].records],
              f"{what}: ledger records")
        check((a[2].retries, a[2].output_tuples) == (b[2].retries, b[2].output_tuples),
              f"{what}: retries/output")

    recorders = {"wire_encode": Recorder(torch, WC, "wire_encode"),
                 "wire_decode": Recorder(torch, WC, "wire_decode")}
    try:
        if "bench" in sizes:
            for fam, (q, g, data) in families(seed, False).items():
                want = np_answer(q, data)
                for engine in ("hash", "grid", "hybrid"):
                    name = f"wire {fam} bench {engine}"
                    packed, per = counted(lambda: run(q, g, data, "cuda", strategy=engine,
                                                      wire_format="packed"))
                    audit.check(name)
                    check(all(per[k] > 0 for k in kernels), f"{name}: a kernel never launched {per}")
                    K.reset_launch_counts()
                    tpacked = run(q, g, data, "torch", strategy=engine, wire_format="packed")
                    check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
                    same(packed, tpacked, f"{name} cuda vs torch")
                    dense, _ = counted(lambda: run(q, g, data, "cuda", strategy=engine))
                    lp, ld = packed[2], dense[2]
                    check(np.array_equal(unique_rows(packed[0].astype(np.int64)), want),
                          f"{name}: rows != numpy join")
                    check(np.array_equal(packed[0], dense[0]) and lp.comm_tuples == ld.comm_tuples
                          and lp.retries == ld.retries and lp.useful_bytes == ld.useful_bytes,
                          f"{name}: packed and dense disagree in rows, comm, retries or useful bytes")
                    check(lp.payload_bytes < ld.payload_bytes, f"{name}: packed bytes >= dense")
                    print(f"{name}: out={lp.output_tuples} comm={lp.comm_tuples} retries={lp.retries} "
                          f"payload_bytes packed={lp.payload_bytes} dense={ld.payload_bytes} "
                          f"(ratio {lp.payload_bytes / ld.payload_bytes:.4f}) padded_slots "
                          f"packed={lp.padded_slots} dense={ld.padded_slots} dispatches "
                          f"packed={lp.measured_dispatches} dense={ld.measured_dispatches} "
                          f"cold_s={packed[3]:.4f} launches={per} cuda==torch rows+ledger: yes "
                          "rows==numpy join: yes", flush=True)
                    summary[f"{fam}/bench/{engine}"] = dict(
                        payload=lp.payload_bytes, dense_payload=ld.payload_bytes, launches=per,
                        packed=gym_result(*packed[:3]), dense=gym_result(*dense[:3]))
        if "real" in sizes:
            for fam, (q, g, data) in families(seed, True).items():
                name = f"wire {fam} real hash"
                want = real_answer(seed, fam)
                cold, per = counted(lambda: run(q, g, data, "cuda", wire_format="packed"))
                audit.check(name)
                base = peak_reset(torch)
                warm, _ = counted(lambda: run(q, g, data, "cuda", wire_format="packed"))
                peak = torch.cuda.max_memory_allocated() - base
                check(all(per[k] > 0 for k in kernels), f"{name}: a kernel never launched {per}")
                same(cold, warm, f"{name} warm run")
                check(np.array_equal(cold[0].astype(np.int64), want) and len(want) > 0,
                      f"{name}: rows != numpy join")
                gs = (gym_summary or {}).get(f"{fam}/real")
                if gs is None:  # the gym phase did not run: run its dense query here
                    base = peak_reset(torch)
                    d = run(q, g, data, "cuda")
                    gs = dict(payload_bytes=d[2].payload_bytes,
                              peak=torch.cuda.max_memory_allocated() - base,
                              comm=d[2].comm_tuples, warm_s=d[3])
                led = cold[2]
                check(led.comm_tuples == gs["comm"] and led.retries == 0,
                      f"{name}: comm or retries differ from the dense run")
                check(led.payload_bytes < gs["payload_bytes"], f"{name}: packed bytes >= dense")
                check(peak <= WIRE_PEAK_RATIO_MAX * gs["peak"],
                      f"{name}: packed peak {peak} > {WIRE_PEAK_RATIO_MAX} x dense {gs['peak']}")
                print(f"{name}: out={led.output_tuples} comm={led.comm_tuples} retries={led.retries} "
                      f"payload_bytes packed={led.payload_bytes} dense={gs['payload_bytes']} "
                      f"(ratio {led.payload_bytes / gs['payload_bytes']:.4f}) padded_slots="
                      f"{led.padded_slots} dispatches={led.measured_dispatches} peak_bytes "
                      f"packed={peak} dense={gs['peak']} (ratio {peak / gs['peak']:.4f}) "
                      f"cold_s={cold[3]:.4f} warm_s={warm[3]:.4f} dense_warm_s={gs['warm_s']:.4f} "
                      f"launches={per} rows==numpy join: yes", flush=True)
                summary[f"{fam}/real"] = dict(payload=led.payload_bytes, dense_payload=gs["payload_bytes"],
                                              peak=peak, dense_peak=gs["peak"], cold_s=cold[3],
                                              warm_s=warm[3], launches=per)
        # the advisor: plan="auto" with the packed wire (so the codec runs
        # too), its key against the host-side choice from the same statistics
        auto = [(f"{fam} bench", q, g, data, False) for fam, (q, g, data) in
                (families(seed, False).items() if "bench" in sizes else [])]
        if "real" in sizes:
            auto += [(f"{fam} real", q, g, data, True) for fam, (q, g, data) in
                     families(seed, True).items()]
            q, g, data = skew_families(seed, True)["S_8_heavy"]
            auto.append(("S_8_heavy real", q, g, data, True))
        for name, q, g, data, real in auto:
            key = advisor_key(q, g, data, "packed", deduped=real)
            # local_backend None: the device's default, which the plan must keep
            res, per = counted(lambda: run(q, g, data, None, plan="auto", wire_format="packed"))
            audit.check(f"wire auto {name}")
            rows, _, led, sec, (pkey, pengine, pbackend, ebackend) = res
            check(pkey == key, f"auto {name}: chose {pkey}, the host advisor {key}")
            check(pbackend is None and ebackend == "cuda",
                  f"auto {name}: the plan turned the kernels off")
            check(all(per[k] > 0 for k in kernels), f"auto {name}: a kernel never launched {per}")
            want = (np_answer(q, data) if not real else skew_answer(seed, "S_8_heavy")
                    if name.startswith("S_8_heavy") else real_answer(seed, name.split()[0]))
            check(np.array_equal(unique_rows(rows.astype(np.int64)), want) and len(want) > 0,
                  f"auto {name}: rows != numpy join")
            if not real:
                K.reset_launch_counts()
                tres = run(q, g, data, "torch", plan="auto", wire_format="packed")
                check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
                same(res, tres, f"auto {name} cuda vs torch")
                check(tres[4][0] == pkey, f"auto {name}: the 'torch' run chose {tres[4][0]}")
            print(f"wire auto {name}: plan={pkey} (host advisor: same) engine="
                  f"{pengine} out={led.output_tuples} comm={led.comm_tuples} "
                  f"rounds={led.rounds} retries={led.retries} dispatches={led.measured_dispatches} "
                  f"payload_bytes={led.payload_bytes} cold_s={sec:.4f} launches={per} "
                  "rows==numpy join: yes", flush=True)
            summary[f"auto/{name}"] = dict(key=pkey, launches=per, cold_s=sec)
    finally:
        for r in recorders.values():
            r.restore()
    return summary, totals, {k: (r.best, r.kw) for k, r in recorders.items()}


def wire_timing(torch, recorded, launches, reps):
    """Time the codec kernels at the largest calls the wire phase gave
    them, beside the plain bit-plane versions (no library call computes
    the codec).  Returns the kernel records of the JSON line."""
    from repro_torch.kernels import wire_codec as WC
    from repro_torch.relational import wire as W

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.int32, device=dev)
    (buf, valid, fmt), _ = recorded["wire_encode"]
    (packed, dfmt, c_out), _ = recorded["wire_decode"]
    got = WC.wire_encode(buf, valid, fmt)
    enc_err = 0 if torch.equal(got, W.wire_encode(buf, valid, fmt)) else 1
    db, dv = WC.wire_decode(packed, dfmt, c_out)
    pb, pv = W.wire_decode(packed, dfmt, c_out)
    dec_err = max(int((db.long() - pb.long()).abs().max()) if db.numel() else 0,
                  int((dv != pv).sum()))
    plain_reps = max(1, min(reps, 5))
    rows = [
        dict(name="wire_encode", shape=f"buf {tuple(buf.shape)} bits {fmt.col_bits}",
             ms=time_cold(torch, lambda: WC.wire_encode(buf, valid, fmt), reps, flush),
             plain_ms=time_cold(torch, lambda: W.wire_encode(buf, valid, fmt), plain_reps, flush),
             err=enc_err, nbytes=buf.numel() * 4 + valid.numel() + got.numel(),
             ops=valid.numel() * fmt.row_bits * 3),
        dict(name="wire_decode", shape=f"packed {tuple(packed.shape)} c_out {c_out} bits {dfmt.col_bits}",
             ms=time_cold(torch, lambda: WC.wire_decode(packed, dfmt, c_out), reps, flush),
             plain_ms=time_cold(torch, lambda: W.wire_decode(packed, dfmt, c_out), plain_reps, flush),
             err=dec_err, nbytes=packed.numel() + db.numel() * 4 + dv.numel(),
             ops=dv.numel() * dfmt.row_bits * 3),
    ]
    recs = []
    for r in rows:
        t_bytes = r["nbytes"] / HBM_BW * 1e3
        t_ops = r["ops"] / INT32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        print(f"kernel {r['name']}: {r['shape']} kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms=None bound_ms={bound:.6f} ({'bytes' if t_bytes >= t_ops else 'operations'}: "
              f"{r['nbytes']} B, {r['ops']} int ops) share_of_bound={bound / r['ms']:.4f} "
              f"max_abs_err={r['err']} launches={launches[r['name']]}", flush=True)
        check(r["err"] == 0, f"{r['name']} disagrees with its plain version")
        recs.append({
            "name": r["name"], "route": "cuda", "source": WIRE_SOURCE,
            "replaces": KERNELS[r["name"]], "launches": launches[r["name"]],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    return recs


# ------------------------------------------------------- flash attention
# ------------------------------------------------------- snapshot phase
def _rand_data(q, rng, dom: int = 6, rows: int = 12):
    """Random relations over a small shared domain, drawn as the
    reference's ``tests/test_gym_engine.py::rand_data`` draws them."""
    out = {}
    for atom in q.atoms:
        n = rng.randint(1, rows)
        out[atom.rel] = np.array(
            [[rng.randint(0, dom - 1) for _ in atom.attrs] for _ in range(n)], dtype=np.int32)
    return out


def _small_chain(n: int, seed: int, rows: int, hi: int):
    """``tests/test_local_backend.py``'s chain data: ``rows`` random links
    over [0, hi] per relation."""
    rng = random.Random(seed)
    return {f"R{i}": np.asarray([[rng.randint(0, hi), rng.randint(0, hi)] for _ in range(rows)],
                                np.int32) for i in range(1, n + 1)}


def snapshot_cases():
    """The reference's snapshot scenarios at their own sizes (p = 4):
    ``examples/gym_fault_tolerance.py`` and the snapshot tests of
    ``tests/test_gym_engine.py``, ``test_caps_cache.py``,
    ``test_skew_hybrid.py``, ``test_wire_format.py``, ``test_optimizer.py``
    (two) and ``test_local_backend.py`` (two).  Each is (name, query, ghd,
    data, config, steps before the snapshot (None: to completion),
    resuming config); the resuming config is the test's, which the
    snapshot's must override."""
    from repro_torch.core import queries as Q
    from repro_torch.core.decompose import ghd_for
    from repro_torch.data import synthetic as D

    c3, c4, c5, c6 = (Q.chain_query(n) for n in (3, 4, 5, 6))
    s8 = (Q.star_query(8), Q.star_ghd(8))
    wire = dict(strategy="hash", seed=3, calibrate_shuffle=True, wire_format="packed")
    return [
        ("fault_tolerance", c6, ghd_for(c6), D.chain_data_sparse(6, seed=5), dict(seed=9), 4,
         dict(seed=9)),
        ("driver", c5, ghd_for(c5), _rand_data(c5, random.Random(42)), dict(seed=1), 2,
         dict(seed=1)),
        ("caps_cache", Q.star_query(4), Q.star_ghd(4), D.star_data_sparse(4, seed=7),
         dict(seed=11), 2, dict(seed=11)),
        ("hybrid", *s8, D.star_data_heavy(8, hub_rows=64, heavy_share=0.8, domain=32,
                                          spoke_extra=8, seed=5),
         dict(strategy="hybrid", seed=3, skew_threshold=3.0), 2, dict(seed=3)),
        ("wire", c4, Q.chain_ghd(4), D.chain_data_sparse(4, seed=7), wire, 1,
         dict(wire, wire_format="dense")),
        ("plan_star", *s8, D.star_data_sparse(8, seed=21), dict(plan="auto", seed=2), 2,
         dict(plan="auto", seed=2)),
        ("plan_tc", Q.triangle_chain_query(3), Q.triangle_chain_ghd(3),
         D.tc_data_sparse(3, seed=22), dict(plan="auto", seed=3), 2, dict(seed=3)),
        # the backend is pinned (the reference pins 'pallas'; here each run's)
        ("backend", c4, ghd_for(c4), _small_chain(4, 42, 10, 5), dict(seed=1, pin=True), 2,
         dict(seed=1)),
        ("completed", c3, ghd_for(c3), _small_chain(3, 7, 8, 4), dict(seed=1), None,
         dict(seed=1)),
    ]


def snapshot_phase(torch, seed: int, audit, gym_summary=None, sizes=("bench", "real")):
    """Snapshot / resume (see the module doc).  Returns (summary, launches
    over the phase's 'cuda' runs)."""
    import tempfile

    from repro_torch.core import gym as G
    from repro_torch.kernels import ops as K
    from repro_torch.relational.spmd import SPMD

    totals = {k: 0 for k in GYM_KERNELS}
    totals.update({"semijoin_probe/bitmap": 0, "semijoin_probe/hash": 0})
    summary = {}

    def tally():
        for k in GYM_KERNELS:
            totals[k] += K.launch_counts()[k]
        for k, v in K.semijoin_probe_path_counts().items():
            totals[f"semijoin_probe/{k}"] += v

    def records(led):
        return [dataclasses.asdict(r) for r in led.records]

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="snapshots-") as tmp:
        if "bench" in sizes:
            for name, q, g, data, cfg, steps, resume in snapshot_cases():
                want = np_answer(q, data)
                runs = {}
                for be in ("cuda", "torch"):
                    c = {k: v for k, v in cfg.items() if k != "pin"}
                    if be == "torch" or cfg.get("pin"):
                        c["local_backend"] = be
                    snap = os.path.join(tmp, f"{name}-{be}.npz")
                    K.reset_launch_counts()
                    audit.reset()
                    drv = G.GymDriver(q, g, data, SPMD(4, device="cuda"), G.GymConfig(**c))
                    if steps is None:
                        drv.run()
                        drv.save(snap)
                    for i in range(steps or 0):
                        drv.step()
                        if name == "fault_tolerance" or i == steps - 1:
                            drv.save(snap)  # the scenario snapshots after every step
                    full = drv.run().to_numpy()
                    drv2 = G.GymDriver(q, g, data, SPMD(4, device="cuda"), G.GymConfig(**resume))
                    drv2.load(snap)
                    check(drv2.local_backend == be and drv2.executor.local_backend == be,
                          f"snapshot {name}: resumed on {drv2.local_backend}, snapshot {be}")
                    out = drv2.run()
                    rows = out.to_numpy()
                    if be == "cuda":
                        tally()
                        audit.check(f"snapshot {name}")
                    else:
                        check(sum(K.launch_counts().values()) == 0,
                              "'torch' backend launched a kernel")
                    check(np.array_equal(rows, full), f"snapshot {name} {be}: resumed rows != "
                          "the uninterrupted run's")
                    check(np.array_equal(unique_rows(full.astype(np.int64)), want),
                          f"snapshot {name} {be}: rows != numpy join")
                    runs[be] = (rows, tuple(out.schema), records(drv2.ledger), drv2.ledger.retries,
                                snap)
                check(np.array_equal(runs["cuda"][0], runs["torch"][0])
                      and runs["cuda"][1:4] == runs["torch"][1:4],
                      f"snapshot {name}: resumed cuda != resumed torch")
                # the card's snapshot, resumed on the CPU when asked for
                cpu = G.GymDriver(q, g, data, SPMD(4, device="cpu"), G.GymConfig(**resume))
                if cfg.get("pin"):  # it pins 'cuda': the CPU must refuse it
                    try:
                        cpu.load(runs["cuda"][4])
                    except ValueError:
                        cpu_note = "refused ('cuda' pinned)"
                    else:
                        raise SmokeFailure(f"snapshot {name}: a 'cuda' snapshot loaded on the CPU")
                else:
                    cpu.load(runs["cuda"][4])
                    check(cpu.local_backend == "torch", f"snapshot {name}: CPU resume backend")
                    crows = cpu.run().to_numpy()
                    check(np.array_equal(crows, runs["cuda"][0])
                          and records(cpu.ledger) == runs["cuda"][2],
                          f"snapshot {name}: CPU resume != the card's")
                    cpu_note = "== the card's rows and records"
                print(f"snapshot {name} bench: out={len(runs['cuda'][0])} "
                      f"records={len(runs['cuda'][2])} resumed rows == uninterrupted == numpy "
                      f"join, cuda == torch record for record; CPU resume {cpu_note}", flush=True)
        if "real" in sizes:
            q, g, data = families(seed, True)["C_8"]
            want = real_answer(seed, "C_8")
            gs = (gym_summary or {}).get("C_8/real")
            if gs is None:  # the gym phase did not run: its query runs here
                gs = dict(result=gym_result(*run_gym(torch, G, q, g, data, "cuda")[:3]))
            K.reset_launch_counts()
            audit.reset()
            snap = os.path.join(tmp, "C_8-real.npz")
            # snapshotted at its middle round, finished, and resumed by a fresh
            # driver: a restart after a fault pays its set-up and the load
            res = drive_snapshot(SPMD(8, device="cuda"), q, g, data, G.GymConfig(seed=23), snap,
                                 fresh=True)
            nbytes = os.path.getsize(snap)
            digest = snapshot_digest(snap)
            per = {k: K.launch_counts()[k] for k in GYM_KERNELS}
            per.update({f"semijoin_probe/{k}": v for k, v in K.semijoin_probe_path_counts().items()})
            tally()
            audit.check("snapshot C_8 real")
            check(all(per[k] > 0 for k in GYM_KERNELS), f"snapshot C_8 real: a kernel never "
                  f"launched {per}")
            first, again, whole = res, res["resumed"], gs["result"]
            check(same_result(first, whole), "snapshot C_8 real: the snapshotted run's first "
                  "finish != the gym phase's run")
            check(np.array_equal(again["rows"].astype(np.int64), want) and len(want) > 0,
                  "snapshot C_8 real: resumed rows != numpy join")
            check((again["comm"], again["rounds"], again["retries"])
                  == (whole["comm"], whole["rounds"], whole["retries"]),
                  f"snapshot C_8 real: comm/rounds/retries {(again['comm'], again['rounds'])}, "
                  f"{again['retries']} != the uninterrupted run's")
            print(f"snapshot C_8 real: inputs={sum(len(v) for v in data.values())} "
                  f"out={again['out']} snapshot after {res['steps']} of {len(again['records'])} steps, "
                  f"bytes={nbytes} save_s={res['save_s']:.4f} resume_s="
                  f"{res['resume_setup_s'] + res['load_s']:.4f} (a fresh driver's set-up "
                  f"{res['resume_setup_s']:.4f} + load {res['load_s']:.4f}) wall_s={res['wall_s']:.4f} "
                  f"(the driver's construction to its first finish, without the save) resumed "
                  f"finish_s={res['finish_s']:.4f} comm={again['comm']} rounds={again['rounds']} "
                  f"retries={again['retries']} (uninterrupted: comm={whole['comm']} rounds="
                  f"{whole['rounds']} retries={whole['retries']}); the first finish == the gym "
                  f"phase's run (rows, records); launches={per} resumed rows==numpy join: yes",
                  flush=True)
            summary["C_8/real"] = dict(bytes=nbytes, save_s=res["save_s"], load_s=res["load_s"],
                                       resume_setup_s=res["resume_setup_s"],
                                       launches=per, steps=res["steps"], digest=digest,
                                       resumed=again)
    return summary, totals


def snapshot_digest(path: str):
    """What two driver snapshots at one cursor must share: the ``meta``
    less its config (one run may pin the backend that another leaves to
    the device), and each array's shape, dtype and sha256."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        meta.pop("config", None)
        arrays = {k: (z[k].shape, str(z[k].dtype), hashlib.sha256(z[k].tobytes()).hexdigest())
                  for k in z.files if k != "meta"}
    return meta, arrays


# ------------------------------------------------------ joinserve phase
# benchmarks/bench_serve.py: the whole mix in flight, the hash engine
SERVE_MAX_IN_FLIGHT = 8
# the served real mix must peak below this share of the card's memory
SERVE_PEAK_SHARE_MAX = 0.9


def zipf_mix(names, n, *, s: float = 1.5, seed: int = 0):
    """``benchmarks/bench_serve.py``'s deterministic zipf-weighted arrival
    mix: rank r of ``names`` gets probability ~ 1/r^s."""
    w = np.array([1.0 / (r + 1) ** s for r in range(len(names))])
    rng = np.random.default_rng(seed)
    return [names[i] for i in rng.choice(len(names), size=n, p=w / w.sum())]


def solo_profile(torch, q, g, data, rows_back: bool = True):
    """One standalone real-size 'cuda' run driven through ``step_gen`` with
    a synchronize around every payload dispatch: its comm, dispatches and
    seconds, the most device bytes it holds between steps (``live``), and
    the most it allocates above the bytes held before each part:
    materialization (``mat``), a DYM round's payload dispatches
    (``payload``, the only work the join server merges across queries)
    and the rest of a round (``other``: measure pre-passes, caps, the
    final projection).  ``rows_back`` reads the answer back to the host,
    as ``gym()`` does, for seconds that stand in for the gym phase's."""
    from repro_torch.core import gym as G
    from repro_torch.core.physical import dispatch_work
    from repro_torch.relational.spmd import SPMD

    base = peak_reset(torch)
    t0 = time.perf_counter()
    drv = G.GymDriver(q, g, data, SPMD(8, device="cuda"), G.GymConfig(strategy="hash", seed=23))
    live = torch.cuda.memory_allocated() - base
    grown = {"mat": 0, "payload": 0, "other": 0}

    def grew(part, before):
        torch.cuda.synchronize()
        grown[part] = max(grown[part], torch.cuda.max_memory_allocated() - before)

    more = True
    while more:
        part = "mat" if drv.cursor < 0 else "other"
        gen = drv.step_gen()
        before = peak_reset(torch)
        try:
            works = next(gen)
            while True:
                grew(part, before)
                before = peak_reset(torch)
                results = [dispatch_work(w) for w in works]
                grew("payload", before)
                before = peak_reset(torch)
                works = gen.send(results)
        except StopIteration as stop:
            more = stop.value
        grew(part, before)
        live = max(live, torch.cuda.memory_allocated() - base)
    if rows_back:
        drv.result.to_numpy()
    secs = time.perf_counter() - t0
    led = drv.ledger
    return dict(comm=led.comm_tuples, dispatches=led.measured_dispatches, warm_s=secs,
                live=live, **grown)


def serve(torch, fams, mix, backend, max_in_flight, spmd=None):
    """Submit the whole mix at tick 0 to a fresh server (shared caps cache)
    on ``spmd`` (default: 8 reducers simulated on the card; a mesh rank's
    serves collectively) and drain it.  Returns (server, tickets, wall
    seconds, seconds at the end of each tick)."""
    from repro_torch.core.caps_cache import CapsCache
    from repro_torch.core.gym import GymConfig
    from repro_torch.relational.spmd import SPMD
    from repro_torch.serve import JoinServer

    srv = JoinServer(spmd or SPMD(8, device="cuda"), max_in_flight=max_in_flight,
                     caps_cache=CapsCache())
    tickets = [srv.submit(f"tenant-{i}:{name}", *fams[name],
                          GymConfig(strategy="hash", seed=23, local_backend=backend))
               for i, name in enumerate(mix)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done_at = {srv.tick: 0.0}
    more = True
    while more:
        more = srv.step()
        done_at[srv.tick] = time.perf_counter() - t0
    torch.cuda.synchronize()
    return srv, tickets, time.perf_counter() - t0, done_at


def ticket_state(t):
    """What a served ticket must reproduce: rows, schema, records, retries,
    admit and finish ticks."""
    return (t.rows(), tuple(t.result.schema), [dataclasses.asdict(r) for r in t.ledger.records],
            t.ledger.retries, t.admit_tick, t.finish_tick)


def server_state(srv, tickets) -> dict:
    """A drained server's state: every ticket's, and the ``ServerLedger``'s
    counts and the server's ticks (the same on every rank of a mesh)."""
    return dict(tickets=[ticket_state(t) for t in tickets], ledger=srv.ledger.summary(),
                ticks=srv.tick)


def same_server(a: dict, b: dict) -> bool:
    return (len(a["tickets"]) == len(b["tickets"])
            and all(np.array_equal(x[0], y[0]) and x[1:] == y[1:]
                    for x, y in zip(a["tickets"], b["tickets"]))
            and (a["ledger"], a["ticks"]) == (b["ledger"], b["ticks"]))


def joinserve_phase(torch, seed: int, audit, gym_summary=None, sizes=("bench", "real")):
    """The multi-tenant join server (see the module doc).  Returns
    (summary, launches over the phase's 'cuda' runs)."""
    from repro_torch.core import gym as G
    from repro_torch.kernels import ops as K

    totals = {k: 0 for k in GYM_KERNELS}
    totals.update({"semijoin_probe/bitmap": 0, "semijoin_probe/hash": 0})
    summary = {}
    mix = zipf_mix(["S_8", "C_8", "TC_9"], 8)

    def counted(fn):
        K.reset_launch_counts()
        audit.reset()
        res = fn()
        per = {k: K.launch_counts()[k] for k in GYM_KERNELS}
        per.update({f"semijoin_probe/{k}": v for k, v in K.semijoin_probe_path_counts().items()})
        for k, v in per.items():
            totals[k] += v
        return res, per

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs, np.float64), p))

    if "bench" in sizes:
        fams = {f: (q, g, d) for f, (q, g, d) in families(seed, False).items()}
        (srv, tickets, secs, _), per = counted(
            lambda: serve(torch, fams, mix, "cuda", SERVE_MAX_IN_FLIGHT))
        audit.check("joinserve bench")
        check(all(per[k] > 0 for k in GYM_KERNELS), f"joinserve bench: a kernel never launched {per}")
        K.reset_launch_counts()
        tsrv, ttickets, _, _ = serve(torch, fams, mix, "torch", SERVE_MAX_IN_FLIGHT)
        check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
        for t, tt in zip(tickets, ttickets):
            a, b = ticket_state(t), ticket_state(tt)
            check(np.array_equal(a[0], b[0]) and a[1:] == b[1:],
                  f"joinserve bench {t.tenant}: cuda server != torch server")
        check(srv.ledger.summary() == tsrv.ledger.summary()
              and (srv.ledger.fused_dispatches, srv.ledger.fused_riders)
              == (tsrv.ledger.fused_dispatches, tsrv.ledger.fused_riders),
              "joinserve bench: ServerLedger cuda != torch")
        solo = {}
        for f in set(mix):
            q, g, data = fams[f]
            solo[f] = G.gym(q, data, ghd=g, p=8, device="cuda",
                            config=G.GymConfig(strategy="hash", seed=23))
        for name, t in zip(mix, tickets):
            rows, _, led = solo[name]
            check(np.array_equal(t.rows(), rows) and t.ledger.comm_tuples == led.comm_tuples,
                  f"joinserve bench {t.tenant}: != its standalone gym()")
        led = srv.ledger
        check(led.retries == 0 and led.dispatches_saved > 0,
              f"joinserve bench: retries {led.retries}, saved {led.dispatches_saved}")
        seq_disp = sum(solo[f][2].measured_dispatches for f in mix)
        print(f"joinserve bench: mix={mix} max_in_flight={SERVE_MAX_IN_FLIGHT} "
              f"ticks={srv.tick} fused_dispatches={led.fused_dispatches} "
              f"fused_riders={led.fused_riders} dispatches_saved={led.dispatches_saved} "
              f"server_dispatches={led.measured_dispatches} standalone_dispatches={seq_disp} "
              f"comm={led.comm_tuples} launches={per} cuda server == torch server per ticket "
              f"(rows, schema, records, ticks) and ServerLedger: yes; every ticket == its "
              f"standalone gym() (rows, comm): yes", flush=True)
        summary["bench"] = dict(saved=led.dispatches_saved, launches=per,
                                state=server_state(srv, tickets))
        del srv, tickets, tsrv, ttickets
    if "real" in sizes:
        fams = families(seed, True)
        # one solo run a family, stepped by hand, gives the memory terms
        gs = {f: (gym_summary or {}).get(f"{f}/real") for f in sorted(set(mix))}
        # the gym phase's runs, when it ran, give the seconds; the profiles the memory terms
        prof = {f: solo_profile(torch, *fams[f], rows_back=gs[f] is None) for f in gs}
        stats = {f: gs[f] or prof[f] for f in prof}
        total = torch.cuda.get_device_properties(0).total_memory
        base = peak_reset(torch)
        counts = {f: mix.count(f) for f in prof}

        def reckon(m):
            """Peak with m queries in flight: the m largest live sets plus
            the larger of the largest solo transient (a materialization,
            inline at admission; a round's measure pre-passes and final
            projection, one driver at a time) and one tick's payloads — every
            family's merged dispatch, whose transient (outputs included) is
            the sum of its riders', all held until the tick delivers."""
            lives = sorted((prof[f]["live"] for f in mix), reverse=True)[:m]
            solo = max(max(prof[f]["mat"], prof[f]["other"]) for f in prof)
            tick = sum(min(m, counts[f]) * prof[f]["payload"] for f in prof)
            return base + sum(lives) + max(solo, tick)

        m = SERVE_MAX_IN_FLIGHT
        while m > 1 and reckon(m) >= SERVE_PEAK_SHARE_MAX * total:
            m -= 1
        reckoned = reckon(m)
        print(f"joinserve real: reckoned peak {reckoned} B for max_in_flight={m} against "
              f"{SERVE_PEAK_SHARE_MAX} x {total} B ({base} B resident; per family live / "
              f"materialization / payload / other round transient B: "
              f"{ {f: (v['live'], v['mat'], v['payload'], v['other']) for f, v in prof.items()} }; "
              f"max_in_flight=8 reckons {reckon(8)} B)", flush=True)
        (srv, tickets, secs, done_at), per = counted(lambda: serve(torch, fams, mix, "cuda", m))
        peak = torch.cuda.max_memory_allocated()
        audit.check("joinserve real")
        led = srv.ledger
        check(all(per[k] > 0 for k in GYM_KERNELS), f"joinserve real: a kernel never launched {per}")
        check(per["semijoin_probe/hash"] == 0, f"joinserve real: a semijoin launch took the hash "
              f"path {per}")
        for name, t in zip(mix, tickets):
            want = real_answer(seed, name)
            check(np.array_equal(t.rows().astype(np.int64), want) and len(want) > 0,
                  f"joinserve real {t.tenant}: rows != numpy join")
            check(t.ledger.comm_tuples == stats[name]["comm"] and t.ledger.retries == 0,
                  f"joinserve real {t.tenant}: comm {t.ledger.comm_tuples} != the gym phase's "
                  f"{stats[name]['comm']}, or retries")
        check(led.retries == 0 and led.dispatches_saved > 0,
              f"joinserve real: retries {led.retries}, saved {led.dispatches_saved}")
        check(peak < SERVE_PEAK_SHARE_MAX * total, f"joinserve real: peak {peak} B >= "
              f"{SERVE_PEAK_SHARE_MAX} x {total} B")
        seq_s = sum(stats[f]["warm_s"] for f in mix)
        seq_disp = sum(stats[f]["dispatches"] for f in mix)
        lat_ticks = [t.latency_ticks for t in tickets]
        lat_s = [done_at[t.finish_tick] for t in tickets]
        print(f"joinserve real: mix={mix} max_in_flight={m} ticks={srv.tick} drain_s={secs:.4f} "
              f"queries_per_s={len(mix) / secs:.4f} sequential_estimate_s={seq_s:.4f} "
              f"(the solo runs' seconds over the mix, the gym phase's warm ones when it ran; "
              f"{len(mix) / seq_s:.4f} queries/s) "
              f"latency_ticks p50={pct(lat_ticks, 50)} p99={pct(lat_ticks, 99)} "
              f"latency_s p50={pct(lat_s, 50):.4f} p99={pct(lat_s, 99):.4f} "
              f"fused_dispatches={led.fused_dispatches} fused_riders={led.fused_riders} "
              f"dispatches_saved={led.dispatches_saved} server_dispatches="
              f"{led.measured_dispatches} standalone_dispatches={seq_disp} comm={led.comm_tuples} "
              f"retries={led.retries} peak_bytes={peak} (reckoned {reckoned}; card {total}) "
              f"launches={per} rows==numpy join and comm==standalone per ticket: yes", flush=True)
        summary["real"] = dict(max_in_flight=m, drain_s=secs, seq_s=seq_s, peak=peak,
                               saved=led.dispatches_saved, launches=per)
        del srv, tickets
    return summary, totals


# ------------------------------------------------------------ the mesh
MESH_P = 8
# the engines the mesh phase drives at bench size: what each rank is held
# to are the wire phase's dense hash / grid / hybrid runs and its packed
# hash run (and the gym phase's, at real size)
MESH_ENGINES = {"hash": {}, "grid": dict(strategy="grid"), "hybrid": dict(strategy="hybrid"),
                "packed": dict(wire_format="packed")}
# the other entry points the mesh phase drives, at the sizes of the phases
# whose single-process runs each rank is held to (logdepth, joinserve)
MESH_ENTRIES = ("S_5 shares_join", "TC_15 gym_loggta", "C_8 gym_loggta", "C_8 acq_mr",
                "joinserve bench", "int8_allreduce")
# the gym kernels an entry launches: Shares has no semijoin, the
# all-reduce no gym kernel
ENTRY_KERNELS = {"S_5 shares_join": ("hash_partition", "sorted_probe_ranges"),
                 "int8_allreduce": ()}
# the elements of each rank's shard of the int8 all-reduce (f32)
MESH_ALLREDUCE_N = 2**26


# the LM mesh entry: the mesh phase's gloo ranks as a ("data", "model")
# mesh, smollm-360m at full width in bf16 (the train phase's TRAIN_ARCH,
# seed weights, AdamW, TRAIN_ACCUM_LR), one step on MESH_LM_BATCH x
# MESH_LM_SEQ tokens.  Cut for the script's time limit: the train phase's
# batch of 8 x 2048 to 8 x 256, and the depth from 32 layers to
# MESH_LM_LAYERS.  On an H100 80GB HBM3 at 700 W, in f32 at 32 layers the
# step took 14.1-14.3 s a rank (11.7-12.0 of it in collectives, the
# gradients then all-reduced whole) and the 4.34 GB checkpoint 20.0 s to
# save, 13.7 s to restore onto the other mesh and 17.0 s onto the
# script's process; at 8 layers the entry took 42-52 s of the ranks' wall:
# the 8 ranks' gathers cross loopback gloo at well under 1 GB/s in all.
# The mesh averages its data slices' gradients in f32, as accumulation
# does microbatches', so the single process' step it is held to takes
# those slices as its microbatches (accum = the "data" axis' size), with
# the accumulation check's tolerances (loss rtol 1e-5; parameters atol
# 2e-5 / rtol 2e-4 on all but TRAIN_FEW, those within 2 lr), the grad norm
# to rtol 1e-4.  Against one microbatch a bf16 step moved 1.09% of the
# parameters 2 lr the other way (32 layers, the same card): the control
# printed beside the gate.  The step computes its MLP on the "model"
# shards, whose row-parallel products differ from the single process' one
# product a weight in their order of sums (and cuBLAS's in their shapes):
# in bf16 that alone moves some parameters 2 lr the other way, so the
# single process the bf16 step is held to runs its MLP products on the
# same shards (split_products), and the one-product step is printed beside
# it; the same step then runs in f32, where the order of sums stays
# inside the tolerances, held to the one-product single process
MESH_LM_SHAPE = (2, 4)
MESH_LM_BATCH, MESH_LM_SEQ, MESH_LM_LAYERS = 8, 256, 2
MESH_LM_GNORM_RTOL = 1e-4
# the checkpoint saved on MESH_LM_SHAPE restores onto this mesh
MESH_LM_RESTORE = (8, 1)
# the serving entry on the same ranks: f32, MESH_LM_LAYERS deep, prompts
# MESH_SERVE_BATCH x MESH_LM_SEQ, MESH_SERVE_STEPS greedy tokens, a cache of
# MESH_SERVE_CACHE positions (a multiple of the "model" axis' 4: split on
# the sequence); logits within MESH_SERVE_LOGIT_REL of the largest
MESH_SERVE_BATCH, MESH_SERVE_STEPS, MESH_SERVE_CACHE = 2, 8, 268
MESH_SERVE_LOGIT_REL = 1e-4


def mesh_lm_config():
    """The LM mesh entry's model: smollm-360m, MESH_LM_LAYERS deep (see
    above)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_LM_LAYERS)


@contextlib.contextmanager
def split_products(m: int):
    """The single process' gated MLPs on a ``"model"`` axis of ``m``
    ranks' arithmetic, in one process (the mesh step's plain version):
    ``models/mlp.py`` takes its split path, whose products
    (``launch/shardings.py``'s ``col_product``, ``row_product``,
    ``from_model``) run here on each rank's block of the whole weight in
    turn, each of the shape the rank's shard has: ``wi``/``wg`` on column
    blocks, ``wo`` on row blocks, the row blocks' f32 products and the
    column products' f32 input gradients summed in f64 and rounded once
    (``_model_sum``, whose sum is the same in any order)."""
    import torch
    from repro_torch.launch import shardings as SH
    from repro_torch.models import mlp

    def blocks(t, dim):
        n = t.shape[dim] // m
        return [t.narrow(dim, r * n, n).contiguous() for r in range(m)]

    def rows(t):  # a (..., k) tensor as (tokens, k)
        return t.reshape(-1, t.shape[-1])

    class Cols(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ws = blocks(w, 1)
            ctx.save_for_backward(x, *ws)
            return torch.cat([x @ b for b in ws], dim=-1)

        @staticmethod
        def backward(ctx, dy):
            x, *ws = ctx.saved_tensors
            dys = blocks(dy, dy.dim() - 1)
            dx = sum(SH._f32_product(d, b.transpose(-1, -2)).double() for d, b in zip(dys, ws))
            dw = torch.cat([rows(x).transpose(0, 1) @ rows(d) for d in dys], dim=1)
            return dx.to(x.dtype), dw

    class Rows(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, w):
            parts, ws = blocks(a, a.dim() - 1), blocks(w, 0)
            ctx.save_for_backward(*parts, *ws)
            return sum(SH._f32_product(x, b).double() for x, b in zip(parts, ws))

        @staticmethod
        def backward(ctx, dy):
            saved = ctx.saved_tensors
            parts, ws = saved[:m], saved[m:]
            dy = dy.to(parts[0].dtype)
            da = torch.cat([dy @ b.transpose(-1, -2) for b in ws], dim=-1)
            dw = torch.cat([rows(x).transpose(0, 1) @ rows(dy) for x in parts], dim=0)
            return da, dw

    swapped = [(mlp, "_ff_split", lambda p: True), (SH, "col_product", Cols.apply),
               (SH, "row_product", Rows.apply),
               (SH, "from_model", lambda x, dtype=torch.float32: x.to(dtype))]
    before = [(mod, name, getattr(mod, name)) for mod, name, _ in swapped]
    try:
        for mod, name, fn in swapped:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in before:
            setattr(mod, name, fn)


def leaf_digests(tree) -> dict:
    """sha256 of each leaf's bytes (a ``{"params", "opt"}`` tree of whole
    tensors), hashed on the host's threads."""
    import concurrent.futures

    import torch
    from repro_torch.train import checkpoint as ckpt

    flat = ckpt._flatten_with_names(tree)

    def one(t):
        t = t.detach().contiguous()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(zip(flat, pool.map(one, flat.values())))


def lm_mesh_rank(seed: int, tmp: str, cfg=None, device_type: str = "cuda",
                 save: bool = True) -> dict:
    """One rank of the LM mesh entry (the mesh phase's gloo world, whose
    size is the product of ``MESH_LM_SHAPE``): place smollm-360m's
    parameters and AdamW state on that mesh, take one step on this rank's
    slice of a seeded global batch and, with ``save``, save a checkpoint
    to ``tmp`` and restore it onto ``MESH_LM_RESTORE``.  Every rank
    returns its step's metrics, wall and collective seconds, and its
    resident bytes (the sum of its local shards, and the dry run's
    per-device argument bytes for the mesh).  Rank 0 also runs the single
    process' step from the same state and batch, the mesh's data slices
    as its microbatches, and the control with one microbatch, and returns
    the gaps (``single``: the gate's, whose MLP products split as the
    mesh's where ``cfg`` is narrower than f32, ``split_products``;
    ``plain``, there, the one-product step), and with ``save`` the digests
    of the state both meshes hold (each gathered to it)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_model
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.dryrun import mesh_cells
    from repro_torch.launch.mesh import MeshShape, make_debug_mesh
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import (
        make_mesh_train_step, place_train_state, state_tree, train_state_shardings)

    t_entry = time.perf_counter()
    lead = dist.get_rank() == 0
    cuda = device_type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()  # what the gym cases left cached
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    cfg = cfg or mesh_lm_config()
    tcfg = TrainConfig(opt=OptConfig(lr=TRAIN_ACCUM_LR, warmup=1))
    mesh = make_debug_mesh(*MESH_LM_SHAPE, device_type)

    def fresh():
        return get_model(cfg, dev, generator=torch.Generator(device=dev).manual_seed(seed))

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = {k: torch.randint(0, cfg.vocab, (MESH_LM_BATCH, MESH_LM_SEQ), generator=gen, device=dev,
                              dtype=torch.int32) for k in ("tokens", "targets")}
    model = fresh()
    state = place_train_state(model, init_train_state(model, tcfg), mesh)
    placed = SH.place(batch, SH.named(mesh, SH.batch_specs(batch, mesh)))
    ms = MeshShape(("data", "model"), MESH_LM_SHAPE)
    reckoned = mesh_cells(cfg.name, "train_4k", [ms], overrides=dict(
        cfg=cfg, batch=MESH_LM_BATCH, seq=MESH_LM_SEQ, tcfg=tcfg))[ms]["memory"]
    step = make_mesh_train_step(model, tcfg, mesh)
    spent = dict(collective_s=0.0)
    resident = SH.resident_bytes(state) + SH.resident_bytes(placed)
    with mesh_timers(spent, [(SH, "_all_gather_bytes", "collective_s"),
                             (SH, "_reduce_scatter", "collective_s"),
                             (SH, "all_reduce", "collective_s")], sync), SH.counting() as coll:
        sync()
        # what this rank holds that is not the step's arguments (the
        # whole batch, the gym cases' leftovers), less from its peak
        held = (torch.cuda.memory_allocated() - resident) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = step(state, placed)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        sync()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = dict(loss=loss, gnorm=gnorm, step_s=step_s, collective_s=spent["collective_s"],
               peak=peak, held=held, coll=coll.by_kind(),
               resident=resident,
               shard_bytes=dict(params=SH.resident_bytes(state["params"]),
                                opt=SH.resident_bytes(state["opt"]), batch=SH.resident_bytes(placed)),
               reckoned=reckoned["argument_size_in_bytes"],
               reckoned_parts=reckoned["argument_bytes_per_device"])
    whole = SH.gather_tree(ckpt._flatten_with_names(state))
    if lead:
        tol = dict(atol=2e-5, rtol=2e-4)
        # accum: the mesh's data slices as microbatches (the gate), then one
        # microbatch (the control, report only); in bf16 the gate's single
        # process splits its MLP products as the mesh does, and the one with
        # one product a weight is reported beside it
        narrow = cfg.dtype != "float32"
        refs = [("single", MESH_LM_SHAPE[0], 2 * TRAIN_ACCUM_LR + 2e-5, narrow),
                ("control", 1, float("inf"), False)]
        if narrow:
            refs.insert(1, ("plain", MESH_LM_SHAPE[0], float("inf"), False))
        for key, accum, bound, split in refs:
            single = fresh()
            stcfg = dataclasses.replace(tcfg, accum=accum)
            sopt = init_train_state(single, stcfg)
            with split_products(MESH_LM_SHAPE[1]) if split else contextlib.nullcontext():
                sm = make_train_step(single, stcfg)(sopt, batch)
            mine = {k: whole[f"params/{k}"] for k, _ in single.named_parameters()}
            theirs = {k: p.detach() for k, p in single.named_parameters()}
            bad, total, worst = _mismatch(torch, mine, theirs, tol, bound)
            out[key] = dict(loss=sm["loss"].item(), gnorm=sm["grad_norm"].item(), bad=bad,
                            total=total, worst=worst, accum=accum, split=split)
            del single, sopt, mine, theirs
    if not save:
        out["entry_s"] = time.perf_counter() - t_entry
        return out
    # the checkpoint: saved on this mesh, restored onto MESH_LM_RESTORE
    t0 = time.perf_counter()
    ckpt.save(os.path.join(tmp, "lm-mesh"), 1, state, extra={"next_step": 1})
    out["save_s"] = time.perf_counter() - t0
    other = make_debug_mesh(*MESH_LM_RESTORE, device_type)
    t0 = time.perf_counter()
    restored, extra = ckpt.restore(os.path.join(tmp, "lm-mesh"), state,
                                   placements=train_state_shardings(cfg, state, other))
    sync()
    out["load_s"] = time.perf_counter() - t0
    del state
    again = SH.gather_tree(ckpt._flatten_with_names(restored))
    out["restored_on"] = sorted({tuple(v.device_mesh.shape) for v in
                                 ckpt._flatten_with_names(restored).values()})
    if lead:
        out["equal"] = extra == {"next_step": 1} and set(again) == set(whole) and all(
            again[k].dtype == whole[k].dtype and torch.equal(again[k], whole[k]) for k in whole)
        out["digests"] = leaf_digests(whole)
    out["entry_s"] = time.perf_counter() - t_entry
    return out


def lm_serve_rank(seed: int, device_type: str = "cuda") -> dict:
    """One rank of the LM mesh's serving entry (see the module doc):
    ``MeshServer`` over the ``MESH_LM_SHAPE`` mesh, greedy ``generate`` of
    the whole batch on every rank.  Rank 0 also runs the single process'
    ``generate`` on the same weights and prompts and returns the gaps."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_model
    from repro_torch.kernels import ops as K
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve import generate
    from repro_torch.serve.mesh import MeshServer

    cuda = device_type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    cfg = dataclasses.replace(mesh_lm_config(), dtype="float32")
    mesh = make_debug_mesh(*MESH_LM_SHAPE, device_type)

    def fresh():
        return get_model(cfg, dev, generator=torch.Generator(device=dev).manual_seed(seed))

    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab, (MESH_SERVE_BATCH, MESH_LM_SEQ), generator=gen, device=dev)
    srv = MeshServer(fresh(), mesh)
    K.reset_launch_counts()
    with SH.counting() as coll:
        sync()
        t0 = time.perf_counter()
        toks, logits = srv.generate(prompt, steps=MESH_SERVE_STEPS, s_cache=MESH_SERVE_CACHE,
                                    return_logits=True)
        sync()
        wall = time.perf_counter() - t0
    out = dict(wall_s=wall, coll=coll.by_kind(), kv=srv.kv, tp_only=srv.tp_only,
               flash=K.launch_counts()["flash_attention"], tokens=toks.cpu())
    if dist.get_rank() == 0:
        want_t, want_l = generate(fresh(), prompt, steps=MESH_SERVE_STEPS, s_cache=MESH_SERVE_CACHE,
                                  return_logits=True)
        out["equal"] = torch.equal(toks, want_t)
        out["rel"] = float((logits - want_l).abs().max() / want_l.abs().max())
    return out


def lm_mesh_parity(per: list, dtype: str) -> None:
    """The LM mesh entry's figures and gates against rank 0's
    single-process steps, over every rank's ``lm_mesh_rank`` in
    ``dtype``."""
    name = f"mesh lm {TRAIN_ARCH} {MESH_LM_SHAPE} {dtype}"
    x0 = per[0]
    s, c = x0["single"], x0["control"]

    def gaps(r):
        return (f"loss {r['loss']:.7f}, grad_norm {r['gnorm']:.7f}, parameters outside atol 2e-5 / "
                f"rtol 2e-4 {r['bad']} of {r['total']} ({r['bad'] / r['total']:.4%}, max |d| "
                f"{r['worst']:.3g})")

    how = "its MLP products split as the mesh's" if s["split"] else "one product a weight"
    note = (f"; the one-product single process (report only): {gaps(x0['plain'])}"
            if "plain" in x0 else "")
    print(f"{name}: step wall_s per rank={[round(x['step_s'], 4) for x in per]} collective_s per "
          f"rank={[round(x['collective_s'], 4) for x in per]}; loss={x0['loss']:.7f} "
          f"grad_norm={x0['gnorm']:.7f}; the single process at accum={s['accum']}, {how}: "
          f"{gaps(s)} (rel {abs(x0['loss'] - s['loss']) / abs(s['loss']):.3g} / "
          f"{abs(x0['gnorm'] - s['gnorm']) / s['gnorm']:.3g}, bounds 1e-05 / {MESH_LM_GNORM_RTOL}; "
          f"parameters: {TRAIN_FEW} of them, max |d| 2 lr + 2e-5){note}; the control at "
          f"accum={c['accum']} (report only): {gaps(c)}; resident bytes per rank "
          f"{[x['resident'] for x in per]} (the dry run's per-device argument bytes "
          f"{x0['reckoned']}); the entry's wall {max(x['entry_s'] for x in per):.2f} s on the "
            f"ranks (slowest)", flush=True)
    check(all(x["loss"] == x0["loss"] and x["gnorm"] == x0["gnorm"] for x in per),
          f"{name}: the ranks' metrics differ")
    check(abs(x0["loss"] - s["loss"]) <= 1e-5 * abs(s["loss"])
          and abs(x0["gnorm"] - s["gnorm"]) <= MESH_LM_GNORM_RTOL * s["gnorm"],
          f"{name}: loss {x0['loss']}, grad_norm {x0['gnorm']} vs the single process' "
          f"{s['loss']}, {s['gnorm']}")
    check(s["bad"] <= TRAIN_FEW * s["total"],
          f"{name}: {s['bad']} of {s['total']} parameters outside the tolerance")
    for r, x in enumerate(per):
        check(x["resident"] == x["reckoned"],
              f"{name}: rank {r} holds {x['resident']} bytes, the dry run reckons {x['reckoned']} "
              f"({x['shard_bytes']} vs {x['reckoned_parts']})")


def lm_mesh_checks(torch, per: list, tmp: str, served=None, per32=None) -> None:
    """The LM mesh entry's figures and gates over every rank's
    ``lm_mesh_rank`` in bf16 (``per``) and f32 (``per32``) (see the module
    doc), then the checkpoint restored onto this process."""
    from repro_torch.configs import get_model
    from repro_torch.launch.dryrun import mesh_trace
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.train import OptConfig, TrainConfig, init_train_state
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import state_tree

    name = f"mesh lm {TRAIN_ARCH} {MESH_LM_SHAPE}"
    x0 = per[0]
    t_checks = time.perf_counter()
    tcfg = TrainConfig(opt=OptConfig(lr=TRAIN_ACCUM_LR, warmup=1))
    t0 = time.perf_counter()
    traced = mesh_trace(TRAIN_ARCH, "train_4k", MeshShape(("data", "model"), MESH_LM_SHAPE),
                        dict(cfg=mesh_lm_config(), batch=MESH_LM_BATCH, seq=MESH_LM_SEQ, tcfg=tcfg))
    trace_s = time.perf_counter() - t0
    ratios = [(x["peak"] - x["held"]) / traced["peak"] for x in per]
    model = get_model(mesh_lm_config(), "cuda")
    t0 = time.perf_counter()
    tree, extra = ckpt.restore(os.path.join(tmp, "lm-mesh"), state_tree(model, init_train_state(model, tcfg)))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    one = extra == {"next_step": 1} and leaf_digests(tree) == x0["digests"]
    checks_s = time.perf_counter() - t_checks
    del model, tree
    shutil.rmtree(os.path.join(tmp, "lm-mesh"), ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"{name}: {MESH_LM_LAYERS} of 32 layers, one step on {MESH_LM_BATCH} x {MESH_LM_SEQ} "
          f"tokens (cut from the train phase's {TRAIN_BATCH} x {TRAIN_SEQ}) over {len(per)} gloo "
          f"ranks sharing the card, in bf16 then in f32", flush=True)
    lm_mesh_parity(per, "bf16")
    if per32:
        lm_mesh_parity(per32, "f32")
    print(f"{name} bf16: shard bytes per rank={[x['shard_bytes'] for x in per]}; checkpoint save_s="
          f"{max(x['save_s'] for x in per):.4f}, restore onto {MESH_LM_RESTORE} load_s="
          f"{max(x['load_s'] for x in per):.4f} bit-equal: {x0['equal']}; onto this process "
          f"load_s={load_s:.4f} bit-equal (sha256 a leaf): {one}; {checks_s:.2f} s in this "
          f"process", flush=True)
    print(f"{name} bf16: per-device peak measured (max_memory_allocated less what the rank held "
          f"that is not the step's) per rank={[x['peak'] - x['held'] for x in per]} / the dry "
          f"run's fake-PG trace of rank 0 {traced['peak']} = {[round(r, 4) for r in ratios]} "
          f"(bounds {DRYRUN_PEAK_RATIO}; trace {trace_s:.2f} s); collective bytes by kind on rank 0 "
          f"{x0['coll']} (the trace's {traced['coll'].by_kind()}: the step's own, without the "
          f"global batch's gather); leaves gathered over 'model' {traced['model_gathered']}",
          flush=True)
    for r, ratio in enumerate(ratios):
        check(DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1],
              f"{name}: rank {r} measured/traced peak {ratio:.4f} outside {DRYRUN_PEAK_RATIO}")
    for r, x in enumerate(per):
        check(x["restored_on"] == [MESH_LM_RESTORE], f"{name}: rank {r} restored onto {x['restored_on']}")
    check(x0["equal"], f"{name}: the {MESH_LM_RESTORE} restore is not bit-equal to the state saved")
    check(one, f"{name}: the checkpoint restored onto one process is not bit-equal to the mesh state")
    if served is None:
        return
    name = f"mesh serve {TRAIN_ARCH} {MESH_LM_SHAPE}"
    v0 = served[0]
    print(f"{name}: f32, {MESH_LM_LAYERS} layers, TP-only placement {v0['tp_only']}, KV cache split "
          f"{v0['kv']}; {MESH_SERVE_BATCH} x {MESH_LM_SEQ} prompt tokens, {MESH_SERVE_STEPS} greedy "
          f"tokens, cache {MESH_SERVE_CACHE}: wall_s per rank={[round(x['wall_s'], 4) for x in served]}, "
          f"flash launches per rank={[x['flash'] for x in served]}; tokens equal rank 0's single "
          f"process: {v0['equal']}, logits max |d| / max |logit| {v0['rel']:.3g} (bound "
          f"{MESH_SERVE_LOGIT_REL}); collective bytes by kind on rank 0 {v0['coll']}", flush=True)
    check(v0["kv"] == ("seq", MESH_SERVE_CACHE), f"{name}: the cache splits as {v0['kv']}, not on the sequence")
    check(all(torch.equal(x["tokens"], v0["tokens"]) for x in served), f"{name}: the ranks' tokens differ")
    check(v0["equal"], f"{name}: tokens differ from the single process'")
    check(v0["rel"] <= MESH_SERVE_LOGIT_REL, f"{name}: logits {v0['rel']:.3g} from the single process'")
    check(all(x["flash"] > 0 for x in served), f"{name}: a rank's prefill launched no flash kernel")


def gym_result(rows, schema, led) -> dict:
    """What a mesh rank must reproduce of a run: rows (in order), schema,
    every ``RoundRecord``, retries and the output count."""
    return dict(rows=rows, schema=tuple(schema), records=[dataclasses.asdict(r) for r in led.records],
                retries=led.retries, out=led.output_tuples, comm=led.comm_tuples, rounds=led.rounds)


def same_result(a: dict, b: dict) -> bool:
    return (np.array_equal(a["rows"], b["rows"]) and a["schema"] == b["schema"]
            and a["records"] == b["records"] and (a["retries"], a["out"]) == (b["retries"], b["out"]))


def same_entry(name: str, a: dict, b: dict) -> bool:
    if name == "joinserve bench":
        return same_server(a, b)
    if name == "int8_allreduce":
        return a["digest"] == b["digest"] and a["finite"] and b["finite"]
    return same_result(a, b)


@contextlib.contextmanager
def mesh_timers(spent: dict, targets=None, sync=None):
    """Time each ``(owner, attribute, key)`` of ``targets`` into
    ``spent[key]``, between synchronizes (``sync``, the card's by
    default), and put the attributes back after.  The default targets are
    the exchanges (``SPMD._all_to_all``), the host reads' gathers
    (``SPMD.to_host``) and ``GymDriver``'s host set-up."""
    import torch
    from repro_torch.core import gym as G
    from repro_torch.relational import spmd as S

    sync = sync or torch.cuda.synchronize

    def timed(name, fn):
        def wrapped(*a, **kw):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync()
                spent[name] += time.perf_counter() - t0
        return wrapped

    saved = targets or [(S.SPMD, "_all_to_all", "exchange_s"), (S.SPMD, "to_host", "gather_s"),
                        (G.GymDriver, "__init__", "setup_s")]
    saved = [(cls, attr, cls.__dict__[attr], name) for cls, attr, name in saved]
    for cls, attr, fn, name in saved:
        setattr(cls, attr, timed(name, fn))
    try:
        yield
    finally:
        for cls, attr, fn, _ in saved:
            setattr(cls, attr, fn)


def drive_snapshot(spmd, q, g, data, cfg, snap: str, fresh: bool) -> dict:
    """Drive a query with ``step()`` through materialization and half its
    DYM rounds, ``save`` it to ``snap`` (collective on a mesh), finish it,
    then resume the snapshot and finish again: in a fresh driver when
    ``fresh``, else in the same one (which spares a real query's host
    dedup).  Returns the first finish's ``gym_result``, the resumed
    finish's (``resumed``: its rows equal the first's, its padding figures
    may not, since a resumed run measures again what the first one had
    prefetched), and the seconds: to the first finish without the save
    (``wall_s``), of the save, of the fresh driver's construction
    (``resume_setup_s``, 0 without one), of the load and of the resumed
    finish."""
    import torch
    from repro_torch.core import gym as G

    def finish(drv):
        out = drv.run()
        return gym_result(out.to_numpy(spmd), out.schema, drv.ledger)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drv = G.GymDriver(q, g, data, spmd, cfg)
    steps = 1 + len(drv.schedule) // 2
    for _ in range(steps):
        drv.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    drv.save(snap)
    t2 = time.perf_counter()
    first = finish(drv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - (t2 - t1)
    t3 = time.perf_counter()
    if fresh:
        drv = G.GymDriver(q, g, data, spmd, cfg)
    torch.cuda.synchronize()
    resume_setup = time.perf_counter() - t3
    t3 = time.perf_counter()
    drv.load(snap)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    again = finish(drv)
    torch.cuda.synchronize()
    return dict(first, resumed=again, steps=steps, wall_s=wall, save_s=t2 - t1,
                resume_setup_s=resume_setup, load_s=t4 - t3, finish_s=time.perf_counter() - t4)


def mesh_entry(name: str, spmd, seed: int) -> dict:
    """One entry point of ``MESH_ENTRIES`` on ``spmd``: a mesh rank's
    ``SPMD(p, mesh=...)``, or the single-process ``SPMD(p, device="cuda")``
    each rank is held to.  The log-depth runs are the logdepth phase's
    (p = 8, seed 23; Shares seed 2), C_8 the bench family, the server the
    joinserve phase's bench mix; the all-reduce adds a ``MESH_ALLREDUCE_N``
    f32 shard a rank (seeded by the rank; the single-process form stacks
    them all) and returns its result's digest."""
    import torch
    from repro_torch.core import acq_mr as A
    from repro_torch.core import gym as G
    from repro_torch.core import queries as Q
    from repro_torch.core import shares as S
    from repro_torch.data import synthetic as D

    if name == "S_5 shares_join":
        return gym_result(*S.shares_join(Q.star_query(5), D.star_data_sparse(5, seed=1), seed=2,
                                         spmd=spmd))
    if name == "TC_15 gym_loggta":
        data = D.tc_data_sparse(5, domain=128, ident=32, extra=96, seed=22)
        cfg = G.GymConfig(seed=23, local_backend="cuda", max_cap_tuples=LOGDEPTH_MAX_CAP)
        return gym_result(*A.gym_loggta(Q.triangle_chain_query(5), data,
                                        ghd=Q.triangle_chain_ghd(5), spmd=spmd, config=cfg))
    if name in ("C_8 gym_loggta", "C_8 acq_mr"):
        q, g, data = families(seed, False)["C_8"]
        fn = A.gym_loggta if name == "C_8 gym_loggta" else A.acq_mr
        return gym_result(*fn(q, data, ghd=g, spmd=spmd,
                              config=G.GymConfig(seed=23, local_backend="cuda")))
    if name == "joinserve bench":
        srv, tickets, secs, _ = serve(torch, families(seed, False), zipf_mix(["S_8", "C_8", "TC_9"], 8),
                                      "cuda", SERVE_MAX_IN_FLIGHT, spmd=spmd)
        return dict(server_state(srv, tickets), drain_s=secs)
    assert name == "int8_allreduce", name
    from repro_torch.train.compression import int8_allreduce

    def shard(r):
        gen = torch.Generator(device=spmd.device).manual_seed(1000 * seed + r)
        return torch.randn(MESH_ALLREDUCE_N, generator=gen, device=spmd.device)

    x = shard(spmd.rank) if spmd.mesh is not None else torch.stack([shard(r) for r in range(spmd.p)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = int8_allreduce(x, group=spmd.mesh) if spmd.mesh is not None else int8_allreduce(x)[0]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return dict(digest=hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest(),
                finite=bool(torch.isfinite(y).all()), ms=ms,
                wire_bytes=y.numel() * 4 + 4)  # the int32 sum's buffer and the scale


def mesh_rank(mesh, seed: int, cases, real, entries=(), snaps=None, go=None, lm=None):
    """One reducer of the mesh phase: ``gym(..., spmd=SPMD(p,
    mesh=mesh))`` with the 'cuda' backend on each case (fam, size,
    engine), a case in ``snaps`` driven by ``drive_snapshot`` to the file
    it names (the bench size resumed in a fresh driver, the real one in the
    same driver), then each of ``entries`` (``mesh_entry``).  ``real``
    holds each real-size family's query, GHD and the ``.npz`` its data was
    saved to (a spawned process' arguments cross a pipe the parent blocks
    on while the child imports).  Returns when the rank was ready (wall
    clock) and per case the run's result, its wall seconds, the seconds of
    ``GymDriver``'s host set-up, of the exchanges and of the host reads
    (``mesh_timers``) over all of the case's work, and the gym kernels'
    launches.  With ``go``, the rank first waits for that file: it drives
    the cases if the file says "run", and nothing otherwise.  With ``lm`` (a
    directory) the rank then runs the LM mesh entry (``lm_mesh_rank``),
    its checkpoint under ``lm``."""
    import torch
    from repro_torch.core import gym as G
    from repro_torch.kernels import ops as K
    from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT_S
    from repro_torch.relational import spmd as S

    ready = time.time()
    if go is not None:  # waited for as long as a collective
        deadline = time.monotonic() + COLLECTIVE_TIMEOUT_S
        while not os.path.exists(go):  # published by an atomic rename
            check(time.monotonic() < deadline, f"mesh rank: no {go} after {COLLECTIVE_TIMEOUT_S} s")
            time.sleep(0.01)
        with open(go) as f:
            if f.read() != "run":
                return dict(ready=ready, cases={})
    p = mesh.size(0)
    snaps = snaps or {}
    spent = {}
    out = {}
    with mesh_timers(spent):
        for case in list(cases) + list(entries):
            spent.update(exchange_s=0.0, gather_s=0.0, setup_s=0.0)
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            spmd = S.SPMD(p, mesh=mesh)
            if isinstance(case, str):
                res = mesh_entry(case, spmd, seed)
            else:
                fam, size, engine = case
                if size == "real":
                    q, g, path = real[fam]
                    with np.load(path) as z:
                        data = {k: z[k] for k in z.files}
                else:
                    q, g, data = families(seed, False)[fam]
                cfg = G.GymConfig(seed=23, local_backend="cuda", **MESH_ENGINES[engine])
                if case in snaps:
                    res = drive_snapshot(spmd, q, g, data, cfg, snaps[case], fresh=size == "bench")
                else:
                    res = gym_result(*G.gym(q, data, ghd=g, spmd=spmd, config=cfg))
                check(sum(K.launch_counts()[k] for k in WIRE_KERNELS) == 0 or engine == "packed",
                      "a dense mesh run launched the codec")
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches = {k: K.launch_counts()[k] for k in GYM_KERNELS}
            launches.update({f"semijoin_probe/{k}": v for k, v in K.semijoin_probe_path_counts().items()})
            out[case] = dict(res, launches=launches, elapsed_s=elapsed, **spent)
            out[case].setdefault("wall_s", elapsed)
    if lm is None:
        return dict(ready=ready, cases=out)
    K.reset_launch_counts()
    res = lm_mesh_rank(seed, lm)
    f32 = lm_mesh_rank(seed, lm, dataclasses.replace(mesh_lm_config(), dtype="float32"), save=False)
    res["launches"] = dict(K.launch_counts())
    return dict(ready=ready, cases=out, lm=res, lm_f32=f32, serve=lm_serve_rank(seed))


def nccl_here(seed: int, cases, entries, snaps):
    """The NCCL mesh of a one-card machine, p = 1, in this process: a
    real NCCL communicator through ``make_reducer_mesh`` over a group of
    one rank (a store in a temporary directory), without the seconds a
    new process takes to reach the card."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT_S, make_reducer_mesh

    tmp = tempfile.mkdtemp(prefix="nccl-mesh-")
    w0 = time.time()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        res = mesh_rank(make_reducer_mesh(1, "cuda"), seed, cases, {}, entries, snaps)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return [res], w0


def mesh_phase(torch, seed: int, gym_summary=None, wire_summary=None, sizes=("bench", "real"),
               logdepth_summary=None, snapshot_summary=None, joinserve_summary=None):
    """The gym's production runtime (see the module doc): ``MESH_P`` gloo
    ranks sharing the card, then an NCCL mesh over every visible card,
    one after the other.  The gloo ranks are spawned first and start up
    beside this process' single-process reference runs; they drive nothing
    before those have finished.  Returns the gym kernels' launches summed
    over the ranks' runs."""
    import threading

    from repro_torch.core import gym as G
    from repro_torch.launch.mesh import spawn_reducers
    from repro_torch.relational.spmd import SPMD

    cases = []
    if "bench" in sizes:
        cases += [(fam, "bench", e) for fam in ("S_8", "C_8", "TC_9") for e in MESH_ENGINES]
    if "real" in sizes:
        cases.append(("C_8", "real", "hash"))
    entries = MESH_ENTRIES if "bench" in sizes else ()
    real = {"C_8": families(seed, True)["C_8"]} if "real" in sizes else {}

    def fam_data(fam, size):
        return real[fam] if size == "real" else families(seed, False)[fam]

    def config(engine):
        return G.GymConfig(seed=23, local_backend="cuda", **MESH_ENGINES[engine])

    def single(fam, size, engine, p):
        """The single-process 'cuda' run a mesh case is held to: the gym or
        wire phase's when it ran at this p, else run here."""
        if p == MESH_P and size == "real" and gym_summary and f"{fam}/real" in gym_summary:
            return gym_summary[f"{fam}/real"]["result"]
        if p == MESH_P and size == "bench":
            if engine == "hash" and gym_summary and f"{fam}/bench" in gym_summary:
                return gym_summary[f"{fam}/bench"]["result"]
            wkey = f"{fam}/bench/{'hash' if engine == 'packed' else engine}"
            if wire_summary and wkey in wire_summary:
                return wire_summary[wkey]["packed" if engine == "packed" else "dense"]
        q, g, data = fam_data(fam, size)
        return gym_result(*G.gym(q, data, ghd=g, p=p, config=config(engine), device="cuda"))

    def single_entry(name, p):
        """The single-process 'cuda' run an entry is held to: the logdepth
        or joinserve phase's when it ran at this p, else run here."""
        reused = {"S_5 shares_join": (logdepth_summary, "S_5 Shares", "result"),
                  "TC_15 gym_loggta": (logdepth_summary, "TC_15 Log-GTA (gym_loggta)", "result"),
                  "joinserve bench": (joinserve_summary, "bench", "state")}.get(name)
        if p == MESH_P and reused and reused[0] and reused[1] in reused[0]:
            return reused[0][reused[1]][reused[2]]
        return mesh_entry(name, SPMD(p, device="cuda"), seed)

    def single_snapshot(backend, p, c, path):
        """The single-process snapshot at a snapshot-driven case's cursor
        (its digest) and the single process' resume of it: the snapshot
        phase's for the real C_8 when it ran, else ``drive_snapshot`` here."""
        fam, size, engine = c
        ss = (snapshot_summary or {}).get("C_8/real")
        if size == "real" and p == MESH_P and ss:
            return ss["digest"], ss["resumed"], "the snapshot phase's"
        q, g, data = fam_data(fam, size)
        one = drive_snapshot(SPMD(p, device="cuda"), q, g, data, config(engine), path + ".single.npz",
                             fresh=size == "bench")
        check(same_result(one, want[(backend, p)][c]),
              f"mesh {backend} p={p} {' '.join(c)}: the single process' snapshot-driven run != "
              "its gym() run")
        return snapshot_digest(path + ".single.npz"), one["resumed"], "one made here"

    totals = {k: 0 for k in GYM_KERNELS}
    totals.update({"semijoin_probe/bitmap": 0, "semijoin_probe/hash": 0})
    n_cards = torch.cuda.device_count()
    # the gloo ranks leave S_8 and TC_9 under hash to the joinserve drain
    # (the script's time limit: the LM entry took their seconds)
    meshes = (("gloo", MESH_P, [c for c in cases if c[1:] != ("bench", "hash") or c[0] == "C_8"]),
              ("nccl", n_cards, [c for c in cases if c[1] == "bench" and c[2] == "hash"]))
    tmp = tempfile.mkdtemp(prefix="mesh-phase-")
    go = os.path.join(tmp, "go")
    # the LM mesh entry rides on the gloo ranks of the bench run
    lm_dir = tmp if "bench" in sizes else None
    real_files = {fam: (q, g, os.path.join(tmp, f"{fam}.npz")) for fam, (q, g, _) in real.items()}
    # C_8 under hash is driven through a snapshot at its middle round
    snaps = {(b, p): {c: os.path.join(tmp, f"{b}-{'-'.join(c)}.npz") for c in pc
                      if c[0] == "C_8" and c[2] == "hash"} for b, p, pc in meshes}
    runs = []
    try:
        # the ranks share the card: hand back what this process' allocator
        # keeps cached from the earlier phases (the join server's ~70 GB)
        torch.cuda.empty_cache()
        box = {}

        def launch():
            try:
                box["res"] = spawn_reducers(
                    mesh_rank, MESH_P, backend="gloo", device_type="cuda",
                    args=(seed, cases, real_files, entries, snaps[("gloo", MESH_P)], go, lm_dir))
            except Exception as e:  # raised below, in this thread
                box["error"] = e

        w0 = time.time()
        t_spawn = time.perf_counter()
        spawner = threading.Thread(target=launch)
        spawner.start()
        signal = "stop"
        try:
            for fam, (q, g, data) in real.items():
                np.savez(real_files[fam][2], **data)
            want = {(b, p): {c: single(*c, p) for c in pc} for b, p, pc in meshes}
            want.update({(b, p, "entries"): {e: single_entry(e, p) for e in entries}
                         for b, p, _ in meshes})
            refs = {(b, p, c): single_snapshot(b, p, c, path)
                    for b, p, _ in meshes for c, path in snaps[(b, p)].items()}
            torch.cuda.synchronize()
            signal = "run"
        finally:  # a rank drives nothing until it reads "run"
            with open(go + ".tmp", "w") as f:
                f.write(signal)
            os.replace(go + ".tmp", go)
            t_go = time.perf_counter()
            spawner.join()
        if "error" in box:
            raise box["error"]
        res = box["res"]
        runs.append((res, time.perf_counter() - t_go, max(r["ready"] for r in res) - w0,
                     t_go - t_spawn))
        # one mesh at a time, so neither one's figures carry the other's load
        for backend, p, pcases in meshes[1:]:
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if p == 1:
                res, w1 = nccl_here(seed, pcases, entries, snaps[(backend, p)])
            else:
                w1 = time.time()
                res = spawn_reducers(mesh_rank, p, backend=backend, device_type="cuda",
                                     args=(seed, pcases, real_files, entries, snaps[(backend, p)]))
            runs.append((res, time.perf_counter() - t0, max(r["ready"] for r in res) - w1, 0.0))
        resumed, snap_notes = mesh_snapshot_checks(meshes, snaps, refs, fam_data, config)
        if lm_dir is not None:
            lm = [r["lm"] for r in runs[0][0]]
            check(all(sum(x["launches"].values()) == 0 for x in lm),
                  "mesh lm: a training step launched a kernel (it has none)")
            served = [r["serve"] for r in runs[0][0]]
            lm_mesh_checks(torch, lm, lm_dir, served, [r["lm_f32"] for r in runs[0][0]])
            # the serving ranks' flash launches are the mesh path's too
            totals["flash_attention"] = sum(x["flash"] for x in served)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for (backend, p, pcases), (res, total, spawn_s, prep_s) in zip(meshes, runs):
        setup_s = run_s = 0.0
        for c in list(pcases) + list(entries):
            per = [r["cases"][c] for r in res]
            label = c if isinstance(c, str) else " ".join(c)
            name = f"mesh {backend} p={p} {label}"
            kernels = ENTRY_KERNELS.get(c, GYM_KERNELS) if isinstance(c, str) else GYM_KERNELS
            for rank, got in enumerate(per):
                if isinstance(c, str):
                    check(same_entry(c, got, want[(backend, p, "entries")][c]),
                          f"{name}: rank {rank} differs from the single-process 'cuda' run")
                else:
                    check(same_result(got, want[(backend, p)][c]),
                          f"{name}: rank {rank} differs from the single-process 'cuda' run")
                    if "resumed" in got:
                        check(same_result(got["resumed"], resumed[(backend, p, c)]),
                              f"{name}: rank {rank}'s resumed finish differs from the single "
                              "process' resume of its snapshot")
                check(all(got["launches"][k] > 0 for k in kernels)
                      and (kernels or sum(got["launches"][k] for k in GYM_KERNELS) == 0),
                      f"{name}: rank {rank} launches {got['launches']}, want every one of {kernels}")
                check(got["launches"]["semijoin_probe/hash"] == 0,
                      f"{name}: rank {rank}: a semijoin_probe launch took the hash path")
                for k, v in got["launches"].items():
                    totals[k] += v
            if backend == "nccl" and not isinstance(c, str):  # held to the numpy join too
                q, _, data = families(seed, False)[c[0]]
                check(all(np.array_equal(x["rows"].astype(np.int64), np_answer(q, data)) for x in per),
                      f"{name}: rows != numpy join")
            wall = max(x["wall_s"] for x in per)
            setup = max(x["setup_s"] for x in per)
            setup_s += setup
            run_s += wall - setup
            share = [round(x["exchange_s"] / x["elapsed_s"], 4) for x in per]
            gshare = [round(x["gather_s"] / x["elapsed_s"], 4) for x in per]
            x0 = per[0]
            if c == "joinserve bench":
                drain = max(x["drain_s"] for x in per)
                what = (f"tickets={len(x0['tickets'])} ticks={x0['ticks']} drain_s (slowest rank)="
                        f"{drain:.4f} queries_per_s={len(x0['tickets']) / drain:.4f} "
                        f"dispatches_saved={x0['ledger']['dispatches_saved']} fused_dispatches="
                        f"{x0['ledger']['fused_dispatches']}; every ticket and the ServerLedger's "
                        f"counts equal on every rank and the single-process 'cuda' server's: yes")
            elif c == "int8_allreduce":
                what = (f"elements a rank={MESH_ALLREDUCE_N} ms per rank="
                        f"{[round(x['ms'], 3) for x in per]} bytes a rank hands the two all_reduces="
                        f"{x0['wire_bytes']}; every rank's result == the leading-axis form's, bit "
                        f"for bit (sha256): yes")
            else:
                what = f"out={x0['out']} records={len(x0['records'])} retries={x0['retries']}"
                if "steps" in x0:
                    what += (f" snapshot after {x0['steps']} steps: save_s="
                             f"{max(x['save_s'] for x in per):.4f} load_s="
                             f"{max(x['load_s'] for x in per):.4f} resumed finish_s="
                             f"{max(x['finish_s'] for x in per):.4f} "
                             f"({'a fresh driver' if c[1] == 'bench' else 'the same driver'}); "
                             f"{snap_notes[(backend, p, c)]}")
                what += "; every rank == single-process 'cuda' (rows, schema, records, ledger): yes"
                if backend == "nccl" and not isinstance(c, str):
                    what += " rows==numpy join: yes"
            print(f"{name}: wall_s={wall:.4f} setup_s={setup:.4f} exchange_share per rank={share} "
                  f"gather_share per rank={gshare} launches per rank="
                  f"{[[x['launches'][k] for k in GYM_KERNELS] for x in per]} {what}", flush=True)
        how = ("in this process, one rank" if backend == "nccl" and p == 1
               else "spawned; the rest is collecting results and stopping the ranks")
        print(f"mesh {backend} p={p}: {len(pcases)} queries and {len(entries)} other entry points, "
              f"mesh_s={total:.2f} spawn_s={spawn_s:.2f} (beside {prep_s:.2f} s of this process' "
              f"reference runs) host_setup_s={setup_s:.2f} run_s={run_s:.2f} (slowest rank each; "
              f"{how}; alone on the card)", flush=True)
    return totals


def mesh_snapshot_checks(meshes, snaps, refs, fam_data, config):
    """Each mesh snapshot against the single process (``refs``: its
    snapshot's digest and resumed result a case): the file equal, array for
    array and in ``meta`` less the config, to the single-process snapshot
    at the same cursor, and at bench size resumed by the single-process
    'cuda' driver as the single process resumes its own.  Returns the
    single process' resumed result and a note a case."""
    from repro_torch.core import gym as G
    from repro_torch.relational.spmd import SPMD

    resumed, notes = {}, {}
    for backend, p, _ in meshes:
        for c, path in snaps[(backend, p)].items():
            fam, size, engine = c
            name = f"mesh {backend} p={p} {' '.join(c)}"
            digest, mine, whose = refs[(backend, p, c)]
            check(snapshot_digest(path) == digest,
                  f"{name}: the mesh snapshot != {whose} single-process snapshot")
            resumed[(backend, p, c)] = mine
            notes[(backend, p, c)] = (
                f"bytes={os.path.getsize(path)}, == {whose} single-process snapshot at the same "
                "cursor array for array and in meta; every rank's resumed finish == the single "
                "process' resume")
            if size == "bench":
                q, g, data = fam_data(fam, size)
                drv = G.GymDriver(q, g, data, SPMD(p, device="cuda"), config(engine))
                drv.load(path)
                out = drv.run()
                check(same_result(gym_result(out.to_numpy(), out.schema, drv.ledger), mine),
                      f"{name}: the mesh snapshot resumed in one process != the single process' "
                      "resume of its own")
                notes[(backend, p, c)] += ", and so is the mesh snapshot's in one process"
    return resumed, notes


def _visible(torch, sq, sk, causal, window, dev):
    rows = torch.arange(sq, device=dev)[:, None]
    cols = torch.arange(sk, device=dev)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        vis &= cols <= rows
    if window > 0:
        vis &= cols > rows - window
    return vis


def _flash_err(got, want) -> float:
    """max |got - want| / max(1, |want|): absolute at |o| <= 1, relative above."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / w.abs().clamp(min=1.0)).max()) if w.numel() else 0.0


def flash_edge_checks(torch, dev):
    """The flash kernel against its plain version on the card, within
    ``FLASH_TOL``: head widths 16/64/128/256 (and 80, padded; and 112 in
    bf16, zamba2's, padded to 128), f32 and
    bf16, GQA groups 1/2/8, causal or not, window 0, shorter than a tile
    or longer, softcap 0 or 50, Sq != Skv both ways, Sq and Skv off the
    bf16 kernel's 128-row block and 64-key tile, Skv = 1, Sq = 1 (whisper's
    cross-attention in decode), the main paths' shapes, and fully masked
    rows, which must be exactly 0."""
    import itertools

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    rng = np.random.default_rng(11)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0

    def run(dtype, b, h, kvh, sq, sk, d, causal, window, softcap):
        nonlocal n
        dt = getattr(torch, dtype)
        # q scaled by 4 so that the scores reach the softcap's bend
        q = torch.from_numpy(4 * rng.standard_normal((b, h, sq, d))).to(dev, dt)
        k = torch.from_numpy(rng.standard_normal((b, kvh, sk, d))).to(dev, dt)
        v = torch.from_numpy(rng.standard_normal((b, kvh, sk, d))).to(dev, dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        what = f"flash_attention {dtype} b{b} h{h}/{kvh} sq{sq} sk{sk} d{d} {kw}"
        check(got.dtype == dt and got.shape == q.shape, f"{what}: dtype/shape")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        err = _flash_err(got, want)
        check(err <= FLASH_TOL[dtype], f"{what}: err {err} > {FLASH_TOL[dtype]}")
        dead = ~_visible(torch, sq, sk, causal, window, dev).any(dim=1)
        check(bool((got[:, :, dead] == 0).all()), f"{what}: a fully masked row is not 0")
        worst[dtype] = max(worst[dtype], err)
        n += 1
        return got

    for d, dtype, g, causal, window, softcap in itertools.product(
        (16, 64, 128, 256), ("float32", "bfloat16"), (1, 2, 8), (True, False),
        (0, 37), (0.0, 50.0),
    ):
        run(dtype, 2, 8, 8 // g, 130, 130, d, causal, window, softcap)
    for d, dtype in itertools.product((16, 64, 128, 256, 80), ("float32", "bfloat16")):
        run(dtype, 1, 4, 2, 70, 200, d, True, 0, 50.0)     # Sq < Skv, top-left causal
        run(dtype, 1, 4, 2, 200, 70, d, False, 33, 0.0)    # Sq > Skv, window
        run(dtype, 2, 4, 1, 129, 1, d, False, 0, 0.0)      # Skv = 1
        for causal in (True, False):                       # rows 23.. see no key
            got = run(dtype, 1, 2, 1, 128, 16, d, causal, 8, 0.0)
            check(bool((got[:, :, 23:] == 0).all()), "masked rows 23.. are not 0")
    for d in (64, 128, 256):  # bf16 tensor-core path: a window shorter than
        # a tile, Sq off the 128-row block and Skv off the 64-key tile
        run("bfloat16", 1, 8, 1, 200, 200, d, True, 5, 50.0)
        run("bfloat16", 1, 8, 2, 77, 333, d, False, 0, 0.0)
        run("bfloat16", 1, 4, 4, 333, 77, d, True, 0, 50.0)
    # the main path's call: gemma2-9b's global layer at 2 x 4608 tokens
    run("bfloat16", 2, 16, 8, 4608, 4608, 256, True, 0, 50.0)
    # zamba2-7b's shared block: D = 112, padded to the bf16 kernel's 128
    for causal, sq, sk in ((True, 130, 130), (False, 77, 333), (True, 333, 77)):
        run("bfloat16", 2, 8, 8, sq, sk, 112, causal, 0, 0.0)
    run("bfloat16", 2, 32, 32, 4096, 4096, 112, True, 0, 0.0)
    # whisper-small, D = 64, non-causal: cross-attention in decode (one
    # query a sequence: the bf16 kernel's 128-row block holds one real
    # row, the rest arrive as zeros and are never stored) and the encoder
    # at its 1500 frames (off the 128-row block and the 64-key tile)
    for dtype in ("float32", "bfloat16"):
        for sk in (1, 63, 64, 1500, 4097):
            run(dtype, 3, 12, 12, 1, sk, 64, False, 0, 0.0)
        run(dtype, 2, 12, 12, 1500, 1500, 64, False, 0, 0.0)
    # and once against the dense oracle
    q = torch.from_numpy(rng.standard_normal((2, 8, 150, 64))).to(dev, torch.float32)
    k = torch.from_numpy(rng.standard_normal((2, 2, 150, 64))).to(dev, torch.float32)
    err = _flash_err(FA.flash_attention(q, k, k, causal=True, window=40, softcap=50.0),
                     ref.attention_ref(q, k, k, causal=True, window=40, softcap=50.0))
    check(err <= FLASH_TOL["float32"], f"flash_attention vs attention_ref: {err}")
    torch.cuda.synchronize()
    return n + 1, worst


class FlashRecorder:
    """Wraps the flash wrapper to keep clones of the first call of a
    global (window 0) layer (without ``clone``, the tensors themselves:
    for inputs nothing writes afterwards); the wrapped call still launches
    the kernel."""

    def __init__(self, mod, clone: bool = True):
        self.mod = mod
        self.orig = mod.flash_attention
        self.best = None
        self.clone = clone
        mod.flash_attention = self

    def __call__(self, q, k, v, **kw):
        if self.best is None and not kw.get("window"):
            qkv = tuple(t.clone() for t in (q, k, v)) if self.clone else (q, k, v)
            self.best = qkv + (dict(kw),)
        return self.orig(q, k, v, **kw)

    def restore(self):
        self.mod.flash_attention = self.orig


def lm_phase(torch, seed: int, profile_dir: str = ""):
    """gemma2-9b serving through ``generate`` with the 'cuda' backend, held
    to a teacher-forced replay through the 'torch' backend on the card.
    With ``profile_dir``, one more warm prefill and decode are profiled."""
    from repro_torch.configs import get_config, get_model
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as K
    from repro_torch.serve import generate

    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    n_layers = len(cfg.blocks())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = get_model(cfg, "cuda", generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    check(model.use_cuda, "LM model is not on the 'cuda' backend")
    prompt_np = np.random.default_rng(seed).integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    prompt = torch.from_numpy(prompt_np).to("cuda")
    s_cache = LM_PROMPT + LM_STEPS + 1
    print(f"lm {cfg.name}: {n_layers} layers, d_model {cfg.d_model}, {n_params} params "
          f"({cfg.dtype}), init_s={init_s:.3f}; batch {LM_BATCH} x prompt {LM_PROMPT}, "
          f"s_cache {s_cache}, {LM_STEPS} greedy steps", flush=True)

    runs = []
    rec = FlashRecorder(FA)
    try:
        for name in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            stats = {}
            K.reset_launch_counts()
            toks, logits = generate(model, prompt, steps=LM_STEPS, s_cache=s_cache,
                                    return_logits=True, stats=stats)
            counts = K.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            check(counts["flash_attention"] == n_layers,
                  f"lm {name}: flash_attention launched {counts['flash_attention']} times, "
                  f"not {n_layers}")
            check(all(counts[k] == 0 for k in GYM_KERNELS), f"lm {name}: gym kernel launched")
            runs.append(dict(name=name, toks=toks, logits=logits, stats=stats, peak=peak,
                             launches=counts["flash_attention"], base=base))
    finally:
        rec.restore()
    cold, warm = runs
    toks, logits = cold["toks"], cold["logits"]
    check(toks.shape == (LM_BATCH, LM_STEPS) and logits.shape == (LM_BATCH, LM_STEPS, cfg.vocab),
          "lm: output shapes")
    check(bool(torch.isfinite(logits).all()), "lm: non-finite logits")
    check(torch.equal(toks, logits.argmax(-1)), "lm: greedy tokens are not the argmax")

    # teacher-forced replay through the plain attention on the card
    model.backend = "torch"
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = model.prefill({"tokens": prompt}, s_cache=s_cache)
    ref_logits = [lg]
    for i in range(LM_STEPS - 1):
        lg, caches = model.decode_step(caches, toks[:, i])
        ref_logits.append(lg)
    ref_logits = torch.stack(ref_logits, dim=1)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    model.backend = None
    check(sum(K.launch_counts().values()) == 0, "lm: the 'torch' backend launched a kernel")
    del caches
    delta, scale, n_same, n_decided = logit_rule(torch, logits, ref_logits, toks, "lm")
    steps_per_gen = LM_STEPS - 1
    out = {}
    for r in runs:
        st = r["stats"]
        total = st["prefill_s"] + st["decode_s"]
        m = out[r["name"]] = dict(
            prefill_s=st["prefill_s"], decode_ms_per_step=1e3 * st["decode_s"] / steps_per_gen,
            decode_ms_per_token=1e3 * st["decode_s"] / (steps_per_gen * LM_BATCH),
            tokens_per_s=LM_BATCH * LM_STEPS / total,
            prefill_tokens_per_s=LM_BATCH * LM_PROMPT / st["prefill_s"],
            peak_bytes=r["peak"], flash_launches=r["launches"],
        )
        print(
            f"lm generate {r['name']}: prefill_s={st['prefill_s']:.4f} "
            f"decode_s={st['decode_s']:.4f} decode_ms_per_step={m['decode_ms_per_step']:.3f} "
            f"decode_ms_per_token={m['decode_ms_per_token']:.3f} "
            f"tokens_per_s={m['tokens_per_s']:.2f} "
            f"prefill_tokens_per_s={m['prefill_tokens_per_s']:.1f} "
            f"max_memory_allocated={r['peak']} flash_launches={r['launches']}",
            flush=True,
        )
    print(
        f"lm cuda vs torch backend (teacher-forced; the torch backend took {torch_s:.3f} s): "
        f"max|dlogit|={delta:.6g} max|logit|={scale:.6g} ratio={delta / scale:.3g} "
        f"(bound {LM_LOGIT_REL_TOL}); argmax equal on {n_same}/{toks.numel()} "
        f"steps, margin > 2 max|dlogit| on {n_decided}; warm tokens == cold: "
        f"{bool(torch.equal(warm['toks'], toks))}; tokens[0][:8]={toks[0, :8].tolist()}",
        flush=True,
    )
    check(rec.best is not None, "lm: no global-layer flash call was recorded")
    # the dry run's witness: the warm run's peak, less what was allocated
    # before it that is not the cell's (the cold run's recorded call, ...)
    out["witness"] = dict(peak=warm["peak"], warm_s=warm["stats"]["prefill_s"],
                          held=warm["base"] - w_bytes - prompt.numel() * prompt.element_size())
    if profile_dir:
        profile_lm(torch, model, {"tokens": prompt}, s_cache, profile_dir)
    del model, logits, ref_logits, runs, cold, warm
    torch.cuda.empty_cache()
    return out, rec.best, n_layers


def profile_lm(torch, model, batch, s_cache: int, out_dir: str, tag: str = "lm") -> None:
    """``torch.profiler`` over one warm prefill of ``batch`` and, apart,
    over the decode steps of one ``generate``: host seconds, the device's
    busy share, and the top device work by name (operator tables go to
    ``out_dir``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    logits, caches = model.prefill(batch, s_cache=s_cache)
    tok = logits.argmax(-1)
    windows = {}
    for name in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if name == "prefill":
                model.prefill(batch, s_cache=s_cache)
            else:
                for _ in range(LM_STEPS - 1):
                    logits, caches = model.decode_step(caches, tok)
                    tok = logits.argmax(-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        windows[name] = (prof, wall)
    for name, (prof, wall) in windows.items():
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kern = {}
        for e in dev_events:
            kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
        busy_s = sum(kern.values()) / 1e6
        with open(os.path.join(out_dir, f"profile_{tag}_{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        print(f"profile {tag} {name} (warm, profiled): wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
              f"device_busy_share={busy_s / wall:.4f} device_ops={len(dev_events)}", flush=True)
        for kname, us in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {kname[:90]:90s} device_ms={us / 1e3:.3f}", flush=True)


def flash_timing(torch, recorded, launches, reps):
    """Time the flash kernel at its recorded main-path call beside its plain
    version and SDPA (a yardstick only: it computes no softcap)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    q, k, v, kw = recorded
    dev = q.device
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.int32, device=dev)  # > 50 MB L2
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    rel = _flash_err(got, want)
    check(rel <= FLASH_TOL[str(q.dtype).split(".")[-1]], f"flash at main-path shapes: {rel}")
    del got, want
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    ms = time_cold(torch, lambda: FA.flash_attention(q, k, v, **kw), reps, flush)
    plain_ms = time_cold(torch, lambda: FA.flash_attention_plain(q, k, v, **kw),
                         max(3, reps // 10), flush)
    causal = bool(kw.get("causal"))
    try:
        def lib():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
        lib()
        lib_note = "SDPA enable_gqa=True, no softcap"
    except TypeError:  # a torch without enable_gqa: repeat the kv heads outside the timing
        kr, vr = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))

        def lib():
            F.scaled_dot_product_attention(q, kr, vr, is_causal=causal)
        lib_note = "SDPA on repeated kv heads, no softcap"
    library_ms = time_cold(torch, lib, reps, flush)
    pairs = visible_pairs(sq, sk, causal, int(kw.get("window") or 0))
    flops = 4 * b * h * d * pairs
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / PEAK_FLOPS_BF16 * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    bound = max(t_ops, t_bytes)
    dk = next(w for w in FA.KERNEL_D[q.dtype] if w >= d)
    padded = "" if dk == d else (
        f"; the kernel runs D = {dk} (zero columns): {4 * b * h * dk * pairs} flop, "
        f"{4 * b * h * dk * pairs / PEAK_FLOPS_BF16 * 1e3:.6f} ms at the peak")
    print(
        f"kernel flash_attention: q {tuple(q.shape)} k/v {tuple(k.shape)} {q.dtype} {kw} "
        f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} ({lib_note}) "
        f"bound_ms={bound:.6f} ({'operations' if t_ops >= t_bytes else 'bytes'}: {flops} flop "
        f"over {pairs} visible pairs, {nbytes} B{padded}) share_of_bound={bound / ms:.4f} "
        f"achieved_tflops={flops / ms / 1e9:.2f} max_abs_err={err:.6g} launches={launches}",
        flush=True,
    )
    return {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": KERNELS["flash_attention"], "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


# --------------------------------------------------------------------- MoE
# the MoE phase: grok-1-314b at its published widths (bf16), the depth cut
# from 64 layers to MOE_LAYERS (a layer holds 4.92e9 parameters, 9.84 GB;
# four layers and the two 0.81e9-parameter tables hold 42.6 GB of the
# card's 80, and a fifth layer would leave too little room for the
# calibrated route's transient), two 2048-token prompts, 16 greedy tokens
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_PROMPT, MOE_STEPS = "grok-1-314b", 4, 2, 2048, 16
# the layer alone at full width: tokens a call, and
# benchmarks/bench_moe.py's zipf-hot mix (prototype popularity ~ 1/rank^1.5)
# with its heavy threshold
MOE_LAYER_TOKENS, MOE_ZIPF_S, MOE_HEAVY_THRESHOLD = 4096, 1.5, 1.5
# dense against calibrated without drops, bf16, as max |d| / max(1, |o|):
# both routes run one expert FFN per pair from the same bf16 rows, in GEMMs
# of other shapes (each of the three products and the SiLU's cast may round
# one bf16 ulp apart, 2**-8 relative), the dense route weights each pair in
# bf16 and adds the k pairs in bf16 while the calibrated one does both in
# f32, and the residual sum rounds once more: four bf16 ulps at |o| in [1, 2)
MOE_ROUTE_TOL = 3.2e-2
# reduced kimi-k2 (the reference tests' config, f32, capacity factor e) on
# the card against the CPU: one train step per route, batch 4 x 16
MOE_KIMI = "kimi-k2-1t-a32b"


def dense_drops_on_host(flat_e, cfg, t: int) -> int:
    """The pairs the dense scatter must drop, from its router decisions: a
    host bincount of ``flat_e`` against the capacity."""
    from repro_torch.models.moe_routing import dense_capacity

    arr = np.bincount(flat_e.cpu().numpy(), minlength=cfg.n_experts)
    return int(np.maximum(arr - dense_capacity(cfg, t), 0).sum())


class MoERecorder:
    """Wraps the transformer's MoE layer and the router (``router_pairs``
    as ``models/mlp.py`` and ``models/moe_routing.py`` call it): keeps each
    call's stats, the experts it chose and its router logits (device
    tensors, read only when ``take`` is called).  With ``force`` set to a
    recorded run's choices and logits, a replay is teacher-forced in its
    expert choices as in its tokens: each call takes the recorded experts
    at its own gate weights, and ``forced`` keeps, per call, the largest
    change of a router logit against the run's, the run's largest logit,
    the tokens whose own choice differed and the largest top-k margin
    among them (the replay's k-th logit over the least of the forced
    experts' logits)."""

    def __init__(self, T, mlp, mr):
        self.T, self.mlp, self.mr = T, mlp, mr
        self.orig, self.orig_router = T.moe_forward_stats, mr.router_pairs
        self.calls, self.chosen, self.logits, self.force, self.forced = [], [], [], None, []
        T.moe_forward_stats = self
        mlp.router_pairs = mr.router_pairs = self.router

    def router(self, p, xf, cfg):
        flat_e, flat_w, flat_tok = self.orig_router(p, xf, cfg)
        logits = xf.float() @ p["router"].float()
        if self.force is not None:
            forced, run_logits = self.force.pop(0)
            t, k = xf.shape[0], cfg.topk
            own, want = flat_e.view(t, k), forced.view(t, k)
            differ = (own.sort(-1).values != want.sort(-1).values).any(-1)
            margin = logits.gather(1, own).min(-1).values - logits.gather(1, want).min(-1).values
            self.forced.append((float((logits - run_logits).abs().max()), float(run_logits.abs().max()),
                                int(differ.sum()), float(margin[differ].max()) if bool(differ.any()) else 0.0))
            w = logits.softmax(-1).gather(1, want)
            flat_e, flat_w = forced, (w / (w.sum(-1, keepdim=True) + 1e-9)).reshape(-1)
        self.chosen.append(flat_e)
        self.logits.append(logits)
        return flat_e, flat_w, flat_tok

    def __call__(self, p, x, cfg):
        y, st = self.orig(p, x, cfg)
        self.calls.append((cfg, x.shape[0] * x.shape[1], st, self.chosen[-1]))
        return y, st

    def take(self):
        """Each call since the last ``take``: t, the route, the stats and
        the dense scatter's drops worked out on the host from the experts
        the call chose; and the (choices, router logits) of each call, in
        call order."""
        out = [dict(t=t, route=cfg.moe_route, host_dropped=dense_drops_on_host(fe, cfg, t),
                    **{k: int(v) for k, v in st.items()}) for cfg, t, st, fe in self.calls]
        chosen = list(zip(self.chosen, self.logits))
        self.calls, self.chosen, self.logits = [], [], []
        return out, chosen

    def restore(self):
        self.T.moe_forward_stats = self.orig
        self.mlp.router_pairs = self.mr.router_pairs = self.orig_router


def moe_serve(torch, model, prompt, s_cache, rec, K, warm: bool = False):
    """A cold (and with ``warm`` a warm) ``generate`` through the 'cuda'
    backend, then a teacher-forced replay of the cold run through the
    'torch' backend: returns the runs' figures and the flash launches."""
    from repro_torch.serve import generate

    cfg = model.cfg
    n_layers, k = len(cfg.blocks()), cfg.topk
    route = cfg.moe_route
    runs = []
    for name in ("cold", "warm")[:1 + warm]:
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        stats = {}
        toks, logits = generate(model, prompt, steps=MOE_STEPS, s_cache=s_cache,
                                return_logits=True, stats=stats)
        flash = K.launch_counts()["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
        calls, chosen = rec.take()
        check(flash == n_layers, f"moe {route} {name}: flash launched {flash} times, not {n_layers}")
        check(len(calls) == n_layers * MOE_STEPS, f"moe {route}: {len(calls)} MoE calls")
        for c in calls:
            if route == "calibrated":
                check(c["routed"] == c["t"] * k and c["dropped"] == 0,
                      f"moe calibrated {name}: {c} (must route t*k and drop 0)")
            else:
                check(c["dropped"] == c["host_dropped"] and c["routed"] == c["t"] * k - c["dropped"],
                      f"moe dense {name}: {c} (drops must equal the host's count)")
        runs.append(dict(name=name, toks=toks, logits=logits, stats=stats, peak=peak,
                         flash=flash, calls=calls, chosen=chosen))
    cold = runs[0]
    toks, logits = cold["toks"], cold["logits"]
    check(toks.shape == (MOE_BATCH, MOE_STEPS) and logits.shape == (MOE_BATCH, MOE_STEPS, cfg.vocab),
          f"moe {route}: output shapes")
    check(bool(torch.isfinite(logits).all()), f"moe {route}: non-finite logits")
    check(torch.equal(toks, logits.argmax(-1)), f"moe {route}: greedy tokens are not the argmax")

    # the replay, teacher-forced in its tokens and in its experts: a bf16
    # rounding apart in attention can flip a near-tie of the router, and
    # a flipped expert (or, on the dense route, a pair that then lands past
    # its expert's capacity) moves a token's output far past the rule.
    # Forcing hides no fault of the router's inputs: each call's router
    # logits must meet the logits' rule against the run's, and a token may
    # choose otherwise only where its replay margin is within the change
    model.backend = "torch"
    K.reset_launch_counts()
    rec.force, rec.forced = list(cold["chosen"]), []
    lg, caches = model.prefill({"tokens": prompt}, s_cache=s_cache)
    ref_logits = [lg]
    for i in range(MOE_STEPS - 1):
        lg, caches = model.decode_step(caches, toks[:, i])
        ref_logits.append(lg)
    ref_logits = torch.stack(ref_logits, dim=1)
    model.backend = None
    check(rec.force == [], f"moe {route}: the replay made {len(rec.force)} fewer MoE calls")
    forced, rec.force = rec.forced, None
    replay, _ = rec.take()
    check(K.launch_counts()["flash_attention"] == 0, f"moe {route}: the 'torch' backend launched flash")
    del caches
    for i, (dr, sr, n_flip, margin) in enumerate(forced):
        check(dr <= LM_LOGIT_REL_TOL * sr,
              f"moe {route}: replay call {i}: max |d router logit| {dr} > {LM_LOGIT_REL_TOL} * {sr}")
        check(margin <= 2 * dr, f"moe {route}: replay call {i}: {n_flip} tokens chose otherwise at a "
              f"top-k margin {margin} > 2 max |d router logit| {2 * dr}")
    router_ratio = max(dr / sr for dr, sr, _, _ in forced)
    flips = sum(1 for f in forced if f[2])
    delta = float((logits - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    top2 = ref_logits.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * delta
    same = ref_logits.argmax(-1) == toks
    prefill = [c for c in cold["calls"] if c["t"] == MOE_BATCH * MOE_PROMPT]
    decode = [c for c in cold["calls"] if c["t"] == MOE_BATCH]
    out = {}
    for r in runs:
        st = r["stats"]
        total = st["prefill_s"] + st["decode_s"]
        out[r["name"]] = m = dict(
            prefill_s=st["prefill_s"], decode_ms_per_step=1e3 * st["decode_s"] / (MOE_STEPS - 1),
            tokens_per_s=MOE_BATCH * MOE_STEPS / total,
            prefill_tokens_per_s=MOE_BATCH * MOE_PROMPT / st["prefill_s"], peak_bytes=r["peak"],
        )
        print(f"moe {cfg.name} {route} generate {r['name']}: prefill_s={st['prefill_s']:.4f} "
              f"decode_ms_per_step={m['decode_ms_per_step']:.3f} tokens_per_s={m['tokens_per_s']:.2f} "
              f"prefill_tokens_per_s={m['prefill_tokens_per_s']:.1f} max_memory_allocated={r['peak']} "
              f"flash_launches={r['flash']}", flush=True)
    print(f"moe {route} pairs per layer, prefill (t={MOE_BATCH * MOE_PROMPT}): "
          f"routed={[c['routed'] for c in prefill]} dropped={[c['dropped'] for c in prefill]} "
          f"heavy={[c['heavy'] for c in prefill]} host-counted dense drops="
          f"{[c['host_dropped'] for c in prefill]}; decode (t={MOE_BATCH}, {MOE_STEPS - 1} steps, "
          f"summed per layer): routed={[sum(c['routed'] for c in decode[i::n_layers]) for i in range(n_layers)]} "
          f"dropped={[sum(c['dropped'] for c in decode[i::n_layers]) for i in range(n_layers)]} "
          f"heavy={[sum(c['heavy'] for c in decode[i::n_layers]) for i in range(n_layers)]}", flush=True)
    print(f"moe {route} cuda vs torch backend (teacher-forced): max|dlogit|={delta:.6g} "
          f"max|logit|={scale:.6g} ratio={delta / scale:.3g} (bound {LM_LOGIT_REL_TOL}); argmax "
          f"equal on {int(same.sum())}/{same.numel()} steps, margin > 2 max|dlogit| on "
          f"{int(decided.sum())}; router logits, replay vs run: largest max|d|/max|logit| of a call "
          f"{router_ratio:.3g} (bound {LM_LOGIT_REL_TOL}); MoE calls of the replay whose own expert "
          f"choice differed from the run's (forced to the run's): {flips} of {len(replay)}, "
          f"{sum(f[2] for f in forced)} tokens, largest top-k margin among them "
          f"{max(f[3] for f in forced):.3g}; warm "
          f"tokens == cold: {bool(torch.equal(runs[-1]['toks'], toks))}; tokens[0][:8]="
          f"{toks[0, :8].tolist()}", flush=True)
    check(delta <= LM_LOGIT_REL_TOL * scale,
          f"moe {route}: max |dlogit| {delta} > {LM_LOGIT_REL_TOL} * max |logit| {scale}")
    check(bool(same[decided].all()), f"moe {route}: argmax differs where the margin exceeds 2 max |dlogit|")
    out["flash"] = sum(r["flash"] for r in runs)
    out["router_ratio"], out["flips"] = router_ratio, flips
    out["prefill_pairs"] = [(c["routed"], c["dropped"], c["heavy"]) for c in prefill]
    return out


def _warm_ms(torch, fn, reps: int = 3) -> float:
    """Median host ms of ``reps`` calls after one, each ending in a sync."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def moe_layer_checks(torch, model, seed: int):
    """One grok layer's MoE block alone at full width (the serving model's
    own tensors), ``MOE_LAYER_TOKENS`` tokens: both routes without drops
    (capacity factor e, the plan from ``calibrate_moe``) agree within
    ``MOE_ROUTE_TOL`` with equal stats; on the zipf-hot mix the dense
    scatter (1.25) drops exactly the host's count, more than 0, and the
    calibrated route under ``calibrate_moe(threshold=1.5)`` flags a heavy
    expert and drops 0.  Prints warm ms and the ledger's bytes."""
    from repro_torch.data.synthetic import zipf_hot_batch
    from repro_torch.models import moe_routing as mr
    from repro_torch.models.common import rms_norm
    from repro_torch.models.mlp import moe_forward_stats
    from repro_torch.relational.ledger import Ledger

    cfg = model.cfg
    p = model.layers[0].moe
    t, d, e, k = MOE_LAYER_TOKENS, cfg.d_model, cfg.n_experts, cfg.topk
    out = {}
    with torch.no_grad():
        g = torch.Generator(device="cuda").manual_seed(seed + 5)
        x = torch.randn((1, t, d), generator=g, device="cuda").to(cfg.torch_dtype)
        nod = dataclasses.replace(cfg, capacity_factor=float(e))
        plan, _ = mr.calibrate_moe(p, rms_norm(x, p["ln"], cfg.norm_eps).reshape(t, d), nod)
        pcfg = mr.apply_plan(nod, plan)
        yd, sd = moe_forward_stats(p, x, nod)
        yc, sc = moe_forward_stats(p, x, pcfg)
        sd, sc = ({kk: int(v) for kk, v in s.items()} for s in (sd, sc))
        err = _flash_err(yd, yc)
        check(sd == sc and sd["dropped"] == 0 and sd["routed"] == t * k,
              f"moe layer, no drops: dense {sd} calibrated {sc}")
        check(err <= MOE_ROUTE_TOL, f"moe layer: dense vs calibrated {err} > {MOE_ROUTE_TOL}")
        ms_d = _warm_ms(torch, lambda: moe_forward_stats(p, x, nod))
        ms_c = _warm_ms(torch, lambda: moe_forward_stats(p, x, pcfg))
        print(f"moe layer alone (t={t}, d={d}, e={e}, k={k}, {cfg.dtype}), no drops: plan {plan}; "
              f"stats dense {sd} == calibrated {sc}; max|d|/max(1,|o|)={err:.4g} (bound "
              f"{MOE_ROUTE_TOL}); warm ms dense={ms_d:.3f} calibrated={ms_c:.3f}", flush=True)
        del yd, yc
        out["nodrop"] = dict(plan=plan, dense_ms=ms_d, calibrated_ms=ms_c, err=err)

        xz = torch.from_numpy(zipf_hot_batch(e, d, 1, t, zs=MOE_ZIPF_S, seed=seed))
        xz = xz.to("cuda").to(cfg.torch_dtype)
        xfz = rms_norm(xz, p["ln"], cfg.norm_eps).reshape(t, d)
        flat_e = mr.router_pairs(p, xfz, cfg)[0]
        arrivals = np.bincount(flat_e.cpu().numpy(), minlength=e)
        want = dense_drops_on_host(flat_e, cfg, t)
        _, szd = moe_forward_stats(p, xz, cfg)
        zplan, _ = mr.calibrate_moe(p, xfz, cfg, threshold=MOE_HEAVY_THRESHOLD)
        zcfg = mr.apply_plan(cfg, zplan)
        _, szc = moe_forward_stats(p, xz, zcfg)
        szd, szc = ({kk: int(v) for kk, v in s.items()} for s in (szd, szc))
        check(want > 0 and szd["dropped"] == want and szd["routed"] == t * k - want,
              f"moe zipf: dense {szd}, host count {want} (arrivals {arrivals.tolist()})")
        check(len(zplan.heavy) >= 1, f"moe zipf: no heavy expert flagged ({zplan})")
        check(szc["dropped"] == 0 and szc["routed"] == t * k, f"moe zipf: calibrated {szc}")
        zms_d = _warm_ms(torch, lambda: moe_forward_stats(p, xz, cfg))
        zms_c = _warm_ms(torch, lambda: moe_forward_stats(p, xz, zcfg))
        led = Ledger()
        mr.record_dense_round(led, szd, cfg=cfg, t=t, d=d, note="dense")
        mr.record_moe_round(led, szc, plan=zplan, d=d, note="calibrated")
        dr, cr = led.records
        print(f"moe layer alone, zipf-hot mix (zs {MOE_ZIPF_S}, arrivals {arrivals.tolist()}): "
              f"dense (factor {cfg.capacity_factor}) {szd}, host-counted drops {want}; calibrated "
              f"{zplan} (threshold {MOE_HEAVY_THRESHOLD}) {szc}; warm ms dense={zms_d:.3f} "
              f"calibrated={zms_c:.3f}; ledger payload_bytes dense={dr.payload_bytes} "
              f"calibrated={cr.payload_bytes}, padded_slots dense={dr.padded_slots} "
              f"calibrated={cr.padded_slots}, summary {led.summary()}", flush=True)
        out["zipf"] = dict(plan=zplan, dense=szd, calibrated=szc, dense_ms=zms_d,
                           calibrated_ms=zms_c, payload_bytes=(dr.payload_bytes, cr.payload_bytes),
                           padded_slots=(dr.padded_slots, cr.padded_slots))
    return out


def moe_kimi_train_check(torch, seed: int):
    """Reduced kimi-k2 (f32, capacity factor e): one train step per route
    with ``moe_metrics`` on the card against the same step on the CPU
    ('torch' backend), held to the train phase's accumulation rule (loss
    rtol 1e-5; parameters atol 2e-5 / rtol 2e-4 on all but TRAIN_FEW of
    the elements, those within 2 lr); the MoE counts equal, and the two
    routes' losses equal."""
    from repro_torch.configs import get_config, get_model, reduced_config
    from repro_torch.models import moe_routing as mr
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

    base = reduced_config(get_config(MOE_KIMI))
    base = dataclasses.replace(base, capacity_factor=float(base.n_experts))
    b, s = 4, 16
    rng = np.random.default_rng(seed)
    batch = {kk: torch.from_numpy(rng.integers(0, base.vocab, (b, s))) for kk in ("tokens", "targets")}
    tcfg = TrainConfig(opt=OptConfig(lr=TRAIN_ACCUM_LR, warmup=1), moe_metrics=True)
    losses = {}
    for route in ("dense", "calibrated"):
        cfg = base if route == "dense" else mr.apply_plan(
            base, mr.MoEPlan.sound(b * s, base.topk, base.n_experts))
        cpu_model = get_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
        init = {kk: v.clone() for kk, v in cpu_model.state_dict().items()}
        ran = {}
        for where in ("cpu", "cuda"):
            if where == "cpu":
                model = cpu_model
            else:
                model = get_model(cfg, "cuda")
                model.load_state_dict(init)
            st = init_train_state(model, tcfg)
            m = make_train_step(model, tcfg)(st, {kk: v.to(where) for kk, v in batch.items()})
            ran[where] = (m["loss"].item(), {kk: int(m[f"moe_{kk}"]) for kk in ("routed", "dropped", "heavy")},
                          {kk: p.detach().cpu() for kk, p in model.named_parameters()})
        (lc, mc, pc), (lg, mg, pg) = ran["cpu"], ran["cuda"]
        check(abs(lc - lg) <= 1e-5 * abs(lc), f"moe kimi {route}: loss card {lg} cpu {lc}")
        n_moe = sum(1 for kind in base.blocks() if kind == "moe")
        check(mc == mg and mc["routed"] == b * s * base.topk * n_moe and mc["dropped"] == 0,
              f"moe kimi {route}: counts card {mg} cpu {mc}")
        bad, total, worst = _mismatch(torch, pg, pc, dict(atol=2e-5, rtol=2e-4), 2 * TRAIN_ACCUM_LR + 2e-5)
        check(bad <= TRAIN_FEW * total, f"moe kimi {route}: {bad} of {total} parameters differ")
        losses[route] = lg
        print(f"moe kimi-k2 reduced train step, {route}: loss card {lg:.7f} cpu {lc:.7f}; counts "
              f"{mg}; parameters outside atol 2e-5 / rtol 2e-4: {bad} of {total} (max |d| "
              f"{worst:.3g})", flush=True)
    check(abs(losses["dense"] - losses["calibrated"]) <= 1e-5 * abs(losses["dense"]),
          f"moe kimi: dense {losses['dense']} vs calibrated {losses['calibrated']}")
    return losses


def moe_phase(torch, seed: int, profile_dir: str = ""):
    """grok-1-314b served at full width on both MoE routes, its layer alone
    on no-drop and zipf-hot traffic, and reduced kimi-k2's train step (see
    the module doc, item 12).  With ``profile_dir``, each route's warm
    ``generate`` and one more warm prefill and decode, profiled.  Returns the figures, the flash
    kernel's launches, its first recorded call and the launches per
    generate."""
    from repro_torch.configs import get_config, get_model
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as K
    from repro_torch.models import mlp
    from repro_torch.models import moe_routing as mr
    from repro_torch.models import transformer as T

    torch.cuda.empty_cache()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    n_layers = len(cfg.blocks())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = get_model(cfg, "cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (MOE_BATCH, MOE_PROMPT))).to("cuda")
    s_cache = MOE_PROMPT + MOE_STEPS
    print(f"moe {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
          f"(head_dim {cfg.hd}), {cfg.n_experts} experts top-{cfg.topk}, expert d_ff "
          f"{cfg.moe_d_ff}, vocab {cfg.vocab}, softcaps {cfg.attn_softcap}/{cfg.logit_softcap}, "
          f"{cfg.dtype}; {n_params} params ({n_bytes} bytes), init_s={init_s:.3f}; batch "
          f"{MOE_BATCH} x prompt {MOE_PROMPT}, s_cache {s_cache}, {MOE_STEPS} greedy steps",
          flush=True)
    print(f"moe reduced: n_layers {full.n_layers} -> {n_layers} (depth only; every width as "
          f"published)", flush=True)

    rec = MoERecorder(T, mlp, mr)
    frec = FlashRecorder(FA)
    try:
        dense = moe_serve(torch, model, prompt, s_cache, rec, K, warm=bool(profile_dir))
        plan = mr.MoEPlan.sound(MOE_BATCH * MOE_PROMPT, cfg.topk, cfg.n_experts)
        cal_model = model.with_config(mr.apply_plan(cfg, plan))
        check(all(a.data_ptr() == b.data_ptr() for a, b in
                  zip(model.parameters(), cal_model.parameters())), "moe: a second copy of the weights")
        print(f"moe calibrated route: {plan} (ret_cap_send {plan.ret_cap_send}, ret_cap_recv "
              f"{plan.ret_cap_recv}) over the dense model's own tensors", flush=True)
        calibrated = moe_serve(torch, cal_model, prompt, s_cache, rec, K, warm=bool(profile_dir))
    finally:
        rec.restore()
        frec.restore()
    if profile_dir:
        profile_lm(torch, model, {"tokens": prompt}, s_cache, profile_dir, tag="moe_dense")
        profile_lm(torch, cal_model, {"tokens": prompt}, s_cache, profile_dir, tag="moe_calibrated")
    del cal_model
    layer = moe_layer_checks(torch, model, seed)
    del model
    torch.cuda.empty_cache()
    kimi = moe_kimi_train_check(torch, seed)
    launches = {kk: 0 for kk in GYM_KERNELS}
    launches["flash_attention"] = dense["flash"] + calibrated["flash"]
    check(frec.best is not None, "moe: no flash call was recorded")
    summary = dict(dense=dense, calibrated=calibrated, layer=layer, kimi=kimi,
                   n_params=n_params, init_s=init_s)
    return summary, launches, frec.best, n_layers


# ------------------------------------------------------------ SSM / xLSTM
# the ssm phase: xlstm-125m and zamba2-7b at full width and depth, bf16,
# random weights from the seed; arch -> prompt tokens a sequence
SSM_PROMPTS = {"xlstm-125m": 2048, "zamba2-7b": 4096}
SSM_BATCH, SSM_STEPS = 2, 16
# (c): prefill all but the last SSM_TAIL prompt tokens, decode those
# teacher-forced, and hold the last step's logits to the whole prefill's.
# This gate, and the 5% bound of zamba2's cuda-vs-torch replay, run an f32
# copy of the model (weights from the same seed; the replay's margin rule
# holds bf16 too, (g) holds bf16 to the f32 copy layer by layer, and
# --profile ssm prints (c)'s bf16 figure).  Random weights make these deep
# recurrent stacks amplify a one-ulp bf16 change layer by layer: prefill
# and decode round their GEMMs apart (a GEMM against a GEMV), and xlstm's
# two paths then differ by 0.083 of the largest logit; the port and the
# reference alike (on the CPU, zamba2's 81-layer pattern at d_model 256
# gives 0.14 in the reference's bf16 and 0.17 in the port's, 1e-5 in f32:
# tests/test_torch_ssm_bf16.py).  zamba2's 75 Mamba2 layers take the flash
# kernel's bf16 rounding in its 6 shared-block calls (within 0.0078 of the
# plain version at the call) to 0.053 of the largest logit
SSM_TAIL = 48
# (g): the bf16 model against its f32 copy (the same seed: the bf16
# weights are the f32 ones rounded) on the same prompt.  Layer by layer,
# each bf16 layer takes the f32 layer's input rounded to bf16, in prefill
# over the prompt and in SSM_GATE_DECODES decode steps from the f32
# layer's state.  Its update (output - input) differs from the f32 layer's
# by e (relative Frobenius norm).  Part of e is the bf16 residual stream's
# own rounding, which grows with depth as the residual outgrows the
# update: r for each residual add (r = the f32 output's rounding to bf16,
# over the f32 update; RESIDUAL_ADDS a block).  The block's own error,
# sqrt(e^2 - adds * r^2), must be within SSM_LAYER_TOL[kind]: nothing
# amplifies there, so a bf16-only cast or rounding fault in one block
# stands against that block's own rounding.  End to end, the bf16 model's
# prefill logits must be within SSM_E2E_TOL of the f32 copy's (the median
# over positions of max |d| / max |logit|).  The control, each bf16 layer
# (and the table) with every weight rounded to SSM_CONTROL_BITS mantissa
# bits (bf16 keeps 7), must exceed each limit at every layer of each kind
# and end to end.
SSM_CONTROL_BITS = 4
SSM_GATE_DECODES = 4  # decode steps a layer, teacher-forced on the prompt's first tokens
RESIDUAL_ADDS = {"mamba": 1, "mlstm": 1, "slstm": 2, "shared_attn": 2}
# Each limit is the geometric mean, to two digits, of the bf16 model's
# largest reading and the control's smallest on an H100 (80GB HBM3,
# 700 W; seed 0), so both sides clear it by 1.5-2.2x.  Block errors, bf16
# / control: prefill mLSTM 0.0165 / 0.0646, sLSTM 0.0051 / 0.0204, Mamba2
# 0.0089 / 0.0316, shared 0.0062 / 0.0246; decode mLSTM 0.0137 / 0.0339,
# sLSTM 0.0043 / 0.0184, Mamba2 0.0069 / 0.0222, shared 0.0064 / 0.0237.
# Median logit gaps: xlstm 0.327 / 0.735, zamba2 0.180 / 0.609.
SSM_LAYER_TOL = {
    "prefill": {"mlstm": 0.033, "slstm": 0.01, "mamba": 0.017, "shared_attn": 0.012},
    "decode": {"mlstm": 0.021, "slstm": 0.0089, "mamba": 0.012, "shared_attn": 0.012},
}
SSM_E2E_TOL = {"xlstm-125m": 0.49, "zamba2-7b": 0.33}
# (d) the long_500k decode cell of each arch that ``cell_enabled`` admits
# (the port's SHAPES["long_500k"], as the reference's): batch 1, a
# 524288-position cache, the first 524288 - LONG_STEPS claimed; the check of
# one shared layer's attention reads the cache LONG_SLICE keys at a time
LONG_STEPS, LONG_SLICE = 16, 65536
LONG_PEAK_SHARE_MAX = 0.9


def logit_rule(torch, got, want, toks, what: str, bound: bool = True):
    """The LM phases' rule for a run's logits against a replay's: max |d|
    within ``LM_LOGIT_REL_TOL`` of the replay's largest logit (unless not
    ``bound``), and the greedy token equal wherever the replay's top-2
    margin exceeds twice that change.  Returns (max |d|, max |logit|,
    steps with equal argmax, steps whose margin decides)."""
    delta = float((got - want).abs().max())
    scale = float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * delta
    same = want.argmax(-1) == toks
    check(not bound or delta <= LM_LOGIT_REL_TOL * scale,
          f"{what}: max |dlogit| {delta} > {LM_LOGIT_REL_TOL} * max |logit| {scale}")
    check(bool(same[decided].all()), f"{what}: argmax differs where the margin exceeds 2 max |dlogit|")
    return delta, scale, int(same.sum()), int(decided.sum())


def ssm_generate(torch, model, prompt, n_flash: int, K, warm: bool = True):
    """(a), (b): cold and warm ``generate`` through the 'cuda' backend, the
    flash kernel ``n_flash`` times each (the shared block's positions, in
    prefill) and no gym kernel, then a teacher-forced replay of the cold
    run through the 'torch' backend under ``logit_rule``, whose 5% bound
    holds an f32 model, or one without attention, whose two backends run
    the same code (``SSM_TAIL`` says why; the margin rule holds all).
    Without ``warm`` the cold run alone."""
    from repro_torch.serve import generate

    cfg = model.cfg
    s_cache = prompt.shape[1] + SSM_STEPS
    runs = []
    for name in ("cold", "warm")[:1 + warm]:
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        stats = {}
        toks, logits = generate(model, prompt, steps=SSM_STEPS, s_cache=s_cache,
                                return_logits=True, stats=stats)
        counts = K.launch_counts()
        check(counts["flash_attention"] == n_flash,
              f"ssm {cfg.name} {name}: flash launched {counts['flash_attention']} times, not {n_flash}")
        check(all(counts[k] == 0 for k in GYM_KERNELS), f"ssm {cfg.name} {name}: a gym kernel launched")
        runs.append(dict(name=name, toks=toks, logits=logits, stats=stats,
                         peak=torch.cuda.max_memory_allocated()))
    toks, logits = runs[0]["toks"], runs[0]["logits"]
    check(toks.shape == (SSM_BATCH, SSM_STEPS) and logits.shape == (SSM_BATCH, SSM_STEPS, cfg.vocab),
          f"ssm {cfg.name}: output shapes")
    check(bool(torch.isfinite(logits).all()), f"ssm {cfg.name}: non-finite logits")
    check(torch.equal(toks, logits.argmax(-1)), f"ssm {cfg.name}: greedy tokens are not the argmax")
    model.backend = "torch"
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = model.prefill({"tokens": prompt}, s_cache=s_cache)
    ref_logits = [lg]
    for i in range(SSM_STEPS - 1):
        lg, caches = model.decode_step(caches, toks[:, i])
        ref_logits.append(lg)
    ref_logits = torch.stack(ref_logits, dim=1)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    model.backend = None
    check(sum(K.launch_counts().values()) == 0, f"ssm {cfg.name}: the 'torch' backend launched a kernel")
    del caches
    out = {}
    for r in runs:
        st = r["stats"]
        total = st["prefill_s"] + st["decode_s"]
        out[r["name"]] = m = dict(
            prefill_s=st["prefill_s"], decode_ms_per_step=1e3 * st["decode_s"] / (SSM_STEPS - 1),
            tokens_per_s=SSM_BATCH * SSM_STEPS / total,
            prefill_tokens_per_s=SSM_BATCH * prompt.shape[1] / st["prefill_s"], peak_bytes=r["peak"],
        )
        print(f"ssm {cfg.name} {cfg.dtype} generate {r['name']}: prefill_s={st['prefill_s']:.4f} "
              f"decode_s={st['decode_s']:.4f} decode_ms_per_step={m['decode_ms_per_step']:.3f} "
              f"tokens_per_s={m['tokens_per_s']:.2f} prefill_tokens_per_s={m['prefill_tokens_per_s']:.1f} "
              f"max_memory_allocated={r['peak']} flash_launches={n_flash}", flush=True)
    bound = cfg.dtype == "float32" or n_flash == 0  # without attention the paths are one
    delta, scale = float((logits - ref_logits).abs().max()), float(ref_logits.abs().max())
    print(f"ssm {cfg.name} {cfg.dtype} cuda vs torch backend (teacher-forced; the torch backend took "
          f"{torch_s:.3f} s): max|dlogit|={delta:.6g} max|logit|={scale:.6g} ratio={delta / scale:.3g} "
          f"({f'bound {LM_LOGIT_REL_TOL}' if bound else 'the margin rule only'}); warm tokens == cold: "
          f"{bool(torch.equal(runs[-1]['toks'], toks))}; tokens[0][:8]={toks[0, :8].tolist()}", flush=True)
    _, _, same, decided = logit_rule(torch, logits, ref_logits, toks, f"ssm {cfg.name} {cfg.dtype}", bound)
    print(f"ssm {cfg.name} {cfg.dtype}: argmax equal on {same}/{toks.numel()} steps, margin > 2 "
          f"max|dlogit| on {decided}", flush=True)
    out["replay"] = (delta, scale)
    out["flash"] = len(runs) * n_flash
    return out


def ssm_consistency(torch, model, prompt, gate: bool, want=None):
    """(c): prefill all but the last ``SSM_TAIL`` tokens, decode those
    teacher-forced, and compare the last step's logits with the whole
    prompt's prefill (``want``, or one run here); with ``gate`` under the
    logits' rule: the recurrent state must pass from prefill to decode.
    Returns (max |d|, max |logit|)."""
    cfg = model.cfg
    p = prompt.shape[1]
    if want is None:
        want, caches = model.prefill({"tokens": prompt}, s_cache=p)
        del caches
    lg, caches = model.prefill({"tokens": prompt[:, :p - SSM_TAIL]}, s_cache=p)
    for t in range(p - SSM_TAIL, p):
        lg, caches = model.decode_step(caches, prompt[:, t])
    del caches
    what = f"ssm {cfg.name} {cfg.dtype} prefill {p - SSM_TAIL} + {SSM_TAIL} decodes"
    if gate:
        delta, scale, same, _ = logit_rule(torch, lg, want, want.argmax(-1), what)
    else:
        delta, scale = float((lg - want).abs().max()), float(want.abs().max())
        same = int((lg.argmax(-1) == want.argmax(-1)).sum())
    print(f"ssm {cfg.name} consistency, {cfg.dtype}: prefill {p - SSM_TAIL} tokens "
          f"({(p - SSM_TAIL) % cfg.chunk} past the last {cfg.chunk}-token chunk) + {SSM_TAIL} "
          f"teacher-forced decodes vs a {p}-token prefill, last position: max|dlogit|={delta:.6g} "
          f"max|logit|={scale:.6g} ratio={delta / scale:.3g} "
          f"({f'bound {LM_LOGIT_REL_TOL}' if gate else 'reported, not gated'}); argmax equal on "
          f"{same}/{SSM_BATCH}", flush=True)
    return delta, scale


def slstm_loop_cost(torch, model, seed: int, tokens: int, profiled: bool):
    """(f): one warm sLSTM layer's prefill over ``SSM_BATCH x tokens``
    (its host loop, a cell step a position) beside one mLSTM layer's
    chunked scan on the same input: host ms (synchronized) and, when
    ``profiled``, device ms and device operations from ``torch.profiler``
    (whose event processing takes tens of seconds here); per position is
    per step of the loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    x = torch.randn((SSM_BATCH, tokens, cfg.d_model), generator=torch.Generator(device="cuda")
                    .manual_seed(seed), device="cuda").to(cfg.torch_dtype)
    out = {}
    for kind in ("slstm", "mlstm"):
        layer = next(l for l in model.layers if l.kind == kind)
        with torch.no_grad():
            layer.prefill(x, None, False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layer.prefill(x, None, False)
            torch.cuda.synchronize()
            host_ms = 1e3 * (time.perf_counter() - t0)
            out[kind] = dict(host_ms=host_ms)
            line = (f"ssm {cfg.name} one {kind} layer's prefill, {SSM_BATCH} x {tokens} (warm): "
                    f"host_ms={host_ms:.3f} ({1e3 * host_ms / tokens:.2f} us a position)")
            if profiled:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    layer.prefill(x, None, False)
                    torch.cuda.synchronize()
                dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
                dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
                out[kind].update(device_ms=dev_ms, device_ops=len(dev))
                line += (f" device_ms={dev_ms:.3f} device_busy_share={dev_ms / host_ms:.4f} "
                         f"device_ops={len(dev)} ({len(dev) / tokens:.1f} a position)")
        print(line, flush=True)
    return out


class DecodeRecorder:
    """Wraps the transformer's ``attn_decode``: while ``at`` is set, keeps
    the parameters, input, cache, length and output of the ``at``-th call
    (counting from the arming); the call itself is unchanged."""

    def __init__(self, T):
        self.T, self.orig = T, T.attn_decode
        self.at, self.n, self.got = None, 0, None
        T.attn_decode = self

    def __call__(self, p, x, cache, cache_len, cfg, **kw):
        out = self.orig(p, x, cache, cache_len, cfg, **kw)
        if self.at is not None:
            if self.n == self.at:
                self.got = (p, x.clone(), cache, cache_len, out[0].clone())
            self.n += 1
        return out

    def restore(self):
        self.T.attn_decode = self.orig


def long_attention_check(torch, cfg, got) -> float:
    """One decode step's attention block at a long cache against an f32
    softmax computed here over ``LONG_SLICE``-key slices (an online
    max/sum across slices): the block's output x + o @ wo, as
    max |d| / max(1, |o|)."""
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.common import rms_norm

    p, x, cache, clen, out = got
    b = x.shape[0]
    pos = torch.full((b, 1), clen, dtype=torch.long, device=x.device)
    q = _project_qkv(p, rms_norm(x, p["ln"], cfg.norm_eps), cfg, pos)[0].float()
    kc, vc = cache["k"], cache["v"]
    kvh, hd = kc.shape[1], kc.shape[3]
    q = q.view(b, kvh, cfg.n_heads // kvh, hd)
    m = torch.full(q.shape[:-1] + (1,), float("-inf"), device=x.device)
    den = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for lo in range(0, clen + 1, LONG_SLICE):
        hi = min(clen + 1, lo + LONG_SLICE)
        sc = (q @ kc[:, :, lo:hi].float().transpose(-1, -2)) * float(cfg.hd) ** -0.5
        if cfg.attn_softcap > 0.0:
            sc = cfg.attn_softcap * torch.tanh(sc / cfg.attn_softcap)
        m2 = torch.maximum(m, sc.amax(-1, keepdim=True))
        w = torch.exp(sc - m2)
        keep = torch.exp(m - m2)
        den = den * keep + w.sum(-1, keepdim=True)
        acc = acc * keep + w @ vc[:, :, lo:hi].float()
        m = m2
    o = (acc / den).to(x.dtype).reshape(b, 1, -1)
    return _flash_err(out, x + (o @ p["wo"]).to(x.dtype))


def round_mantissa(torch, t, bits: int):
    """``t`` with each element rounded to ``bits`` mantissa bits (to
    nearest, ties away from zero), in ``t``'s dtype."""
    drop = 23 - bits
    x = t.float().contiguous().view(torch.int32)
    x = (x + (1 << (drop - 1))) & -(1 << drop)
    return x.view(torch.float32).to(t.dtype)


def rounded_copy(torch, module, bits: int):
    """A deep copy of ``module`` with every parameter through
    ``round_mantissa`` (the control of ``SSM_CONTROL_BITS``)."""
    import copy

    out = copy.deepcopy(module)
    with torch.no_grad():
        for prm in out.parameters():
            prm.copy_(round_mantissa(torch, prm, bits))
    return out


def block_err(torch, kind: str, x16, y16, x32, y32) -> float:
    """A bf16 block's own error against the f32 block (see
    ``SSM_LAYER_TOL``): its update's relative error less, in quadrature,
    the bf16 residual stream's rounding."""
    u32 = y32 - x32
    e = float((y16.float() - x16.float() - u32).norm() / u32.norm())
    r = float((y32.to(torch.bfloat16).float() - y32).norm() / u32.norm())
    return max(e * e - RESIDUAL_ADDS[kind] * r * r, 0.0) ** 0.5


def logit_gap(got, want):
    """Per position max |d| / max |logit| over the vocabulary: (median,
    90th percentile, max) over all positions."""
    r = ((got.float() - want).abs().amax(-1) / want.abs().amax(-1)).flatten().double()
    return float(r.median()), float(r.quantile(0.9)), float(r.max())


def ssm_bf16_gate(torch, m16, m32, prompt):
    """(g): ``m16`` (bf16) against ``m32``, its f32 copy, on ``prompt``
    (see ``SSM_LAYER_TOL``), with the ``SSM_CONTROL_BITS`` control beside
    it, in one pass over the layers: the f32 chain; each bf16 and control
    layer on the f32 layer's input, in prefill and in ``SSM_GATE_DECODES``
    decode steps of the prompt's first tokens, each from the f32 layer's
    state before it; and the bf16 and control
    models' own chains.  Prints the readings; returns (readings, failures,
    the f32 chain's last-position logits)."""
    from repro_torch.models.common import embed, rms_norm, unembed
    from repro_torch.models.transformer import ATTN_KINDS, _pad_seq

    cfg = m16.cfg
    b, s = prompt.shape
    bf = torch.bfloat16
    pos = m32._pos(None, b, s)
    use_cuda = m32.use_cuda
    tables = {"bf16": m16.embed["table"],
              "control": round_mantissa(torch, m16.embed["table"], SSM_CONTROL_BITS)}
    x32 = embed(prompt, m32.embed["table"])
    xd32 = embed(prompt[:, :SSM_GATE_DECODES], m32.embed["table"])
    own = {w: embed(prompt, t) for w, t in tables.items()}
    errs = {w: {"prefill": {}, "decode": {}} for w in tables}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for l32, l16 in zip(m32.layers, m16.layers):
            kind = l32.kind
            base = getattr(l16, "block", l16)  # a shared position runs the one block
            layers = {"bf16": base, "control": rounded_copy(torch, base, SSM_CONTROL_BITS)}
            y32, c32 = l32.prefill(x32, pos, use_cuda)
            if kind in ATTN_KINDS:  # room for the decode steps
                c32 = {k: _pad_seq(t, s + SSM_GATE_DECODES) for k, t in c32.items()}
            xin = x32.to(bf)
            for w, layer in layers.items():
                y, _ = layer.prefill(xin, pos, use_cuda)
                errs[w]["prefill"].setdefault(kind, []).append(block_err(torch, kind, xin, y, x32, y32))
                own[w] = layer.prefill(own[w], pos, use_cuda)[0]
            yd32, yd = [], {w: [] for w in layers}
            for j in range(SSM_GATE_DECODES):  # each from the f32 layer's state before it
                xj = xd32[:, j:j + 1]
                for w, layer in layers.items():
                    cj = {k: t.to(bf) if kind in ATTN_KINDS else t.clone() for k, t in c32.items()}
                    yd[w].append(layer.decode(xj.to(bf), cj, s + j)[0])
                y, c32 = l32.decode(xj, c32, s + j)
                yd32.append(y)
            yd32 = torch.cat(yd32, dim=1)
            for w in layers:
                errs[w]["decode"].setdefault(kind, []).append(
                    block_err(torch, kind, xd32.to(bf), torch.cat(yd[w], dim=1), xd32, yd32))
            x32, xd32 = y32, yd32
        want = m32._head(x32)
        gaps = {}
        for w, x in own.items():
            g = m16.final_ln if w == "bf16" else round_mantissa(torch, m16.final_ln, SSM_CONTROL_BITS)
            gaps[w] = logit_gap(unembed(rms_norm(x, g, cfg.norm_eps), tables[w], cfg.logit_softcap), want)
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    fails = []
    for w in ("bf16", "control"):
        for phase, by_kind in errs[w].items():
            for kind, e in by_kind.items():
                lim = SSM_LAYER_TOL[phase][kind]
                print(f"ssm {cfg.name} (g) {w} vs f32, {phase}, {len(e)} {kind} layers: block error "
                      f"min {min(e):.5g} median {float(np.median(e)):.5g} max {max(e):.5g} "
                      f"(limit {lim}: {'every layer within' if w == 'bf16' else 'every layer above'})",
                      flush=True)
                if w == "bf16" and max(e) > lim:
                    fails.append(f"ssm {cfg.name} (g): a bf16 {kind} layer's {phase} error "
                                 f"{max(e)} > {lim}")
                if w == "control" and min(e) <= lim:
                    fails.append(f"ssm {cfg.name} (g): the {SSM_CONTROL_BITS}-bit control's {kind} "
                                 f"{phase} error {min(e)} passes the limit {lim}")
        med, p90, mx = gaps[w]
        lim = SSM_E2E_TOL[cfg.name]
        print(f"ssm {cfg.name} (g) {w} vs f32, prefill logits over {b} x {s} positions, max|d| / "
              f"max|logit|: median {med:.5g} p90 {p90:.5g} max {mx:.5g} (limit on the median {lim})",
              flush=True)
        if (med > lim) if w == "bf16" else (med <= lim):
            fails.append(f"ssm {cfg.name} (g): the {w} model's median logit gap {med} "
                         f"{'>' if w == 'bf16' else '<='} {lim}")
    print(f"ssm {cfg.name} (g) took {gate_s:.2f} s; {len(fails)} failures", flush=True)
    return dict(errs=errs, gaps=gaps, seconds=gate_s), fails, want[:, -1]


def ssm_long_decode(torch, model, seed: int, K):
    """(d): the model's long_500k decode cell.  ``init_caches(1, S, S -
    16)`` with ``S = SHAPES["long_500k"][0]``; the claimed prefix of each
    shared-block position's K and V (zamba2-7b's) filled in place with
    seeded random bf16 (the reference's dry run takes cache contents as
    inputs), the recurrent states zero; one cold step, then ``LONG_STEPS -
    1`` timed ones.  Gates: finite logits, no flash launch, the peak under
    ``LONG_PEAK_SHARE_MAX`` of the card and within 10% above its reckoning
    (what is allocated when the cell starts: the weights and what the phase
    still holds; the caches, one f32 copy of a K or V cache in
    ``attn_decode``, the f32 table for the logits), and with shared positions the last
    step's last shared layer against ``long_attention_check``."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import transformer as T

    cfg = model.cfg
    long_cache = SHAPES["long_500k"][0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prefix = long_cache - LONG_STEPS
    t0 = time.perf_counter()
    caches = model.init_caches(1, long_cache, prefix)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shared = [i for i, l in enumerate(model.layers) if l.kind == "shared_attn"]
    for i in shared:
        for key in ("k", "v"):
            caches["layers"][i][key][:, :, :prefix].normal_(generator=gen)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    w_bytes = sum(t.numel() * t.element_size() for t in model.parameters())
    c_bytes = sum(t.numel() * t.element_size() for c in caches["layers"] for t in c.values())
    kv_copy = 4 * caches["layers"][shared[0]]["k"].numel() if shared else 0
    reckoned = base + c_bytes + kv_copy + 4 * cfg.vocab * cfg.d_model
    total = torch.cuda.get_device_properties(0).total_memory
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (LONG_STEPS, 1))).to("cuda")
    rec = DecodeRecorder(T)
    K.reset_launch_counts()
    logits = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = model.decode_step(caches, toks[0])
        torch.cuda.synchronize()
        cold_ms = 1e3 * (time.perf_counter() - t0)
        logits.append(lg)
        t0 = time.perf_counter()
        for i in range(1, LONG_STEPS):
            if i == LONG_STEPS - 1 and shared:
                rec.at = len(shared) - 1  # the last shared position
            lg, caches = model.decode_step(caches, toks[i])
            logits.append(lg)
        torch.cuda.synchronize()
        warm_ms = 1e3 * (time.perf_counter() - t0) / (LONG_STEPS - 1)
    finally:
        rec.restore()
    peak = torch.cuda.max_memory_allocated()
    what = f"ssm {cfg.name} long_500k"
    check(caches["len"] == long_cache, f"{what}: len {caches['len']} after {LONG_STEPS} steps")
    check(sum(K.launch_counts().values()) == 0, f"{what}: a kernel launched in decode")
    logits = torch.stack(logits)
    check(bool(torch.isfinite(logits).all()), f"{what}: non-finite logits")
    err = None
    if shared:
        check(rec.got is not None and rec.got[3] == long_cache - 1, f"{what}: no last-step attention call")
        err = long_attention_check(torch, cfg, rec.got)
        check(err <= FLASH_TOL["bfloat16"], f"{what}: attention vs f32 slices {err} > {FLASH_TOL['bfloat16']}")
    check(peak <= LONG_PEAK_SHARE_MAX * total, f"{what}: peak {peak} > {LONG_PEAK_SHARE_MAX} of {total}")
    check(peak <= 1.1 * reckoned, f"{what}: peak {peak} > 1.1 x the reckoned {reckoned}")
    attn = (f"; last step's last shared layer vs an f32 softmax over {LONG_SLICE}-key slices: "
            f"{err:.3g} (bound {FLASH_TOL['bfloat16']})" if shared else "")
    print(f"{what} decode: batch 1, cache {long_cache} positions ({prefix} claimed, "
          f"{'shared-block K/V seeded random bf16, ' if shared else ''}recurrent states 0; filled in "
          f"{fill_s:.3f} s); cold step {cold_ms:.3f} ms, decode_ms_per_step={warm_ms:.3f} over "
          f"{LONG_STEPS - 1} steps; max_memory_allocated={peak} ({peak / total:.4f} of {total}; "
          f"reckoned {reckoned}: allocated at the start {base} (weights {w_bytes}) + caches {c_bytes} "
          f"+ an f32 K/V copy {kv_copy} + "
          f"the f32 table {4 * cfg.vocab * cfg.d_model}; measured/reckoned {peak / reckoned:.4f})"
          f"{attn}; logits finite, |logit| max {float(logits.abs().max()):.4g}", flush=True)
    del caches
    torch.cuda.empty_cache()
    return dict(cold_ms=cold_ms, decode_ms_per_step=warm_ms, peak=peak, reckoned=reckoned, err=err,
                witness=dict(peak=peak, held=base - w_bytes, warm_s=warm_ms / 1e3))


def ssm_phase(torch, seed: int, profile_dir: str = ""):
    """xlstm-125m and zamba2-7b served at full width and depth (see the
    module doc, item 13).  Returns the figures, the flash kernel's
    launches, its first recorded call (zamba2's shared block) and its
    launches a zamba2 ``generate``."""
    from repro_torch.configs import cell_enabled, get_config, get_model
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as K

    summary, flash_total, per_generate = {}, 0, 0
    gate_fails = []  # (g)'s, checked once both models have printed theirs
    frec = FlashRecorder(FA)
    try:
        for arch, plen in SSM_PROMPTS.items():
            torch.cuda.empty_cache()
            cfg = get_config(arch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = get_model(cfg, "cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            n_params = sum(p.numel() for p in model.parameters())
            n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
            kinds = {k: cfg.blocks().count(k) for k in dict.fromkeys(cfg.blocks())}
            n_flash = kinds.get("shared_attn", 0)
            per_generate = max(per_generate, n_flash)
            prompt = torch.from_numpy(np.random.default_rng(seed).integers(
                0, cfg.vocab, (SSM_BATCH, plen))).to("cuda")
            print(f"ssm {arch}: {cfg.n_layers} layers {kinds}, d_model {cfg.d_model}, {cfg.n_heads} "
                  f"heads (head_dim {cfg.hd}), vocab {cfg.vocab}, chunk {cfg.chunk}, {cfg.dtype}; "
                  f"{n_params} params ({n_bytes} bytes), init_s={init_s:.3f}; batch {SSM_BATCH} x "
                  f"prompt {plen}, {SSM_STEPS} greedy steps", flush=True)
            marks = [("start", time.perf_counter())]
            fig = ssm_generate(torch, model, prompt, n_flash, K, warm=False)
            flash_total += fig["flash"]
            marks.append(("generate+replay", time.perf_counter()))
            if "slstm" in kinds:
                fig["slstm_loop"] = slstm_loop_cost(torch, model, seed, plen, bool(profile_dir))
            if profile_dir:  # and the bf16 prefill-then-decode figure (SSM_TAIL)
                profile_lm(torch, model, {"tokens": prompt}, plen + SSM_STEPS, profile_dir,
                           tag=f"ssm_{arch}")
                fig["consistency_bf16"] = ssm_consistency(torch, model, prompt, gate=False)
            marks.append(("slstm loop/profile", time.perf_counter()))
            if cell_enabled(arch, "long_500k"):
                fig["long_500k"] = ssm_long_decode(torch, model, seed, K)
            marks.append(("long_500k", time.perf_counter()))
            torch.cuda.empty_cache()  # the f32 copy beside the bf16 model, for (g)
            m32 = get_model(dataclasses.replace(cfg, dtype="float32"), "cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed))
            if n_flash:  # the f32 replay's 5% bound (ssm_generate)
                fig["f32"] = ssm_generate(torch, m32, prompt, n_flash, K, warm=False)
                flash_total += fig["f32"]["flash"]
            marks.append(("f32 replay", time.perf_counter()))
            K.reset_launch_counts()
            fig["bf16_gate"], fails, want = ssm_bf16_gate(torch, model, m32, prompt)
            gate_fails += fails
            n = K.launch_counts()["flash_attention"]  # the f32 chain, 2 bf16 and 2 control runs
            check(n == 5 * n_flash, f"ssm {arch} (g): flash launched {n} times, not {5 * n_flash}")
            flash_total += n
            del model
            marks.append(("(g) bf16 vs f32", time.perf_counter()))
            K.reset_launch_counts()
            fig["consistency"] = ssm_consistency(torch, m32, prompt, gate=True, want=want)
            del m32
            n = K.launch_counts()["flash_attention"]  # the P - SSM_TAIL prefill's
            check(n == n_flash, f"ssm {arch} f32 consistency: flash launched {n} times, not {n_flash}")
            flash_total += n
            marks.append(("f32 consistency", time.perf_counter()))
            print(f"ssm {arch} seconds: " + ", ".join(
                f"{name} {t - marks[i][1]:.1f}" for i, (name, t) in enumerate(marks[1:])), flush=True)
            summary[arch] = dict(fig, n_params=n_params, init_s=init_s)
    finally:
        frec.restore()
    torch.cuda.empty_cache()
    check(not gate_fails, "; ".join(gate_fails))
    check(frec.best is not None, "ssm: no flash call was recorded")
    launches = {k: 0 for k in GYM_KERNELS}
    launches["flash_attention"] = flash_total
    return summary, launches, frec.best, per_generate


# ---------------------------------------------------------------- Whisper
# the whisper phase: whisper-small at full width and depth, nothing cut (12
# encoder + 12 decoder layers, d_model 768, 12 heads of 64, d_ff 3072, vocab
# 51865, tied table, bf16, 294683904 params), random weights from the seed;
# the frames (the conv frontend is a stub in both packages) are normal values
# drawn on the card from the seed.
# (a) serving at whisper's own audio context: 1500 frames (its 30-s window
# after the conv stride), SHAPES["prefill_32k"]'s batch (32), 32 greedy
# tokens, a self cache of 32 + 4 positions (launch/serve.py's rule)
WHISPER_ARCH, WHISPER_FRAMES, WHISPER_STEPS = "whisper-small", 1500, 32
# (b) SHAPES["prefill_32k"] with the batch cut 32 -> 4 for the script's time
# (each of the 12 encoder calls is then 1.32e13 flop), 4 decode steps
WHISPER_PREFILL_BATCH, WHISPER_PREFILL_STEPS = 4, 4
# (c) SHAPES["decode_32k"] with the batch cut 128 -> 48: the cross caches
# take 1.208e9 B a sequence (12 layers x K and V x 12 heads x 32768 x 64 x
# 2 B), 154.6 GB at 128, and 64 would need 78.0 GB in all (0.92 of the card);
# the self cache holds 64 positions (the reference's input_specs), 8 steps
WHISPER_DECODE_BATCH, WHISPER_DECODE_STEPS = 48, 8
# (c)'s peak: at most this share above its reckoning (what is allocated when
# the cell starts, the weights among it; the caches; the f32 copy of the
# table for the logits)
WHISPER_PEAK_MARGIN = 0.02


def whisper_serve(torch, model, frames, n_flash: int, K, warm: bool = True):
    """(a): cold (and with ``warm`` warm) ``generate_whisper`` through the
    'cuda' backend, the flash kernel ``n_flash`` times each and no gym
    kernel, then a teacher-forced replay of the cold run through the
    'torch' backend under ``logit_rule``, whose 5% bound holds an f32
    model (the margin rule holds both).  Returns the figures and the cold
    run's tokens and logits."""
    from repro_torch.serve import generate_whisper

    cfg = model.cfg
    b = frames.shape[0]
    dec_cache = WHISPER_STEPS + 4
    runs = []
    for name in ("cold", "warm")[:1 + warm]:
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        stats = {}
        toks, logits = generate_whisper(model, frames, steps=WHISPER_STEPS, dec_cache=dec_cache,
                                        return_logits=True, stats=stats)
        counts = K.launch_counts()
        check(counts["flash_attention"] == n_flash,
              f"whisper {cfg.dtype} {name}: flash launched {counts['flash_attention']} times, not {n_flash}")
        check(all(counts[k] == 0 for k in GYM_KERNELS), f"whisper {name}: a gym kernel launched")
        runs.append(dict(name=name, toks=toks, logits=logits, stats=stats,
                         peak=torch.cuda.max_memory_allocated()))
    toks, logits = runs[0]["toks"], runs[0]["logits"]
    check(toks.shape == (b, WHISPER_STEPS) and logits.shape == (b, WHISPER_STEPS, cfg.vocab),
          f"whisper {cfg.dtype}: output shapes")
    check(bool(torch.isfinite(logits).all()), f"whisper {cfg.dtype}: non-finite logits")
    check(torch.equal(toks, logits.argmax(-1)), f"whisper {cfg.dtype}: greedy tokens are not the argmax")
    model.backend = "torch"
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = model.prefill({"frames": frames}, s_cache=dec_cache)
    ref_logits = [lg]
    for i in range(WHISPER_STEPS - 1):
        lg, caches = model.decode_step(caches, toks[:, i])
        ref_logits.append(lg)
    ref_logits = torch.stack(ref_logits, dim=1)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    model.backend = None
    check(sum(K.launch_counts().values()) == 0, "whisper: the 'torch' backend launched a kernel")
    del caches
    out = {}
    for r in runs:
        st = r["stats"]
        total = st["prefill_s"] + st["decode_s"]
        out[r["name"]] = m = dict(
            prefill_s=st["prefill_s"], decode_ms_per_step=1e3 * st["decode_s"] / (WHISPER_STEPS - 1),
            tokens_per_s=b * WHISPER_STEPS / total, peak_bytes=r["peak"],
        )
        print(f"whisper {cfg.name} {cfg.dtype} generate {r['name']}: prefill_s={st['prefill_s']:.4f} "
              f"decode_s={st['decode_s']:.4f} decode_ms_per_step={m['decode_ms_per_step']:.3f} "
              f"tokens_per_s={m['tokens_per_s']:.2f} max_memory_allocated={r['peak']} "
              f"flash_launches={n_flash}", flush=True)
    bound = cfg.dtype == "float32"
    delta, scale, same, decided = logit_rule(torch, logits, ref_logits, toks,
                                             f"whisper {cfg.dtype} cuda vs torch", bound)
    print(f"whisper {cfg.dtype} cuda vs torch backend (teacher-forced; the torch backend took "
          f"{torch_s:.3f} s): max|dlogit|={delta:.6g} max|logit|={scale:.6g} ratio={delta / scale:.3g} "
          f"({f'bound {LM_LOGIT_REL_TOL}' if bound else 'the margin rule only'}); argmax equal on "
          f"{same}/{toks.numel()} steps, margin > 2 max|dlogit| on {decided}; warm tokens == cold: "
          f"{bool(torch.equal(runs[-1]['toks'], toks))}; tokens[0][:8]={toks[0, :8].tolist()}",
          flush=True)
    out["replay"] = (delta, scale)
    return out, toks, logits


def whisper_phase(torch, seed: int, reps: int, profile_dir: str = ""):
    """whisper-small served at full width and depth (see the module doc,
    item 14): (a) 1500 frames, (b) prefill_32k, (c) decode_32k, and the
    flash kernel timed at (a)'s encoder call and (c)'s cross call.
    Returns the figures, the flash launches, the two timing records and
    the launches a (a) ``generate``."""
    from repro_torch.configs import SHAPES, get_config, get_model
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as K
    from repro_torch.serve import generate_whisper

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    torch.cuda.empty_cache()
    cfg = get_config(WHISPER_ARCH)
    n_enc, n_dec, d = cfg.enc_layers, cfg.n_layers, cfg.d_model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = get_model(cfg, "cuda", generator=gen())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    check(n_params == 294683904, f"whisper: {n_params} params, not whisper-small's 294683904")
    per_generate = n_enc + n_dec * WHISPER_STEPS  # the encoder, then cross-attention a step
    _, batch, _ = SHAPES["prefill_32k"]
    print(f"whisper {cfg.name}: {n_enc} encoder + {n_dec} decoder layers, d_model {d}, "
          f"{cfg.n_heads} heads (head_dim {cfg.hd}), d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; {n_params} params ({w_bytes} bytes), init_s={init_s:.3f}", flush=True)
    summary, flash_total, records = dict(n_params=n_params, init_s=init_s), 0, {}
    marks = [("start", time.perf_counter())]

    # (a) whisper's own context, bf16, then the f32 copy
    frames = torch.randn((batch, WHISPER_FRAMES, d), generator=gen(), device="cuda").to(cfg.torch_dtype)
    print(f"whisper (a): batch {batch} x {WHISPER_FRAMES} frames, {WHISPER_STEPS} greedy steps, "
          f"self cache {WHISPER_STEPS + 4}", flush=True)
    rec = FlashRecorder(FA)  # the first call: encoder layer 0
    try:
        summary["a"], _, _ = whisper_serve(torch, model, frames, per_generate, K, warm=False)
    finally:
        rec.restore()
    flash_total += per_generate
    check(rec.best is not None and rec.best[0].shape == (batch, cfg.n_heads, WHISPER_FRAMES, cfg.hd)
          and not rec.best[3]["causal"], "whisper (a): the encoder call was not recorded")
    records["encoder"] = flash_timing(torch, rec.best, per_generate, reps)
    del rec
    if profile_dir:
        profile_lm(torch, model, {"frames": frames}, WHISPER_STEPS + 4, profile_dir, tag="whisper")
    marks.append(("(a) bf16", time.perf_counter()))
    torch.cuda.empty_cache()  # the f32 copy (1.18 GB) beside the bf16 model
    m32 = get_model(dataclasses.replace(cfg, dtype="float32"), "cuda", generator=gen())
    f32, toks, logits = whisper_serve(torch, m32, frames.float(), per_generate, K, warm=False)
    flash_total += per_generate
    # teacher-forced decode against the decoder's full forward over the
    # same tokens (BOS, then the first 31 generated)
    seq = torch.cat([torch.zeros_like(toks[:, :1]), toks[:, :-1]], dim=1)
    K.reset_launch_counts()
    full = m32.logits(frames.float(), seq)
    n = K.launch_counts()["flash_attention"]
    check(n == n_enc + 2 * n_dec, f"whisper f32 full forward: flash launched {n} times, not {n_enc + 2 * n_dec}")
    flash_total += n
    delta, scale, same, decided = logit_rule(torch, logits, full, toks, "whisper f32 decode vs full forward")
    print(f"whisper float32 teacher-forced decode vs the decoder's full forward over the same "
          f"{WHISPER_STEPS} tokens: max|dlogit|={delta:.6g} max|logit|={scale:.6g} "
          f"ratio={delta / scale:.3g} (bound {LM_LOGIT_REL_TOL}); argmax equal on {same}/"
          f"{toks.numel()}, margin > 2 max|dlogit| on {decided}", flush=True)
    summary["a_f32"] = dict(f32, full_forward=(delta, scale))
    del m32, full, logits, frames
    marks.append(("(a) f32", time.perf_counter()))

    # (b) prefill_32k, batch cut to WHISPER_PREFILL_BATCH
    s, _, _ = SHAPES["prefill_32k"]
    b = WHISPER_PREFILL_BATCH
    torch.cuda.empty_cache()
    frames = torch.randn((b, s, d), generator=gen(), device="cuda").to(cfg.torch_dtype)
    n_flash = n_enc + n_dec * WHISPER_PREFILL_STEPS
    rec = FlashRecorder(FA)
    runs = []
    base = torch.cuda.memory_allocated() - b * s * d * 2  # the weights and what the script holds
    try:
        for name in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            stats = {}
            toks = generate_whisper(model, frames, steps=WHISPER_PREFILL_STEPS,
                                    dec_cache=WHISPER_PREFILL_STEPS + 4, stats=stats)
            n = K.launch_counts()["flash_attention"]
            check(n == n_flash, f"whisper (b) {name}: flash launched {n} times, not {n_flash}")
            check(toks.shape == (b, WHISPER_PREFILL_STEPS), "whisper (b): output shape")
            runs.append(dict(stats, peak=torch.cuda.max_memory_allocated()))
    finally:
        rec.restore()
    flash_total += 2 * n_flash
    q, k, v, kw = rec.best
    check(q.shape == (b, cfg.n_heads, s, cfg.hd) and not kw["causal"], "whisper (b): no encoder call")
    err = _flash_err(FA.flash_attention(q, k, v, **kw), FA.flash_attention_plain(q, k, v, **kw))
    check(err <= FLASH_TOL["bfloat16"], f"whisper (b): the encoder call vs the plain version {err}")
    # the peak falls while prefill builds the cross K/V: what is allocated
    # before the frames (the weights and what the script holds), the
    # frames, the encoder output, the recorded call's clones, the cross
    # caches and one layer's projections (cross_kv: K and V, each before
    # and after its contiguous copy)
    cross = 2 * n_dec * b * cfg.n_kv_heads * s * cfg.hd * 2
    clones = 3 * q.numel() * q.element_size()
    act = b * s * d * 2
    reckoned = base + cross + 2 * act + clones + 2 * cross // n_dec
    del rec, q, k, v
    for name, r in zip(("cold", "warm"), runs):
        print(f"whisper (b) prefill_32k, batch {b} (cut from {batch}) x {s} frames, generate "
              f"{name}: prefill_s={r['prefill_s']:.4f} decode_ms_per_step="
              f"{1e3 * r['decode_s'] / (WHISPER_PREFILL_STEPS - 1):.3f} max_memory_allocated="
              f"{r['peak']} (reckoned {reckoned}: allocated before {base} (weights {w_bytes}) + cross "
              f"caches {cross} + the "
              f"frames and the encoder output {2 * act} + the recorded call's clones {clones} + "
              f"one layer's cross K/V projections {2 * cross // n_dec}; measured/reckoned "
              f"{r['peak'] / reckoned:.4f}) flash_launches={n_flash}", flush=True)
    print(f"whisper (b): the encoder call q {(b, cfg.n_heads, s, cfg.hd)} non-causal vs the plain "
          f"version: {err:.3g} (bound {FLASH_TOL['bfloat16']})", flush=True)
    # the dry run's witness: less what was allocated before the frames that
    # is not the cell's, and the recorded call's clones
    summary["b"] = dict(runs=runs, reckoned=reckoned, err=err, witness=dict(
        peak=runs[1]["peak"], held=base - w_bytes + clones, warm_s=runs[1]["prefill_s"]))
    del frames
    marks.append(("(b)", time.perf_counter()))

    # (c) decode_32k, batch cut to WHISPER_DECODE_BATCH, random cross K/V
    s, _, _ = SHAPES["decode_32k"]
    b = WHISPER_DECODE_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the weights and what the script holds
    t0 = time.perf_counter()
    caches = model.init_caches(b, s, 64)
    g = gen()
    for key in ("k", "v"):
        caches["cross"][key].normal_(generator=g)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    c_bytes = sum(t.numel() * t.element_size() for part in ("cross", "self")
                  for t in caches[part].values())
    table = 4 * cfg.vocab * d
    reckoned = base + c_bytes + table
    total = torch.cuda.get_device_properties(0).total_memory
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (WHISPER_DECODE_STEPS, b))).to("cuda")
    rec = FlashRecorder(FA, clone=False)  # layer 0's cross call: q (b, 12, 1, 64)
    K.reset_launch_counts()
    logits = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = model.decode_step(caches, toks[0])
        torch.cuda.synchronize()
        cold_ms = 1e3 * (time.perf_counter() - t0)
        logits.append(lg)
        t0 = time.perf_counter()
        for i in range(1, WHISPER_DECODE_STEPS):
            lg, caches = model.decode_step(caches, toks[i])
            logits.append(lg)
        torch.cuda.synchronize()
        warm_ms = 1e3 * (time.perf_counter() - t0) / (WHISPER_DECODE_STEPS - 1)
    finally:
        rec.restore()
    peak = torch.cuda.max_memory_allocated()
    n = K.launch_counts()["flash_attention"]
    check(n == n_dec * WHISPER_DECODE_STEPS, f"whisper (c): flash launched {n} times")
    flash_total += n
    logits = torch.stack(logits)
    check(caches["len"] == WHISPER_DECODE_STEPS and bool(torch.isfinite(logits).all()),
          "whisper (c): non-finite logits or a wrong cache length")
    check(base + c_bytes <= peak <= (1 + WHISPER_PEAK_MARGIN) * reckoned,
          f"whisper (c): peak {peak} outside [{base + c_bytes}, {1 + WHISPER_PEAK_MARGIN} x {reckoned}]")
    print(f"whisper (c) decode_32k, batch {b} (cut from {SHAPES['decode_32k'][1]}), cross caches "
          f"{s} frames seeded random bf16 (filled in {fill_s:.3f} s), self cache 64: cold step "
          f"{cold_ms:.3f} ms, decode_ms_per_step={warm_ms:.3f} over {WHISPER_DECODE_STEPS - 1} steps; "
          f"max_memory_allocated={peak} ({peak / total:.4f} of {total}; reckoned {reckoned}: allocated "
          f"at the start {base} (weights {w_bytes}) + caches {c_bytes} + the f32 table {table}; "
          f"measured/reckoned "
          f"{peak / reckoned:.4f}); logits finite, |logit| max {float(logits.abs().max()):.4g}; "
          f"flash_launches={n}", flush=True)
    check(rec.best is not None and rec.best[0].shape == (b, cfg.n_heads, 1, cfg.hd),
          "whisper (c): the cross call was not recorded")
    records["cross"] = flash_timing(torch, rec.best, n_dec * WHISPER_DECODE_STEPS, reps)
    summary["c"] = dict(cold_ms=cold_ms, decode_ms_per_step=warm_ms, peak=peak, reckoned=reckoned,
                        witness=dict(peak=peak, held=base - w_bytes, warm_s=warm_ms / 1e3))
    del rec, caches, logits, model
    torch.cuda.empty_cache()
    marks.append(("(c) and the timings", time.perf_counter()))
    print("whisper seconds: " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}" for i, (name, t) in enumerate(marks[1:])), flush=True)
    launches = {k: 0 for k in GYM_KERNELS}
    launches["flash_attention"] = flash_total
    return summary, launches, records, per_generate


# ---------------------------------------------------------------- training
# the train phase: smollm-360m at full width and depth, bf16, AdamW with f32
# moments, batch 8 x 2048 tokens (16384 a step; 2048 keys meet
# CHUNKED_MIN_KV, so every layer's attention takes the chunked scan)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "smollm-360m", 8, 2048, 4
# launch/train.py's steps with --ckpt (the script's time limit: 8 until
# the ssm phase came)
TRAIN_CLI_STEPS = 2
# the corpus join at a size that gives the gym kernels real work
TRAIN_BIG_CORPUS = dict(n_docs=2**20, n_shards=2**10)
# chunked against dense attention at the real shape, bf16: both compute in
# f32 from the same bf16 inputs and round once, in other summation orders
# (about two bf16 ulps of the largest magnitude)
TRAIN_ATTN_TOL = 1e-2
# step 0, chunked against dense (both under remat): the attention outputs'
# bf16 roundings travel through 32 layers of bf16 activations
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 2e-3, 2e-2
# accumulation parity (f32 at full width, the reference test's dtype and
# tolerances, rtol 1e-5 on the loss, atol 2e-5 / rtol 2e-4 on parameters
# at its lr 1e-3): a first AdamW step moves a parameter by about
# lr * g / (|g| + eps), so a gradient element near zero whose last bits
# differ moves its parameter by up to 2 lr; all but TRAIN_FEW of the
# elements must meet the tolerance, and those 2 lr.  The same budget holds
# the resumed step's parameters, whose only nondeterminism is the
# embedding's backward (atomics)
TRAIN_ACCUM_LR = 1e-3
TRAIN_FEW = 1e-3
# the steps on one batch: the reference test's lr 1e-2 (for its reduced
# config) diverges at full width in bf16 after three steps (losses 11.30,
# 11.50, 10.69, 10.25, 10.95, 11.67, 12.11, 12.09 on the H100), a step of
# 1e-2 being a third of a weight's init std (960^-0.5)
TRAIN_LR = 1e-3

CUDA_LOSS_CHILD = """
import sys
sys.path.insert(0, {src!r})
import torch
from repro_torch.configs import get_config, get_model, make_smoke_batch, reduced_config
from repro_torch.kernels import ops as K
cfg = reduced_config(get_config("smollm-360m"))
model = get_model(cfg, "cuda", backend="cuda")
model.requires_grad_(True)
batch = make_smoke_batch(cfg, torch.Generator(device="cuda").manual_seed(0), b=2, s=64)
K.reset_launch_counts()
try:
    model.loss(batch)
except RuntimeError as e:
    assert "no backward" in str(e), e
    assert K.launch_counts()["flash_attention"] == 0
    print("refused:", str(e).split(";")[0])
else:
    raise SystemExit("a 'cuda'-backend loss ran through the flash kernel")
"""


def numpy_eligible(cfg_data, q_min: int) -> np.ndarray:
    """The eligible doc ids in numpy: the selection predicates of
    ``tests/test_train_substrate.py::test_pipeline_gym_join``."""
    d = cfg_data
    docs = d["docs"]
    ok = (np.isin(docs[:, 1], d["shards"][d["shards"][:, 1] >= q_min][:, 0])
          & np.isin(docs[:, 0], d["dedup"][d["dedup"][:, 1] == 1][:, 0])
          & np.isin(docs[:, 2], d["mix"][d["mix"][:, 1] > 0][:, 0]))
    return np.unique(docs[ok, 0]).astype(np.int64)


def corpus_join_checks(torch, K, dev: str = "cuda"):
    """``eligible_docs`` on the card's default ('cuda') backend against the
    'torch' backend on the card and numpy, at the pipeline's default corpus
    and at 2^20 docs; returns the kernels' launches."""
    from repro_torch.core.gym import GymConfig
    from repro_torch.data import CorpusConfig, eligible_docs, synth_corpus

    totals = {k: 0 for k in GYM_KERNELS}
    totals.update({"semijoin_probe/bitmap": 0, "semijoin_probe/hash": 0})
    for name, cfg in (("default", CorpusConfig()),
                      ("2^20 docs", CorpusConfig(**TRAIN_BIG_CORPUS))):
        data = synth_corpus(cfg)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, summ = eligible_docs(cfg, data, device=dev)
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t0
        counts = K.launch_counts()
        paths = K.semijoin_probe_path_counts()
        for k in GYM_KERNELS:
            totals[k] += counts[k]
        for k, v in paths.items():
            totals[f"semijoin_probe/{k}"] += v
        check(all(counts[k] > 0 for k in GYM_KERNELS),
              f"corpus join {name}: a gym kernel never launched {counts}")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        tids, tsumm = eligible_docs(cfg, data, device=dev,
                                    config=GymConfig(strategy="hash", local_backend="torch"))
        torch_s = time.perf_counter() - t0
        check(sum(K.launch_counts().values()) == 0, "corpus join: 'torch' launched a kernel")
        want = numpy_eligible(data, cfg.q_min)
        check(np.array_equal(ids, tids) and summ == tsumm,
              f"corpus join {name}: 'cuda' != 'torch'")
        check(np.array_equal(ids, want) and len(ids) > 0, f"corpus join {name}: != numpy")
        print(f"train corpus join {name}: docs={cfg.n_docs} shards={cfg.n_shards} "
              f"eligible={len(ids)} rounds={summ['rounds']} comm={summ['comm_tuples']} "
              f"dispatches={summ['measured_dispatches']} retries={summ['retries']} "
              f"cuda_s={cuda_s:.4f} torch_backend_s={torch_s:.4f} launches="
              f"{ {k: counts[k] for k in GYM_KERNELS} } semijoin_paths={paths} "
              f"cuda==torch==numpy: yes", flush=True)
    return totals


def chunked_attention_check(torch, K, seed: int, dev: str = "cuda"):
    """Chunked against dense attention at the train phase's shape (bf16,
    causal): forward and q/k/v gradients, and each backward's peak memory."""
    cfg_h, cfg_kv, hd = 15, 5, 64
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((TRAIN_BATCH, cfg_h, TRAIN_SEQ, hd), (TRAIN_BATCH, cfg_kv, TRAIN_SEQ, hd),
              (TRAIN_BATCH, cfg_kv, TRAIN_SEQ, hd))
    q, k, v = (torch.randn(s, generator=g, device=dev).bfloat16().requires_grad_(True)
               for s in shapes)
    w = torch.randn(shapes[0], generator=g, device=dev).bfloat16()
    res, peaks, secs = {}, {}, {}
    for impl in ("chunked", "dense"):
        for rep in range(2):  # the peak of the first, the seconds of the second
            base = peak_reset(torch)
            t0 = time.perf_counter()
            o = K.attention(q, k, v, impl=impl)
            grads = torch.autograd.grad((o.float() * w.float()).sum(), (q, k, v))
            torch.cuda.synchronize()
            secs[impl] = time.perf_counter() - t0
            if rep == 0:
                peaks[impl] = torch.cuda.max_memory_allocated() - base
            res[impl] = (o.detach(),) + grads
            del o, grads
    errs = {}
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        a, b = res["chunked"][i].float(), res["dense"][i].float()
        errs[name] = float((a - b).abs().max()) / float(b.abs().max())
    check(all(e <= TRAIN_ATTN_TOL for e in errs.values()),
          f"chunked vs dense at the real shape: {errs} > {TRAIN_ATTN_TOL}")
    check(peaks["chunked"] < peaks["dense"], f"chunked peak {peaks} not below dense")
    print(f"train attention q {shapes[0]} k/v {shapes[1]} bf16 causal: chunked vs dense "
          f"max|d|/max|ref| {errs} (bound {TRAIN_ATTN_TOL}); forward+backward peak bytes "
          f"chunked={peaks['chunked']} dense={peaks['dense']} "
          f"(ratio {peaks['chunked'] / peaks['dense']:.4f}); warm seconds chunked="
          f"{secs['chunked']:.4f} dense={secs['dense']:.4f}", flush=True)
    return peaks


def _mismatch(torch, a, b, tol, bound):
    """(elements outside ``tol``, elements, max |a - b|) of two tensor dicts;
    raises past ``bound``."""
    bad = total = 0
    worst = 0.0
    for k in a:
        x, y = a[k].float(), b[k].float()
        d = (x - y).abs()
        bad += int((d > tol["atol"] + tol["rtol"] * y.abs()).sum())
        total += x.numel()
        worst = max(worst, float(d.max()))
        check(worst <= bound, f"{k}: |d| {float(d.max())} > {bound}")
    return bad, total, worst


def train_phase(torch, seed: int, profile_dir: str = "", dev: str = "cuda"):
    """The LM training path (see the module doc, item 15): returns the
    figures and the kernels' launches over the phase's training runs."""
    from repro_torch.configs import get_config, get_model
    from repro_torch.data import CorpusConfig, batches
    from repro_torch.kernels import ops as K
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.dryrun import leaf_tensors, storage_bytes
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optim import global_norm
    from repro_torch.train.step import load_state_tree, state_tree

    torch.cuda.empty_cache()
    K.reset_launch_counts()
    launches = corpus_join_checks(torch, K, dev)
    peaks = chunked_attention_check(torch, K, seed, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg = get_config(TRAIN_ARCH)
    n_layers = len(cfg.blocks())
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def fresh(dtype_cfg=cfg, s=seed):
        g = torch.Generator(device=dev).manual_seed(s)
        return get_model(dtype_cfg, dev, generator=g)

    K.reset_launch_counts()
    model = fresh()
    n_params = sum(p.numel() for p in model.parameters())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batches(
        CorpusConfig(seed=seed), batch=TRAIN_BATCH, seq=TRAIN_SEQ, vocab=cfg.vocab,
        device=dev)).items()}
    print(f"train {cfg.name}: {n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads}, {n_params} params ({cfg.dtype}), AdamW f32 moments; "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ} = {tokens} tokens", flush=True)

    # step 0: the train path (chunked, remat) against dense (remat: dense
    # without it would keep every layer's scores, ~6 GB a layer) and
    # against chunked without remat
    model.requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    ref0 = {}
    for name, kw in (("dense", dict(remat=True, impl="dense")),
                     ("no_remat", dict(remat=False))):
        loss = model.loss(batch, **kw)
        grads = torch.autograd.grad(loss, params)
        ref0[name] = (loss.item(), global_norm(dict(enumerate(grads))).item())
        del loss, grads
    tcfg = TrainConfig(opt=OptConfig(lr=TRAIN_LR, warmup=1))
    opt = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    base = peak_reset(torch)
    # the step's arguments: what of ``base`` is the cell's (the dry run's witness)
    args = storage_bytes(list(model.parameters()) + leaf_tensors(opt) + leaf_tensors(batch))
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(opt, batch)
        loss = m["loss"].item()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if i == 0:
            gnorm0 = m["grad_norm"].item()
    peak_abs = torch.cuda.max_memory_allocated()
    peak = peak_abs - base
    dl, dn = abs(losses[0] - ref0["dense"][0]), abs(gnorm0 - ref0["dense"][1])
    warm = float(np.median(step_s[1:]))
    print(f"train step 0: loss={losses[0]:.6f} grad_norm={gnorm0:.6f}; dense (remat) "
          f"{ref0['dense'][0]:.6f} / {ref0['dense'][1]:.6f} (rel {dl / abs(ref0['dense'][0]):.3g} "
          f"/ {dn / ref0['dense'][1]:.3g}, bounds {TRAIN_LOSS_RTOL} / {TRAIN_GNORM_RTOL}); "
          f"chunked without remat {ref0['no_remat'][0]:.6f} / {ref0['no_remat'][1]:.6f}", flush=True)
    print(f"train {TRAIN_STEPS} steps on one batch (lr {TRAIN_LR}, warmup 1): losses "
          f"{[round(x, 4) for x in losses]}; step_s {[round(x, 4) for x in step_s]}; "
          f"warm step_s (median of {len(step_s) - 1}) {warm:.4f}, tokens_per_s "
          f"{tokens / warm:.1f}, peak bytes {peak}", flush=True)
    check(dl <= TRAIN_LOSS_RTOL * abs(ref0["dense"][0]) and dn <= TRAIN_GNORM_RTOL * ref0["dense"][1],
          f"step 0 chunked {losses[0]}, {gnorm0} vs dense {ref0['dense']}")
    check(abs(losses[0] - ref0["no_remat"][0]) <= 1e-6 * abs(losses[0]),
          f"step 0: remat changed the loss {ref0['no_remat']}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"train: loss did not fall {losses}")

    # checkpoint after step k, restore into a fresh model and optimizer
    t0 = time.perf_counter()
    path = ckpt.save(os.path.join(tmp, "resume"), TRAIN_STEPS, state_tree(model, opt),
                     extra={"next_step": TRAIN_STEPS})
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    other = fresh(s=seed + 1)
    ostate = init_train_state(other, tcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, extra = ckpt.restore(os.path.join(tmp, "resume"), state_tree(other, ostate))
    load_state_tree(other, ostate, restored)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del restored
    shutil.rmtree(os.path.join(tmp, "resume"))
    want = ckpt._flatten_with_names(state_tree(model, opt))
    got = ckpt._flatten_with_names(state_tree(other, ostate))
    check(set(got) == set(want) and extra == {"next_step": TRAIN_STEPS}, "restore: keys/extra")
    check(all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want),
          "restore: not bit-equal")
    m_a = step(opt, batch)
    m_b = make_train_step(other, tcfg)(ostate, batch)
    check(m_a["loss"].item() == m_b["loss"].item(),
          f"resumed loss {m_b['loss'].item()} != uninterrupted {m_a['loss'].item()}")
    pa = {k: p.detach() for k, p in model.named_parameters()}
    pb = {k: p.detach() for k, p in other.named_parameters()}
    bad, total, worst = _mismatch(torch, pb, pa, dict(atol=0.0, rtol=0.0), 2e-2 + 1e-3)
    check(bad <= TRAIN_FEW * total, f"resumed step: {bad} of {total} parameters differ")
    print(f"train checkpoint after step {TRAIN_STEPS}: bytes={nbytes} save_s={save_s:.4f} "
          f"load_s={load_s:.4f}; restored bit-equal ({len(want)} tensors); step "
          f"{TRAIN_STEPS + 1} loss resumed == uninterrupted: {m_b['loss'].item():.6f}; "
          f"parameters differing {bad} of {total} (max |d| {worst:.3g}; the embedding's "
          f"backward sums by atomics)", flush=True)
    del other, ostate, pb, got

    # with profile_dir, one profiled step: the device's busy share and top device work
    busy = profile_train(torch, step, opt, batch, profile_dir) if profile_dir else None
    del model, opt, step, pa, want, batch, m_a, m_b
    torch.cuda.empty_cache()

    # a 'cuda'-backend loss refuses the kernel (a child process, which
    # reaches the card while the accumulation check below runs: that
    # check prints no time)
    child = subprocess.Popen([sys.executable, "-c", CUDA_LOSS_CHILD.format(src=os.path.join(HERE, "src"))],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    try:
        # accum=2 against accum=1 on one batch, f32 at full width
        f32 = dataclasses.replace(cfg, dtype="float32")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batches(
            CorpusConfig(seed=seed + 1), batch=TRAIN_BATCH, seq=TRAIN_SEQ, vocab=cfg.vocab,
            device=dev)).items()}
        runs = []
        for accum in (1, 2):
            mdl = fresh(f32)
            t = TrainConfig(opt=OptConfig(lr=TRAIN_ACCUM_LR, warmup=1), accum=accum)
            st = init_train_state(mdl, t)
            m = make_train_step(mdl, t)(st, batch)
            runs.append((m["loss"].item(), {k: p.detach() for k, p in mdl.named_parameters()}))
            del mdl, st, m
        (l1, p1), (l2, p2) = runs
        check(abs(l1 - l2) <= 1e-5 * abs(l1), f"accum: loss {l1} vs {l2}")
        bad, total, worst = _mismatch(torch, p2, p1, dict(atol=2e-5, rtol=2e-4), 2 * TRAIN_ACCUM_LR + 2e-5)
        check(bad <= TRAIN_FEW * total, f"accum: {bad} of {total} parameters outside the tolerance")
        print(f"train accum=2 vs accum=1 (f32, lr {TRAIN_ACCUM_LR}): loss {l2:.7f} vs {l1:.7f}; "
              f"parameters outside atol 2e-5 / rtol 2e-4: {bad} of {total} (max |d| {worst:.3g})",
              flush=True)
        del runs, p1, p2, batch
        torch.cuda.empty_cache()
        c_out, c_err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    check(child.returncode == 0 and "refused" in c_out,
          f"child: a 'cuda'-backend loss did not refuse: {c_out} {c_err[-2000:]}")
    print(f"train child process: a 'cuda'-backend loss {c_out.strip()}", flush=True)

    # the launch/train.py loop on the pipeline's batches, with --ckpt
    run_dir = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    out = train_cli.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_CLI_STEPS), "--batch",
                          str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt", run_dir,
                          "--device", dev])
    cli_s = time.perf_counter() - t0
    check(len(out["losses"]) == TRAIN_CLI_STEPS and all(np.isfinite(out["losses"])),
          f"launch/train: losses {out['losses']}")
    check(ckpt.latest_step(run_dir) == TRAIN_CLI_STEPS, "launch/train: no final checkpoint")
    del out
    torch.cuda.empty_cache()
    counts = K.launch_counts()
    for k in GYM_KERNELS:
        launches[k] += counts[k]
    for k, v in K.semijoin_probe_path_counts().items():
        launches[f"semijoin_probe/{k}"] += v
    launches["flash_attention"] = counts["flash_attention"]
    check(counts["flash_attention"] == 0, f"training launched the flash kernel {counts}")
    print(f"train launch/train.py: {TRAIN_CLI_STEPS} steps with --ckpt in {cli_s:.2f} s; flash "
          f"launches while training: {counts['flash_attention']}", flush=True)

    # the trained checkpoint serves through launch/serve.py --ckpt
    K.reset_launch_counts()
    toks = serve_cli.main(["--arch", TRAIN_ARCH, "--ckpt", run_dir, "--device", dev,
                           "--batch", "2", "--prompt", "256", "--steps", "4"])
    serve_flash = K.launch_counts()["flash_attention"]
    check(tuple(toks.shape) == (2, 4) and serve_flash == n_layers,
          f"serve --ckpt: flash launched {serve_flash} times, not {n_layers}")
    print(f"train serve --ckpt: flash launches {serve_flash} (once per layer)", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    flops = 6 * n_params * tokens + 12 * n_layers * cfg.n_heads * cfg.hd * TRAIN_SEQ * tokens
    print(f"train model flops a step: {flops} (6 N T + 12 L H hd S T) = "
          f"{flops / warm / 1e12:.2f} TFLOP/s at the warm step, "
          f"{flops / warm / PEAK_FLOPS_BF16:.4f} of 989 TFLOP/s bf16", flush=True)
    summary = dict(warm_step_s=warm, tokens_per_s=tokens / warm, peak_bytes=peak,
                   ckpt_bytes=nbytes, save_s=save_s, load_s=load_s, busy=busy,
                   attn_peaks=peaks, losses=losses,
                   witness=dict(peak=peak_abs, held=base - args, warm_s=warm, tcfg=tcfg))
    return summary, launches


def profile_train(torch, step, opt, batch, out_dir: str):
    """``torch.profiler`` over one warm train step: the device's busy share
    and its top device work (the operator table goes to ``out_dir``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in dev_events:
        kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_s = sum(kern.values()) / 1e6
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile_train.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    print(f"profile train step (warm, profiled): wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
          f"device_busy_share={busy_s / wall:.4f} device_ops={len(dev_events)}", flush=True)
    for kname, us in sorted(kern.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {kname[:90]:90s} device_ms={us / 1e3:.3f}", flush=True)
    return busy_s / wall

# ----------------------------------------------------------------- dry run
# the dry run's witnesses (``launch/dryrun.py``): each run an earlier phase
# measured, as (name, phase, arch, shape, the overrides that make the cell
# that run); the train witness also takes the train phase's optimizer
DRYRUN_WITNESSES = (
    ("gemma2-9b prefill", "lm", LM_ARCH, "prefill_32k",
     dict(batch=LM_BATCH, seq=LM_PROMPT, s_cache=LM_PROMPT + LM_STEPS + 1)),
    ("whisper-small prefill_32k (b)", "whisper", WHISPER_ARCH, "prefill_32k",
     dict(batch=WHISPER_PREFILL_BATCH, s_cache=WHISPER_PREFILL_STEPS + 4)),
    ("whisper-small decode_32k (c)", "whisper", WHISPER_ARCH, "decode_32k",
     dict(batch=WHISPER_DECODE_BATCH)),
    ("zamba2-7b long_500k", "ssm", "zamba2-7b", "long_500k", {}),
    ("smollm-360m train", "train", TRAIN_ARCH, "train_4k", dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ)),
)
# measured peak (less what the script held that is not the cell's) over
# the dry run's reckoned peak
DRYRUN_PEAK_RATIO = (0.95, 1.05)
# gemma2-9b's prefill flops against the hand count (its layers' 2 N a
# token, the head at the last position only, flash's formula per layer)
DRYRUN_FLOP_RTOL = 1e-2


def flash_host_us(torch, FA, calls: int = 2000) -> float:
    """Host microseconds a call of the flash wrapper takes (checks, then
    the operator ``torch.ops.repro_torch.flash_attention``) at a tiny shape
    (16 queries against 64 keys, D = 64, bf16), so that the card keeps up
    with the launches."""
    q = torch.zeros((1, 1, 16, 64), dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16, device="cuda")
    for _ in range(50):
        FA.flash_attention(q, kv, kv, causal=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        FA.flash_attention(q, kv, kv, causal=False)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def gemma_prefill_hand_flops(cfg, n_params: int, b: int, s: int) -> int:
    """2 (N - d V) a token for the layers, 2 d V for each sequence's last
    logits, and the flash formula over every layer's call."""
    d, v = cfg.d_model, cfg.vocab
    attn = sum(4 * b * cfg.n_heads * cfg.hd * visible_pairs(s, s, True, cfg.window if k == "local" else 0)
               for k in cfg.blocks())
    return 2 * (n_params - d * v) * b * s + 2 * d * v * b + attn


def dryrun_phase(torch, witnesses):
    """The dry run held against the runs the card measured: each witness
    of ``DRYRUN_WITNESSES`` whose phase ran, reckoned on ``meta`` (no card
    work) with the overrides of its run (the train witness with the train
    phase's own ``TrainConfig``); its measured peak less what the script
    held that is not the cell's must lie within ``DRYRUN_PEAK_RATIO`` of
    the reckoned peak, its flops must reach its model flops (gemma2-9b's
    prefill, whose head runs at the last position only: the hand count
    within ``DRYRUN_FLOP_RTOL``), and in a prefill the flash operator's fake
    must run once per attention call.  Prints mfu (model flops over the
    measured warm seconds at the bf16 peak), bound_over_measured (the
    reckoned roofline bound over those seconds) and the flash wrapper's
    host us a call.  Returns the figures."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.roofline import HBM_BYTES

    print(f"dryrun: {torch.cuda.get_device_name(0)} total_memory="
          f"{torch.cuda.get_device_properties(0).total_memory} (HBM_BYTES in launch/roofline.py: "
          f"{HBM_BYTES})", flush=True)
    out = {}
    for name, phase, arch, shape, ov in DRYRUN_WITNESSES:
        w = witnesses.get(name)
        if w is None:
            print(f"dryrun witness {name}: skipped (the {phase} phase did not run)", flush=True)
            continue
        ov = dict(ov, tcfg=w["tcfg"]) if "tcfg" in w else ov
        rec = DR.run_cell(arch, shape, ov, max_batch=False)
        cfg = get_config(arch)
        reckoned = rec["memory"]["peak_bytes"]
        measured = w["peak"] - w["held"]
        ratio = measured / reckoned
        r = rec["roofline"]
        flops, mf = rec["cost"]["flops"], r["model_flops"]
        mfu = mf / (w["warm_s"] * PEAK_FLOPS_BF16)
        frac = r["bound_s"] / w["warm_s"]
        what = f"dryrun witness {name}"
        line = (f"{what}: batch {rec['batch']} seq {rec['seq']}; peak measured {measured} (the run's "
                f"{w['peak']} less {w['held']} held that is not the cell's) / reckoned {reckoned} = "
                f"{ratio:.4f} (bounds {DRYRUN_PEAK_RATIO}); arguments {rec['memory']['argument_bytes']}; "
                f"flops {flops:.6g} / model flops {mf:.6g} = {flops / mf:.4f}; bytes accessed "
                f"{rec['cost']['bytes accessed']:.6g}; compute_s {r['compute_s']:.6g} memory_s "
                f"{r['memory_s']:.6g} bound_s {r['bound_s']:.6g} ({r['dominant']}); warm s "
                f"{w['warm_s']:.6g}: mfu {mfu:.4g} bound_over_measured {frac:.4g}; flash fake calls "
                f"{rec['flash_calls']}; trace_s {rec['trace_s']:.2f}")
        if phase == "lm":
            hand = gemma_prefill_hand_flops(cfg, rec["n_params"], rec["batch"], rec["seq"])
            line += f"; hand count {hand} ({flops / hand:.6f})"
        print(line, flush=True)
        check(DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1],
              f"{what}: measured/reckoned peak {ratio:.4f} outside {DRYRUN_PEAK_RATIO}")
        if phase == "lm":
            check(abs(flops / hand - 1) <= DRYRUN_FLOP_RTOL, f"{what}: flops {flops} vs the hand count {hand}")
        else:
            check(flops >= mf, f"{what}: flops {flops} below the model flops {mf}")
        if rec["kind"] == "prefill":
            calls = cfg.enc_layers + cfg.n_layers if cfg.encdec else len(cfg.blocks())
            check(rec["flash_calls"] == calls,
                  f"{what}: the flash fake ran {rec['flash_calls']} times, not {calls}")
        out[name] = dict(ratio=ratio, measured=measured, reckoned=reckoned, mfu=mfu,
                         bound_over_measured=frac, flops=flops, model_flops=mf)
    us = flash_host_us(torch, FA)
    print(f"dryrun: flash at q (1, 1, 16, 64) against 64 keys, bf16: wrapper_host_us={us:.2f} "
          f"(the wrapper through torch.ops.repro_torch.flash_attention)", flush=True)
    out["wrapper_host_us"] = us
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--phases",
                    default="gym,grid,skew,logdepth,wire,snapshot,joinserve,mesh,lm,moe,ssm,whisper,train,"
                            "dryrun",
                    help="comma-separated main paths to drive: gym (the join path), "
                         "grid (the grid engine), skew (the hybrid engine beside hash "
                         "and grid on skewed data), logdepth (Log-GTA, Log-GTA', Shares), "
                         "wire (the packed wire and plan='auto'), snapshot (save/load "
                         "mid-query), joinserve (the multi-tenant join server), mesh (the "
                         "gym on a torch.distributed mesh, one process a reducer), lm "
                         "(gemma2-9b serving), moe (grok-1-314b serving on both MoE "
                         "routes, the MoE layer alone, reduced kimi-k2 training), ssm "
                         "(xlstm-125m and zamba2-7b serving, their long_500k decode), whisper "
                         "(whisper-small serving at 1500 frames, prefill_32k and decode_32k), "
                         "train (smollm-360m training on the GYM-assembled data pipeline), "
                         "dryrun (launch/dryrun.py held against the runs the earlier phases "
                         "measured)")
    ap.add_argument("--sizes", default="bench,real",
                    help="comma-separated gym, grid, skew, wire, snapshot, joinserve and mesh "
                         "sizes to drive: bench, real")
    ap.add_argument("--profile", default="",
                    help="comma-separated families (S_8,C_8,TC_9) to profile at real size, "
                         "lm to profile the LM serving path, moe the MoE serving path, "
                         "ssm the xlstm-125m and zamba2-7b serving paths, whisper the "
                         "whisper-small serving path, train a training step")
    ap.add_argument("--profile-out", default=os.path.join(HERE, "chiprun_out", "profile"))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import hash_partition as HP
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref
    from repro_torch.kernels import semijoin_probe as SP
    from repro_torch.kernels import sorted_probe as SO

    # full-f32 products on the card: no TF32 in matrix products or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = build.compile_library()
    build.load()
    print(f"build: {lib_path.name} from {len(build.sources())} sources, "
          f"nvcc_s={build.build_seconds:.2f} total_s={time.perf_counter() - t0:.2f}", flush=True)
    for line in build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()[:160]}")

    dev = torch.device("cuda")
    mma = sass_mma_count(lib_path)
    print(f"flash_attention SASS: {mma} tensor-core MMA instructions (HGMMA/HMMA; -1: no "
          f"cuobjdump)", flush=True)
    check(mma != 0, "the flash kernels' SASS holds no tensor-core MMA instruction")

    t0 = time.perf_counter()
    trap = start_bitmap_trap()
    try:
        n = kernel_edge_checks(torch, K, ref, dev)
        n += sorted_probe_edge_checks(torch, K, ref, dev)
        n_bitmap = bitmap_edge_checks(torch, K, ref, dev)
        print(f"kernel edge cases: {n + n_bitmap} checks ({n_bitmap} of the semijoin probe's "
              f"bitmap path), every gym CUDA kernel == its plain version", flush=True)
        n_wire = wire_edge_checks(torch, dev)
        print(f"wire codec edge cases: {n_wire} checks, wire_encode/wire_decode == their plain "
              f"versions and decode inverts encode (the golden fixture included)", flush=True)
        n, worst = flash_edge_checks(torch, dev)
        print(f"flash_attention edge cases: {n} checks within {FLASH_TOL} of the plain version "
              f"(worst |d|/max(1,|o|): {worst}), fully masked rows exactly 0", flush=True)
        print(f"semijoin_probe bitmap path, a key >= bound in a child process: trapped "
              f"({bitmap_trap_check(trap)}); edge phase {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        if trap.poll() is None:
            trap.kill()

    kernels = []
    by_path = {}
    summary = None
    witnesses = {}  # the dry run's, by DRYRUN_WITNESSES name
    if "gym" in phases:
        recorders = {
            "hash_partition": Recorder(torch, HP, "hash_partition"),
            "semijoin_probe": Recorder(torch, SP, "semijoin_probe"),
            "sorted_probe_ranges": Recorder(torch, SO, "sorted_probe_ranges"),
        }
        K.reset_launch_counts()
        try:
            summary, launches = main_path(torch, args.seed, tuple(args.sizes.split(",")))
        finally:
            for r in recorders.values():
                r.restore()
        print(f"main path launches (cuda gym runs): {launches}", flush=True)
        check(all(launches[k] > 0 for k in GYM_KERNELS), f"a kernel never launched: {launches}")
        sizes = set(args.sizes.split(","))
        if {"bench", "real"} <= sizes:
            # the dense path is unchanged: the counts from before the packed wire
            got = {
                "dispatches": {f: summary[f"{f}/real"]["dispatches"] for f in ("S_8", "C_8", "TC_9")},
                "padded": {f: summary[f"{f}/real"]["padded"] for f in ("S_8", "C_8", "TC_9")},
                "launches": {k: launches[k] for k in GYM_KERNELS},
            }
            check(got == DENSE_BASELINE, f"dense gym counts {got} != the baseline {DENSE_BASELINE}")
            print(f"dense baseline: dispatches, padded slots and launches equal those from "
                  f"before the packed wire {DENSE_BASELINE}", flush=True)
        check(launches["semijoin_probe/hash"] == 0
              and launches["semijoin_probe/bitmap"] == launches["semijoin_probe"],
              f"a main-path semijoin_probe launch took the hash path: {launches}")
        recorded = {k: (r.best, r.kw) for k, r in recorders.items()}
        kernels += kernel_timing(torch, K, ref, recorded, launches, args.reps)
        del recorders, recorded  # the recorded inputs: the later phases' peaks exclude them
        by_path["gym"] = launches
        fams = [f for f in args.profile.split(",") if f and f not in PROFILE_PATHS]
        if fams:
            profile_queries(torch, args.seed, fams, args.profile_out)
    wire_recorded = None
    wire_summary = None
    path_summary = {}  # the logdepth, snapshot and joinserve phases' runs, for the mesh phase
    for path in ("grid", "skew", "logdepth", "wire", "snapshot", "joinserve"):
        if path not in phases:
            continue
        t0 = time.perf_counter()
        audit = SemijoinAudit(SP, K)
        K.reset_launch_counts()
        try:
            if path == "grid":
                _, launches = main_path(torch, args.seed, tuple(args.sizes.split(",")),
                                        strategy="grid", audit=audit, hash_summary=summary,
                                        warm=False)
            elif path == "skew":
                _, launches = skew_phase(torch, args.seed, audit, summary,
                                         tuple(args.sizes.split(",")))
            elif path == "wire":
                wire_summary, launches, wire_recorded = wire_phase(
                    torch, args.seed, audit, summary, tuple(args.sizes.split(",")))
            elif path == "snapshot":
                path_summary[path], launches = snapshot_phase(torch, args.seed, audit, summary,
                                                              tuple(args.sizes.split(",")))
            elif path == "joinserve":
                path_summary[path], launches = joinserve_phase(torch, args.seed, audit, summary,
                                                               tuple(args.sizes.split(",")))
            else:
                path_summary[path], launches = logdepth_phase(torch, args.seed, audit)
        finally:
            audit.restore()
        print(f"{path} path launches (cuda runs): {launches}; phase {time.perf_counter() - t0:.1f} s",
              flush=True)
        want = GYM_KERNELS + (WIRE_KERNELS if path == "wire" else ())
        check(all(launches[k] > 0 for k in want), f"{path}: a kernel never launched: {launches}")
        by_path[path] = launches
    if "mesh" in phases:
        t0 = time.perf_counter()
        launches = mesh_phase(torch, args.seed, summary, wire_summary, tuple(args.sizes.split(",")),
                              path_summary.get("logdepth"), path_summary.get("snapshot"),
                              path_summary.get("joinserve"))
        print(f"mesh path launches (every rank's 'cuda' runs, both meshes): {launches}; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(all(launches[k] > 0 for k in GYM_KERNELS), f"mesh: a kernel never launched: {launches}")
        by_path["mesh"] = launches
    del wire_summary, path_summary
    if wire_recorded is not None:
        kernels += wire_timing(torch, wire_recorded, by_path["wire"], args.reps)
        del wire_recorded
    if "lm" in phases:
        lm, flash_call, per_generate = lm_phase(
            torch, args.seed, args.profile_out if "lm" in args.profile.split(",") else "")
        kernels.append(flash_timing(torch, flash_call, per_generate, args.reps))
        del flash_call
        witnesses["gemma2-9b prefill"] = lm["witness"]
    if "moe" in phases:
        t0 = time.perf_counter()
        _, launches, moe_call, per_generate = moe_phase(
            torch, args.seed, profile_dir=args.profile_out if "moe" in args.profile.split(",") else "")
        print(f"moe path launches ('cuda' generate runs): {launches}; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        moe_flash = flash_timing(torch, moe_call, per_generate, args.reps)
        del moe_call
        flash = [r for r in kernels if r["name"] == "flash_attention"]
        if flash:  # the lm phase's call is the record; grok's call rides beside it
            flash[0]["moe_call"] = {k: v for k, v in moe_flash.items()
                                    if k not in ("name", "route", "source", "replaces")}
        else:
            kernels.append(moe_flash)
        by_path["moe"] = launches
    if "ssm" in phases:
        t0 = time.perf_counter()
        ssm, launches, zamba_call, per_generate = ssm_phase(
            torch, args.seed, profile_dir=args.profile_out if "ssm" in args.profile.split(",") else "")
        print(f"ssm path launches ('cuda' generate and consistency runs): {launches}; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        zamba_flash = flash_timing(torch, zamba_call, per_generate, args.reps)
        del zamba_call
        flash = [r for r in kernels if r["name"] == "flash_attention"]
        if flash:  # the lm phase's call is the record; zamba2's call rides beside it
            flash[0]["zamba_call"] = {k: v for k, v in zamba_flash.items()
                                      if k not in ("name", "route", "source", "replaces")}
        else:
            kernels.append(zamba_flash)
        by_path["ssm"] = launches
        witnesses["zamba2-7b long_500k"] = ssm["zamba2-7b"]["long_500k"]["witness"]
    if "whisper" in phases:
        t0 = time.perf_counter()
        wsum, launches, calls, per_generate = whisper_phase(
            torch, args.seed, args.reps,
            profile_dir=args.profile_out if "whisper" in args.profile.split(",") else "")
        print(f"whisper path launches ('cuda' generate, full-forward and decode runs): {launches}; "
              f"phase {time.perf_counter() - t0:.1f} s", flush=True)
        rides = {f"whisper_{name}_call": {k: v for k, v in rec.items()
                                          if k not in ("name", "route", "source", "replaces")}
                 for name, rec in calls.items()}
        flash = [r for r in kernels if r["name"] == "flash_attention"]
        if not flash:  # without the lm phase the encoder call is the record
            kernels.append(calls["encoder"])
            del rides["whisper_encoder_call"]
            flash = kernels[-1:]
        flash[0].update(rides)
        by_path["whisper"] = launches
        witnesses["whisper-small prefill_32k (b)"] = wsum["b"]["witness"]
        witnesses["whisper-small decode_32k (c)"] = wsum["c"]["witness"]
    if "train" in phases:
        t0 = time.perf_counter()
        tsum, launches = train_phase(
            torch, args.seed, args.profile_out if "train" in args.profile.split(",") else "")
        print(f"train path launches (the corpus joins' 'cuda' runs and the training runs): "
              f"{launches}; phase {time.perf_counter() - t0:.1f} s", flush=True)
        check(all(launches[k] > 0 for k in GYM_KERNELS), f"train: a kernel never launched: {launches}")
        by_path["train"] = launches
        witnesses["smollm-360m train"] = tsum["witness"]
    if "dryrun" in phases:
        t0 = time.perf_counter()
        dryrun_phase(torch, witnesses)
        print(f"dryrun phase {time.perf_counter() - t0:.1f} s", flush=True)
    for rec in kernels:
        rec["launches_by_path"] = {p: n.get(rec["name"], 0) for p, n in by_path.items()}
    torch.cuda.synchronize()
    print(f"chip_smoke phases {sorted(phases)}: total_s={time.perf_counter() - t_start:.1f}",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
