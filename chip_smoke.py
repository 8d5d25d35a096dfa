#!/usr/bin/env python3
"""Smoke run of the PyTorch port (awm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths at the shapecap model's full width (64 channels,
16000-sample chunks) through the entry points a user calls, with the
hand-written CUDA LSTM kernels: the serving path (embed -> detect, 512-chunk
bucket; kernel A), the joint train step (B=128; kernels B and C under
LSTMFunction, A in validation), and the robust path (the train step under the
channel-attack curriculum, and the 12-attack robustness sweep of
eval.evaluate_robustness); then the strided family (main14b_2) at its
published width, whose two stacked LSTM(32) run the kernels' width-32
instantiations over 50 steps a chunk; and the entry points
(awm_tpu_torch/entry.py), whose dry run checks a sharded LSTM gradient at
width 16.  Phases:

1. print the card's name and power limit (nvidia-smi);
2. build ops/csrc/lstm_fwd.cu, lstm_fwd_cluster.cu and lstm_bwd.cu with
   nvcc for sm_90a, in parallel, and print ptxas's report;
3. hold every kernel instantiation against its plain PyTorch version: A at
   the serving shape (B=512) and an odd B, B and C at the training shape
   (B=128) and an odd B, T=16000 (the odd B the first rows of the other's
   inputs, its plain forward those rows of the other's), and at the dry
   run's step's (B=4, T=512), with the rows per block the launch plan
   picks, and C twice for equal bits; then every rows-per-block variant the
   plan can pick, at B=1, a ragged B=7, B=128 (and B=512 for A) and at T
   shorter and longer than the kernels' rings (T = 1, 2, 3, 37, 50);
   LSTMFunction's gradients against autograd of the plain forward; then
   every width-32 instantiation at every rows variant, B in (1, 7, 128) by
   T in (1, 2, 3, 15, 16, 17, 37, 50, 64, 65, 800), A at (512, 50) and
   B=300 at T=50; A and B on both of their paths (the short path,
   lstm_fwd_short_kernel, where T <= 64, with the ring path's bits; the
   ring at every T); C on both of its paths (fused, one launch, where its blocks
   fit one wave; four launches at T=800 and B=300), twice for equal bits;
   one call each of A, B, fused C and four-launch C at T=50 from fp32
   weights, by the profiler's kernel list: its kernels and no cast, fill or
   memset; and two stacked LSTMFunction layers' gradients at width 32;
   then every width-16 instantiation at every rows variant on both of its
   paths (A and B short, with the ring path's bits, and ring; C in one
   cooperative launch and in four; B, T in W16_SHAPES, T = 64 and 65, and
   the batch just past the fused grid that the card's occupancy reading
   gives, where the plan takes the four launches and a forced cooperative
   launch raises; C twice for equal bits), one call each at the dry run's
   shape by the profiler's kernel list, and LSTMFunction's gradients of the
   dry run's loss at width 16; then the masked instantiations of capacities
   32 and 16 (MASKED_SMALL: 24 x 24, 17 x 17, 20 x 32, 32 x 20, 12 x 12, 9 x
   3, T = 1, 17, 50, 64) on the short forward and the fused backward against
   their plain versions, the masked ring's bits and the zero-padded square
   call's (masked_small_checks), the batch just past the fused grid and a
   forced launch past the card's reading, one kernel a call;
4. the serving path, launch counters zeroed just before: fp32 session vs
   the JAX package's golden outputs, the bf16 session's watermark_array ->
   detect_array -> verify_array on an 8-s waveform, and its embed_detect on
   512 chunks;
4a. entry.entry() on the card, counters zeroed just before
   (entry_phase): its example arguments' shapes, four speech-like clips at
   the preset's bf16 and at fp32 compute against entry(device="cpu") on the
   same inputs, kernel A at width 64 launched;
4b. the widths (widths_phase, see NEW_WIDTHS): kernels A, B and C masked,
   on the cluster path and on the wide path past 256 against their plain
   versions, at the base family's main-path shapes too, and timed; every
   rows a group of the wide fp32 A and B; C's wide fp32 gate pass against
   kernel B's gates bit for bit (gates_checks); kernel C on the cluster path
   at D = H = 256, B = 512, T = 16000 in windows, against plain in row
   slices (cluster_scale_check); the base family at channels 48, 128 and
   512 (sessions, train steps) against the CPU, counters zeroed just
   before; the strided family at hidden_dim 24 (two LSTM(24): capacity 32
   masked, on the short forward and the fused backward) the same way,
   counters zeroed just before (strided_hidden_family);
5. the train path, counters zeroed just before: one fp32 train_step vs the
   JAX package's train golden (terms, gradient norms, BatchNorm
   statistics), then ``python -m awm_tpu_torch train`` in process (bf16,
   B=128, from the packaged weights, synthetic speech, 3 steps and one
   validation), an InferenceSession over the trained networks, and every
   kernel instantiation must have launched on one of the two paths;
6. the robust path, counters zeroed just before: the attack ops on the card
   against the same call on the CPU (biquad lowpass at 7 and 4 kHz and a
   high-Q set that takes the scan fallback, resample round trips at 8000 /
   11025 / 22050 Hz, G.711 mu-law and A-law and the int16 round trip
   exactly, and a gradient through a resample round trip and a biquad); one
   fp32 train step under the C_robust curriculum with the
   draws of assets/robust_train_golden.npz vs that JAX golden; ``python -m
   awm_tpu_torch train --augment ...`` in process with the C_robust leg's
   flags (bf16, B=128, 3 steps and one attacked validation);
   eval.evaluate_robustness of the fp32 session on the golden's 8 chunks vs
   the JAX table of assets/robust_golden.npz, and of the bf16 session over
   the default 12 attacks on 128 clips of the synthetic test split beside
   the reference's record evidence/r5/shapecap/demo_eval.json; evaluate_model
   on the same clips; kernels B and C must have launched in the robust steps
   and A in the sweeps;
7. checkpoints, counters zeroed just before each of phases 7-11: the
   packaged shapecap weights written as a checkpoint of the port; a session
   over that directory gives from_npz's embed_detect bit for bit on 512
   chunks; a TrainState with Adam moments saved on the card restores on the
   card and on the CPU, equal tensor for tensor;
8. the trainer: ``train --ckpt-dir D --epochs 1`` (bf16, synthetic speech
   with --music-frac 0.15, from that checkpoint directory), ckpt_latest
   restored equals the trained state, then ``--epochs 2`` resumes at epoch
   1 with step and learning rate continuing; the native WAV decoder is built
   and BatchLoader over a folder of WAVs gives the Python decode's batch bit
   for bit;
9. ``curriculum robust_decode --smoke``, all 8 legs at full width, one leg a
   call (peak memory printed per leg): ckpt_best and its sidecar in each,
   B_dilated keeps its dilated head at init, a re-run skips every leg, the
   final sidecar records bits / dilated / 3000;
10. the HTTP server in process on 127.0.0.1 over the shapecap checkpoint,
   fp32: concurrent clients' /embed, /detect and /verify of 8-s waveforms
   equal the unbatched session (one int16 LSB; 1e-5), fewer device batches
   than requests, a bad body gets a 400 and the server goes on;
11. the tools on the shapecap checkpoint, bf16: demo_eval (quality, ecc,
   music; n=1024) beside evidence/r5/shapecap/demo_eval.json, bit_diagnostic
   (n=256) beside evidence/r5/shapecap/per_bit.txt;
12. the strided family, counters zeroed just before (strided_phase): the
   fp32 session on seeded weights vs assets/strided_golden.npz, one fp32
   train step vs its JAX train golden, ``train --preset strided`` (bf16,
   B=128, 3 steps and one validation, --ckpt-dir), a session over that
   checkpoint round-trips an 8-s waveform, ``demo_eval --preset strided``
   (quality), and a main14b_2 .pth pair through ``detect --preset strided
   --torch-generator/--torch-detector`` on the card equal to the CPU; all six
   width-32 instantiations must have launched there;
13. multi-process training, counters zeroed just before (parallel_phase; the
   ranks report their own launch counts): ``torchrun --nproc-per-node 1 -m
   awm_tpu_torch train --data-parallel`` (NCCL; bf16, B=128, 3 steps and one
   validation, --ckpt-dir), whose ckpt_latest restores here equal to the
   trained state, and the bf16 step through a mesh of one beside the plain
   step; two ranks on the one card over gloo (NCCL refuses two ranks on one
   device): the shapecap fp32 step at B=128 on a data=2 mesh with its
   validation, and the base preset's fp32 step on a model=2 mesh with the
   message table sharded and gathered, each against one process on the same
   card, gradients included; three model=2 steps leave the ranks' replicated
   parameters bit-equal; kernels B and C launched on each rank and A in its
   validation; the bf16 step's clips/s with the collectives a step issues
   and their share of its time (the two launches start together; the 2-rank
   run times its steps once the 1-rank run has exited); ``prep metadata``,
   ``segment`` and ``classify`` on a folder of WAVs;
13a. the multi-device dry run, counters zeroed just before (dryrun_phase):
   entry.dryrun_multichip(4), four ranks over gloo on the one card, mesh
   (2, 2), the preset's bf16 step with the message table sharded and the
   sharded LSTM gradient at width 16 within 1e-4; every rank launched B and
   C at width 64 and at width 16 (one call each, which this card's plan
   sends to the short path and the fused backward's one cooperative
   launch); then the same dry run at fp32 on the card
   and on the CPU, rank 0's loss terms and gradients held together;
14. the bench, counters zeroed just before (bench_phase): ``python -m
   awm_tpu_torch bench`` in process (no other process of the port alive
   first), its one line with the seven keys of the repo-level bench.py, every
   number finite and positive, kernels A, B and C in bf16 at width 64
   launched; tools/bench_sweep.py in a subprocess (run through ``counted``,
   which reports its launches) with the JAX tool's defaults (infer 128-1024,
   train 64-512) and --trace-dir: a rate at each point before the first
   FAILED, which may only be (OutOfMemoryError), exit code 0, a trace
   written, A, B and C launched; the sweep of the strided preset at 512 /
   128 in process, its width-32 instantiations launched; demo_table on phase
   11's demo_eval report and bit_diagnostic line beside the reference's
   record;
15. the corpus drill (drill_phase): awm_tpu_torch/tools/corpus_drill.sh on
   the card in a subprocess (raw WAVs -> prep -> train --data, 2 epochs at
   B=32 -> demo_eval), each ``python -m`` command through ``counted``:
   DRILL_DONE, B and C launched by train and A by demo_eval, metadata.csv
   and selected.csv equal to evidence/drill/'s, the classification's first
   rows equal to its classification_head.csv; its demo_eval.json printed
   beside the record's;
16. time each kernel, its plain version and torch.nn.LSTM (cuDNN, the
   yardstick only), embed+detect clips/s at B=512, train-step clips/s at
   B=128 clean and under the curriculum, and the 12-attack sweep's wall time
   at n=128, per compute dtype, with the step's peak memory, a profile of
   one bf16 step's device time by kernel, and kernel C's time by launch
   (recurrence, dx, dW, sum; the fused kernel's one at width 32); the bf16 server under tools/serve_load.py's
   load (32 clients, 8-s requests): requests/s, audio s/s, clips/s beside
   the session's embed+detect clips/s, p50/p99 latency, chunks per device
   batch, with the host/device split of a request; the width-32 kernels at
   T=50 (A at B=512, B and C at B=128) beside their plain versions,
   nn.LSTM(32) and the least time of 50 dependent steps, and C's four
   launches at B=300; their device ms at T = 1, 2, 8, 16, 32, 50, 64 and
   the least-squares fit fixed + T x step (what a short call costs before
   its steps, and a step); the strided
   embed+detect clips/s at B=512 and train-step clips/s at B=128 per compute
   dtype, with peak memory and a profile of one bf16 step; the width-16
   kernels at the dry run's (B, T) = (4, 32) and at (128, 50) on both paths
   (the plan's short and fused, and the ring and four launches) beside their
   plain versions, nn.LSTM(16) and the bounds; 12 x 12 (capacity 16 masked)
   at the same shapes and 24 x 24 (capacity 32 masked) at the strided
   family's (A at B=512, B and C at B=128, T=50), on both paths alike;
   every T=50-scale row's device ms by the profiler and, beside it, by
   queued_ms (the calls queued behind a spin kernel between two events: no
   profiler, so a window the profiler returns empty is measured too);
16a. where the train step's peak memory goes (memory_phase): one bf16 step
   of the bench's base preset at B=256 under torch.cuda.memory's history
   with C++ stacks, the blocks live at its peak by the port's innermost
   frame (the forward's) or by autograd node and ATen frame (the
   backward's) and by part (before the step, saved by the forward, kernel
   B's c_{t-1}, kernel C's scratch, the backward's by kind: cuDNN's
   workspace, layout copies for cuDNN, convolution gradients, each node's
   gradients), the most of cuDNN's workspace and copies live at once in the
   backward, and the bytes autograd saves, BatchNorm's share of them; then
   the same preset's bf16 step at B=512 (its peak memory and time);
17. print the {"kernels": [...]} line (54 instantiations: widths 64, 48
   (capacity 48's squares, A, B and C), 32 and 16, A, B and C masked on
   capacity 64 at 56, on 32 at 24 and on 16 at 12, cluster 128, wide 512;
   the width-32
   forward ones with their path and every width-32 one with its fit; the
   width-16 and 12 x 12 ones at the dry run's shape, with their times at
   (128, 50)),
   one line with the card, the wall and every phase's seconds, and last the
   {"ok": true, ...} line.

Any failed check exits non-zero without the last line.  There is no CPU
fallback: without a card the script exits 1 at once.  Phases 13-15 start
this script with arguments (``cli-rank`` and ``parallel-rank`` under
torchrun, ``counted``: see rank_main); run with none, it needs one card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shlex
import subprocess
import sys
import tempfile
import threading
import time
from typing import NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B_SERVE, B_TRAIN, T, ODD_B = 512, 128, 16000, 3
# The strided family's two stacked LSTM(32) see T / (2 * 4 * 5 * 8) = 50 steps
# a 1-s chunk.  Its kernel checks: B in (1, 7, 128) by T in W32_T (the ring's
# 16-step chunk edges, the forward's short path up to its bound of 64 and
# one step past it), A at the serving batch, and B=300 at T=50, a training
# batch whose backward blocks do not fit one wave (150 blocks of two rows on
# 132 SMs), every rows variant.  Kernels A and B take the short path where T
# <= 64, and are checked there on the ring path too; kernel C takes its
# fused path (one launch) where T <= 64 and its blocks fit one wave
# (launch_plan): here B in (1, 7, 128) at T <= 64, at either rows variant;
# its four launches at T in (65, 800) and at B=300.
W32, T32, B_WAVES = 32, 50, 300
W32_T = (1, 2, 3, 15, 16, 17, 37, 50, 64, 65, 800)
W32_SHAPES = tuple((b, t) for b in (1, 7, B_TRAIN) for t in W32_T) + ((B_SERVE, T32), (B_WAVES, T32))
W32_FIT_T = (1, 2, 8, 16, 32, 50, 64)  # the T-sweep of the width-32 kernels' device ms
# Width 16, the gradient check of entry.dryrun_multichip (B=4 over the data
# axis, T=32): A and B on the short path and the ring, C in one cooperative
# launch and in four: B in (1, 2, 4, 7, 128) by T in (1, 17, 32, 50), the
# paths' bound T = 64 and one past it, every rows variant.  Its timed
# shapes: the dry run's and the strided family's training shape.
W16 = 16
W16_SHAPES = ((1, 1), (7, 1), (2, 32), (4, 32), (7, 17), (7, 50), (B_TRAIN, 50))
W16_EDGE = ((3, 64), (7, 64), (3, 65), (7, 65))  # the short and fused paths' bound of 64 steps and one past it
DRY_B, DRY_T = 4, 32
# Masked within capacities 32 and 16 (max(D, H) <= 32, not a capacity's
# square), which at T <= 64 take the short forward and the fused backward as
# the square calls do.  Phase 3 (masked_small_checks) holds every such
# instantiation at MASKED_SMALL x MASKED_SMALL_T, B = MASKED_SMALL_B (a
# ragged last block), rows 1, 2 and 4 (C: 1 and 2): against the plain
# versions; A and B with the masked ring's bits and the square call's on
# operands zero-padded to the capacity; C twice the same bits, at capacity
# 32 the padded square call's bits, at 16 its recurrence's db the masked four
# launches' (see masked_small_checks); the batch just past the fused grid
# (four launches) and a cooperative launch forced past the card's reading
# (raises); one call, one kernel.  Phase 16 times MASKED32 x MASKED32 at T32
# (A B_SERVE, B and C B_TRAIN) and MASKED16 x MASKED16 at (DRY_B, DRY_T) and
# (B_TRAIN, T32), each on both paths.  Phase 4b drives the strided family at
# hidden_dim STRIDED_HIDDEN (two LSTM(24, 24) over 50 steps a chunk:
# capacity 32 masked) through the session and the train step.
MASKED_SMALL = ((24, 24), (17, 17), (20, 32), (32, 20), (12, 12), (9, 3))
MASKED_SMALL_T = (1, 17, 50, 64)
MASKED_SMALL_B = 7
MASKED32, MASKED16 = 24, 12  # the kernel table's *_w32_masked and *_w16_masked rows
STRIDED_HIDDEN = 24
# The width-16 instantiations that no path of the port runs (the dry run's
# gradient check is fp32, through LSTMFunction: kernels B and C): phase 3
# holds them against their plain versions and phase 16 times them; the
# check that every kernel launched on a main path leaves them out (with the
# masked counters of capacities 64, 48 and 16: below).
OFF_PATH = ("lstm_fwd_f32_w16", "lstm_fwd_bf16_w16", "lstm_fwd_train_bf16_w16", "lstm_bwd_bf16_w16")
# The widths phase (4b, widths_phase): kernels A, B and C at the widths the
# kernels take masked or on capacity 48 (48 x 48, the base family at
# channels 48: capacity 48's square; 40 x 24: capacity 48 at runtime
# widths; 56 x 56: capacity 64 at runtime widths; C at the capacity-48
# widths at rows 1 and 2) and on the cluster path (96 x 96,
# 128 x 128, the base family at channels 128, and the ceiling 256 x 256)
# against their plain versions at B=3, T=512; at the shapes the base
# family's main path hands them (T=16000; A at the session's B=64, B and C
# at the train step's B=32); timed, and held against their plain versions,
# at T=16000 (A B=512, B and C B=128) at the base family's two new widths
# (C at the ceiling by cluster_scale_check), and A, B and C at MASKED64;
# then the base family at channels 48 and 128 through the
# session (64 chunks) and the train step (B=32), from
# checkpoint.seeded_flax_tree weights.  The masked
# instantiations of capacities 64 (49..63), 48 and 16 run on no main path
# (OFF_PATH); capacity 32's run on the strided family at hidden_dim
# STRIDED_HIDDEN (phase 4b).
# The wide path past 256 (lstm_wide.cu): A, B and C at WIDE_PATH_WIDTHS (one
# unit past the cluster path, the base family at channels 320 and 512, 1024,
# D != H both ways) against their plain versions at B=3, T=512; the unit
# tiles (fewer CTAs a row group, of more tiles each) at 512 x 512 with
# TILED_CTAS against the plan's bits, and at TILED_WIDTH, a row group of
# more CTAs than the card holds at once, against plain; past the widths
# whole-row staging capped (CEILING_CHECKS: fp32 C and bf16 A / B at 14592,
# bf16 C at 28672, D = 16, B = 2, T = 24) against plain, C twice the same
# bits; at 512 x 512 the chunked and whole-row staging (CHUNK_CHECKS) give
# the plan's bits; at 512 x 512 at
# every B in ROWS_CHECK_B by T in ROWS_CHECK_T (the plan's rows and one row
# a group: many row groups, in several launches); timed at T=16000 (A
# B=512, B and C B=128, the plain version in slices where the card's memory
# refuses the whole batch); the base family at channels 512 (WIDE_CHANNELS)
# through the session and the train step at B=WIDE_PATH_B.
WIDE_PATH_WIDTHS = ((257, 257), (320, 320), (512, 512), (1024, 1024), (300, 40), (40, 600))
NEW_WIDTHS = ((48, 48), (40, 24), (56, 56), (96, 96), (128, 128), (256, 256)) + WIDE_PATH_WIDTHS
NEW_B, NEW_T = 3, 512
BASE_CHANNELS = (48, 128)  # the base family's new widths: capacity 48, the cluster path
MASKED64 = 56  # a width of 49..63: capacity 64 at runtime widths (the kernel table's *_masked of A, B and C)
PADDED_CHECKS = ((48, 48), (40, 24))  # capacity 48 (A, B and C) against capacity 64's square on zero-padded operands
WIDE_CHANNELS = 512  # the base family on the wide path
TILED_CTAS = (7, 31)  # 512 x 512's 32 tiles on 7 CTAs (4 or 5 tiles each), on 31 (one CTA of two)
# 272 tiles a row group, past the CTAs an H100 holds at once of every wide
# recurrence (264 of bf16 A / B's, two an SM; 132 of the others)
TILED_WIDTH = 4352
# Past the widths whose whole staged row of h / da filled a CTA's shared
# memory before the chunks (an H100's 227 KB: fp32 C 14264, bf16 A / B
# 14512, bf16 C 28532): (dtype, H) at D = 16, B = 2, T = CEILING_T, all of
# A, B and C at each.
CEILING_CHECKS = (("f32", 14592), ("bf16", 14592), ("bf16", 28672))
CEILING_T = 24
# Staged chunks at 512 x 512 held to the plan's bits: 64 terms (A / B in
# chunks, where the plan stages h whole), 2048 (C's whole row of da, where
# the plan stages it in chunks).
CHUNK_CHECKS = (64, 2048)
# C's chunks of CHUNK_ROWS_CHUNKS terms held to the plan's chunk at B =
# CHUNK_ROWS_B by rows a group: 8 (the fp32 dh product's 4 x 4 tiles a
# thread) and 32 (its 8 x 8 tiles a warp, then 8; a whole row of da at 32
# rows fits no CTA in fp32).
CHUNK_ROWS, CHUNK_ROWS_B, CHUNK_ROWS_CHUNKS = (8, 32), 40, (16, 64)
WIDE_CHUNKS, WIDE_B = 64, 32  # the session's chunks, the train step's batch
# The train step's batch at channels 512: the base bf16 step at 64 channels
# peaked at 47.19 GiB at B=256 (0.18 GiB a clip, PERF.md section 5); eight
# times the conv widths make about 1.5 GiB a clip, twice that in fp32.
WIDE_PATH_B = 8
WIDE_HOLD_T, WIDE_HOLD_CHUNKS = 1600, 2  # the card-vs-CPU holds' clip length, session chunks
OFF_PATH += tuple(f"{k}_{sfx}_w16_masked" for k in ("lstm_fwd", "lstm_fwd_train", "lstm_bwd")
                  for sfx in ("f32", "bf16"))
OFF_PATH += tuple(f"{k}_{sfx}{w}_masked" for k in ("lstm_fwd", "lstm_fwd_train", "lstm_bwd")
                  for sfx in ("f32", "bf16") for w in ("_w48", ""))
# The base family at channels 48 and 128 on the card against the port's own
# CPU run of the same seeded weights.  Session (64 chunks on the card; its
# first WIDE_HOLD_CHUNKS chunks through the CPU session): per-chunk summaries,
# max abs, delta_rms relative.  fp32 (TF32 off): summation order only, and
# the random init keeps the LSTM contractive (test_generator_matches_flax
# holds the CPU at 1e-5); a vote fraction moves by 1/16000 a sign flip.
# bf16: both sides round at the same points, entry()'s bf16 card-vs-CPU
# bound (ENTRY_CARD_TOL: logits 2e-2) on means of 16000 samples.  Train step
# (B=32 at WIDE_HOLD_T samples on both devices, messages given): loss terms
# relative, and ||g - g_cpu|| / ||g_cpu|| of each gradient group, fp32 at
# the dry run's DRY_CARD_TOL; bf16 rounds activations, da and the recurrent
# h at every step, so aggregates only, at ten times the bf16 session's.
WIDE_SESSION_TOL = {"float32": {"wm_prob": 1e-4, "clean_prob": 1e-4, "msg_logit_mean": 1e-4,
                                "msg_vote_frac": 1e-3, "delta_rms": 1e-4},
                    "bfloat16": {"wm_prob": 2e-2, "clean_prob": 2e-2, "msg_logit_mean": 5e-2,
                                 "msg_vote_frac": 5e-2, "delta_rms": 2e-2}}
WIDE_TRAIN_TOL = {"float32": {"terms": 1e-4, "drift": 5e-3}, "bfloat16": {"terms": 5e-2, "drift": 2e-1}}
WIDE_GROUPS = {"gen.lstm": r"^gen\.lstm\d*\.", "gen, the rest": r"^gen\.(?!lstm\d*\.)", "det": r"^det\."}
# Kernels B and C at width 64 in the dry run's train step (entry.dryrun_multichip):
# each rank's 4 of the 2n = 8 clips (n = 4 ranks, data axis 2) at
# entry.AUDIO_LEN = 512 samples, held with the training shapes in phase 3.
DRY_STEP_SHAPE = (4, 512)
# (B, T) of the rows-per-block variant checks: one row, a ragged last block
# for 2 and 4 rows, the training batch; T below, at and beyond the depth of
# the kernels' rings (32 steps forward, 16 backward).
VARIANT_SHAPES = ((1, 1), (1, 2), (7, 3), (7, 37), (B_TRAIN, 50))
# LSTMFunction's gradients vs autograd of the plain forward, B=3 T=2000,
# relative to each gradient's max.  fp32: summation order.  bf16: autograd
# of the plain forward also rounds the recurrent gradient to bf16 at each
# step (the backward of its .to(bf16)), which the kernels do not.
FUNCTION_TOL = {"f32": 1e-4, "bf16": 5e-2}
# fp32 session vs the JAX package's fp32 golden (CPU).  The trained LSTM
# amplifies fp32 rounding-order differences over 16000 steps (two correct
# fp32 recurrences differ by up to ~1e-3 in h; measured on the CPU); the
# shaped delta sees ~3e-5 of that.
GOLDEN_TOL = {"embed_delta": 2e-4, "wm_prob": 1e-4, "clean_prob": 1e-4,
              "msg_logit_mean": 1e-3, "msg_vote_frac": 1e-3, "delta_rms": 1e-6}
# fp32 strided session (seeded weights, kernels A at width 32, convs with TF32
# off) vs the JAX package's fp32 golden on the CPU: the port's CPU session
# gives 7e-8 on every output (tests/test_torch_strided.py); the card's cuDNN
# convolutions sum in another order, so 1e-5 (1e-6 for the RMS).  A vote
# fraction counts signs of 16000 per-sample logits: one that sits at zero
# moves it by 1/16000.
STRIDED_GOLDEN_TOL = {"embed_delta": 1e-5, "wm_prob": 1e-5, "clean_prob": 1e-5,
                      "msg_logit_mean": 1e-5, "msg_vote_frac": 1e-3, "delta_rms": 1e-6}
# fp32 strided train step vs the JAX golden: terms relative (CPU 2e-7);
# gradient norms relative, the CPU test's 2e-3 (CPU 1.8e-4 at worst, a
# detector bias whose gradient sums cancelling terms; the card 3.2e-6 at
# worst, H100 80GB HBM3 at 700 W).
STRIDED_TRAIN_TOL = {"terms": 1e-4, "grad_norm": 2e-3}
# fp32 train step vs the JAX train golden (tests/test_torch_checkpoint.py
# states the CPU measurements): terms relative; BN statistics absolute +
# relative; gradient norms relative, because a 1e-7 relative change of the
# input moves the trained LSTM's gradient norms by 1.4% in the JAX package
# itself.  Conv biases fed to a train-mode BatchNorm (zero gradient
# analytically) are left out.
TRAIN_TOL = {"terms": 1e-4, "stats_abs": 1e-4, "stats_rel": 1e-3, "grad_norm": 5e-2}
BN_FED = re.compile(r"res\w*\.conv[12]\.bias$")
# The attack ops on the card vs the same call on the CPU, (16, 16000): fp32
# convolutions with TF32 off differ from the CPU's by summation order only
# (TF32 would show as ~1e-3); the scan fallback relative to its output's max
# (matrix powers with entries of order 30); the integer codecs and the int16
# round trip exactly.
OPS_TOL = {"fir": 1e-5, "scan_rel": 2e-4}
# The C_robust leg's curriculum (awm_tpu/__main__.py:352-354 through
# :258-267), the configuration of assets/robust_train_golden.npz.
ROBUST_AUGMENT = dict(noise_snr_db=(10.0, 40.0), volume_range=(0.3, 1.2),
                      lowpass_hz=(3500.0, 5000.0, 7000.0), quantize=True,
                      resample_hz=(8000, 11025, 22050), attack_prob=0.45)
ROBUST_FLAGS = ["--augment", "--attack-prob", "0.45", "--noise-snr", "10,40",
                "--lowpass-hz", "3500,5000,7000", "--resample-hz", "8000,11025,22050"]
STOCHASTIC_ATTACKS = ("noise_30db", "noise_20db")
QUANTISER_ATTACKS = ("quantize_int16", "mulaw_8bit", "alaw_8bit")
# fp32 sweep on the golden's 8 chunks vs the JAX package's (CPU): per clip the
# probabilities and time-mean bit logits (GOLDEN_TOL's reasons, through one
# more channel op).  Behind a quantiser a delta that differs by 1e-7 of its
# peak already lands a sample on the other side of a codec step (6% of the
# sample for the 8-bit laws), which moves a time-mean logit by 2e-3 (measured
# on the CPU; 6e-3 at 1e-5), so those three rows' logits are held at
# "mlm_quantised".  Per column of the table, a rate moves by 1/8 (2/8 on a
# half) if one probability sits within that of its threshold, AUC by 1/64 per
# swapped pair, bit accuracy by 1/128 per logit mean within rounding of zero.
ROBUST_TOL = {"p_wm": 1e-3, "p_clean": 1e-3, "mlm": 2e-3, "mlm_quantised": 2e-2,
              "wm_prob": 1e-3, "clean_prob": 1e-3, "calibrated_threshold": 1e-3,
              "detect_rate": 1 / 8, "false_positive_rate": 1 / 8, "auc": 1 / 64,
              "detect_rate_calibrated": 2 / 8, "fpr_calibrated": 2 / 8, "bit_accuracy": 2 / 128}
# bf16 sweep on 128 test-split clips beside the reference's record of the same
# clips (its bf16 session on a TPU): the columns that say whether the
# watermark survives each deterministic channel.
RECORD_TOL = {"detect_rate": 0.02, "false_positive_rate": 0.02, "auc": 0.02}
N_SWEEP = 128
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; bf16 tensor-core
# and fp32 (non-tensor) FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PALLAS = "awm_tpu/ops/pallas/lstm_kernel.py"
PALLAS_CALL = {"lstm_fwd": 157, "lstm_fwd_train": 342, "lstm_bwd": 391}  # line of each pl.pallas_call


class Kernel(NamedTuple):
    kernel: str  # lstm_kernel.KERNELS
    source: str
    replaces: str
    sfx: str  # operand type, "f32" or "bf16"
    width: int  # D; the masked and cluster rows: the base family's width they run at
    tol: float  # vs its plain version (lstm_kernel.KERNEL_TOL)
    hidden: int = 0  # H where it is not D


KERNELS: dict[str, Kernel] = {}  # by instantiation name, filled by kernel_table once torch is imported


def kernel_table(K) -> dict[str, Kernel]:
    """Every compiled instantiation, named by lstm_kernel.instantiation, at
    the first width of the list that runs it (capacities 64, 32 and 16 at
    runtime widths: MASKED64, MASKED32, MASKED16)."""
    import torch

    table = {}
    for w in (*K.WIDTHS, *BASE_CHANNELS, WIDE_CHANNELS, MASKED64, MASKED32, MASKED16):
        for kernel in K.KERNELS:
            for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                name = K.instantiation(kernel, dtype, w)
                table.setdefault(name, Kernel(kernel, f"awm_tpu_torch/ops/csrc/{K.source_of(name)}.cu",
                                              f"{PALLAS}:{PALLAS_CALL[kernel]}", sfx, w, K.KERNEL_TOL[kernel, sfx]))
    return table

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def speechlike(n_chunks: int, seed: int, chunk: int = T) -> np.ndarray:
    """(n_chunks, chunk) voiced-speech-like rows: 8 harmonics of a gliding
    f0 under a syllable envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(chunk, dtype=np.float64) / 16000.0
    f0 = rng.uniform(90.0, 260.0, (n_chunks, 1)) * (1.0 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0, axis=1) / 16000.0
    x = sum(rng.uniform(0.05, 0.3, (n_chunks, 1)) / k * np.sin(k * phase) for k in range(1, 9))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0, (n_chunks, 1)) * t)
    return (x * env + 0.01 * rng.standard_normal((n_chunks, chunk))).astype(np.float32)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def lstm_inputs(b: int, dtype, device, seed: int, t: int = T, w: int = 64, h: int | None = None):
    """Seeded x (b, t, w), torch-layout weights of LSTM(w, h) (h defaults
    to w) at the scale of torch's LSTM init, and an upstream gradient dy in
    x's dtype (as autograd hands it to the backward), made on the card."""
    import torch

    h = h or w
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(b, t, w, device=device, generator=g) * 0.5).to(dtype)
    bound = 1.0 / h**0.5  # 1/sqrt(H)
    ws = [(torch.rand(*s, device=device, generator=g) * 2 - 1) * bound
          for s in ((4 * h, w), (4 * h, h), (4 * h,))]
    dy = (torch.randn(b, t, h, device=device, generator=g) * 0.1).to(dtype)
    return x, ws[0], ws[1], 2 * ws[2], dy


def bound_ms(name: str, b: int, t: int = T, width: int | None = None) -> tuple[float, str]:
    """Least time for the call at the instantiation's widths D and H (or D
    = H = width where given: the cluster path's names cover 65-256): the
    larger of bytes / HBM rate and the matrix-product FLOPs / the peak rate
    of their type.  Each input read once, each output written once.
    Forward: x, y (+ the fp32 c_{t-1} stream for B) and the fp32 weights;
    FLOPs 2 * B * T * 4H * (D + H).  Backward: x, y, dy, the fp32 c_{t-1}
    and weights in, dx and the fp32 weight gradients out; FLOPs 2 * B * T * 4H * (2 (D + H) + D + H):
    the gate recompute, dh, dx and both dW products, three times the
    forward's."""
    sfx, d = KERNELS[name].sfx, width or KERNELS[name].width
    h = width or KERNELS[name].hidden or d
    elt = 2 if sfx == "bf16" else 4
    g = 4 * h
    weights = (g * (d + h) + g) * 4
    fwd_flops = 2.0 * b * t * g * (d + h)
    if name.startswith("lstm_bwd"):
        nbytes = b * t * (d * 2 * elt + h * (2 * elt + 4)) + 2 * weights
        flops = 3 * fwd_flops
    else:
        nbytes = b * t * (d + h) * elt + weights + (b * t * h * 4 if "train" in name else 0)
        flops = fwd_flops
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[sfx] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def latency_bound_ms(t: int, w: int, sm_clock_mhz: float) -> float:
    """Least time of t dependent recurrent steps: each step's gate sums wait
    on the last step's h, and a lane's part of one is W / 4 dependent FMAs
    (lstm_common.cuh's split) of 4 cycles each, at the card's SM clock.  A
    floor that leaves out the shuffles, activations and barrier of a step."""
    return t * (w / 4) * 4 / (sm_clock_mhz * 1e3)


def rel_err(a, ref) -> float:
    # in place: the one temporary of a's size is all the ceiling checks' 12 GiB dW_hh leave room for
    return float((a.float() - ref.float()).abs_().max() / (ref.float().abs().max() + 1e-12))


def cudnn_lstm(w_ih, w_hh, bias, dtype, device):
    """torch.nn.LSTM with the same function (b_ih = b, b_hh = 0): the
    library yardstick only; the port never calls it."""
    import torch

    w = w_hh.shape[1]
    m = torch.nn.LSTM(w, w, batch_first=True).to(device)
    with torch.no_grad():
        m.weight_ih_l0.copy_(w_ih)
        m.weight_hh_l0.copy_(w_hh)
        m.bias_ih_l0.copy_(bias)
        m.bias_hh_l0.zero_()
    m = m.to(dtype)
    m.flatten_parameters()
    return m


def yardstick(timed, what: str, batch: int | None = None):
    """A library call's time, or None where it does not run (it is the
    yardstick only; the port never calls it).  Given a batch, timed takes
    the rows of one call: where the card's memory refuses the whole batch,
    the time is n calls of ceil(batch / n) rows, n = 2, 4, ... (printed)."""
    import torch

    n = 1
    while True:
        rows = -(-batch // n) if batch else None
        try:
            ms = timed() if batch is None else n * timed(rows)
        except torch.OutOfMemoryError as e:
            print(f"{what} at {rows} rows did not run: {str(e).splitlines()[0]}", flush=True)
            torch.cuda.empty_cache()
            if not batch or rows == 1:
                return None
            n *= 2
            continue
        except RuntimeError as e:
            print(f"{what} did not run: {e}", flush=True)
            return None
        if n > 1:
            print(f"{what}: {n} calls of {rows} rows, {ms:.3f} ms in all", flush=True)
        return ms


def timed_call(fn):
    """fn's output and the time of that one call by CUDA events (ms)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def max_abs(a, ref) -> float:
    return float((a.float() - ref.float()).abs_().max())


def device_kernels(step) -> tuple[list[tuple[str, float, int]], float]:
    """([(kernel name, device ms, launches)] by time, wall ms) of one
    synchronised call (torch.profiler).  Only device kernels are listed: an
    operator's row repeats the device time of the kernels launched under it,
    and a kernel has no CPU time of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    events = sorted((e for e in prof.key_averages() if dev_us(e) > 0 and e.self_cpu_time_total == 0),
                    key=dev_us, reverse=True)
    return [(e.key, dev_us(e) / 1e3, e.count) for e in events], wall_ms


def profile_step(step, label: str) -> None:
    """Device time of one synchronised call by kernel: the top 12, the LSTM
    kernels, and the device's busy share of the call's wall time."""
    events, wall_ms = device_kernels(step)
    total = sum(ms for _, ms, _ in events)
    print(f"profile of one {label} train step: device kernels {total:.1f} ms of "
          f"{wall_ms:.1f} ms wall (busy {100 * total / wall_ms:.1f}%)")
    for i, (key, ms, count) in enumerate(events):
        if i < 12 or "lstm_" in key:  # the hand-written kernels wherever they rank
            print(f"  {ms:9.2f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{count:<5d} {key[:90]}", flush=True)


def kernel_means(call, reps: int) -> dict[str, float]:
    """Device ms of each kernel of one call (each launched once a call), the
    mean over the launches that a trace of reps calls holds: the profiler
    drops a kernel of a window now and then, most often its first, so a
    window's sum over reps would read low."""
    events, _ = device_kernels(lambda: [call() for _ in range(reps)])
    return {key: ms / count for key, ms, count in events}


def device_split(call, parts: dict[str, str], reps: int) -> dict[str, float | None]:
    """Device ms of one call by part (a kernel-name fragment each), from
    kernel_means over a trace of reps calls.  A trace that misses a part
    altogether is taken again, three times at most; a part still missing is
    None, "not measured", never 0."""
    for _ in range(3):
        means = kernel_means(call, reps)
        split = {part: sum(ms for key, ms in means.items() if frag in key) or None
                 for part, frag in parts.items()}
        if None not in split.values():
            break
    else:
        missing = [frag for part, frag in parts.items() if split[part] is None]
        print(f"device_split: {missing} in none of 3 traces of {reps} calls; the last held "
              f"{[(key[:60], round(ms, 5)) for key, ms in means.items()]}; {trace_events(call)}", flush=True)
    return split


def trace_events(call) -> str:
    """What one more trace of one call holds, by kind: its events, the CPU
    side's kernel launches, the device's kernels (a trace the profiler
    returns empty of device work shows which side is missing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum("Launch" in e.name for e in events)
    device = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in events)
    return f"one more trace: {len(events)} events, {launches} launch calls, {device} device kernels"


def queued_ms(call, reps: int = 50) -> float:
    """Device ms of one call with the host's time taken out, by CUDA events
    alone: a spin kernel (torch.cuda._sleep) holds the stream while the host
    queues reps calls between two events, so the card runs them back to back
    (the launch gaps between its kernels included).  The spin is doubled
    until the start event is still unreached once every call is queued.  No
    profiler: a window the profiler returns empty is measured all the same."""
    import torch

    call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin = 1 << 22
    while True:
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued or spin > 1 << 32:
            return start.elapsed_time(end) / reps
        spin *= 2


def lstm_device_ms(call, reps: int = 50) -> float | None:
    """Device ms of one forward call in its LSTM kernel alone, on either
    path (at T=50 a call's CUDA-event time is mostly the host's: the
    wrapper's checks, allocations and launch), or None where three traces
    missed it."""
    return device_split(call, {"fwd": "lstm_fwd_"}, reps)["fwd"]


def fwd_kernel_name(plan) -> str:
    """The forward kernel a call of this plan launches."""
    return "lstm_fwd_short_kernel" if plan.fwd_short else "lstm_fwd_kernel"


def path_of(plan) -> str:
    """The forward's path in a plan, as the result lines name it."""
    return "short" if plan.fwd_short else "cluster" if plan.cluster else "ring"


BWD_PARTS = {True: ("fused",), False: ("rec", "dx", "dw", "sum")}  # kernel C's launches by path


def backward_split(call, fused: bool, reps: int = 5) -> dict[str, float | None]:
    """Device ms of kernel C in one call by launch: the fused path's one
    kernel, or the four launches' (recurrence, dx, dW, sum), by
    device_split (at T=50 a trace of a few calls can lose them all: take
    50)."""
    return device_split(call, {part: f"lstm_bwd_{part}_" for part in BWD_PARTS[fused]}, reps)


def split_total(split: dict[str, float | None]) -> float | None:
    """A call's device ms from its split: None unless every part was seen."""
    return None if None in split.values() else sum(split.values())


def fmt_ms(ms: float | None, digits: int = 4) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def launched_alone(call, want: tuple[str, ...]) -> tuple[bool, list[str]]:
    """Whether one call runs exactly the kernels named by want (a name
    fragment each, in any order) and no other device work: no cast, no
    fill, no memset.  A trace the profiler has dropped a kernel from is
    taken again, three times at most.  Returns (held, the kernels seen)."""
    for _ in range(3):
        events, _ = device_kernels(call)
        seen = [key for key, _, count in events for _ in range(count)]
        if len(seen) >= len(want):
            break
    held = len(seen) == len(want) and sorted(
        next((i for i, w in enumerate(want) if w in key), -1) for key in seen) == list(range(len(want)))
    return held, seen


def train_cfg(compute_dtype: str):
    """The shapecap architecture and shaping, the base preset's losses with
    --dec-loss mean: the configuration of tests/torch_assets.py's golden."""
    from awm_tpu_torch.checkpoint import SHAPECAP_ARCH, configs_from_arch, read_arch
    from awm_tpu_torch.config import get_config

    model, shaping = configs_from_arch(read_arch(SHAPECAP_ARCH))
    cfg = get_config("base")
    return dataclasses.replace(
        cfg, model=model, shaping=shaping,
        loss=dataclasses.replace(cfg.loss, dec_loss_mode="mean"),
        train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype),
    )


def test_split_clips(n: int) -> np.ndarray:
    """The first n clips of the synthetic corpus's held-out test split, as
    tools/demo_eval.py takes them (24576 clips, 80/10/10, split seed 42)."""
    from awm_tpu_torch.data import SyntheticClips, split_indices

    ds = SyntheticClips(n=24576, audio_len=T)
    te_idx = split_indices(len(ds), (0.8, 0.1, 0.1), seed=42)[2][:n]
    return np.stack([ds[int(i)] for i in te_idx])


class RecordingSession:
    """A session that also keeps what detect_summary returned, call by call
    (evaluate_robustness returns the table only)."""

    def __init__(self, session):
        self._session = session
        self.summaries = []

    def __getattr__(self, name):
        return getattr(self._session, name)

    def detect_summary(self, chunks, lengths=None):
        out = self._session.detect_summary(chunks, lengths)
        self.summaries.append(out)
        return out


def check_train_golden(state, terms, tgold, dev, what: str) -> None:
    """One fp32 train step's terms, gradient norms and BatchNorm statistics
    against a JAX train golden, to TRAIN_TOL."""
    import torch

    worst = max(abs(float(v) - float(tgold[f"term/{k}"])) / abs(float(tgold[f"term/{k}"]))
                for k, v in terms.items())
    check(worst <= TRAIN_TOL["terms"], f"{what}: loss terms rel err {worst:.2e} "
                                       f"(tol {TRAIN_TOL['terms']:.0e})")
    grad_errs, stat_errs = {}, []
    for net in ("gen", "det"):
        module = getattr(state, net)
        for k, p in module.named_parameters():
            if not BN_FED.search(k):
                ref = float(tgold[f"grad_norm/{net}.{k}"])
                grad_errs[f"{net}.{k}"] = abs(float(p.grad.norm()) - ref) / ref
        for k, b in module.named_buffers():
            ref = torch.from_numpy(tgold[f"batch_stats/{net}.{k}"]).to(dev)
            stat_errs.append(float(((b - ref).abs() - TRAIN_TOL["stats_rel"] * ref.abs()).max()))
    gk = max(grad_errs, key=grad_errs.get)
    check(grad_errs[gk] <= TRAIN_TOL["grad_norm"],
          f"{what}: gradient norms rel err <= {grad_errs[gk]:.2e} "
          f"(worst {gk}; lstm.w_hh {grad_errs['gen.lstm.w_hh']:.2e}; tol {TRAIN_TOL['grad_norm']:.0e})")
    check(max(stat_errs) <= TRAIN_TOL["stats_abs"],
          f"{what}: BatchNorm statistics within {TRAIN_TOL['stats_abs']:.0e} + "
          f"{TRAIN_TOL['stats_rel']:.0e} relative (excess {max(stat_errs):.2e})")


def shapecap_state(cfg, dev):
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.checkpoint import SHAPECAP_NPZ, load_into

    state = tr.init_state(cfg, device=dev)
    load_into(state.gen, state.det, SHAPECAP_NPZ)
    return state


class Tee:
    """Writes to the real stdout and keeps a copy (what a CLI call printed)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def cli_printed(cli, argv):
    """(return value, printed text) of one in-process CLI call."""
    import contextlib

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = cli(argv)
    return out, tee.text()


def zero_counts(K) -> None:
    for name in K.launches:
        K.launches[name] = 0


def add_counts(K, launches, label: str) -> None:
    print(f"{label} launches: {K.launches}", flush=True)
    for name, n in K.launches.items():
        launches[name] += n


def states_equal(a, b) -> bool:
    """Two TrainStates' parameters, BN statistics and Adam state equal
    tensor for tensor (b may live on another device)."""
    import torch

    for net in ("gen", "det"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        if sorted(sa) != sorted(sb) or not all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa):
            return False
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return oa["param_groups"] == ob["param_groups"] and all(
        torch.equal(v.cpu(), ob["state"][i][k].cpu()) for i in oa["state"] for k, v in oa["state"][i].items())


def write_wav_folder(d: str) -> None:
    """16 kHz WAVs of the kinds a corpus holds: 16-bit mono of the clip's
    length, longer and shorter, 16-bit stereo, 24-bit and float32 mono."""
    import struct

    rng = np.random.default_rng(21)
    kinds = {"a16": (16000, 1, 16, 1), "b16_long": (21000, 1, 16, 1), "c16_short": (9000, 1, 16, 1),
             "d16_stereo": (17000, 2, 16, 1), "e24": (16000, 1, 24, 1), "f32": (12000, 1, 32, 3)}
    for name, (n, ch, bits, fmt) in kinds.items():
        x = np.clip(speechlike(1, seed=len(name), chunk=n)[0][:, None] * np.ones(ch)
                    + 0.01 * rng.standard_normal((n, ch)), -1, 1)
        if fmt == 3:
            data = x.astype("<f4").tobytes()
        elif bits == 16:
            data = np.round(x * 32767).astype("<i2").tobytes()
        else:
            v = np.round(x * 8388607).astype(np.int32).reshape(-1)
            data = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], 1).astype(np.uint8).tobytes()
        block = ch * bits // 8
        with open(os.path.join(d, f"{name}.wav"), "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
                    + struct.pack("<IHHIIHH", 16, fmt, ch, 16000, 16000 * block, block, bits)
                    + b"data" + struct.pack("<I", len(data)) + data)


def post(addr, path: str, body: bytes):
    import http.client

    c = http.client.HTTPConnection(*addr, timeout=600)
    c.request("POST", path, body=body, headers={"Content-Length": str(len(body))})
    r = c.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def pcm16(body: bytes) -> np.ndarray:
    import io
    import wave

    with wave.open(io.BytesIO(body)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def concurrently(fns) -> list:
    import threading

    out = [None] * len(fns)
    barrier = threading.Barrier(len(fns))

    def run(i):
        barrier.wait()
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out


def checkpoint_phase(K, launches, dev, work: str, served, audio_len=None) -> str:
    """Phase 7: the shapecap weights as a checkpoint of the port (returns its
    directory); a session over it vs from_npz on `served` (chunks, messages,
    from_npz's bf16 embed_detect); a TrainState with Adam moments saved on
    the card restored on the card and on the CPU."""
    import torch

    from awm_tpu_torch import api, checkpoint as ck, train as tr

    zero_counts(K)
    cfg16 = train_cfg("bfloat16")
    if audio_len:
        cfg16 = dataclasses.replace(cfg16, audio_len=audio_len)
    ckpt = os.path.join(work, "shapecap", "ckpt_best")
    t0 = time.time()
    state = shapecap_state(cfg16, dev)
    ck.save_checkpoint(ckpt, state, epoch=1, best_val=0.5, model_cfg=cfg16.model, shaping_cfg=cfg16.shaping)
    print(f"shapecap written as a checkpoint of the port: {time.time() - t0:.2f} s, "
          f"{sorted(os.listdir(ckpt))}", flush=True)
    check(ck.read_arch(ckpt) == ck.read_arch(ck.SHAPECAP_ARCH), "checkpoint sidecar equals the packaged awm_arch.json")
    chunks, msgs, want = served
    kw = {"chunk_len": audio_len} if audio_len else {}
    got = api.InferenceSession.from_checkpoint(ckpt, device=dev, **kw).embed_detect(chunks, msgs)
    check(all(np.array_equal(got[k], want[k]) for k in want),
          f"session from the checkpoint directory vs from_npz, bf16 embed_detect x{len(chunks)}: equal bits")
    batch8 = torch.from_numpy(speechlike(8, seed=13, chunk=cfg16.audio_len)).to(dev)
    for _ in range(2):  # Adam moments and a step count to carry
        tr.train_step(cfg16, state, batch8)
    saved = os.path.join(work, "state")
    ck.save_checkpoint(saved, state, epoch=4, best_val=0.25, model_cfg=cfg16.model)
    for where in (dev.type, "cpu"):
        other = tr.init_state(cfg16, seed=9, device=where)
        _, epoch, best_val = ck.restore_checkpoint(saved, other)
        on = {p.device.type for p in other.gen.parameters()} | {
            v.device.type for st in other.optimizer.state.values() for v in st.values() if v.dim()}
        check(states_equal(state, other) and (epoch, best_val, other.step) == (4, 0.25, 2) and on == {where},
              f"TrainState saved on the {dev.type} restores on the {where}: parameters, BN statistics and "
              f"Adam moments equal tensor for tensor, step {other.step}, epoch {epoch}")
    add_counts(K, launches, "checkpoint path")
    return ckpt


def trainer_phase(K, launches, cli, dev, work: str, ckpt: str, audio_len=None) -> None:
    """Phase 8: the train command with --ckpt-dir, its resume, and the native
    WAV decoder behind BatchLoader."""
    import torch

    from awm_tpu_torch import checkpoint as ck, train as tr
    from awm_tpu_torch.data import BatchLoader, OneSecClips
    from awm_tpu_torch.data import native as wav_native

    zero_counts(K)
    run_dir = os.path.join(work, "train")
    argv = ["train", "--device", dev.type, "--compute-dtype", "bfloat16", "--batch-size", "16",
            "--synthetic-n", "80", "--music-frac", "0.15", "--workers", "4", "--init-from", ckpt,
            "--message-encoding", "bits", "--decode-head", "dilated", "--delta-band-hz", "3000",
            "--shape-max-rms", "0.01", "--dec-loss", "mean", "--lr", "1e-4", "--ckpt-dir", run_dir]
    argv += ["--audio-len", str(audio_len)] if audio_len else []
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        plot = None
        print("matplotlib is absent here: --loss-plot is not run", flush=True)
    else:
        plot = os.path.join(run_dir, "loss.png")
        argv += ["--loss-plot", plot]
    t0 = time.time()
    first, _ = cli_printed(cli, argv + ["--epochs", "1"])
    first_s = time.time() - t0
    spe = first["state"].step
    cfg16 = dataclasses.replace(train_cfg("bfloat16"), audio_len=audio_len or T)
    restored = tr.init_state(cfg16, seed=3, device=dev)
    _, epoch, _ = ck.restore_checkpoint(ck.latest_path(run_dir), restored)
    check(epoch == 1 and restored.step == spe and states_equal(first["state"], restored),
          f"train --ckpt-dir: ckpt_latest (epoch {epoch}, step {restored.step}) restores equal to the "
          f"trained state tensor for tensor")
    lr = first["state"].optimizer.param_groups[0]["lr"]
    del first, restored
    t0 = time.time()
    second, printed = cli_printed(cli, argv + ["--epochs", "2"])
    adam_steps = {int(st["step"]) for st in second["state"].optimizer.state.values()}
    check("next epoch = 1" in printed and [r["epoch"] for r in second["history"]] == [1]
          and second["state"].step == 2 * spe and adam_steps == {2 * spe}
          and second["state"].optimizer.param_groups[0]["lr"] == lr,
          f"train --epochs 2 resumes at epoch 1: step {spe} -> {second['state'].step}, Adam steps "
          f"{adam_steps}, lr {lr}; {first_s:.1f} s and {time.time() - t0:.1f} s")
    check(all(ck.is_checkpoint(os.path.join(run_dir, d)) for d in ("ckpt_best", "ckpt_latest")),
          "train --ckpt-dir: ckpt_best and ckpt_latest written")
    if plot:
        check(os.path.getsize(plot) > 0, "matplotlib imports here: --loss-plot wrote its PNG")
    del second
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wav_dir = os.path.join(work, "wavs")
    os.makedirs(wav_dir)
    write_wav_folder(wav_dir)
    ds = OneSecClips(wav_dir)
    fast = BatchLoader(ds, len(ds), shuffle=False, drop_last=False, num_workers=4)
    slow = BatchLoader(ds, len(ds), shuffle=False, drop_last=False, num_workers=4, native=False)
    (a,), (b,) = list(fast), list(slow)
    check(wav_native.available() and fast.native_batches == 1 and np.array_equal(a, b),
          f"native WAV decoder built ({os.path.basename(wav_native.library_path())}) and used: "
          f"BatchLoader over {len(ds)} WAVs (16/24-bit, float, stereo) equals the Python decode bit for bit")
    add_counts(K, launches, "trainer path")


def curriculum_phase(K, launches, cli, work: str, device: str, audio_len=None) -> None:
    """Phase 9: curriculum robust_decode --smoke, one leg a call with its peak
    memory, then a re-run that skips every leg."""
    import torch

    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch.__main__ import _CURRICULA

    zero_counts(K)
    cur_dir = os.path.join(work, "curriculum")
    cur = ["curriculum", "robust_decode", "--out", cur_dir, "--smoke", "--synthetic-n", "40",
           "--batch-size", "8", "--workers", "4", "--device", device]
    cur += ["--audio-len", str(audio_len)] if audio_len else []
    legs = [name for name, *_ in _CURRICULA["robust_decode"]["legs"]]
    leg_text = {}
    for leg in legs:
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        _, leg_text[leg] = cli_printed(cli, cur + ["--stop-after", leg])
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
        print(f"curriculum leg {leg}: {time.time() - t0:.1f} s, peak memory {peak:.2f} GiB", flush=True)
        best = os.path.join(cur_dir, leg, "ckpt_best")
        check(ck.is_checkpoint(best) and ck.read_arch(best) is not None,
              f"curriculum leg {leg}: ckpt_best with its sidecar")
    kept = re.search(r"kept init for (\d+) leaves[^\n]*", leg_text["B_dilated"])
    check(kept is not None and kept.group(1) == "8" and "det.dec_dil1.weight" in kept.group(0)
          and "det.dec_out.bias" in kept.group(0),
          f"B_dilated keeps the dilated head's 8 leaves at init ({kept.group(0)[:100] if kept else None} ...)")
    out, printed = cli_printed(cli, cur)
    final = ck.read_arch(out["final_ckpt"])
    check(printed.count("already done, skipping") == len(legs)
          and out["final_ckpt"] == os.path.join(cur_dir, "H2_tighten", "ckpt_best"),
          f"curriculum re-run skips all {len(legs)} finished legs")
    check((final["message_encoding"], final["decode_head"], final["delta_band_hz"]) == ("bits", "dilated", 3000.0),
          f"final sidecar records {final['message_encoding']} / {final['decode_head']} / {final['delta_band_hz']}")
    add_counts(K, launches, "curriculum path")


def http_phase(K, launches, dev, ckpt: str, audio_len=None) -> None:
    """Phase 10: the fp32 server in process; concurrent clients against the
    unbatched session; a bad body."""
    import torch

    from awm_tpu_torch import api
    from awm_tpu_torch.serve import make_server
    from awm_tpu_torch.tools.serve_load import healthz
    from awm_tpu_torch.utils.audio_io import encode_wav_bytes

    zero_counts(K)
    kw = {"chunk_len": audio_len} if audio_len else {}
    sess = api.InferenceSession.from_checkpoint(ckpt, compute_dtype=torch.float32, device=dev, **kw)
    httpd, batched = make_server(sess, "127.0.0.1", 0, max_wait_ms=20.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = httpd.server_address
    try:
        waves = [speechlike(1, seed=40 + i, chunk=8 * sess.chunk_len)[0] for i in range(12)]
        bodies = [encode_wav_bytes(w, 16000) for w in waves]
        decoded = [pcm16(b).astype(np.float32) / 32768.0 for b in bodies]
        paths = [(f"/embed?message={500 + i}&seed={i}", "/detect", f"/verify?message={500 + i}")[i % 3]
                 for i in range(len(bodies))]
        before = healthz(*addr)
        t0 = time.time()
        results = concurrently([lambda p=p, b=b: post(addr, p, b) for p, b in zip(paths, bodies)])
        http_s = time.time() - t0
        after = healthz(*addr)
        worst = {"embed_lsb": 0, "detect": 0.0, "verify": 0.0}
        same = True
        for i, (status, headers, body) in enumerate(results):
            same &= status == 200
            if status != 200:
                print(f"request {paths[i]}: {status} {body[:200]}", flush=True)
                continue
            if i % 3 == 0:
                want = api.watermark_array(decoded[i], sess, message=500 + i, seed=i)
                same &= headers["X-Awm-Messages"] == ",".join(map(str, want["messages"]))
                worst["embed_lsb"] = max(worst["embed_lsb"], int(np.abs(
                    pcm16(body) - pcm16(encode_wav_bytes(want["watermarked_waveform"], 16000))).max()))
                continue
            got = json.loads(body)
            want = (api.detect_array(decoded[i], sess) if i % 3 == 1 else
                    api.verify_array(decoded[i], sess, 500 + i))
            key = "detect" if i % 3 == 1 else "verify"
            for k, v in want.items():
                if isinstance(v, float):
                    worst[key] = max(worst[key], abs(got[k] - v))
                elif isinstance(v, list) and v and isinstance(v[0], float):
                    worst[key] = max(worst[key], float(np.abs(np.asarray(got[k]) - v).max()))
                elif not isinstance(v, np.ndarray):
                    same &= got[k] == v
        reqs = after["batching"]["requests"] - before["batching"]["requests"]
        batches = after["batching"]["device_batches"] - before["batching"]["device_batches"]
        check(same and worst["embed_lsb"] <= 1 and worst["detect"] <= 1e-5 and worst["verify"] <= 1e-5,
              f"fp32 server, {len(bodies)} concurrent clients, 8-s WAVs to /embed, /detect, /verify in "
              f"{http_s:.2f} s: all 200, equal to the unbatched session (embed {worst['embed_lsb']} LSB, "
              f"detect {worst['detect']:.1e}, verify {worst['verify']:.1e}; tol 1 LSB, 1e-5)")
        check(batches < reqs, f"fp32 server: {batches} device batches for {reqs} requests")
        status, _, body = post(addr, "/detect", b"RIFF....WAVEjunk")
        check(status == 400 and healthz(*addr)["status"] == "ok",
              f"bad body: {status} {body[:60]!r}; the server goes on")
    finally:
        httpd.shutdown()
        httpd.server_close()
        batched.close()
    add_counts(K, launches, "HTTP serving path")


def tools_phase(K, launches, ckpt: str, device: str, work: str, audio_len=None) -> dict:
    """Phase 11: demo_eval and bit_diagnostic (bf16) beside the reference's
    records of the shapecap checkpoint.  Returns the paths of the two
    reports, written into work as demo_eval.json and per_bit.txt."""
    from awm_tpu_torch.tools import bit_diagnostic, demo_eval

    zero_counts(K)
    common = ["--ckpt", ckpt, "--device", device] + (["--audio-len", str(audio_len)] if audio_len else [])
    with open(os.path.join(REPO, "evidence", "r5", "shapecap", "demo_eval.json")) as f:
        record = json.load(f)["quality"]
    t0 = time.time()
    report = demo_eval.main(common + ["--n-eval", "1024", "--sections", "quality,ecc,music"])
    demo_s = time.time() - t0
    q = report["quality"]
    cols = ("detect_rate", "false_positive_rate", "roc_auc", "watermarked_prob", "clean_prob", "bit_accuracy",
            "delta_rms")
    print(json.dumps({"demo_eval_quality_vs_record": {k: [q[k], record[k]] for k in cols}
                      | {"stoi": [q["file_roundtrip"]["stoi"], record["file_roundtrip"]["stoi"]]}}), flush=True)
    check(all(q[k] == record[k] for k in cols[:3]),
          f"demo_eval n=1024 ({demo_s:.1f} s): detect_rate {q['detect_rate']}, false_positive_rate "
          f"{q['false_positive_rate']}, roc_auc {q['roc_auc']} equal to the record")
    diffs = {k: abs(q[k] - record[k]) for k in ("watermarked_prob", "clean_prob", "bit_accuracy")}
    check(max(diffs.values()) <= 0.02, f"demo_eval: watermarked_prob, clean_prob, bit_accuracy within 0.02 "
                                       f"of the record ({', '.join(f'{k} {v:.4f}' for k, v in diffs.items())})")
    rel = abs(q["delta_rms"] - 0.010833) / 0.010833
    check(rel <= 0.02, f"demo_eval: unshaped delta_rms {q['delta_rms']:.6f} within 2% of 0.010833 ({rel:.2%})")
    stoi = q["file_roundtrip"]["stoi"]
    check(abs(stoi - 0.9145) <= 0.01, f"demo_eval: STOI {stoi:.4f} within 0.01 of 0.9145")
    print(json.dumps({"demo_eval_ecc": report["ecc"], "demo_eval_music": report["music"]}), flush=True)
    with open(os.path.join(REPO, "evidence", "r5", "shapecap", "per_bit.txt")) as f:
        per_bit = json.loads(f.read().strip().splitlines()[-1])
    bd = bit_diagnostic.main(common + ["--n-eval", "256"])
    saved = {"json": os.path.join(work, "demo_eval.json"), "per_bit": os.path.join(work, "per_bit.txt")}
    with open(saved["json"], "w") as f:
        json.dump(report, f, indent=2)
    with open(saved["per_bit"], "w") as f:
        f.write(json.dumps(bd) + "\n")
    agg = float(np.mean(bd["ml_acc"]))
    bit_d = float(np.abs(np.subtract(bd["ml_acc"], per_bit["ml_acc"])).max())
    strength = float(np.mean(bd["mean_abs_logit"])) / float(np.mean(per_bit["mean_abs_logit"])) - 1
    check(abs(agg - 0.7559) <= 0.02 and bit_d <= 0.04 and abs(strength) <= 0.10,
          f"bit_diagnostic n=256 beside per_bit.txt: mean-logit accuracy {agg:.4f} (0.7559, tol 0.02), "
          f"worst bit {bit_d:.4f} (tol 0.04), mean |logit| {strength:+.1%} (tol 10%)")
    bd8 = bit_diagnostic.main(common + ["--n-eval", "256", "--attack", "resample_8k"])
    print(f"bit_diagnostic under resample_8k: mean-logit accuracy {np.mean(bd8['ml_acc']):.4f}", flush=True)
    add_counts(K, launches, "tools path")
    return saved


# The seven keys of the line the repo-level bench.py prints (bench.py:146-152),
# in its order; "metric" and "unit" are strings, the other five numbers.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "train_clips_per_sec_per_chip",
              "train_vs_baseline", "detect_only_clips_per_sec_per_chip")
SWEEP_TIMEOUT_S, DRILL_TIMEOUT_S = 420, 420
SWEEP_OOM = "FAILED (OutOfMemoryError)"


def sweep_rows(label: str, text: str, kind: str, batches: list) -> dict:
    """The rows a bench_sweep run printed for one kind ("infer" or "train"),
    {B: clips/s, or the FAILED text}, checked: the batch sizes in the order
    asked, a finite positive rate at each point before the first FAILED, a
    FAILED only for running out of memory and only as the sweep's last row,
    and every size swept when none failed."""
    rows = re.findall(rf"^{kind} B=\s*(\d+): (.+)$", text, re.M)
    out = {int(b): (r if r.startswith("FAILED") else float(r.split()[0])) for b, r in rows}
    failed = [b for b, r in out.items() if isinstance(r, str)]
    rates = [r for r in out.values() if not isinstance(r, str)]
    ok = (bool(rows) and [int(b) for b, _ in rows] == batches[:len(rows)]
          and all(np.isfinite(r) and r > 0 for r in rates)
          and all(out[b] == SWEEP_OOM for b in failed)
          and (failed == [int(rows[-1][0])] if failed else len(rows) == len(batches)))
    check(ok, f"bench_sweep {label} {kind}: {out}")
    return out


def counted(log: str, argv: list) -> None:
    """``counted LOG -m MODULE ARGS...``: run MODULE as ``python -m MODULE
    ARGS...`` runs it, then append one JSON line to LOG: its argv and the
    kernel launches this process made (none where it never loaded the
    kernels)."""
    import runpy

    if argv[:1] != ["-m"] or len(argv) < 2:
        raise SystemExit(f"chip_smoke counted: want -m MODULE ARGS..., got {argv}")
    sys.argv = argv[1:]
    try:
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    finally:
        kernels = sys.modules.get("awm_tpu_torch.ops.lstm_kernel")
        with open(log, "a") as f:
            f.write(json.dumps({"argv": argv[1:], "launches": dict(kernels.launches) if kernels else {}}) + "\n")


def counting_python(work: str, log: str) -> str:
    """A directory that holds a ``python`` which runs every ``python -m
    MODULE ...`` through ``counted`` into log, and any other call as this
    interpreter does: put first on a script's PATH, it counts the kernels
    that the script's commands launch."""
    d = os.path.join(work, "counting_bin")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "python")
    me, py = shlex.quote(os.path.abspath(__file__)), shlex.quote(sys.executable)
    with open(path, "w") as f:
        f.write(f'#!/bin/sh\nif [ "$1" = -m ]; then exec {py} {me} counted {shlex.quote(log)} "$@"; fi\n'
                f'exec {py} "$@"\n')
    os.chmod(path, 0o755)
    return d


def counted_launches(launches, log: str, expected: dict) -> list:
    """The records that the processes run through ``counted`` wrote to log,
    their launches added to launches.  expected maps the start of a
    command's argv ("awm_tpu_torch train") to the instantiations that its
    processes must have launched."""
    records = []
    if os.path.isfile(log):
        with open(log) as f:
            records = [json.loads(line) for line in f if line.strip()]
    for r in records:
        print(f"{' '.join(r['argv'][:2])} launches: {r['launches']}", flush=True)
        for name, n in r["launches"].items():
            launches[name] += n
    for what, names in expected.items():
        got = [r["launches"] for r in records if " ".join(r["argv"]).startswith(what)]
        for name in names:
            n = sum(c.get(name, 0) for c in got)
            check(n > 0, f"{name} launched {n} times by {what} ({len(got)} process(es))")
    return records


def sweep_argv(sizes: dict) -> list:
    return [f"--{kind}={','.join(map(str, sizes[kind]))}" for kind in ("infer", "train")]


def bench_phase(K, launches, cli, work: str, demo: dict) -> dict:
    """Phase 14: ``python -m awm_tpu_torch bench`` in process, counters
    zeroed just before: its one line with bench.py's seven keys, kernels A,
    B and C (bf16, width 64) launched.  tools/bench_sweep.py with the JAX
    tool's defaults and --trace-dir in a subprocess, so that running out of
    card memory leaves this process as it was, its launches read back
    through ``counted``: A, B and C (bf16, width 64) launched.  The strided
    preset's sweep at 512 / 128 in process, counters zeroed just before: its
    width-32 instantiations launched.  demo_table on phase 11's demo_eval
    report with its bit_diagnostic line, beside the reference's record."""
    import torch

    from awm_tpu_torch import bench
    from awm_tpu_torch.tools import bench_sweep, demo_table

    t_phase = time.time()
    busy = bench._busy_pids()
    check(not busy, f"bench: no other process of the port alive before the call, so the wait cannot "
                    f"fire (found {busy})")
    zero_counts(K)
    t0 = time.time()
    _, printed = cli_printed(cli, ["bench"])
    bench_s = time.time() - t0
    line = json.loads(printed.strip().splitlines()[-1])
    numbers = [line.get(k) for k in BENCH_KEYS if k not in ("metric", "unit")]
    check(tuple(line) == BENCH_KEYS and all(isinstance(v, (int, float)) and np.isfinite(v) and v > 0
                                            for v in numbers),
          f"bench ({bench_s:.1f} s): one JSON line with bench.py's seven keys, every number finite "
          f"and positive")
    w64 = [K.instantiation(kernel, torch.bfloat16, 64) for kernel in K.KERNELS]
    w32 = [K.instantiation(kernel, torch.bfloat16, W32) for kernel in K.KERNELS]
    for name in w64:
        check(K.launches[name] > 0, f"{name} launched {K.launches[name]} times by bench")
    add_counts(K, launches, "bench")
    torch.cuda.empty_cache()  # the sweep's process gets the memory this one cached

    sweeps = {}
    base = {"infer": [128, 256, 512, 1024], "train": [64, 128, 256, 512]}
    trace_dir, log = os.path.join(work, "sweep_trace"), os.path.join(work, "sweep_launches.jsonl")
    argv = ["-m", "awm_tpu_torch.tools.bench_sweep", "--trace-dir", trace_dir, *sweep_argv(base)]
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "counted", log, *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=SWEEP_TIMEOUT_S)
    seconds = time.time() - t0
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0, f"bench_sweep {' '.join(argv[2:])}: exit code {proc.returncode} "
                                f"({seconds:.1f} s)" + ("" if proc.returncode == 0 else ": " + proc.stderr[-3000:]))
    sweeps["base"] = {kind: sweep_rows("base", proc.stdout, kind, base[kind]) for kind in base}
    sweeps["base"]["seconds"] = seconds
    counted_launches(launches, log, {"awm_tpu_torch.tools.bench_sweep": w64})
    trace = os.path.join(trace_dir, "trace.json")
    size = os.path.getsize(trace) if os.path.isfile(trace) else 0
    check(size > 0, f"bench_sweep --trace-dir wrote {trace} ({size} bytes)")

    strided = {"infer": [512], "train": [128]}
    zero_counts(K)
    t0 = time.time()
    _, text = cli_printed(bench_sweep.main, ["--preset", "strided", *sweep_argv(strided)])
    sweeps["strided"] = {kind: sweep_rows("strided", text, kind, strided[kind]) for kind in strided}
    sweeps["strided"]["seconds"] = time.time() - t0
    for name in w32:
        check(K.launches[name] > 0, f"{name} launched {K.launches[name]} times by the strided sweep")
    add_counts(K, launches, "strided sweep")
    torch.cuda.empty_cache()

    record = os.path.join(REPO, "evidence", "r5", "shapecap", "demo_eval.json")
    _, table = cli_printed(demo_table.main, [demo["json"], "--per-bit", demo["per_bit"], "--vs", record])
    head = table.split("### Headline\n\n", 1)[-1].splitlines()[0]
    check(head.startswith("| Axis |") and head.count("|") == 4 and "Per-bit (n=256)" in table,
          "demo_table on phase 11's demo_eval report: the headline with two columns and the per-bit line")
    phase_s = time.time() - t_phase
    print(f"bench phase: {phase_s:.1f} s (bench {bench_s:.1f} s, sweeps "
          f"{', '.join(f'{k} {v['seconds']:.1f} s' for k, v in sweeps.items())})", flush=True)
    return {"bench": line, "bench_s": bench_s, "sweeps": sweeps, "phase_s": phase_s}


def drill_phase(K, launches, work: str) -> dict:
    """Phase 15: awm_tpu_torch/tools/corpus_drill.sh on the card in a
    subprocess, each of its ``python -m`` commands run through ``counted``:
    it prints DRILL_DONE; its train launched B and C and its demo_eval A
    (bf16, width 64); its metadata.csv and selected.csv equal
    evidence/drill/'s and its classification's first two rows equal
    classification_head.csv (features within 1e-6), with the record's
    directory /tmp/awm_corpus_drill in place of this run's; its
    demo_eval.json printed beside the record's, not held (the networks
    start from another RNG, and the JAX run trained on the CPU)."""
    import csv

    import torch

    d = os.path.join(work, "awm_corpus_drill")
    ref = os.path.join(REPO, "evidence", "drill")
    log = os.path.join(work, "drill_launches.jsonl")
    env = {**os.environ, "PATH": counting_python(work, log) + os.pathsep + os.environ.get("PATH", "")}
    t0 = time.time()
    proc = subprocess.run(["bash", os.path.join(REPO, "awm_tpu_torch", "tools", "corpus_drill.sh"), d, "cuda"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=DRILL_TIMEOUT_S)
    seconds = time.time() - t0
    print("\n".join(ln for ln in proc.stdout.splitlines()
                    if ln.startswith(("epoch", "selected", "wrote", "copied"))), flush=True)
    check(proc.returncode == 0 and "DRILL_DONE" in proc.stdout.splitlines(),
          f"corpus_drill.sh cuda: exit code {proc.returncode}, DRILL_DONE printed ({seconds:.1f} s)"
          + ("" if proc.returncode == 0 else ": " + proc.stderr[-3000:]))
    fwd, fwd_train, bwd = (K.instantiation(kernel, torch.bfloat16, 64) for kernel in K.KERNELS)
    counted_launches(launches, log, {"awm_tpu_torch train": [fwd_train, bwd],
                                     "awm_tpu_torch.tools.demo_eval": [fwd]})
    if proc.returncode:
        return {"seconds": seconds}

    def read(path):
        with open(path) as f:
            return f.read().replace(d, "/tmp/awm_corpus_drill")

    for name in ("metadata.csv", "selected.csv"):
        check(read(os.path.join(d, name)) == read(os.path.join(ref, name)),
              f"corpus drill: {name} equal to evidence/drill/{name}")
    got = list(csv.reader(read(os.path.join(d, "classified", "audio_classification_results.csv")).splitlines()))
    want = list(csv.reader(read(os.path.join(ref, "classification_head.csv")).splitlines()))

    def same(g, w):
        try:
            return abs(float(g) - float(w)) <= 1e-6 * max(1.0, abs(float(w)))
        except ValueError:
            return g == w

    check(got[0] == want[0]
          and all(len(g) == len(w) and all(map(same, g, w)) for g, w in zip(got[1:3], want[1:3])),
          "corpus drill: the classification's header and first two rows equal classification_head.csv "
          "(features within 1e-6)")
    with open(os.path.join(d, "demo_eval.json")) as f:
        ours = json.load(f)
    with open(os.path.join(ref, "demo_eval.json")) as f:
        theirs = json.load(f)
    q, rq = ours["quality"], theirs["quality"]
    print(json.dumps({"drill_demo_eval_vs_record": {
        k: [q[k], rq[k]] for k in rq if not isinstance(rq[k], dict)} | {
        "n_eval": [ours["n_eval"], theirs["n_eval"]], "best_val": [ours["best_val"], theirs["best_val"]]}}),
        flush=True)
    print(f"drill phase: {seconds:.1f} s", flush=True)
    return {"seconds": seconds, "best_val": ours["best_val"]}


def width32_checks(K, dev, max_err, max_rel) -> None:
    """Phase 3, width 32: every _w32 instantiation of A, B and C at every
    rows variant against its plain version on W32_SHAPES (C twice for equal
    bits); two stacked LSTMFunction layers' gradients against autograd of
    the plain forward.  Fills max_err / max_rel with the worst over the
    shapes."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        name, fname, bname = (K.instantiation(k, dtype, W32) for k in K.KERNELS)
        worst = {name: 0.0, fname: 0.0, bname: 0.0}
        rel, same, bits = 0.0, True, True
        paths = {True: set(), False: set()}  # (B, T) of the checks of C by path: fused, four launches
        fwd_paths = {True: set(), False: set()}  # (B, T) of the checks of A and B by path: short, ring
        for b, t in W32_SHAPES:
            x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=3000 + 10 * b + t, t=t, w=W32)
            with no_tf32():
                ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                for rows in (None, *K.FWD_ROWS):
                    ring = None
                    for short in (False, True) if t <= K.FWD_SHORT_MAX_STEPS else (False,):
                        fwd_paths[short].add((b, t))
                        y0 = K.forward_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
                        y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
                        worst[name] = max(worst[name], float((y0.float() - ref_y.float()).abs().max()))
                        worst[fname] = max(worst[fname], float((y.float() - ref_y.float()).abs().max()),
                                           float((cprev - ref_c).abs().max()))
                        same &= bool(torch.isfinite(y0).all()) and y0.shape == (b, t, W32)
                        same &= torch.equal(y0, y)
                        if ring is None:
                            ring = (y0, y, cprev)
                        else:  # the short path gives the ring path's bits
                            bits &= all(torch.equal(a, r) for a, r in zip((y0, y, cprev), ring))
                if b == B_SERVE:  # C's shapes are the training batch's
                    continue
                ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
                for rows in (None, *K.BWD_ROWS):
                    paths[K.launch_plan(b, t, dtype, sm_count, W32, rows).bwd_fused].add((b, t))
                    grads = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
                    again = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
                    same &= all(torch.equal(g, g2) for g, g2 in zip(grads, again))
                    rel = max(rel, *(rel_err(g, r) for g, r in zip(grads, ref_g)))
                    worst[bname] = max(worst[bname], *(float((g.float() - r.float()).abs().max())
                                                       for g, r in zip(grads, ref_g)))
        torch.cuda.synchronize()
        for n in (name, fname):
            check(worst[n] <= KERNELS[n].tol and same,
                  f"{n} vs plain, every rows variant, both paths, (B, T) in B (1, 7, {B_TRAIN}) x T {W32_T} "
                  f"and ({B_SERVE}, {T32}), ({B_WAVES}, {T32}): max abs err {worst[n]:.3e} "
                  f"(tol {KERNELS[n].tol:.0e})")
            max_err[n] = worst[n]
        check(bits and (B_SERVE, T32) in fwd_paths[True] and (B_TRAIN, T32) in fwd_paths[True]
              and (B_TRAIN, K.FWD_SHORT_MAX_STEPS + 1) in fwd_paths[False]
              and not any(t > K.FWD_SHORT_MAX_STEPS for _, t in fwd_paths[True]),
              f"{name} and {fname} checked on both paths: short (lstm_fwd_short_kernel) at "
              f"{len(fwd_paths[True])} (B, T) with T <= {K.FWD_SHORT_MAX_STEPS}, ring at {len(fwd_paths[False])}; "
              f"the short path gives the ring path's bits at every one: {bits}")
        tol = KERNELS[bname].tol
        check(rel <= tol and same, f"{bname} vs plain, every rows variant, the same (B, T) but B={B_SERVE}: "
                                   f"max rel err {rel:.3e} (tol {tol:.0e}), two runs the same bits: {same}")
        check((B_TRAIN, T32) in paths[True] and (B_WAVES, T32) in paths[False],
              f"{bname} checked on both paths: fused (one launch) at (B, T) {sorted(paths[True])}; four "
              f"launches at {sorted(paths[False])}")
        max_err[bname], max_rel[bname] = worst[bname], rel

        # one call, one kernel: no cast, fill or memset beside it (fp32 weights,
        # dy in x's type, as the bf16 train step hands them over)
        fwd_at = lambda b: (fwd_kernel_name(K.launch_plan(b, T32, dtype, sm_count, W32)),)
        for b, kernel, want in ((B_SERVE, "lstm_fwd", fwd_at(B_SERVE)),
                                (B_TRAIN, "lstm_fwd_train", fwd_at(B_TRAIN)),
                                (B_TRAIN, "lstm_bwd", ("lstm_bwd_fused_kernel",)),
                                (B_WAVES, "lstm_bwd", ("lstm_bwd_rec_", "lstm_bwd_dx_", "lstm_bwd_dw_",
                                                       "lstm_bwd_sum_"))):
            x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=4000 + b, t=T32, w=W32)
            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
            call = {"lstm_fwd": lambda: K.forward_kernel(x, w_ih, w_hh, bias),
                    "lstm_fwd_train": lambda: K.forward_train_kernel(x, w_ih, w_hh, bias),
                    "lstm_bwd": lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)}[kernel]
            held, seen = launched_alone(call, want)
            check(held, f"{K.instantiation(kernel, dtype, W32)} B={b} T={T32}, fp32 weights: one call "
                        f"launches {len(want)} kernel(s) and nothing else: {seen}")

        # two stacked layers, as the strided generator runs them
        x, *w0, _ = lstm_inputs(ODD_B, dtype, dev, seed=41, t=T32, w=W32)
        _, *w1, _ = lstm_inputs(1, dtype, dev, seed=42, t=1, w=W32)
        leaves = [x, *w0, *w1]
        a = [p.clone().requires_grad_() for p in leaves]
        c = [p.clone().requires_grad_() for p in leaves]
        with no_tf32():
            torch.sin(K.LSTMFunction.apply(K.LSTMFunction.apply(*a[:4]), *a[4:]).float()).sum().backward()
            torch.sin(lstm_forward(lstm_forward(*c[:4]), *c[4:]).float()).sum().backward()
        rels = [rel_err(p.grad, q.grad) for p, q in zip(a, c)]
        check(max(rels) <= FUNCTION_TOL[sfx] and all(p.grad.dtype == p.dtype for p in a),
              f"LSTMFunction {sfx} width 32, two stacked layers' grads vs autograd of the plain forward, "
              f"B={ODD_B} T={T32}: max rel err {max(rels):.2e} (x {rels[0]:.2e}; tol {FUNCTION_TOL[sfx]:.0e})")


def lstm_times(K, dtype, b: int, t: int, w: int, dev, clock_mhz: float, b_fwd: int | None = None) -> dict:
    """Phase 16 at one (B, T) and width D = H = w (capacity 32 or 16, square
    or masked): kernels A (at b_fwd rows where given), B and C a call (CUDA
    events over 200 calls) and on the device (torch.profiler, and queued_ms
    beside it), each also on
    the path the plan does not take (the ring beside the short forward, or
    the short beside the ring where the plan keeps a masked fp32 forward
    there; the four launches beside the fused backward), their plain versions,
    torch.nn.LSTM (cuDNN, the yardstick only), the bound and the least time
    of t dependent steps of the capacity's chain; each printed.  {name:
    row}."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    name, fname, bname = (K.instantiation(k, dtype, w) for k in K.KERNELS)
    b_fwd = b_fwd or b
    x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=60 + b + t, t=t, w=w)
    xa = lstm_inputs(b_fwd, dtype, dev, seed=61 + b_fwd + t, t=t, w=w)[0] if b_fwd != b else x
    timed = lambda fn: cuda_ms(fn, reps=200, warmup=20)
    with no_tf32():
        y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
        calls = {name: lambda: K.forward_kernel(xa, w_ih, w_hh, bias),
                 fname: lambda: K.forward_train_kernel(x, w_ih, w_hh, bias),
                 bname: lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)}
        plains = {name: lambda: lstm_forward(xa, w_ih, w_hh, bias),
                  fname: lambda: lstm_forward_train(x, w_ih, w_hh, bias),
                  bname: lambda: lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)}
        plan = K.device_plan(b, t, dtype, dev.index or 0, w)
        fused = plan.bwd_fused
        dev_ms = {name: lstm_device_ms(calls[name]), fname: lstm_device_ms(calls[fname]),
                  bname: split_total(backward_split(calls[bname], fused, reps=50))}
        # the other path of each (the ring or the short forward, the four launches) beside the plan's
        other = {}
        if t <= K.FWD_SHORT_MAX_STEPS:
            flip = not plan.fwd_short
            ring = {name: lambda: K.forward_kernel(xa, w_ih, w_hh, bias, short=flip),
                    fname: lambda: K.forward_train_kernel(x, w_ih, w_hh, bias, short=flip)}
            for n, fn in ring.items():
                other[n] = {"path": "short" if flip else "ring", "ms": timed(fn), "device_ms": lstm_device_ms(fn),
                            "queued_ms": queued_ms(fn)}
        if fused:
            four = lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, fused=False)
            other[bname] = {"path": "four launches", "ms": timed(four),
                            "device_ms": split_total(backward_split(four, False, reps=50)), "queued_ms": queued_ms(four)}
        m = cudnn_lstm(w_ih, w_hh, bias, dtype, dev)
        xg = x.clone().requires_grad_()
        with torch.inference_mode():
            lib = {name: yardstick(lambda: timed(lambda: m(xa)), f"nn.LSTM({w}) {dtype}")}
        lib[fname] = yardstick(lambda: timed(lambda: m(xg)), f"nn.LSTM({w}) {dtype} forward")
        ylib = m(xg)[0]
        lib[bname] = yardstick(lambda: timed(lambda: torch.autograd.grad(
            ylib, [xg, *m.parameters()], dy, retain_graph=True)), f"nn.LSTM({w}) {dtype} backward")
        rows = {}
        for n in (name, fname, bname):
            bn = b_fwd if n == name else b
            bms, by = bound_ms(n, bn, t)
            rows[n] = {"ms": timed(calls[n]), "plain_ms": cuda_ms(plains[n], reps=5), "bound_ms": bms,
                       "bound_by": by, "library_ms": lib[n], "device_ms": dev_ms[n], "queued_ms": queued_ms(calls[n]),
                       "latency_bound_ms": latency_bound_ms(t, K.capacity(w), clock_mhz)}
            if n in other:
                rows[n]["other_path"] = other[n]
            print(f"{n} B={bn} T={t}: kernel {rows[n]['ms']:.4f} ms a call ({fmt_ms(dev_ms[n])} of it on the "
                  f"device, {rows[n]['queued_ms']:.4f} ms queued), plain {rows[n]['plain_ms']:.2f} ms, cuDNN "
                  f"nn.LSTM({w}) {lib[n]} ms, bound {bms:.5f} ms ({by}), {t} dependent steps >= "
                  f"{rows[n]['latency_bound_ms']:.5f} ms at {clock_mhz:.0f} MHz"
                  + (f"; on the {other[n]['path']} path {other[n]['ms']:.4f} ms a call "
                     f"({fmt_ms(other[n]['device_ms'])} on the device, {other[n]['queued_ms']:.4f} ms queued)"
                     if n in other else ""),
                  flush=True)
    return rows


def fused_edge(K, dtype, t: int, dev, w: int = W16, h: int | None = None) -> int:
    """The least batch whose backward at widths (w, h) (default 16 x 16)
    and T = t the plan sends to the four launches on this card, the batch
    before it fused: just past the grid the plan counts on (at capacity 16
    the card's occupancy reading of the call's instantiation,
    lstm_kernel._fused_slots; at 32 one block an SM)."""
    for b in range(2, 1 << 16):
        if not K.device_plan(b, t, dtype, dev.index or 0, w, h).bwd_fused:
            if K.device_plan(b - 1, t, dtype, dev.index or 0, w, h).bwd_fused:
                return b
    raise RuntimeError(f"no batch past the fused grid at {w} x {h or w}, T={t}")


def width16_checks(K, dev, max_err, max_rel) -> None:
    """Phase 3, width 16: every _w16 instantiation of A, B and C at every
    rows variant against its plain version on both of its paths (A and B
    short where T <= FWD_SHORT_MAX_STEPS, with the ring path's bits, and the
    ring; C fused where T <= FUSED_MAX_STEPS and its grid is resident, and
    the four launches; C twice for equal bits on each) at W16_SHAPES, T = 64
    and 65 (W16_EDGE), and the batch just past the fused grid that the
    card's occupancy reading gives (fused_edge, T = T32): the plan takes the
    four launches there, and a cooperative launch forced on a grid the card
    does not hold raises; one call each of A, B and C at the dry run's shape
    by the profiler's kernel list (short and fused: one kernel each, no
    cast, fill or memset; C forced on the four launches: four);
    LSTMFunction's gradients of the dry run's loss sum(sin(lstm(x))) at
    (DRY_B, DRY_T) against autograd of the plain forward.  Fills max_err /
    max_rel."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    idx = dev.index or 0
    for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        name, fname, bname = (K.instantiation(k, dtype, W16) for k in K.KERNELS)
        worst = {name: 0.0, fname: 0.0, bname: 0.0}
        rel, same, bits = 0.0, True, True
        paths = {True: set(), False: set()}  # (B, T) of the checks of C by path: fused, four launches
        fwd_paths = {True: set(), False: set()}  # (B, T) of the checks of A and B by path: short, ring
        edge = fused_edge(K, dtype, T32, dev)
        reading = dict(zip(K.BWD_ROWS, K._fused_slots(idx, dtype, W16, T32)))
        edge_plan = K.device_plan(edge, T32, dtype, idx, W16)
        refused = []  # rows at which a cooperative launch forced at the edge batch raised
        for b, t in W16_SHAPES + W16_EDGE + ((edge, T32),):
            x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=5000 + 10 * b + t, t=t, w=W16)
            with no_tf32():
                ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                for rows in (None, *K.FWD_ROWS):
                    ring = None
                    for short in (False, True) if t <= K.FWD_SHORT_MAX_STEPS else (False,):
                        fwd_paths[short].add((b, t))
                        y0 = K.forward_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
                        y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
                        worst[name] = max(worst[name], float((y0.float() - ref_y.float()).abs().max()))
                        worst[fname] = max(worst[fname], float((y.float() - ref_y.float()).abs().max()),
                                           float((cprev - ref_c).abs().max()))
                        same &= bool(torch.isfinite(y0).all()) and y0.shape == (b, t, W16) and torch.equal(y0, y)
                        if ring is None:
                            ring = (y0, y, cprev)
                        else:  # the short path gives the ring path's bits
                            bits &= all(torch.equal(a, r) for a, r in zip((y0, y, cprev), ring))
                ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
                for rows in (None, *K.BWD_ROWS):
                    at = rows or K.device_plan(b, t, dtype, idx, W16).bwd_rows
                    for fused in (False, True) if t <= K.FUSED_MAX_STEPS else (False,):
                        if fused and -(-b // at) > reading[at]:  # not resident at once: the launch must raise
                            try:
                                K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=True)
                                torch.cuda.synchronize()
                            except RuntimeError:
                                refused.append(at)
                            continue
                        paths[fused].add((b, t))
                        grads = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=fused)
                        again = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=fused)
                        same &= all(torch.equal(g, g2) for g, g2 in zip(grads, again))
                        rel = max(rel, *(rel_err(g, r) for g, r in zip(grads, ref_g)))
                        worst[bname] = max(worst[bname], *(float((g.float() - r.float()).abs().max())
                                                           for g, r in zip(grads, ref_g)))
        torch.cuda.synchronize()
        shapes = f"(B, T) in {W16_SHAPES + W16_EDGE} and ({edge}, {T32})"
        for n in (name, fname):
            check(worst[n] <= KERNELS[n].tol and same,
                  f"{n} vs plain, every rows variant, both paths, {shapes}: max abs err {worst[n]:.3e} "
                  f"(tol {KERNELS[n].tol:.0e})")
            max_err[n] = worst[n]
        check(bits and (DRY_B, DRY_T) in fwd_paths[True] and (7, K.FWD_SHORT_MAX_STEPS + 1) in fwd_paths[False]
              and not any(t > K.FWD_SHORT_MAX_STEPS for _, t in fwd_paths[True]),
              f"{name} and {fname} checked on both paths: short (lstm_fwd_short_kernel) at "
              f"{len(fwd_paths[True])} (B, T) with T <= {K.FWD_SHORT_MAX_STEPS}, ring at {len(fwd_paths[False])}; "
              f"the short path gives the ring path's bits at every one: {bits}")
        tol = KERNELS[bname].tol
        check(rel <= tol and same, f"{bname} vs plain, both paths, every rows variant, {shapes}: max rel err "
                                   f"{rel:.3e} (tol {tol:.0e}), two runs the same bits: {same}")
        check((DRY_B, DRY_T) in paths[True] and (7, K.FUSED_MAX_STEPS + 1) in paths[False]
              and (edge, T32) in paths[False] and not edge_plan.bwd_fused
              and K.device_plan(edge - 1, T32, dtype, idx, W16).bwd_fused
              and len(refused) == sum(-(-edge // at) > reading[at] for at in (edge_plan.bwd_rows, *K.BWD_ROWS)),
              f"{bname} checked on both paths: fused (one cooperative launch) at {len(paths[True])} (B, T), four "
              f"launches at {len(paths[False])}; the card holds {reading} fused blocks at 1 / 2 rows (T={T32}): B="
              f"{edge - 1} fused, B={edge} four launches at {edge_plan.bwd_rows} row(s) a block, and a cooperative "
              f"launch forced on a grid past the reading raised at rows {refused}")
        max_err[bname], max_rel[bname] = worst[bname], rel

        # one call, its kernels alone: no cast, fill or memset beside them
        x, w_ih, w_hh, bias, dy = lstm_inputs(DRY_B, dtype, dev, seed=4100, t=DRY_T, w=W16)
        y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
        plan = K.device_plan(DRY_B, DRY_T, dtype, idx, W16)
        for label, call, want in (
                ("A", lambda: K.forward_kernel(x, w_ih, w_hh, bias), (fwd_kernel_name(plan),)),
                ("B", lambda: K.forward_train_kernel(x, w_ih, w_hh, bias), (fwd_kernel_name(plan),)),
                ("C", lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), ("lstm_bwd_fused_kernel",)),
                ("C, four launches", lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, fused=False),
                 ("lstm_bwd_rec_", "lstm_bwd_dx_", "lstm_bwd_dw_", "lstm_bwd_sum_"))):
            held, seen = launched_alone(call, want)
            check(held and plan.fwd_short and plan.bwd_fused,
                  f"width 16 {sfx} {label} B={DRY_B} T={DRY_T}, fp32 weights: one call launches {len(want)} "
                  f"kernel(s) and nothing else: {seen}")

        x, *w, _ = lstm_inputs(DRY_B, dtype, dev, seed=51, t=DRY_T, w=W16)
        a = [p.clone().requires_grad_() for p in (x, *w)]
        c = [p.clone().requires_grad_() for p in (x, *w)]
        with no_tf32():
            torch.sin(K.LSTMFunction.apply(*a).float()).sum().backward()
            torch.sin(lstm_forward(*c).float()).sum().backward()
        rels = [rel_err(p.grad, q.grad) for p, q in zip(a, c)]
        dx_err = float((a[0].grad.float() - c[0].grad.float()).abs().max())
        check(max(rels) <= FUNCTION_TOL[sfx] and all(p.grad.dtype == p.dtype for p in a)
              and (sfx == "bf16" or dx_err < 1e-4),
              f"LSTMFunction {sfx} width 16, the dry run's loss at B={DRY_B} T={DRY_T}, grads vs autograd of "
              f"the plain forward: max rel err {max(rels):.2e} (tol {FUNCTION_TOL[sfx]:.0e}), dx max abs "
              f"{dx_err:.2e}")


def masked_small_checks(K, dev, max_err, max_rel) -> None:
    """Phase 3, masked within capacities 32 and 16 (MASKED_SMALL): at every
    T of MASKED_SMALL_T, B = MASKED_SMALL_B, A and B on the short path at
    rows 1, 2 and 4 against plain, with the masked ring's bits and the bits
    of the square short call on operands zero-padded to the capacity (its
    padded outputs exactly 0); C on the fused path at rows 1 and 2 against
    plain, twice the same bits, the padded square call's padded outputs
    exactly 0; at capacity 32 the padded square fused call's bits in every
    output, at capacity 16 db the masked four launches' bits (the fused
    recurrence's da is theirs, and both sum the blocks in order).  At capacity
    16 the square fused kernel's own recurrence rounds a few gates in the last
    bit unlike its four-launch recurrence, so its padded call is no bit
    reference there (PERF.md section 6).  Then the batch just past the
    fused grid at T32 takes the four launches, against plain, and a
    cooperative launch forced one block past the card's reading of the
    masked instantiation raises; one call each of A, B and C at MASKED32 (B
    = B_TRAIN) and MASKED16 (the dry run's shape) runs one kernel and
    nothing beside it.  Fills max_err / max_rel."""
    import torch
    import torch.nn.functional as F

    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    idx, b = dev.index or 0, MASKED_SMALL_B
    for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        worst, rel = {}, {}
        held = dict.fromkeys(("paths", "ring", "padded", "zeros", "twice", "c_padded", "c_db"), True)
        for d, h in MASKED_SMALL:
            cap = K.capacity(d, h)
            name, fname, bname = (K.instantiation(k, dtype, d, h) for k in K.KERNELS)
            for t in MASKED_SMALL_T:
                x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=6000 + 100 * d + h + t, t=t, w=d, h=h)
                xp, wi, wh, bp = padded_to(x, w_ih, w_hh, bias, h, cap)
                plan = K.device_plan(b, t, dtype, idx, d, h)
                held["paths"] &= plan.bwd_fused and plan.fwd_short == (dtype in K.MASKED_SHORT_DTYPES)
                with no_tf32():
                    ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                    ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
                    for rows in K.FWD_ROWS:
                        y0 = K.forward_kernel(x, w_ih, w_hh, bias, rows=rows, short=True)
                        y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows, short=True)
                        ring = K.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows, short=False)
                        pad = K.forward_train_kernel(xp, wi, wh, bp, rows=rows, short=True)
                        worst[name] = max(worst.get(name, 0.0), max_abs(y0, ref_y))
                        worst[fname] = max(worst.get(fname, 0.0), max_abs(y, ref_y), max_abs(cprev, ref_c))
                        held["ring"] &= torch.equal(y0, y) and torch.equal(y, ring[0]) and torch.equal(cprev, ring[1])
                        held["padded"] &= torch.equal(y, pad[0][..., :h]) and torch.equal(cprev, pad[1][..., :h])
                        held["zeros"] &= h == cap or (float(pad[0][..., h:].float().abs().max()) == 0.0
                                                      and float(pad[1][..., h:].abs().max()) == 0.0)
                    ypad, cpad, dypad = (F.pad(v, (0, cap - h)) for v in (ref_y, ref_c, dy))
                    for rows in K.BWD_ROWS:
                        g = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=True)
                        again = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=True)
                        padg, zero = unpadded_grads(
                            K.backward_kernel(xp, ypad, cpad, dypad, wi, wh, bp, rows=rows, fused=True), d, h, cap)
                        held["twice"] &= all(torch.equal(a, a2) for a, a2 in zip(g, again))
                        held["zeros"] &= zero
                        if cap == 32:
                            held["c_padded"] &= all(torch.equal(a, p) for a, p in zip(g, padg))
                        else:
                            four = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=False)
                            held["c_db"] &= torch.equal(g[3], four[3])
                        rel[bname] = max(rel.get(bname, 0.0), *(rel_err(a, r) for a, r in zip(g, ref_g)))
                        worst[bname] = max(worst.get(bname, 0.0), *(max_abs(a, r) for a, r in zip(g, ref_g)))
        torch.cuda.synchronize()
        shapes = f"(D, H) in {MASKED_SMALL}, T in {MASKED_SMALL_T}, B={b}"
        for n in sorted(worst):
            tol = KERNELS[n].tol
            if n.startswith("lstm_bwd"):
                check(rel[n] <= tol and held["twice"],
                      f"{n} fused vs plain, rows 1 and 2, {shapes}: max rel err {rel[n]:.3e} (tol {tol:.0e}), "
                      f"two runs the same bits: {held['twice']}")
                max_err[n], max_rel[n] = worst[n], rel[n]
            else:
                check(worst[n] <= tol, f"{n} short vs plain, rows 1, 2, 4, {shapes}: max abs err {worst[n]:.3e} "
                                       f"(tol {tol:.0e})")
                max_err[n] = worst[n]
        check(all(held.values()), f"masked {sfx} at capacities 32 and 16, {shapes}: the plan's fused backward "
                                  f"and {'short' if dtype in K.MASKED_SHORT_DTYPES else 'ring'} forward "
                                  f"{held['paths']}; A and B short with the masked ring's bits {held['ring']} "
                                  f"and the zero-padded square call's {held['padded']}; every padded output 0 "
                                  f"{held['zeros']}; C at 32 the padded square fused call's bits {held['c_padded']}, "
                                  f"at 16 db the masked four launches' {held['c_db']}")

        # the batch just past the fused grid, and a cooperative launch forced past the card's reading
        for w in (MASKED32, MASKED16):
            cap, bname = K.capacity(w), K.instantiation("lstm_bwd", dtype, w)
            edge = fused_edge(K, dtype, T32, dev, w)
            x, w_ih, w_hh, bias, dy = lstm_inputs(edge, dtype, dev, seed=6500 + w, t=T32, w=w)
            with no_tf32():
                ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
                g = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
            edge_rel = max(rel_err(a, r) for a, r in zip(g, ref_g))
            reading = K._fused_slots(idx, dtype, cap, T32, True)
            x, w_ih, w_hh, bias, dy = lstm_inputs(reading[0] + 1, dtype, dev, seed=6501 + w, t=T32, w=w)
            refused = []
            with no_tf32():
                y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
                try:
                    K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=1, fused=True)
                    torch.cuda.synchronize()
                except RuntimeError:
                    refused.append(reading[0] + 1)
            plan = K.device_plan(edge, T32, dtype, idx, w)
            check(not plan.bwd_fused and K.device_plan(edge - 1, T32, dtype, idx, w).bwd_fused
                  and edge_rel <= KERNELS[bname].tol and refused == [reading[0] + 1],
                  f"{bname} at {w} x {w}, T={T32}: B={edge - 1} fused, B={edge} four launches at {plan.bwd_rows} "
                  f"row(s) a block (max rel err {edge_rel:.2e}); the card holds {reading} masked fused blocks at "
                  f"1 / 2 rows, and a cooperative launch forced at B={reading[0] + 1}, one row a block, raised: "
                  f"{refused}")

        # one call, one kernel (the plan's: the ring for fp32's forward, MASKED_SHORT_DTYPES)
        for w, bb, t in ((MASKED32, B_TRAIN, T32), (MASKED16, DRY_B, DRY_T)):
            x, w_ih, w_hh, bias, dy = lstm_inputs(bb, dtype, dev, seed=6600 + w, t=t, w=w)
            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
            fwd = (fwd_kernel_name(K.device_plan(bb, t, dtype, idx, w)),)
            for label, call, want in (
                    ("A", lambda: K.forward_kernel(x, w_ih, w_hh, bias), fwd),
                    ("B", lambda: K.forward_train_kernel(x, w_ih, w_hh, bias), fwd),
                    ("C", lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), ("lstm_bwd_fused_kernel",))):
                ok, seen = launched_alone(call, want)
                check(ok, f"masked {w} x {w} {sfx} {label} B={bb} T={t}, fp32 weights: one call launches "
                          f"1 kernel ({want[0]}) and nothing else: {seen}")


def seeded_nets(cfg, seed: int, dev=None):
    """The (generator, detector) of cfg with seeded_flax_tree's weights for
    `seed`, BatchNorm statistics included where the family has them."""
    from awm_tpu_torch.checkpoint import seeded_flax_tree, variables_from_flax
    from awm_tpu_torch.models import build_models

    tree = seeded_flax_tree(cfg.model, seed)
    nets = build_models(cfg.model)
    for name, net in zip(("gen", "det"), nets):
        net.load_state_dict(variables_from_flax({part: tree[part][name] for part in tree if name in tree[part]}),
                            strict=True)
    return tuple(net.to(dev) if dev is not None else net for net in nets)


def reference_pth(net, n_strides: int, path: str, seed: int) -> None:
    """Write a port strided network as the reference's main14b_2 .pth
    (ref: py/main14b_2.py:105-224 names: E, encoder_blocks.{i} with
    skip_conv, decoder_blocks / upsample_blocks alternating ConvTranspose and
    block, lstm.weight_ih_l{k}, ...), each LSTM bias split into a seeded
    bias_ih + bias_hh: the inverse of checkpoint.import_torch_strided_*."""
    import torch

    names = {"init_conv": "init_conv", "proj": "proj", "embedding": "E", "final_conv_enc": "final_conv_enc",
             "final_conv_dec": "final_conv_dec", "final_conv": "final_conv"}
    for i in range(n_strides):
        names.update({f"enc{i}": f"encoder_blocks.{i}", f"dec_up{i}": f"decoder_blocks.{2 * i}",
                      f"dec_res{i}": f"decoder_blocks.{2 * i + 1}", f"up{i}": f"upsample_blocks.{2 * i}",
                      f"up_res{i}": f"upsample_blocks.{2 * i + 1}"})
    g = torch.Generator().manual_seed(seed)
    out = {}
    for key, v in net.state_dict().items():
        v = v.detach().cpu().clone()
        head, *rest = key.split(".")
        if head.startswith("lstm"):
            k = head[4:]
            if rest == ["b"]:
                split = 0.1 * torch.randn(v.shape, generator=g)
                out[f"lstm.bias_ih_l{k}"], out[f"lstm.bias_hh_l{k}"] = v - split, split
            else:
                out[f"lstm.weight_{rest[0][2:]}_l{k}"] = v
            continue
        out[".".join([names[head], *("skip_conv" if r == "skip" else r for r in rest)])] = v
    torch.save(out, path)


def strided_phase(K, launches, cli, dev, work: str, audio_len=None) -> str:
    """Phase 12: the strided family at full width, counters zeroed just
    before: the fp32 session on seeded weights vs assets/strided_golden.npz;
    one fp32 train step vs its JAX train golden; ``train --preset strided``
    in process (bf16, B=128, 3 steps and one validation, --ckpt-dir); a
    session over that checkpoint round-trips an 8-s waveform; demo_eval
    --preset strided (quality); a main14b_2 .pth pair imported through
    ``detect --preset strided --torch-generator/--torch-detector`` on the
    card equals the same call on the CPU.  Returns ckpt_best's path."""
    import torch

    from awm_tpu_torch import api, checkpoint as ck, train as tr
    from awm_tpu_torch.config import get_config
    from awm_tpu_torch.tools import demo_eval
    from awm_tpu_torch.utils.audio_io import save_wav

    zero_counts(K)
    chunk = audio_len or T
    length = ["--audio-len", str(audio_len)] if audio_len else []
    cfg = get_config("strided")
    cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    with np.load(os.path.join(ck.ASSETS, "strided_golden.npz")) as g:
        sgold = {k: g[k] for k in g.files}
    seed = int(sgold["seed"])
    if audio_len is None:  # the goldens are 16000-sample chunks
        gen, det = seeded_nets(cfg, seed)
        sess32 = api.InferenceSession(gen, det, compute_dtype=torch.float32, shaping=cfg.shaping, device=dev)
        delta = sess32.embed_chunks(sgold["chunks"], sgold["messages"])
        summary = sess32.embed_detect(sgold["chunks"], sgold["messages"])
        errs = {"embed_delta": float(np.abs(delta - sgold["embed_delta"]).max())}
        errs.update({k: float(np.abs(summary[k] - sgold[k]).max()) for k in summary})
        for key, err in errs.items():
            check(err <= STRIDED_GOLDEN_TOL[key], f"fp32 strided session vs JAX strided golden, {key}: max abs "
                                                  f"err {err:.3e} (tol {STRIDED_GOLDEN_TOL[key]:.0e})")
        del sess32, gen, det
        state = tr.init_state(cfg32, device=dev)
        for name, net in zip(("gen", "det"), seeded_nets(cfg, seed, dev)):
            getattr(state, name).load_state_dict(net.state_dict())
        terms = tr.train_step(cfg32, state, torch.from_numpy(sgold["train/chunks"]).to(dev),
                              message=torch.from_numpy(sgold["train/messages"]).long().to(dev))
        worst = max(abs(float(v) - float(sgold[f"term/{k}"])) / abs(float(sgold[f"term/{k}"]))
                    for k, v in terms.items())
        grad_errs = {f"{n}.{k}": abs(float(p.grad.norm()) - float(sgold[f"grad_norm/{n}.{k}"]))
                     / float(sgold[f"grad_norm/{n}.{k}"])
                     for n in ("gen", "det") for k, p in getattr(state, n).named_parameters()}
        gk = max(grad_errs, key=grad_errs.get)
        check(worst <= STRIDED_TRAIN_TOL["terms"] and grad_errs[gk] <= STRIDED_TRAIN_TOL["grad_norm"]
              and len(grad_errs) == sum(k.startswith("grad_norm/") for k in sgold),
              f"fp32 strided train step vs JAX strided train golden: terms rel err {worst:.2e} (tol "
              f"{STRIDED_TRAIN_TOL['terms']:.0e}), {len(grad_errs)} gradient norms rel err <= "
              f"{grad_errs[gk]:.2e} (worst {gk}; lstm0.w_hh {grad_errs['gen.lstm0.w_hh']:.2e}; "
              f"tol {STRIDED_TRAIN_TOL['grad_norm']:.0e})")
        del state
        torch.cuda.empty_cache()

    run_dir = os.path.join(work, "strided")
    t0 = time.time()
    out = cli(["train", "--preset", "strided", "--device", dev.type, "--compute-dtype", "bfloat16",
               "--batch-size", str(B_TRAIN), "--synthetic-n", str(4 * B_TRAIN - B_TRAIN // 4), "--epochs", "1",
               "--workers", "4", "--ckpt-dir", run_dir] + length)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    row, best = out["history"][0], ck.best_path(run_dir)
    arch = ck.read_arch(best)
    print(f"train --preset strided bf16 B={B_TRAIN}: {out['state'].step} steps + validation in "
          f"{time.time() - t0:.1f} s; train {row['train_total']:.4f} val {row['val_total']:.4f}", flush=True)
    check(out["state"].step == 3 and all(np.isfinite(v) for k, v in row.items() if k != "epoch")
          and ck.is_checkpoint(best) and arch["family"] == "strided" and arch["strides"] == [2, 4, 5, 8],
          f"train --preset strided: {out['state'].step} steps, every term finite, ckpt_best with a strided "
          f"sidecar ({arch['family']}, strides {arch['strides']})")
    del out

    sess = api.InferenceSession.from_checkpoint(best, device=dev, chunk_len=chunk)
    wav = speechlike(8, seed=31, chunk=chunk).reshape(-1)
    wm = api.watermark_array(wav, sess, message=0x5A5A)
    det_wm = api.detect_array(wm["watermarked_waveform"], sess)
    ver = api.verify_array(wm["watermarked_waveform"], sess, 0x5A5A)
    print(f"strided session over ckpt_best, 8-s waveform: delta rms "
          f"{float(np.sqrt((wm['delta_waveform'] ** 2).mean())):.5f}, wm_prob {det_wm['mean_probability']:.4f}, "
          f"bit agreement {ver['bit_agreement']}/16, {ver['decision']}", flush=True)
    check(wm["watermarked_waveform"].shape == wav.shape and np.isfinite(wm["watermarked_waveform"]).all()
          and 0.0 <= det_wm["mean_probability"] <= 1.0 and 0 <= ver["bit_agreement"] <= 16,
          "strided session over ckpt_best: watermark_array -> detect_array -> verify_array on an 8-s "
          "waveform, finite, input shape")

    t0 = time.time()
    report = demo_eval.main(["--ckpt", best, "--preset", "strided", "--device", dev.type, "--n-eval", "256",
                             "--sections", "quality"] + length)
    q = report["quality"]
    print(json.dumps({"demo_eval_strided_quality": q}), flush=True)
    check(all(np.isfinite(v) for v in q.values() if isinstance(v, float))
          and 0.0 <= q["roc_auc"] <= 1.0 and 0.0 <= q["bit_accuracy"] <= 1.0,
          f"demo_eval --preset strided n=256 ({time.time() - t0:.1f} s): detect_rate {q['detect_rate']}, "
          f"roc_auc {q['roc_auc']:.4f}, bit_accuracy {q['bit_accuracy']:.4f}, all finite")

    gp, dp = os.path.join(work, "strided_gen.pth"), os.path.join(work, "strided_det.pth")
    gen, det = seeded_nets(cfg, seed + 1)
    reference_pth(gen, len(cfg.model.strides), gp, seed=5)
    reference_pth(det, len(cfg.model.strides), dp, seed=6)
    wav_path = os.path.join(work, "strided.wav")
    save_wav(wav_path, speechlike(2, seed=32, chunk=chunk).reshape(-1), 16000)
    got = {}
    for where in (dev.type, "cpu"):
        _, printed = cli_printed(cli, ["detect", wav_path, "--preset", "strided", "--torch-generator", gp,
                                       "--torch-detector", dp, "--device", where] + length)
        got[where] = json.loads(printed[printed.index("{"):])
    diff = abs(got[dev.type]["mean_probability"] - got["cpu"]["mean_probability"])
    check(diff <= 1e-5 and got[dev.type]["predicted_message"] == got["cpu"]["predicted_message"]
          and got[dev.type]["is_watermarked"] == got["cpu"]["is_watermarked"],
          f"detect --preset strided with a main14b_2 .pth pair, card vs CPU (fp32): probability "
          f"{got[dev.type]['mean_probability']:.6f} vs {got['cpu']['mean_probability']:.6f} (tol 1e-5), "
          f"messages {got[dev.type]['predicted_message']} / {got['cpu']['predicted_message']}")
    add_counts(K, launches, "strided path")
    for name in K.launches:
        if name in KERNELS and KERNELS[name].width == W32:
            check(K.launches[name] > 0, f"{name} launched {K.launches[name]} times on the strided path")
    return best


# The multi-process phase.  NCCL refuses two ranks on one card, so the
# one-card run of two ranks goes over gloo (all_reduce and broadcast of CUDA
# tensors, all this path issues); train --data-parallel itself runs one rank
# over NCCL.  The 2-rank fp32 steps are held against one process on the same
# card with test_fp32_train_step_matches_jax's tolerances: terms 1e-5
# relative, BatchNorm statistics 1e-5, and step_errors' rules for the
# gradients and the updated parameters.  Except: the gradients of the trained
# generator LSTM and of the encoder before it (UPSTREAM_OF_LSTM) follow a
# recurrence over T steps that amplifies rounding: at B=128, T=800 on the CPU
# the sharded step's order of summation moves them by up to 10% of their
# largest entry, and so does a 1e-6 relative change of the one process's
# input (by up to 21%).  Those are held, as a group, to move no more than the
# one process's own gradients move under that input change (step_drift),
# measured in the same run.
PARALLEL_B, PARALLEL_TABLE_B = B_TRAIN, 32  # data=2: 64 rows a rank; model=2: the base preset
PARALLEL_TOL = {"terms": 1e-5, "stats": 1e-5, "input_change": 1e-6}
TABLE_STEPS = 3  # model=2 steps after which the replicated parameters must still be bit-equal
UPSTREAM_OF_LSTM = re.compile(r"^gen\.(enc_|lstm\.)")


def step_drift(got: dict, want: dict, params) -> float:
    """||g - g_ref|| / ||g_ref|| over the named parameters' gradients taken
    together ("grad.<name>" of got and want)."""
    diff = sum(float((got[f"grad.{k}"].double() - want[f"grad.{k}"].double()).square().sum()) for k in params)
    return (diff / sum(float(want[f"grad.{k}"].double().square().sum()) for k in params)) ** 0.5


def step_errors(got: dict, want: dict, params, lr: float, drifting=()) -> dict:
    """One train step against a reference step from the same weights, batch
    and draws, by tests/test_torch_train.py::test_fp32_train_step_matches_jax's
    rules; got and want map a parameter's name to its value after the step
    and "grad.<name>" to its gradient; the parameters in `drifting` are
    held by the "step" rule alone (step_drift reads their gradients).  Each
    rule's worst reading over the parameters, as a share of its limit (the
    check passes below 1):
    "grad": |g - g_ref| over 5e-3 of the parameter's largest |g_ref|;
    "bn_fed_grad": a BatchNorm-fed conv bias's |g| (zero analytically) over
    1e-3 of the largest |g_ref| of all; "sure_step": the updated parameter's
    error over 1e-2 lr where |g_ref| is 100x the gradients' difference (inf
    where no entry is); "step": its error anywhere over 2 lr + 1e-7 (Adam's
    first step amplifies a gradient within rounding of zero to +-lr)."""
    gmax = max(float(want[f"grad.{k}"].abs().max()) for k in params)
    worst = dict.fromkeys(("grad", "bn_fed_grad", "sure_step", "step"), 0.0)
    for k in params:
        g, ref_g = got[f"grad.{k}"].double(), want[f"grad.{k}"].double()
        err = (got[k].double() - want[k].double()).abs()
        worst["step"] = max(worst["step"], float(err.max()) / (2 * lr + 1e-7))
        if k in drifting:
            continue
        if BN_FED.search(k):
            worst["bn_fed_grad"] = max(worst["bn_fed_grad"], float(g.abs().max()) / (1e-3 * gmax))
            continue
        diff = float((g - ref_g).abs().max())
        worst["grad"] = max(worst["grad"], diff / (5e-3 * float(ref_g.abs().max())))
        sure = ref_g.abs() > 100 * diff
        worst["sure_step"] = max(worst["sure_step"], float(err[sure].max()) / (1e-2 * lr)
                                 if bool(sure.any()) else float("inf"))
    return worst


def timed_all_reduce(seconds: list):
    """A stand-in for torch.distributed.all_reduce that adds each call's
    time, between two synchronisations of the card (so not the compute
    queued before it), to seconds[0]; the measurement swaps it in around the
    timed steps only."""
    import torch
    import torch.distributed as dist

    plain = dist.all_reduce

    def timed(t, *args, **kwargs):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = plain(t, *args, **kwargs)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        seconds[0] += time.perf_counter() - t0
        return out

    return timed


class Launch(NamedTuple):
    proc: subprocess.Popen
    t0: float
    what: str


def torchrun(nproc: int, argv: list) -> Launch:
    """Start this script under torchrun on this host (a free port), in its
    own session so that a timeout can take every rank with it."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", os.path.abspath(__file__)] + argv
    t0 = time.time()
    p = subprocess.Popen(cmd, cwd=REPO, start_new_session=True,
                         env=dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=REPO, SMOKE_LAUNCH=str(t0)))
    return Launch(p, t0, f"torchrun --nproc-per-node {nproc} {argv[0]}")


def joined(launch: Launch, timeout: int = 300) -> bool:
    """Wait for a launch (killing every rank at the timeout); checks that
    every rank exited 0."""
    import signal

    try:
        rc = launch.proc.wait(timeout=max(1.0, launch.t0 + timeout - time.time()))
    except subprocess.TimeoutExpired:
        os.killpg(launch.proc.pid, signal.SIGKILL)
        rc = launch.proc.wait()
    check(rc == 0, f"{launch.what}: exit {rc} in {time.time() - launch.t0:.1f} s")
    return rc == 0


def parallel_inputs(n: int, chunk: int, seed: int):
    return (speechlike(n, seed=seed, chunk=chunk),
            np.random.default_rng(seed).integers(0, 2**16, n).astype(np.int64))


def table_cfg(chunk: int):
    """The base preset (its 2^16 x 64 message table), fp32."""
    from awm_tpu_torch.config import get_config

    cfg = get_config("base")
    return dataclasses.replace(cfg, audio_len=chunk,
                               train=dataclasses.replace(cfg.train, compute_dtype="float32"))


def since_launch(marks: dict, what: str) -> None:
    """Seconds from the torchrun launch to this point of a rank."""
    marks[what] = round(time.time() - float(os.environ["SMOKE_LAUNCH"]), 2)


def cpu_state(state) -> dict:
    """{'gen.<name>': CPU tensor} of both networks' parameters and buffers."""
    return {f"{net}.{k}": v.detach().cpu() for net in ("gen", "det")
            for k, v in getattr(state, net).state_dict().items()}


def cpu_grads(grads: dict) -> dict:
    """{'grad.gen.<name>': CPU tensor} of parallel.full_grads' gradients (a
    copy: the next step rewrites them)."""
    return {f"grad.{k}": v.cpu().clone() for k, v in grads.items()}


def cli_rank(out: str, argv: list) -> None:
    """One rank of ``python -m awm_tpu_torch <argv>`` under torchrun: the
    command's own main(), then this rank's launch counts and the trained
    state (rank 0, the table gathered) written to out."""
    import torch

    from awm_tpu_torch.__main__ import main as cli
    from awm_tpu_torch.ops import lstm_kernel as K
    from awm_tpu_torch.parallel import full_state_dicts, shutdown

    marks = {}
    since_launch(marks, "torch imported")
    rank = int(os.environ["RANK"])
    res = cli(argv)
    since_launch(marks, "train command done")
    sds = full_state_dicts(res["state"])
    if rank == 0:
        torch.save({"state": {f"{net}.{k}": v.cpu() for net in ("gen", "det") for k, v in sds[net].items()},
                    "step": res["state"].step}, os.path.join(out, "trained.pt"))
    with open(os.path.join(out, f"cli.{rank}.json"), "w") as f:
        json.dump({"launches": K.launches, "history": res["history"], "marks": marks}, f)
    shutdown()


def parallel_rank(out: str, device: str, chunk: str, card_free: str) -> None:
    """One of two ranks over gloo on one device: the shapecap fp32 step at
    PARALLEL_B global rows on a data=2 mesh with its validation, the base
    preset's fp32 steps on a model=2 mesh (table sharded; the first step's
    state and gradients kept, then the replicated parameters after
    TABLE_STEPS), then, once the file card_free exists (no other process is
    using the card), the bf16 step timed, with the collectives it issues
    counted and timed."""
    import torch
    import torch.distributed as dist

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.ops import lstm_kernel as K
    from awm_tpu_torch.parallel import (collectives, full_grads, full_state_dicts, initialize_distributed,
                                        make_mesh, shard_batch, shard_state, shutdown)

    marks = {}
    since_launch(marks, "torch imported")
    dev, chunk = torch.device(device), int(chunk)
    if dev.type == "cuda":  # both ranks on the one card
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    initialize_distributed(device=dev, backend="gloo")
    rank = dist.get_rank()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    zero_counts(K)
    mesh = make_mesh()
    since_launch(marks, "group and mesh")
    cfg32 = dataclasses.replace(train_cfg("float32"), audio_len=chunk)
    s, msgs = parallel_inputs(PARALLEL_B, chunk, seed=11)
    rows = torch.from_numpy(shard_batch(s, mesh)).to(dev)
    state = shard_state(shapecap_state(cfg32, dev), mesh)
    # validation first: after Adam's first step the two runs' networks differ by
    # up to 2 lr wherever a gradient is rounding noise
    val = tr.eval_step(cfg32, state, rows, generator=torch.Generator().manual_seed(7))
    terms = tr.train_step(cfg32, state, rows, message=torch.from_numpy(msgs).to(dev))
    torch.save({"terms": {k: float(v) for k, v in terms.items()}, "val": {k: float(v) for k, v in val.items()},
                "state": {**cpu_state(state), **cpu_grads(full_grads(state))}},
               os.path.join(out, f"data2.{rank}.pt"))
    del state
    cfgb = table_cfg(chunk)
    sb, mb = parallel_inputs(PARALLEL_TABLE_B, chunk, seed=13)
    mesh2 = make_mesh(model_parallel=2)
    stb = shard_state(tr.init_state(cfgb, seed=5, device=dev), mesh2)
    local_rows = stb.gen.embedding.weight.shape[0]
    sb, mb = torch.from_numpy(sb).to(dev), torch.from_numpy(mb).to(dev)
    tb = tr.train_step(cfgb, stb, sb, message=mb)
    sds = full_state_dicts(stb)
    first = {"terms": {k: float(v) for k, v in tb.items()}, "local_rows": local_rows,
             "state": {**{f"{net}.{k}": v.cpu().clone() for net in ("gen", "det") for k, v in sds[net].items()},
                       **cpu_grads(full_grads(stb))}}
    del sds
    later = [{k: float(v) for k, v in tr.train_step(cfgb, stb, sb).items()} for _ in range(TABLE_STEPS - 1)]
    replicated = {f"{net}.{k}": v.detach().cpu() for net in ("gen", "det")
                  for k, v in getattr(stb, net).named_parameters() if k != "embedding.weight"}
    torch.save({**first, "later_terms": later, "replicated": replicated}, os.path.join(out, f"model2.{rank}.pt"))
    counted = dict(K.launches)
    since_launch(marks, "checked steps")
    del stb, first, replicated
    cfg16 = dataclasses.replace(train_cfg("bfloat16"), audio_len=chunk)
    st16 = shard_state(shapecap_state(cfg16, dev), mesh)
    deadline = time.time() + 300
    while not os.path.exists(card_free):
        if time.time() > deadline:
            raise TimeoutError(f"{card_free} did not appear")
        time.sleep(0.1)
    since_launch(marks, "card free")
    tr.train_step(cfg16, st16, rows)  # warm-up
    sync()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        tr.train_step(cfg16, st16, rows)
    sync()
    wall = (time.perf_counter() - t0) / reps
    collectives.stats["count"], seconds, plain = 0, [0.0], dist.all_reduce
    dist.all_reduce = timed_all_reduce(seconds)
    t0 = time.perf_counter()
    for _ in range(reps):
        tr.train_step(cfg16, st16, rows)
    sync()
    timed_wall = (time.perf_counter() - t0) / reps
    dist.all_reduce = plain
    since_launch(marks, "timed steps")
    with open(os.path.join(out, f"rank.{rank}.json"), "w") as f:
        json.dump({"launches": counted, "marks": marks, "bf16_step_s": wall, "timed_step_s": timed_wall,
                   "collectives_per_step": collectives.stats["count"] / reps,
                   "collective_s_per_step": seconds[0] / reps}, f)
    shutdown()


def parallel_references(dev, chunk: int) -> dict:
    """The one-process steps that phase 13's ranks are held against, on
    the card: the shapecap fp32 validation and step at PARALLEL_B rows, the
    same step on its input changed by PARALLEL_TOL["input_change"] (the
    yardstick of the generator LSTM's drift), and the base preset's fp32
    step at PARALLEL_TABLE_B rows; states and gradients as CPU copies."""
    import torch

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.parallel import full_grads

    cfg32 = dataclasses.replace(train_cfg("float32"), audio_len=chunk)
    s, msgs = parallel_inputs(PARALLEL_B, chunk, seed=11)
    ref = shapecap_state(cfg32, dev)
    s_dev = torch.from_numpy(s).to(dev)
    rval = tr.eval_step(cfg32, ref, s_dev, generator=torch.Generator().manual_seed(7))
    rterms = tr.train_step(cfg32, ref, s_dev, message=torch.from_numpy(msgs).to(dev))
    want = {"terms": {k: float(v) for k, v in rterms.items()}, "val": {k: float(v) for k, v in rval.items()},
            "state": {**cpu_state(ref), **cpu_grads(full_grads(ref))}}
    params = {f"{net}.{k}" for net in ("gen", "det") for k, _ in getattr(ref, net).named_parameters()}
    del ref, rterms, rval
    # the yardstick of the generator LSTM's drift: one process, its input changed by 1e-6
    ref = shapecap_state(cfg32, dev)
    tr.train_step(cfg32, ref, s_dev * (1 + PARALLEL_TOL["input_change"]),
                  message=torch.from_numpy(msgs).to(dev))
    moved = step_drift(cpu_grads(full_grads(ref)), want["state"],
                       {k for k in params if UPSTREAM_OF_LSTM.search(k)})
    del ref
    cfgb = table_cfg(chunk)
    sb, mb = parallel_inputs(PARALLEL_TABLE_B, chunk, seed=13)
    refb = tr.init_state(cfgb, seed=5, device=dev)
    tb = tr.train_step(cfgb, refb, torch.from_numpy(sb).to(dev), message=torch.from_numpy(mb).to(dev))
    want_b = {"terms": {k: float(v) for k, v in tb.items()},
              "state": {**cpu_state(refb), **cpu_grads(full_grads(refb))}}
    params_b = {f"{net}.{k}" for net in ("gen", "det") for k, _ in getattr(refb, net).named_parameters()}
    del refb, tb
    return {"data2": (want, params, moved), "model2": (want_b, params_b)}


def parallel_phase(K, launches, cli, dev, work: str, audio_len=None) -> dict:
    """Phase 13: multi-process training, counters zeroed just before (the
    ranks' own counts, read from their files, are the phase's).  (a)
    ``torchrun --nproc-per-node 1 -m awm_tpu_torch train --data-parallel``
    (NCCL on the card; bf16, B=128, 3 steps and one validation, --ckpt-dir):
    ckpt_latest restores in this process equal to the trained state; the
    bf16 step through a mesh of one beside the plain step.  (b) two ranks on
    the one device over gloo: the shapecap fp32 step at B=128 on a data=2
    mesh and its validation, and the base preset's fp32 step on a model=2
    mesh (table gathered), each against one process on the same device;
    kernels B and C launched on each rank, A in its validation; the bf16
    step's clips/s, collectives a step and their share of its time.  (a)
    and (b) start together, their start-ups overlapping, and (b) times its
    steps once (a) has exited.  (c) ``prep metadata``, ``segment`` and
    ``classify`` on a folder of WAVs.  Returns the numbers to print."""
    import torch

    from awm_tpu_torch import checkpoint as ck, train as tr
    from awm_tpu_torch.checkpoint import SHAPECAP_NPZ
    from awm_tpu_torch.data import prep
    from awm_tpu_torch.parallel import full_grads, initialize_distributed, make_mesh, shard_state, shutdown

    zero_counts(K)
    t_phase = time.time()
    chunk = audio_len or T
    length = ["--audio-len", str(audio_len)] if audio_len else []
    out = os.path.join(work, "parallel")
    os.makedirs(out)
    lr = train_cfg("float32").train.schedule.lr
    numbers = {}
    phase = {name: 0 for name in launches}

    # (a) one rank through the train command, NCCL on the card, and (b) two
    # ranks on the one device over gloo, started together so that their
    # start-ups overlap; (b) times its steps once (a) has exited
    run_dir = os.path.join(out, "train")
    argv = ["train", "--data-parallel", "--device", dev.type, "--compute-dtype", "bfloat16",
            "--batch-size", str(B_TRAIN), "--synthetic-n", str(4 * B_TRAIN - B_TRAIN // 4),
            "--epochs", "1", "--workers", "4", "--init-from", SHAPECAP_NPZ, "--message-encoding",
            "bits", "--decode-head", "dilated", "--delta-band-hz", "3000", "--shape-max-rms", "0.01",
            "--dec-loss", "mean", "--lr", "1e-4", "--ckpt-dir", run_dir] + length
    card_free = os.path.join(out, "card_free")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    one = torchrun(1, ["cli-rank", out] + argv)
    two = torchrun(2, ["parallel-rank", out, str(dev), str(chunk), card_free])
    one_ok = joined(one)
    open(card_free, "w").close()
    two_ok = joined(two)

    if one_ok:
        with open(os.path.join(out, "cli.0.json")) as f:
            rank0 = json.load(f)
        print(f"train --data-parallel, s from the launch: {rank0['marks']}", flush=True)
        trained = torch.load(os.path.join(out, "trained.pt"), weights_only=True)
        restored = tr.init_state(dataclasses.replace(train_cfg("bfloat16"), audio_len=chunk), seed=3,
                                 device=dev)
        _, epoch, _ = ck.restore_checkpoint(ck.latest_path(run_dir), restored)
        got = cpu_state(restored)
        check(epoch == 1 and restored.step == trained["step"] == 3 and got.keys() == trained["state"].keys()
              and all(torch.equal(v, trained["state"][k]) for k, v in got.items()),
              f"train --data-parallel (1 rank, NCCL): ckpt_latest (epoch {epoch}, step {restored.step}) "
              f"restores here equal to the trained state")
        row = rank0["history"][0]
        check(all(np.isfinite(v) for k, v in row.items() if k != "epoch"),
              f"train --data-parallel: train {row['train_total']:.4f} val {row['val_total']:.4f}, finite")
        for name, n in rank0["launches"].items():
            phase[name] += n
        del restored, trained
    # the bf16 step through a mesh of one beside the plain step, the card to
    # this process alone
    cfg16 = dataclasses.replace(train_cfg("bfloat16"), audio_len=chunk)
    batch = torch.from_numpy(speechlike(B_TRAIN, seed=9, chunk=chunk)).to(dev)
    initialize_distributed(device=dev)  # a group of this process alone
    mesh1 = make_mesh()
    for label in ("plain", "data_parallel_1", "data_parallel_1", "plain"):
        state = shapecap_state(cfg16, dev)
        if label != "plain":
            shard_state(state, mesh1)
        tr.train_step(cfg16, state, batch)  # warm-up
        ms = cuda_ms(lambda: tr.train_step(cfg16, state, batch), reps=3, warmup=0) if dev.type == "cuda" \
            else 1.0
        numbers.setdefault(f"bf16_clips_s_{label}", []).append(B_TRAIN / ms * 1e3)
        del state
    shutdown()
    print(f"bf16 train step B={B_TRAIN}, clips/s: plain {numbers['bf16_clips_s_plain']}, through a mesh "
          f"of one {numbers['bf16_clips_s_data_parallel_1']}", flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if two_ok:
        ranks = []
        for r in range(2):
            with open(os.path.join(out, f"rank.{r}.json")) as f:
                ranks.append(json.load(f))
        print(f"2 ranks, s from the launch: {[rk['marks'] for rk in ranks]}", flush=True)
        data2 = [torch.load(os.path.join(out, f"data2.{r}.pt"), weights_only=True) for r in range(2)]
        model2 = [torch.load(os.path.join(out, f"model2.{r}.pt"), weights_only=True) for r in range(2)]
        refs = parallel_references(dev, chunk)
        (want, params, moved), (want_b, params_b) = refs["data2"], refs["model2"]
        for what, got, ref, names, drifting in (
                ("data=2 shapecap fp32", data2, want, params, {k for k in params if UPSTREAM_OF_LSTM.search(k)}),
                ("model=2 base fp32 (table sharded)", model2, want_b, params_b, set())):
            term_err = max(abs(g["terms"][k] - v) / abs(v) for g in got for k, v in ref["terms"].items())
            if "val" in ref:
                term_err = max(term_err, max(abs(g["val"][k] - v) / abs(v) for g in got
                                             for k, v in ref["val"].items()))
            worst = {k: max(step_errors(g["state"], ref["state"], names, lr, drifting)[k] for g in got)
                     for k in ("grad", "bn_fed_grad", "sure_step", "step")}
            drift = max(step_drift(g["state"], ref["state"], drifting) for g in got) if drifting else 0.0
            stats = [k for k in ref["state"] if k not in names and not k.startswith("grad.")]
            s_err = max(float(((g["state"][k] - ref["state"][k]).abs() - PARALLEL_TOL["stats"]
                               * ref["state"][k].abs()).max()) for g in got for k in stats)
            check(term_err <= PARALLEL_TOL["terms"] and s_err <= PARALLEL_TOL["stats"] and worst["step"] <= 1
                  and all(worst[k] < 1 for k in ("grad", "bn_fed_grad", "sure_step"))
                  and (not drifting or drift <= moved),
                  f"2 ranks over gloo, {what} vs one process: terms rel err {term_err:.2e}, BN statistics "
                  f"excess {s_err:.2e}; gradients and updated parameters, worst share of each limit "
                  f"(step_errors): " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
                  + (f"; generator LSTM and encoder gradients drift {drift:.2e} (one process under a "
                     f"{PARALLEL_TOL['input_change']:.0e} input change: {moved:.2e})" if drifting else ""))
        check(all(m["local_rows"] == 2**15 for m in model2)
              and all(m["state"]["gen.embedding.weight"].shape == (2**16, 64) for m in model2),
              "model=2: each rank holds 2^15 rows of the table; the gathered table has 2^16")
        rep0, rep1 = (m["replicated"] for m in model2)
        differ = [k for k in rep0 if not torch.equal(rep0[k], rep1[k])]
        later = [m["later_terms"] for m in model2]
        apart = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(*later) for k in b)
        check(not differ and apart <= PARALLEL_TOL["terms"]
              and all(np.isfinite(v) for t in later[0] for v in t.values()),
              f"model=2, {TABLE_STEPS} steps: the two ranks' {len(rep0)} replicated parameters bit-equal "
              f"(differ: {differ}); finite terms {apart:.2e} apart (relative, tol "
              f"{PARALLEL_TOL['terms']:.0e}), totals {[t['total'] for t in later[0]]}")
        for r, rk in enumerate(ranks):
            for name, n in rk["launches"].items():
                phase[name] += n
            f32 = {k: rk["launches"][K.instantiation(k, torch.float32, 64)] for k in K.KERNELS}
            check(all(n > 0 for n in f32.values()), f"rank {r}: fp32 kernels launched {f32}")
        step_s = float(np.mean([rk["bf16_step_s"] for rk in ranks]))
        numbers.update(
            two_rank_bf16_clips_s=PARALLEL_B / step_s,
            collectives_per_step=ranks[0]["collectives_per_step"],
            collective_share=float(np.mean([rk["collective_s_per_step"] / rk["timed_step_s"] for rk in ranks])))
        print(f"2 ranks over gloo on one device, bf16 step at B={PARALLEL_B} global: "
              f"{numbers['two_rank_bf16_clips_s']:.1f} clips/s ({1e3 * step_s:.1f} ms a step); "
              f"{numbers['collectives_per_step']:.0f} collectives a step, "
              f"{100 * numbers['collective_share']:.1f}% of the step's time "
              f"(timed step {1e3 * ranks[0]['timed_step_s']:.1f} ms)", flush=True)

    # (c) the dataset tools on a folder of WAVs
    wavs, meta = os.path.join(out, "wavs"), os.path.join(out, "meta.csv")
    os.makedirs(wavs)
    write_wav_folder(wavs)
    cli_printed(cli, ["prep", "metadata", wavs, meta])
    _, seg = cli_printed(cli, ["prep", "segment", os.path.join(out, "clips"), "--metadata", meta,
                               "--workers", "4"])
    _, cls = cli_printed(cli, ["prep", "classify", wavs, os.path.join(out, "cls"), "--workers", "4"])
    counts = json.loads(cls)
    rows, n_clips = prep.read_metadata(meta), int(seg.split()[1])
    whole = sum(int(d * 16000 + 0.5) // 16000 for _, d in rows)  # 1-s clips the files hold
    check(len(rows) == len(os.listdir(wavs)) and n_clips == whole
          and sum(counts.values()) == len(rows) and counts["error"] == 0,
          f"prep: metadata {len(rows)} rows, segment {n_clips} clips ({whole} whole seconds), "
          f"classify {counts}")

    numbers["phase_s"] = time.time() - t_phase
    print(f"multi-process phase launches: {phase}; {numbers['phase_s']:.1f} s", flush=True)
    for name, n in phase.items():
        launches[name] += n
    return numbers


def padded_to(x, w_ih, w_hh, bias, h: int, cap: int = 64):
    """x, W_ih, W_hh and b of LSTM(d, h) zero-padded to LSTM(cap, cap): each
    gate's h rows (and the columns) to cap."""
    import torch.nn.functional as F

    d = x.shape[2]
    pad = lambda w, cols: F.pad(w.view(4, h, cols), (0, cap - cols, 0, cap - h)).reshape(4 * cap, cap)
    return (F.pad(x, (0, cap - d)), pad(w_ih, d), pad(w_hh, h),
            F.pad(bias.view(4, h), (0, cap - h)).reshape(4 * cap))


def unpadded_grads(grads, d: int, h: int, cap: int = 64) -> tuple[tuple, bool]:
    """Kernel C's (dx, dW_ih, dW_hh, db) of a call on padded_to's operands
    sliced back to LSTM(d, h), and whether every padded entry is exactly 0."""
    dx, dw_ih, dw_hh, db = grads
    wi, wh, b = dw_ih.view(4, cap, cap), dw_hh.view(4, cap, cap), db.view(4, cap)
    nothing = lambda v: v.numel() == 0 or float(v.float().abs().max()) == 0.0
    zero = all(nothing(v) for v in (dx[..., d:], wi[:, h:], wi[:, :, d:], wh[:, h:], wh[:, :, h:], b[:, h:]))
    return (dx[..., :d], wi[:, :h, :d].reshape(4 * h, d), wh[:, :h, :h].reshape(4 * h, h),
            b[:, :h].reshape(4 * h)), zero


def wide_checks(K, dev, max_err, max_rel) -> None:
    """The widths phase's kernel checks: A, B and C at NEW_WIDTHS against
    their plain versions at B=3, T=512, fp32 and bf16 (KERNEL_TOL); two
    backward calls (and on the cluster and wide paths two forward calls)
    give the same bits, C at capacity 48 at both rows variants; 48 x 48 and
    40 x 24 (capacity 48) give the bits of the width-64 instantiation on
    the zero-padded operands, A, B and C (PADDED_CHECKS); one past the
    cluster path
    (257 x 257, 8 x 257) launches the *_wide instantiations through
    lstm_fused_forward and returns the plain result.  Then the wide path's
    unit tiles: at 512 x 512 with fewer CTAs a row group (TILED_CTAS: CTAs
    of more tiles each) A, B and C give the bits of the plan's (untiled)
    call, and at TILED_WIDTH (more CTAs a group than the card holds at
    once) the plan takes fewer CTAs of more tiles and A, B and C hold
    against plain; at 512 x 512 the staged chunks of CHUNK_CHECKS give the
    plan's bits too, and past the widths whole-row staging capped
    (CEILING_CHECKS) A, B and C hold against plain, C twice the same bits.
    The worst errors go to max_err / max_rel under the masked, cluster and
    wide names."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tol_a, tol_b, tol_c = (K.KERNEL_TOL[k, sfx] for k in K.KERNELS)
        for d, h in NEW_WIDTHS:
            name, fname, bname = (K.instantiation(k, dtype, d, h) for k in K.KERNELS)
            x, w_ih, w_hh, bias, dy = lstm_inputs(NEW_B, dtype, dev, seed=d * 1000 + h, t=NEW_T, w=d, h=h)
            with no_tf32():
                y0 = K.forward_kernel(x, w_ih, w_hh, bias)
                y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
                grads = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
                again = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
                torch.cuda.synchronize()
                ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                ref_g = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
            err_a = float((y0.float() - ref_y.float()).abs().max())
            err_b = max(float((y.float() - ref_y.float()).abs().max()), float((cprev - ref_c).abs().max()))
            rels = [rel_err(g, r) for g, r in zip(grads, ref_g)]
            same = all(torch.equal(g, g2) for g, g2 in zip(grads, again)) and torch.equal(y0, y)
            if name.endswith(("_cluster", "_wide")):
                same &= torch.equal(y0, K.forward_kernel(x, w_ih, w_hh, bias))
            shapes = (y.shape == (NEW_B, NEW_T, h) and grads[0].shape == x.shape
                      and grads[1].shape == (4 * h, d) and grads[2].shape == (4 * h, h))
            check(shapes and err_a <= tol_a and err_b <= tol_b and max(rels) <= tol_c and same
                  and all(bool(torch.isfinite(g).all()) for g in grads),
                  f"{name} / {fname} / {bname} (D={d} H={h}) vs plain, B={NEW_B} T={NEW_T}: A {err_a:.3e}, "
                  f"B {err_b:.3e} max abs (tol {tol_a:.0e}); C rel {', '.join(f'{r:.2e}' for r in rels)} "
                  f"(tol {tol_c:.0e}); two calls the same bits: {same}")
            for n, e in ((name, err_a), (fname, err_b)):
                max_err[n] = max(max_err.get(n, 0.0), e)
            max_err[bname] = max(max_err.get(bname, 0.0),
                                 max(float((g.float() - r.float()).abs().max()) for g, r in zip(grads, ref_g)))
            max_rel[bname] = max(max_rel.get(bname, 0.0), max(rels))
            if K.capacity(d, h) == 48:  # C at both rows variants of capacity 48's block
                by_rows = []
                for rows in K.BWD_ROWS:
                    with no_tf32():
                        g1 = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=rows)
                        g2 = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=rows)
                        torch.cuda.synchronize()
                    rel = max(rel_err(g, r) for g, r in zip(g1, ref_g))
                    by_rows.append((rows, rel, all(torch.equal(a, a2) for a, a2 in zip(g1, g2))))
                    max_rel[bname] = max(max_rel[bname], rel)
                    max_err[bname] = max(max_err[bname], *(max_abs(g, r) for g, r in zip(g1, ref_g)))
                    del g1, g2
                check(all(rel <= tol_c and same for _, rel, same in by_rows),
                      f"{bname} (D={d} H={h}) at rows " + ", ".join(f"{r}: rel {e:.2e}, twice the same bits {same}"
                                                                   for r, e, same in by_rows)
                      + f" vs plain (tol {tol_c:.0e})")
            if (d, h) in PADDED_CHECKS:
                padded = padded_to(x, w_ih, w_hh, bias, h)
                y64 = K.forward_kernel(*padded)
                yt64, c64 = K.forward_train_kernel(*padded)
                held = (torch.equal(y0, y64[..., :h]) and torch.equal(y, yt64[..., :h])
                        and torch.equal(cprev, c64[..., :h]) and float(y64[..., h:].float().abs().max()) == 0.0)
                check(held, f"{name} / {fname} at {d} x {h}: the same bits as "
                            f"{K.instantiation('lstm_fwd', dtype, 64)} on the zero-padded operands, padded units "
                            f"exactly 0")
                # C: dW and db sum each output over the rows as the padded call does, fp32 dx over the gate
                # columns in order; bf16 dx's mma k-tiles hold 16 columns, which straddle two gates where 16
                # does not divide H (40 x 24): there its fp32 sums group other terms than the padded call's
                # and dx is held against plain above (the parent's capacity-64 call runs the same dx kernel)
                g64 = K.backward_kernel(padded[0], yt64, c64, torch.nn.functional.pad(dy, (0, 64 - h)),
                                        *padded[1:])
                sliced, zero = unpadded_grads(g64, d, h)
                exact = ("dx", "dW_ih", "dW_hh", "db") if dtype == torch.float32 or h % 16 == 0 else (
                    "dW_ih", "dW_hh", "db")
                same = {n: torch.equal(g, p) for n, g, p in zip(("dx", "dW_ih", "dW_hh", "db"), grads, sliced)}
                check(zero and all(same[n] for n in exact),
                      f"{bname} at {d} x {h}: {', '.join(exact)} the same bits as "
                      f"{K.instantiation('lstm_bwd', dtype, 64)} on the zero-padded operands ({same}), padded "
                      f"entries exactly 0: {zero}")
                del g64, sliced
            del x, y0, y, cprev, grads, again, ref_y, ref_c, ref_g
            torch.cuda.empty_cache()
    ceiling = K.CLUSTER_MAX_WIDTH
    for d, h in ((ceiling + 1, ceiling + 1), (8, ceiling + 1)):
        x, w_ih, w_hh, bias, _ = lstm_inputs(2, torch.float32, dev, seed=1, t=8, w=d, h=h)
        name = K.instantiation("lstm_fwd", torch.float32, d, h)
        before = dict(K.launches)
        with no_tf32():
            y = K.lstm_fused_forward(x, w_ih, w_hh, bias)
            torch.cuda.synchronize()
            err = max_abs(y, lstm_forward_train(x, w_ih, w_hh, bias)[0])
        moved = {n: K.launches[n] - before[n] for n in K.launches if K.launches[n] != before[n]}
        check(name.endswith("_wide") and moved == {name: 1} and err <= K.KERNEL_TOL["lstm_fwd", "f32"],
              f"D={d} H={h} (one past the cluster path's {ceiling}) on the card: {name} launched ({moved}), "
              f"max abs err vs plain {err:.3e}")
    for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        w = WIDE_CHANNELS
        x, w_ih, w_hh, bias, dy = lstm_inputs(7, dtype, dev, seed=w + 5, t=300, w=w)

        def calls(ctas, chunk=None):
            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias, ctas=ctas, chunk=chunk)
            return (K.forward_kernel(x, w_ih, w_hh, bias, ctas=ctas, chunk=chunk), y, cprev,
                    *K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, ctas=ctas, chunk=chunk))
        with no_tf32():
            base = calls(None)
            same = {ctas: all(torch.equal(a, b) for a, b in zip(calls(ctas), base)) for ctas in TILED_CTAS}
            same_chunks = {chunk: all(torch.equal(a, b) for a, b in zip(calls(None, chunk), base))
                           for chunk in CHUNK_CHECKS}
            xr, *wr, dyr = lstm_inputs(CHUNK_ROWS_B, dtype, dev, seed=w + 6, t=64, w=w)
            yr, cr = K.forward_train_kernel(xr, *wr)
            for rows in CHUNK_ROWS:
                ref = K.backward_kernel(xr, yr, cr, dyr, *wr, rows=rows)
                same_chunks[f"C at {rows} rows"] = all(
                    all(torch.equal(a, b) for a, b in zip(K.backward_kernel(xr, yr, cr, dyr, *wr, rows=rows,
                                                                            chunk=chunk), ref))
                    for chunk in CHUNK_ROWS_CHUNKS)
            del xr, wr, dyr, yr, cr
        plan = K._plan_for(x, w)
        check(all(same.values()) and plan.fwd_ctas == plan.bwd_ctas == -(-w // K.WIDE_UNITS),
              f"{K.instantiation('lstm_fwd', dtype, w)} / B / C at {w} x {w}, B=7 T=300: CTAs a row group "
              f"{TILED_CTAS} (of more unit tiles each) give the bits of the plan's {plan.fwd_ctas}: {same}")
        check(all(same_chunks.values()),
              f"{K.instantiation('lstm_fwd', dtype, w)} / B / C at {w} x {w}, B=7 T=300, rows {plan.fwd_rows} / "
              f"{plan.bwd_rows}: h / da staged in chunks of {CHUNK_CHECKS} terms give the plan's bits, and C's at "
              f"B={CHUNK_ROWS_B}, T=64 in chunks of {CHUNK_ROWS_CHUNKS} at rows {CHUNK_ROWS}: {same_chunks}")
        d = h = TILED_WIDTH
        tol_a, tol_b, tol_c = (K.KERNEL_TOL[k, sfx] for k in K.KERNELS)
        x, w_ih, w_hh, bias, dy = lstm_inputs(3, dtype, dev, seed=d, t=40, w=d)
        plan = K._plan_for(x, h)
        before = dict(K.launches)
        with no_tf32():
            y0 = K.forward_kernel(x, w_ih, w_hh, bias)
            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
            grads = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
            again = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
            torch.cuda.synchronize()
            ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
            ref_g = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
        moved = {n: K.launches[n] - before[n] for n in K.launches if K.launches[n] != before[n]}
        err_a, err_b = max_abs(y0, ref_y), max(max_abs(y, ref_y), max_abs(cprev, ref_c))
        rels = [rel_err(g, r) for g, r in zip(grads, ref_g)]
        k = -(-h // K.WIDE_UNITS)
        check(plan.fwd_ctas < k and plan.bwd_ctas < k and all(n.endswith("_wide") for n in moved)
              and err_a <= tol_a and err_b <= tol_b and max(rels) <= tol_c
              and all(torch.equal(g, g2) for g, g2 in zip(grads, again)),
              f"{K.instantiation('lstm_fwd', dtype, h)} / B / C at {d} x {h} (a row group of {k} unit tiles, more "
              f"than the card holds at once: {plan.fwd_ctas} / {plan.bwd_ctas} CTAs a group), B=3 T=40, vs plain: "
              f"A {err_a:.3e}, B {err_b:.3e} (tol {tol_a:.0e}); C rel {', '.join(f'{r:.2e}' for r in rels)} "
              f"(tol {tol_c:.0e}); C twice the same bits; launched {moved}")
        del x, y0, y, cprev, grads, again, ref_y, ref_c, ref_g
        torch.cuda.empty_cache()
    for sfx, h in CEILING_CHECKS:
        dtype = torch.float32 if sfx == "f32" else torch.bfloat16
        tol_a, tol_b, tol_c = (K.KERNEL_TOL[k, sfx] for k in K.KERNELS)
        x, w_ih, w_hh, bias, dy = lstm_inputs(2, dtype, dev, seed=h + 1, t=CEILING_T, w=16, h=h)
        before = dict(K.launches)
        with no_tf32():
            y0 = K.forward_kernel(x, w_ih, w_hh, bias)
            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
            grads = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
            again = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
            torch.cuda.synchronize()
            plan = K._plan_for(x, h)
            ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
            err_a, err_b = max_abs(y0, ref_y), max(max_abs(y, ref_y), max_abs(cprev, ref_c))
            del ref_y, ref_c
            torch.cuda.empty_cache()
            ref_g = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
        moved = {n: K.launches[n] - before[n] for n in K.launches if K.launches[n] != before[n]}
        rels = [rel_err(g, r) for g, r in zip(grads, ref_g)]
        names = [K.instantiation(k, dtype, 16, h) for k in K.KERNELS]
        check(moved == {names[0]: 1, names[1]: 1, names[2]: 2} and err_a <= tol_a and err_b <= tol_b
              and max(rels) <= tol_c and all(torch.equal(g, g2) for g, g2 in zip(grads, again)),
              f"{' / '.join(names)} at D=16 H={h} (past the width whole-row staging capped), B=2 T={CEILING_T}, "
              f"{plan.fwd_rows} / {plan.bwd_rows} rows, {plan.fwd_ctas} / {plan.bwd_ctas} CTAs a group, vs plain: "
              f"A {err_a:.3e}, B {err_b:.3e} (tol {tol_a:.0e}); C rel {', '.join(f'{r:.2e}' for r in rels)} "
              f"(tol {tol_c:.0e}); C twice the same bits; launched {moved}")
        for n, e in zip(names, (err_a, err_b)):
            max_err[n] = max(max_err.get(n, 0.0), e)
        max_rel[names[2]] = max(max_rel.get(names[2], 0.0), max(rels))
        del x, w_ih, w_hh, bias, dy, y0, y, cprev, grads, again, ref_g
        torch.cuda.empty_cache()


ROWS_CHECK_WIDTHS = (96, 128, 256, WIDE_CHANNELS)  # the cluster path's K = 3, 4, 8; the wide path
ROWS_CHECK_B, ROWS_CHECK_T = (1, 7, 32), (1, 17, 512)


def cluster_parts(plan) -> dict[str, tuple[str, int]]:
    """Kernel C's launches on the cluster path, by a kernel-name fragment
    and its launches a call: the gate pass, the recurrence, dx and dW once a
    window of the plan's, the ordered sum once."""
    wins = -(-T // plan.bwd_window)
    return {"gates": ("lstm_bwd_gates_", wins), "rec": ("lstm_bwd_cluster_", wins), "dx": ("lstm_bwd_dx_", wins),
            "dw": ("lstm_bwd_dw_", wins), "sum": ("lstm_bwd_sum_", 1)}


def capacity_parts(dtype) -> dict[str, tuple[str, int]]:
    """Kernel C's launches on a register-held capacity at runtime widths (and
    at capacity 48's square), by a kernel-name fragment and its launches a
    call: the recurrence, bf16 W_ih rounded once, dx, dW, the ordered sum."""
    import torch

    wih = {"wih": ("lstm_bwd_wih_", 1)} if dtype == torch.bfloat16 else {}
    return {"rec": ("lstm_bwd_rec_kernel", 1), **wih, "dx": ("lstm_bwd_dx_", 1), "dw": ("lstm_bwd_dw_", 1),
            "sum": ("lstm_bwd_sum_", 1)}


def rows_variants(K, x, w: int) -> tuple:
    """The rows variants rows_checks holds at width w: on the cluster path
    every one it builds (CLUSTER_ROWS); on the wide path in fp32 every rows
    a row group (WIDE_ROWS: A and B's tiles a warp follow them); in bf16
    the plan's (A's and C's) and one row a group (B row groups: at B=32 in
    more launches than one)."""
    import torch

    if not K.is_wide(w):
        return K.CLUSTER_ROWS
    if x.dtype == torch.float32:
        return K.WIDE_ROWS
    plan = K._plan_for(x, w)
    return tuple(sorted({plan.fwd_rows, plan.bwd_rows, 1}))


def rows_checks(K, dev, max_err, max_rel) -> None:
    """A, B and C at each of ROWS_CHECK_WIDTHS (the cluster path at 96, 128
    and 256, K = 3, 4, 8; the wide path at 512), B in ROWS_CHECK_B, T in
    ROWS_CHECK_T, fp32 and bf16, at every rows variant of rows_variants,
    against the plain versions (KERNEL_TOL); two calls of A and of C give
    the same bits, and A and B the same y.  Then kernel C at 48 x 48
    (capacity48_checks).  The worst errors go to max_err / max_rel."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    for w in ROWS_CHECK_WIDTHS:
        for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tol_a, tol_b, tol_c = (K.KERNEL_TOL[k, sfx] for k in K.KERNELS)
            name, fname, bname = (K.instantiation(k, dtype, w) for k in K.KERNELS)
            worst = {"A": 0.0, "B": 0.0, "C": 0.0}
            held, seen = True, set()
            for b in ROWS_CHECK_B:
                for t in ROWS_CHECK_T:
                    x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=w * 100 + b * 10 + t, t=t, w=w)
                    with no_tf32():
                        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                        ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
                        for rows in rows_variants(K, x, w):
                            seen.add(rows)
                            y0 = K.forward_kernel(x, w_ih, w_hh, bias, rows=rows)
                            again = K.forward_kernel(x, w_ih, w_hh, bias, rows=rows)
                            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows)
                            g = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
                            g2 = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
                            torch.cuda.synchronize()
                            err_a, err_b = max_abs(y0, ref_y), max(max_abs(y, ref_y), max_abs(cprev, ref_c))
                            rels = [rel_err(a, r) for a, r in zip(g, ref_g)]
                            same = (torch.equal(y0, again) and torch.equal(y0, y)
                                    and all(torch.equal(a, a2) for a, a2 in zip(g, g2)))
                            ok = err_a <= tol_a and err_b <= tol_b and max(rels) <= tol_c and same
                            if not ok:
                                print(f"  {w}x{w} {sfx} B={b} T={t} rows {rows}: A {err_a:.3e}, B {err_b:.3e}, "
                                      f"C rel {max(rels):.3e}, same bits {same}", flush=True)
                            held &= ok
                            worst = {"A": max(worst["A"], err_a), "B": max(worst["B"], err_b),
                                     "C": max(worst["C"], max(rels))}
                            max_err[bname] = max(max_err.get(bname, 0.0), *(max_abs(a, r) for a, r in zip(g, ref_g)))
                    del x, y0, again, y, cprev, g, g2, ref_y, ref_c, ref_g
            for n, e in ((name, worst["A"]), (fname, worst["B"])):
                max_err[n] = max(max_err.get(n, 0.0), e)
            max_rel[bname] = max(max_rel.get(bname, 0.0), worst["C"])
            check(held, f"{name} / {fname} / {bname} at {w}x{w}, rows a {'group' if K.is_wide(w) else 'cluster'} "
                        f"{sorted(seen)} at B in {ROWS_CHECK_B}, T in {ROWS_CHECK_T} vs plain: A {worst['A']:.3e}, "
                        f"B {worst['B']:.3e} max abs (tol {tol_a:.0e}); C rel {worst['C']:.3e} (tol {tol_c:.0e}); "
                        f"A twice, C twice the same bits, A and B the same y")
            torch.cuda.empty_cache()
    for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        capacity48_checks(K, dev, max_rel, sfx, dtype)


def capacity48_checks(K, dev, max_rel, sfx: str, dtype) -> None:
    """rows_checks' kernel C at 48 x 48 (capacity 48's square), B=7,
    T=512, at rows 1 and 2: against plain (KERNEL_TOL), two calls the same
    bits, and in the profiler's list its recurrence on the 48-wide block
    (lstm_bwd_rec_kernel<T, rows, 48, false>) and dx / dW at runtime widths
    (bf16 on the tensor cores: lstm_bwd_{dx,dw}_any_mma)."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    bname, tol = K.instantiation("lstm_bwd", dtype, 48), K.KERNEL_TOL["lstm_bwd", sfx]
    tname = "__nv_bfloat16" if dtype == torch.bfloat16 else "float"
    x, w_ih, w_hh, bias, dy = lstm_inputs(7, dtype, dev, seed=4807, t=512, w=48)
    with no_tf32():
        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
        ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
    for rows in K.BWD_ROWS:
        call = lambda: K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
        with no_tf32():
            got, again = call(), call()
            torch.cuda.synchronize()
            prods = ("dx_any_mma_", "dw_any_mma_") if dtype == torch.bfloat16 else ("dx_narrow_", "dw_any_")
            parts = device_split(call, {"rec": f"lstm_bwd_rec_kernel<{tname}, {rows}, 48, false>",
                                        "dx": f"lstm_bwd_{prods[0]}", "dw": f"lstm_bwd_{prods[1]}"}, reps=3)
        rels = [rel_err(a, r) for a, r in zip(got, ref_g)]
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        max_rel[bname] = max(max_rel.get(bname, 0.0), max(rels))
        check(max(rels) <= tol and same and None not in parts.values(),
              f"{bname} (48 x 48, B=7 T=512, rows {rows}): the recurrence on capacity 48's block "
              f"(lstm_bwd_rec_kernel<{tname}, {rows}, 48, false> {fmt_ms(parts['rec'])}), dx / dW at runtime "
              f"widths (lstm_bwd_{prods[0]} {fmt_ms(parts['dx'])}, lstm_bwd_{prods[1]} {fmt_ms(parts['dw'])}) in "
              f"the profiler's list; vs plain: rel {', '.join(f'{r:.2e}' for r in rels)} (tol {tol:.0e}); two "
              f"calls the same bits: {same}")


def wide_main_checks(K, dev, max_err, max_rel) -> None:
    """A, B and C at the shapes the base family's main path hands them at
    channels 48 and 128, T=16000, fp32 and bf16, against their plain
    versions (KERNEL_TOL): A at the session's batch (WIDE_CHUNKS chunks,
    one bucket), B and C at the train step's (WIDE_B), so that each call
    takes the main path's plan (rows, waves, dW chunks); on the cluster path
    the plan takes one wave (their times: ops/bench_lstm.py --width 128
    --batch 64|32 --library).  The worst errors go to max_err / max_rel."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for w in BASE_CHANNELS:
        for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tol_a, tol_b, tol_c = (K.KERNEL_TOL[k, sfx] for k in K.KERNELS)
            name, fname, bname = (K.instantiation(k, dtype, w) for k in K.KERNELS)
            slots = K._cluster_slots(dev.index or 0, dtype, w, w) if K.capacity(w) is None else None
            plans = [K.launch_plan(b, T, dtype, sm_count, w, None, None, slots) for b in (WIDE_CHUNKS, WIDE_B)]
            if slots is not None:
                waves = [-(-p.fwd_blocks // slots[0][K.CLUSTER_ROWS.index(p.fwd_rows)]) for p in plans]
                waves.append(-(-plans[1].bwd_blocks // slots[1][K.CLUSTER_ROWS.index(plans[1].bwd_rows)]))
                check(waves == [1, 1, 1], f"the base family at channels {w} ({dtype}) on the cluster path takes one "
                                          f"wave: A at B={WIDE_CHUNKS} {plans[0].fwd_rows} rows a cluster, B and C at "
                                          f"B={WIDE_B} {plans[1].fwd_rows} / {plans[1].bwd_rows}; waves {waves}, the "
                                          f"card holding {slots} clusters (A, C) of {K.CLUSTER_ROWS} rows")
            x, w_ih, w_hh, bias, dy = lstm_inputs(WIDE_CHUNKS, dtype, dev, seed=w + 9, w=w)
            xb, dyb = x[:WIDE_B].contiguous(), dy[:WIDE_B].contiguous()
            with no_tf32():
                y0 = K.forward_kernel(x, w_ih, w_hh, bias)
                y, cprev = K.forward_train_kernel(xb, w_ih, w_hh, bias)
                grads = K.backward_kernel(xb, y, cprev, dyb, w_ih, w_hh, bias)
                torch.cuda.synchronize()
                ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                ref_g = lstm_backward(xb, y, cprev, dyb, w_ih, w_hh, bias)
            err_a = max_abs(y0, ref_y)
            err_b = max(max_abs(y, ref_y[:WIDE_B]), max_abs(cprev, ref_c[:WIDE_B]))
            rels = [rel_err(g, r) for g, r in zip(grads, ref_g)]
            check(err_a <= tol_a and err_b <= tol_b and max(rels) <= tol_c
                  and all(bool(torch.isfinite(g).all()) for g in (y0, y, *grads)),
                  f"{name} (B={WIDE_CHUNKS}: {plans[0].fwd_rows} rows a block, {plans[0].fwd_blocks} blocks) / "
                  f"{fname} / {bname} (B={WIDE_B}: {plans[1].fwd_rows} / {plans[1].bwd_rows} rows, "
                  f"{plans[1].n_chunks} dW chunks) at the main path's shapes, W={w} T={T}, vs plain: A "
                  f"{err_a:.3e}, B {err_b:.3e} max abs (tol {tol_a:.0e}); C rel "
                  f"{', '.join(f'{r:.2e}' for r in rels)} (tol {tol_c:.0e})")
            max_err[name] = max(max_err.get(name, 0.0), err_a)
            max_err[fname] = max(max_err.get(fname, 0.0), err_b)
            max_err[bname] = max(max_err.get(bname, 0.0), *(max_abs(g, r) for g, r in zip(grads, ref_g)))
            max_rel[bname] = max(max_rel.get(bname, 0.0), max(rels))
            del x, xb, dy, dyb, y0, y, cprev, grads, ref_y, ref_c, ref_g
            torch.cuda.empty_cache()


A_PLAIN_B = B_TRAIN  # rows of A's B_SERVE that wide_times holds (and times) its plain version on


def wide_times(K, dev, times: dict, max_err, max_rel) -> None:
    """The widths phase's timing at the base family's new widths (48:
    masked, 128: cluster, WIDE_CHANNELS = 512: wide), T=16000: A at B=512, B
    and C at B=128, fp32 and bf16, by CUDA events (2 calls after one); the
    plain versions at the same T (A's on its first A_PLAIN_B rows, its
    plain_batch; held_in_slices: in slices of rows where the card's memory
    refuses the batch), whose outputs are held against
    the kernels' (KERNEL_TOL; the worst errors go to max_err / max_rel);
    torch.nn.LSTM (cuDNN, the yardstick only; a batch the card's memory
    refuses in slices, see yardstick); the bound.  On the cluster path C's
    device ms by launch; on the wide path every kernel's device ms by launch
    (device_per_call, wide_parts), at capacity 48 C's (capacity_parts);
    the plan's window, rows a group, row
    groups and CTAs a group, and the scratch the call allocates beside its
    inputs and outputs (the caching allocator's peak over the call) beside
    the plan's count.  Printed and kept in times under the instantiation's
    name.  (The cluster path's widest, 256, is timed by ops/bench_lstm.py
    --width 256; cluster_scale_check holds its C at T=16000.)"""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for w in (96, 128, 256):
        k = -(-w // K.CLUSTER_UNITS)
        for dtype in (torch.float32, torch.bfloat16):
            slots = K._cluster_slots(dev.index or 0, dtype, w, w)
            # one CTA an SM, two for C's bf16 recurrence at up to 4 rows (its registers allow it)
            most = [[(2 if j == 1 and dtype == torch.bfloat16 and r <= 4 else 1) * sm_count // k
                     for r in K.CLUSTER_ROWS] for j in (0, 1)]
            check(all(1 <= n <= m for pair, bound in zip(slots, most) for n, m in zip(pair, bound)),
                  f"cluster path at {w} x {w} ({k} CTAs a cluster), {dtype}: clusters the card holds at once "
                  f"(A, C at rows {K.CLUSTER_ROWS}) {slots}, each at least 1 and at most {most} "
                  f"(one CTA an SM, two for C's bf16 recurrence at up to 4 rows)")

    def scratch_of(call, out_bytes: int) -> int:
        """Bytes the call allocates past its inputs and outputs (peak)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = call()
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base - out_bytes

    for w in (*BASE_CHANNELS, WIDE_CHANNELS):
        wide = K.is_wide(w)
        for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            name, fname, bname = (K.instantiation(k, dtype, w) for k in K.KERNELS)
            tol_a, tol_b, tol_c = (K.KERNEL_TOL[k, sfx] for k in K.KERNELS)
            elt = 2 if dtype == torch.bfloat16 else 4
            x, w_ih, w_hh, bias, _ = lstm_inputs(B_SERVE, dtype, dev, seed=w + 7, w=w)
            plan_a = K._plan_for(x, w)
            a_split = a_scratch = None
            with no_tf32():
                ms = cuda_ms(lambda: K.forward_kernel(x, w_ih, w_hh, bias), reps=2)
                if wide:
                    a_split = device_per_call(lambda: K.forward_kernel(x, w_ih, w_hh, bias),
                                              wide_parts(K, plan_a, "lstm_fwd", dtype, w))
                    a_scratch = scratch_of(lambda: K.forward_kernel(x, w_ih, w_hh, bias), B_SERVE * T * w * elt)
                y0 = K.forward_kernel(x, w_ih, w_hh, bias)
                finite = bool(torch.isfinite(y0).all())
                (err_a,), _, plain = held_in_slices(lambda i, j: (lstm_forward(x[i:j], w_ih, w_hh, bias),),
                                                    A_PLAIN_B, (y0[:A_PLAIN_B],), f"plain A {w} {sfx}")
                del y0
                torch.cuda.empty_cache()
                m = cudnn_lstm(w_ih, w_hh, bias, dtype, dev)
                with torch.inference_mode():
                    lib = yardstick(lambda r: cuda_ms(lambda: m(x[:r]), reps=2), f"nn.LSTM({w}) {sfx}", B_SERVE)
            rows = {name: (ms, plain, lib, B_SERVE, a_split, a_scratch, plan_a, "lstm_fwd")}
            del x, m
            torch.cuda.empty_cache()
            x, w_ih, w_hh, bias, dy = lstm_inputs(B_TRAIN, dtype, dev, seed=w + 8, w=w)
            plan_c = K._plan_for(x, w)
            f_split = f_scratch = b_split = b_scratch = None
            with no_tf32():
                y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
                f_ms = cuda_ms(lambda: K.forward_train_kernel(x, w_ih, w_hh, bias), reps=2)
                if wide:
                    f_split = device_per_call(lambda: K.forward_train_kernel(x, w_ih, w_hh, bias),
                                              wide_parts(K, plan_c, "lstm_fwd_train", dtype, w))
                    f_scratch = scratch_of(lambda: K.forward_train_kernel(x, w_ih, w_hh, bias),
                                           B_TRAIN * T * w * (elt + 4))
                grads = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
                b_ms = cuda_ms(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), reps=2)
                if wide:
                    b_split = device_per_call(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias),
                                              wide_parts(K, plan_c, "lstm_bwd", dtype, w))
                    b_scratch = scratch_of(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias),
                                           B_TRAIN * T * w * elt + 4 * (4 * w * 2 * w + 4 * w))
                else:
                    b_split = device_per_call(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias),
                                              cluster_parts(plan_c) if K.capacity(w) is None
                                              else capacity_parts(dtype))
                finite &= all(bool(torch.isfinite(g).all()) for g in (y, *grads))
                errs, _, f_plain = held_in_slices(lambda i, j: lstm_forward_train(x[i:j], w_ih, w_hh, bias),
                                                  B_TRAIN, (y, cprev), f"plain B {w} {sfx}")
                err_b = max(errs)
                torch.cuda.empty_cache()
                errs, refs, b_plain = held_in_slices(
                    lambda i, j: lstm_backward(x[i:j], y[i:j], cprev[i:j], dy[i:j], w_ih, w_hh, bias), B_TRAIN,
                    grads, f"plain C {w} {sfx}")
            rels = [e / (r + 1e-12) for e, r in zip(errs, refs)]
            err_c = max(errs)
            check(finite and err_a <= tol_a and err_b <= tol_b and max(rels) <= tol_c,
                  f"{name} (B={B_SERVE}) / {fname} / {bname} (B={B_TRAIN}) at W={w} T={T} vs plain: A "
                  f"{err_a:.3e}, B {err_b:.3e} max abs (tol {tol_a:.0e}); C rel "
                  f"{', '.join(f'{r:.2e}' for r in rels)} (tol {tol_c:.0e})")
            for n, e in ((name, err_a), (fname, err_b), (bname, err_c)):
                max_err[n] = max(max_err.get(n, 0.0), e)
            max_rel[bname] = max(max_rel.get(bname, 0.0), max(rels))
            del grads
            torch.cuda.empty_cache()
            with no_tf32():
                m = cudnn_lstm(w_ih, w_hh, bias, dtype, dev)
                xg = x.clone().requires_grad_()
                f_lib = yardstick(lambda r: cuda_ms(lambda: m(xg[:r]), reps=2), f"nn.LSTM({w}) {sfx} forward",
                                  B_TRAIN)

                def lib_backward(r):
                    ylib = m(xg[:r])[0]
                    return cuda_ms(lambda: torch.autograd.grad(ylib, [xg, *m.parameters()], dy[:r],
                                                               retain_graph=True), reps=2)
                b_lib = yardstick(lib_backward, f"nn.LSTM({w}) {sfx} backward", B_TRAIN)
            rows.update({fname: (f_ms, f_plain, f_lib, B_TRAIN, f_split, f_scratch, plan_c, "lstm_fwd_train"),
                         bname: (b_ms, b_plain, b_lib, B_TRAIN, b_split, b_scratch, plan_c, "lstm_bwd")})
            for n, (k_ms, p_ms, l_ms, b, split, scratch, plan, kernel) in rows.items():
                bms, by = bound_ms(n, b, width=w)
                row = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by, "library_ms": l_ms,
                       "width": w, "batch": b, "steps": T}
                if kernel == "lstm_fwd":
                    row["plain_batch"] = A_PLAIN_B
                if split:
                    row["split_ms"] = split
                bwd = kernel == "lstm_bwd"
                if wide:
                    row.update({"device_ms": split_total(split),
                                "window": plan.bwd_window if bwd else plan.fwd_window,
                                "rows_a_group": plan.bwd_rows if bwd else plan.fwd_rows,
                                "row_groups": plan.bwd_blocks if bwd else plan.fwd_blocks,
                                "ctas_a_group": plan.bwd_ctas if bwd else plan.fwd_ctas,
                                "scratch_bytes": scratch, "planned_scratch_bytes": plan.scratch_bytes(kernel)})
                times[n] = row
                split_text = ""
                if split:
                    head = f"device {fmt_ms(row['device_ms'], 3)}: " if wide else "device ms by launch: "
                    split_text = f" ({head}" + ", ".join(f"{part} {fmt_ms(v, 3)}" for part, v in split.items()) + ")"
                print(f"{n} W={w} B={b} T={T}: kernel {k_ms:.3f} ms{split_text}, plain {p_ms:.1f} ms"
                      f"{f' (its first {A_PLAIN_B} rows)' if kernel == 'lstm_fwd' else ''}, cuDNN "
                      f"nn.LSTM({w}) {l_ms} ms, bound {bms:.4f} ms ({by})"
                      + (f"; window {row['window']} steps, {row['rows_a_group']} rows a group, {row['row_groups']} "
                         f"groups of {row['ctas_a_group']} CTAs; scratch {scratch / 1e9:.3f} GB allocated (plan "
                         f"{row['planned_scratch_bytes'] / 1e9:.3f} GB)" if wide else ""), flush=True)
            del x, y, cprev, dy, m, xg
            torch.cuda.empty_cache()


def masked64_times(K, dev, times: dict, max_err, max_rel) -> None:
    """Kernels A (B=512), B and C (B=128) at MASKED64 x MASKED64, T=16000,
    on capacity 64 at runtime widths, which no main path runs since capacity
    48 took the widths 33..48: timed as wide_times times the base family's
    (the kernel by CUDA events, 2 calls after one; C's device ms by launch;
    the plain version held against it, A's on its first A_PLAIN_B rows;
    torch.nn.LSTM, the yardstick only; the bound), printed and kept in times
    under the instantiation's name; the worst errors go to max_err /
    max_rel."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_forward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    w = MASKED64
    for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        masked64_backward_time(K, dev, times, max_err, max_rel, dtype)
        for kernel, b in (("lstm_fwd", B_SERVE), ("lstm_fwd_train", B_TRAIN)):
            name, train = K.instantiation(kernel, dtype, w), kernel == "lstm_fwd_train"
            held_b = B_TRAIN if train else A_PLAIN_B
            x, w_ih, w_hh, bias, _ = lstm_inputs(b, dtype, dev, seed=w + b, w=w)
            kernel_fn = K.forward_train_kernel if train else K.forward_kernel
            with no_tf32():
                ms = cuda_ms(lambda: kernel_fn(x, w_ih, w_hh, bias), reps=2)
                got = kernel_fn(x, w_ih, w_hh, bias)
                got = got if train else (got,)
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                plain = ((lambda i, j: lstm_forward_train(x[i:j], w_ih, w_hh, bias)) if train
                         else (lambda i, j: (lstm_forward(x[i:j], w_ih, w_hh, bias),)))
                errs, _, plain_ms = held_in_slices(plain, held_b, tuple(g[:held_b] for g in got), f"plain {name}")
                del got
                torch.cuda.empty_cache()
                m = cudnn_lstm(w_ih, w_hh, bias, dtype, dev)
                if train:
                    xg = x.clone().requires_grad_()
                    lib = yardstick(lambda r: cuda_ms(lambda: m(xg[:r]), reps=2), f"nn.LSTM({w}) {sfx} forward", b)
                    del xg
                else:
                    with torch.inference_mode():
                        lib = yardstick(lambda r: cuda_ms(lambda: m(x[:r]), reps=2), f"nn.LSTM({w}) {sfx}", b)
            tol = K.KERNEL_TOL[kernel, sfx]
            check(finite and max(errs) <= tol and name.endswith("_masked"),
                  f"{name} (capacity 64 at {w} x {w}, B={b} T={T}) vs plain on {held_b} rows: max abs "
                  f"{max(errs):.3e} (tol {tol:.0e})")
            max_err[name] = max(max_err.get(name, 0.0), max(errs))
            bms, by = bound_ms(name, b, width=w)
            times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib,
                           "width": w, "batch": b, "steps": T, "plain_batch": held_b}
            print(f"{name} W={w} B={b} T={T}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms (its first {held_b} "
                  f"rows), cuDNN nn.LSTM({w}) {lib} ms, bound {bms:.4f} ms ({by})", flush=True)
            del x, m
            torch.cuda.empty_cache()


def masked64_backward_time(K, dev, times: dict, max_err, max_rel, dtype) -> None:
    """masked64_times' kernel C at MASKED64 x MASKED64, B=128, T=16000: the
    call by CUDA events (2 after one) and by launch, the plain backward held
    against it (KERNEL_TOL), nn.LSTM's backward (the yardstick only), the
    bound."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward
    from awm_tpu_torch.utils.precision import no_tf32

    w, b = MASKED64, B_TRAIN
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    name = K.instantiation("lstm_bwd", dtype, w)
    x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=w + b + 1, w=w)
    with no_tf32():
        y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
        call = lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
        grads = call()
        ms = cuda_ms(call, reps=2)
        split = device_per_call(call, capacity_parts(dtype))
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        errs, refs, plain_ms = held_in_slices(
            lambda i, j: lstm_backward(x[i:j], y[i:j], cprev[i:j], dy[i:j], w_ih, w_hh, bias), b, grads,
            f"plain {name}")
        del grads
        torch.cuda.empty_cache()
        m = cudnn_lstm(w_ih, w_hh, bias, dtype, dev)
        xg = x.clone().requires_grad_()

        def lib_backward(r):
            ylib = m(xg[:r])[0]
            return cuda_ms(lambda: torch.autograd.grad(ylib, [xg, *m.parameters()], dy[:r], retain_graph=True),
                           reps=2)
        lib = yardstick(lib_backward, f"nn.LSTM({w}) {sfx} backward", b)
    rels = [e / (r + 1e-12) for e, r in zip(errs, refs)]
    tol = K.KERNEL_TOL["lstm_bwd", sfx]
    check(finite and max(rels) <= tol and name.endswith("_masked"),
          f"{name} (capacity 64 at {w} x {w}, B={b} T={T}) vs plain: rel {', '.join(f'{r:.2e}' for r in rels)} "
          f"(tol {tol:.0e})")
    max_err[name] = max(max_err.get(name, 0.0), max(errs))
    max_rel[name] = max(max_rel.get(name, 0.0), max(rels))
    bms, by = bound_ms(name, b, width=w)
    times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib,
                   "width": w, "batch": b, "steps": T, "split_ms": split}
    print(f"{name} W={w} B={b} T={T}: kernel {ms:.3f} ms (device ms by launch: "
          + ", ".join(f"{part} {fmt_ms(v, 3)}" for part, v in split.items())
          + f"), plain {plain_ms:.1f} ms, cuDNN nn.LSTM({w}) backward {lib} ms, bound {bms:.4f} ms ({by})", flush=True)
    del x, y, cprev, dy, m, xg
    torch.cuda.empty_cache()


def held_in_slices(fn, batch: int, got: tuple, what: str) -> tuple[list, list, float]:
    """A plain version held against a kernel's outputs `got` at `batch`
    rows, and its time (ms, CUDA events): fn(i, j) runs rows i..j-1 (a
    tuple of outputs), in one call of all rows or, where the card's memory
    refuses it, in n calls of ceil(batch / n) rows, n = 2, 4, ... (printed).
    An output with a batch axis is compared slice by slice and dropped; the
    others (weight gradients) are summed in row order first.  Returns each
    output's max abs error and its plain value's max abs."""
    import torch

    n = 1
    while True:
        rows = -(-batch // n)
        errs, refs, sums, ms = [0.0] * len(got), [0.0] * len(got), [None] * len(got), 0.0
        try:
            for i in range(0, batch, rows):
                j = min(i + rows, batch)
                out, t_ms = timed_call(lambda: fn(i, j))
                ms += t_ms
                for k, o in enumerate(out):
                    if o.dim() == 3:
                        errs[k] = max(errs[k], max_abs(got[k][i:j], o))
                        refs[k] = max(refs[k], float(o.float().abs().max()))
                    else:
                        sums[k] = o if sums[k] is None else sums[k] + o
                del out
            break
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
            if rows == 1:
                raise
            n *= 2
    for k, total in enumerate(sums):
        if total is not None:
            errs[k], refs[k] = max_abs(got[k], total), float(total.abs().max())
    if n > 1:
        print(f"{what}: {n} calls of {rows} rows, {ms:.1f} ms in all", flush=True)
    return errs, refs, ms


def device_per_call(call, parts: dict[str, tuple[str, int]]) -> dict[str, float | None]:
    """Device ms of one call by part (a kernel-name fragment each, and its
    launches a call: the wide path launches its kernels once or more a
    window): device_split's mean over the launches a trace of two calls
    holds, times the part's launches (the profiler drops a launch now and
    then, most often a call's first); None where every trace missed the
    part."""
    split = device_split(call, {part: frag for part, (frag, _) in parts.items()}, reps=2)
    return {part: None if ms is None else ms * parts[part][1] for part, ms in split.items()}


def wide_parts(K, plan, kernel: str, dtype, width: int) -> dict[str, tuple[str, int]]:
    """Kernel A / B's or C's launches on the wide path, by a kernel-name
    fragment and its launches a call: the packing once, the projection (C:
    the gate pass, dx, dW) once a window, the recurrence once a window and
    row-group launch, C's sum once."""
    bwd = kernel == "lstm_bwd"
    window, rows, groups, ctas = ((plan.bwd_window, plan.bwd_rows, plan.bwd_blocks, plan.bwd_ctas) if bwd
                                  else (plan.fwd_window, plan.fwd_rows, plan.fwd_blocks, plan.fwd_ctas))
    wins = -(-T // window)
    per = dict(zip(K.WIDE_ROWS, K._wide_slots(0, dtype, width)[bwd]))[rows] // ctas
    recs = wins * -(-groups // per)
    if not bwd:
        return {"pack": ("lstm_wide_pack", 1), "xp": ("lstm_bwd_gates_", wins), "rec": ("lstm_wide_fwd_", recs)}
    # fp32's gate pass is two kernels a window (x's sums, then h's): device_split adds their means
    return {"pack": ("lstm_wide_pack", 1), "gates": ("lstm_bwd_gates_", wins), "rec": ("lstm_wide_bwd_", recs),
            "dx": ("lstm_bwd_dx_", wins), "dw": ("lstm_bwd_dw_", wins), "sum": ("lstm_bwd_sum_", 1)}


def wide_config(channels: int, compute_dtype: str):
    """The base preset at another channel count (LSTM(C, C)), compute dtype
    as given."""
    from awm_tpu_torch.config import get_config

    cfg = get_config("base")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, channels=channels),
                               train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype))


def grad_groups(state) -> dict:
    """{group: the norm of its gradients, as one vector} and the vectors."""
    import torch

    out = {}
    for group, pat in WIDE_GROUPS.items():
        gs = [p.grad.detach().float().cpu().reshape(-1) for net in ("gen", "det")
              for k, p in getattr(state, net).named_parameters()
              if re.search(pat, f"{net}.{k}") and p.grad is not None]
        out[group] = torch.cat(gs)
    return out


def family_holds(K, dev, label: str, nets, cfg_of, b: int, data: tuple, shaping=None) -> dict:
    """One family's runs on the card from the weights `nets` (the
    (generator, detector) pair): an embed+detect session of its chunks at
    bf16 and fp32, the first WIDE_HOLD_CHUNKS held against the CPU session
    (WIDE_SESSION_TOL); one train step at B = b, T = 16000 (finite terms),
    and one at that B, T = WIDE_HOLD_T, held against the same step on the
    CPU (WIDE_TRAIN_TOL).  cfg_of(compute dtype name) gives the config;
    data = (chunks, messages, train clips, hold clips, train messages).
    Returns the errors by run."""
    import torch

    from awm_tpu_torch import api
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.utils.precision import no_tf32

    chunks, msgs, clips, hold, tmsg = data
    clips, hold, tmsg = clips[:b], hold[:b], tmsg[:b]
    errs = {}
    for dt, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        with no_tf32():
            card = api.InferenceSession(*nets, compute_dtype=dt, shaping=shaping, device=dev).embed_detect(chunks, msgs)
            cpu = api.InferenceSession(*nets, compute_dtype=dt, shaping=shaping, device="cpu").embed_detect(
                chunks[:WIDE_HOLD_CHUNKS], msgs[:WIDE_HOLD_CHUNKS])
        e = {k: float(np.abs(card[k][:WIDE_HOLD_CHUNKS] - cpu[k]).max()) for k in cpu}
        e["delta_rms"] /= float(np.abs(cpu["delta_rms"]).max()) + 1e-12
        errs[f"session {label} {dname}"] = e
        tol = WIDE_SESSION_TOL[dname]
        check(all(np.isfinite(v).all() for v in card.values()) and card["msg_logit_mean"].shape == (len(chunks), 16)
              and all(e[k] <= tol[k] for k in tol),
              f"{label} {dname} session, {len(chunks)} chunks on the card, the first "
              f"{WIDE_HOLD_CHUNKS} vs the CPU: " + ", ".join(f"{k} {v:.2e}" for k, v in e.items())
              + f" (tol {tol}; delta_rms relative)")
    for dname in ("bfloat16", "float32"):
        cfg = cfg_of(dname)
        states = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            states[where] = tr.init_state(cfg, device=device)
            for name, net in zip(("gen", "det"), nets):
                getattr(states[where], name).load_state_dict(net.state_dict())
        with no_tf32():
            main = tr.init_state(cfg, device=dev)
            for name, net in zip(("gen", "det"), nets):
                getattr(main, name).load_state_dict(net.state_dict())
            t0 = time.perf_counter()
            terms = tr.train_step(cfg, main, clips.to(dev), message=tmsg.to(dev))
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            check(all(bool(torch.isfinite(v)) for v in terms.values()),
                  f"{label} {dname} train step, B={b} T={T} on the card: finite loss terms "
                  f"({step_s:.2f} s with the kernels' first calls)")
            got = {where: tr.train_step(cfg, states[where], hold.to(device), message=tmsg.to(device))
                   for where, device in (("card", dev), ("cpu", torch.device("cpu")))}
        terms_err = max(abs(float(got["card"][k]) - float(v)) / (abs(float(v)) + 1e-12)
                        for k, v in got["cpu"].items())
        ga, gb = grad_groups(states["card"]), grad_groups(states["cpu"])
        drift = {g: float((ga[g] - gb[g]).norm() / (gb[g].norm() + 1e-12)) for g in ga}
        errs[f"train {label} {dname}"] = {"terms": terms_err, **drift}
        tol = WIDE_TRAIN_TOL[dname]
        check(terms_err <= tol["terms"] and max(drift.values()) <= tol["drift"],
              f"{label} {dname} train step, B={b} T={WIDE_HOLD_T}, card vs CPU: loss terms "
              f"rel {terms_err:.2e} (tol {tol['terms']:.0e}); gradient drift "
              + ", ".join(f"{g} {v:.2e}" for g, v in drift.items()) + f" (tol {tol['drift']:.0e})")
        del states, main
        torch.cuda.empty_cache()
    return errs


def family_data():
    """The families' session chunks and messages, train and hold clips and
    train messages (family_holds' data)."""
    import torch

    return (speechlike(WIDE_CHUNKS, seed=80), np.random.default_rng(81).integers(0, 2**16, size=WIDE_CHUNKS),
            torch.from_numpy(speechlike(WIDE_B, seed=82)),
            torch.from_numpy(speechlike(WIDE_B, seed=83, chunk=WIDE_HOLD_T)),
            torch.from_numpy(np.random.default_rng(84).integers(0, 2**16, size=WIDE_B)))


def plain_counted(K):
    """Wrap the plain LSTM versions that lstm_kernel routes CPU tensors to so
    that a call on a CUDA tensor is recorded: (the list of such calls, a
    function that restores them)."""
    on_card, wrapped = [], {}
    for fn_name in ("lstm_forward", "lstm_forward_train", "lstm_backward"):
        fn = wrapped[fn_name] = getattr(K, fn_name)

        def counted(*args, _fn=fn, _name=fn_name):
            if args[0].is_cuda:
                on_card.append(_name)
            return _fn(*args)
        setattr(K, fn_name, counted)

    def restore():
        for fn_name, fn in wrapped.items():
            setattr(K, fn_name, fn)
    return on_card, restore


def strided_hidden_family(K, launches, dev) -> dict:
    """The strided family at hidden_dim STRIDED_HIDDEN (two LSTM(24, 24)
    over 50 steps a chunk: capacity 32 masked, the short forward and the
    fused backward), checkpoint.seeded_flax_tree weights, counters zeroed
    just before: family_holds' session of WIDE_CHUNKS chunks and train step
    at B = WIDE_B, against the CPU.  Every capacity-32 masked instantiation
    must launch, the plan of the session's and the train step's shapes must
    take the short and the fused paths, and no plain version may run on a
    CUDA tensor.  Returns the errors."""
    import torch

    from awm_tpu_torch.config import get_config

    scfg = get_config("strided")
    cfg_of = lambda dname: dataclasses.replace(
        scfg, model=dataclasses.replace(scfg.model, hidden_dim=STRIDED_HIDDEN),
        train=dataclasses.replace(scfg.train, compute_dtype=dname))
    zero_counts(K)
    on_card, restore = plain_counted(K)
    try:
        nets = seeded_nets(cfg_of("float32"), seed=STRIDED_HIDDEN)
        errs = family_holds(K, dev, f"strided family hidden_dim {STRIDED_HIDDEN}", nets, cfg_of, WIDE_B,
                            family_data(), shaping=scfg.shaping)
    finally:
        restore()
    steps = T // int(np.prod(scfg.model.strides))
    idx = dev.index or 0
    for dt in (torch.float32, torch.bfloat16):
        session, train = (K.device_plan(b, steps, dt, idx, STRIDED_HIDDEN) for b in (WIDE_CHUNKS, WIDE_B))
        short = dt in K.MASKED_SHORT_DTYPES
        check(session.fwd_short == train.fwd_short == short and train.bwd_fused,
              f"strided hidden_dim {STRIDED_HIDDEN} {dt}: the plan at T={steps} takes the "
              f"{'short' if short else 'ring'} forward (B={WIDE_CHUNKS}, {WIDE_B}) and the fused backward "
              f"(B={WIDE_B})")
        for k in K.KERNELS:
            name = K.instantiation(k, dt, STRIDED_HIDDEN)
            check(name.endswith("_w32_masked") and K.launches[name] > 0,
                  f"{name} launched {K.launches[name]} times by the strided family at hidden_dim {STRIDED_HIDDEN}")
    check(not on_card, f"no plain LSTM version ran on a CUDA tensor in the strided hidden_dim {STRIDED_HIDDEN} "
                       f"runs ({len(on_card)} calls: {sorted(set(on_card))})")
    add_counts(K, launches, f"strided hidden_dim {STRIDED_HIDDEN}")
    return errs


def wide_family(K, launches, dev) -> dict:
    """The base family at channels 48 (LSTM(48, 48): capacity 48's squares),
    128 (LSTM(128, 128): the cluster path) and 512 (LSTM(512, 512): the
    wide path), seeded_flax_tree weights, with the counters zeroed just
    before: an embed+detect session of WIDE_CHUNKS chunks at bf16 and fp32,
    its first chunks held against the CPU session; one train step at
    B=WIDE_B (WIDE_PATH_B at 512), T=16000, bf16 and fp32 (finite terms),
    and one at that B, T=WIDE_HOLD_T held against the same step on the CPU.
    The plain versions are counted on CUDA tensors: none may run.  Returns
    the errors."""
    import torch

    zero_counts(K)
    plain_on_card, restore = plain_counted(K)
    errs = {}
    data = family_data()
    try:
        for c in (*BASE_CHANNELS, WIDE_CHANNELS):
            nets = seeded_nets(wide_config(c, "float32"), seed=c)
            errs.update(family_holds(K, dev, f"base family C={c}", nets, lambda dname, c=c: wide_config(c, dname),
                                     WIDE_PATH_B if c == WIDE_CHANNELS else WIDE_B, data))
    finally:
        restore()
    new = [K.instantiation(k, dt, c) for c in (*BASE_CHANNELS, WIDE_CHANNELS) for k in K.KERNELS
           for dt in (torch.float32, torch.bfloat16)]
    for name in new:
        check(K.launches[name] > 0, f"{name} launched {K.launches[name]} times by the base family at channels "
                                    f"{'/'.join(map(str, (*BASE_CHANNELS, WIDE_CHANNELS)))}")
    check(not plain_on_card, f"no plain LSTM version ran on a CUDA tensor in the base family's runs "
                             f"({len(plain_on_card)} calls: {sorted(set(plain_on_card))})")
    add_counts(K, launches, "widths phase")
    return errs


CLUSTER_SCALE_B, CLUSTER_SCALE_SLICE = 512, 128  # A's serving batch; the plain version's rows at once


def cluster_scale_check(K, dev, max_err, max_rel) -> None:
    """Kernel C on the cluster path at its widest, D = H = 256, bf16, B =
    CLUSTER_SCALE_B, T = 16000: the call's operands fit the card (~25 GB),
    and its windows keep the scratch it allocates within
    CLUSTER_SCRATCH_BYTES (for all T the gate pass's records alone were 67
    GB: the call raised torch.OutOfMemoryError); held against lstm_backward
    in slices of CLUSTER_SCALE_SLICE rows (dx by rows; dW and db the slices'
    sums) at KERNEL_TOL."""
    import torch

    from awm_tpu_torch.ops.lstm import lstm_backward
    from awm_tpu_torch.utils.precision import no_tf32

    b, w, dtype = CLUSTER_SCALE_B, K.CLUSTER_MAX_WIDTH, torch.bfloat16
    bname = K.instantiation("lstm_bwd", dtype, w)
    x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=5120, w=w)
    plan = K._plan_for(x, w)
    t0 = time.time()
    with no_tf32():
        y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - base - sum(g.numel() * g.element_size() for g in got)
        kernel_s = time.time() - t0
        dx_err, dx_ref, sums = 0.0, 0.0, None
        for r0 in range(0, b, CLUSTER_SCALE_SLICE):
            rows = slice(r0, r0 + CLUSTER_SCALE_SLICE)
            ref = lstm_backward(x[rows], y[rows], cprev[rows], dy[rows], w_ih, w_hh, bias)
            dx_err = max(dx_err, max_abs(got[0][rows], ref[0]))
            dx_ref = max(dx_ref, float(ref[0].float().abs().max()))
            sums = list(ref[1:]) if sums is None else [a + r for a, r in zip(sums, ref[1:])]
            del ref
    rels = [dx_err / (dx_ref + 1e-12)] + [rel_err(a, r) for a, r in zip(got[1:], sums)]
    max_rel[bname] = max(max_rel.get(bname, 0.0), max(rels))
    tol = K.KERNEL_TOL["lstm_bwd", "bf16"]
    check(max(rels) <= tol and scratch <= K.CLUSTER_SCRATCH_BYTES and plan.bwd_window < T,
          f"{bname} at {w} x {w}, B={b} T={T}: {-(-T // plan.bwd_window)} windows of {plan.bwd_window} steps, "
          f"scratch {scratch / 1e9:.3f} GB allocated (budget {K.CLUSTER_SCRATCH_BYTES / 1e9:.3f} GB; all T's records "
          f"{b * T * w * K.CLUSTER_REC * 4 / 1e9:.1f} GB), B + C {kernel_s:.1f} s; vs plain in slices of "
          f"{CLUSTER_SCALE_SLICE} rows: dx, dW_ih, dW_hh, db rel {', '.join(f'{r:.2e}' for r in rels)} (tol {tol:.0e})")
    del x, y, cprev, dy, got, sums
    torch.cuda.empty_cache()


def gates_checks(K, dev) -> None:
    """C's wide fp32 gate pass reproduces the gates kernel B formed, bit for
    bit, at ops/bench_lstm.py's GATES_CASES (its --gates: lstm_wide.cu built
    with -DAWM_WIDE_GATES=1, which main starts building beside the port's
    libraries)."""
    import torch

    from awm_tpu_torch.ops.bench_lstm import GATES_CASES, gates_check

    differ = gates_check(torch, K, ".", torch.cuda.get_device_name(dev))
    check(differ == 0, f"C's wide fp32 gate pass vs kernel B's gates at {len(GATES_CASES)} cases (rows 1-64, whole "
                       f"and chunked h, a tiled group, H = 512, 300, 257, 600, 40): {differ} differ in any bit")


def widths_phase(K, launches, dev, max_err, max_rel, times) -> dict:
    """Phase 4b: wide_checks, rows_checks, gates_checks, cluster_scale_check,
    wide_main_checks, wide_times, masked64_times, then wide_family and
    strided_hidden_family, each with the counters zeroed just before (the
    functions take only K, launches and dev beside what they fill, so a
    card-side rehearsal can call them alone)."""
    laps = [("checks", time.time())]
    wide_checks(K, dev, max_err, max_rel)
    laps.append(("rows", time.time()))
    rows_checks(K, dev, max_err, max_rel)
    laps.append(("gates", time.time()))
    gates_checks(K, dev)
    laps.append(("cluster at scale", time.time()))
    cluster_scale_check(K, dev, max_err, max_rel)
    laps.append(("main shapes", time.time()))
    wide_main_checks(K, dev, max_err, max_rel)
    laps.append(("timed shapes", time.time()))
    wide_times(K, dev, times, max_err, max_rel)
    laps.append(("masked 64 timed", time.time()))
    masked64_times(K, dev, times, max_err, max_rel)
    laps.append(("family", time.time()))
    errs = wide_family(K, launches, dev)
    laps.append(("strided hidden_dim 24", time.time()))
    errs.update(strided_hidden_family(K, launches, dev))
    laps.append(("end", time.time()))
    print("widths phase s: " + ", ".join(f"{label} {t1 - t0:.1f}" for (label, t0), (_, t1) in zip(laps, laps[1:])),
          flush=True)
    return errs


# entry() on the card vs the same weights and inputs on the CPU (the plain
# LSTM there): fp32 compute, two correct fp32 forwards in other summation
# orders, kernel A's recurrence over 16000 steps from the seed-0 init;
# bf16 (the preset's), each conv's output rounded to bf16 after cuDNN's or
# the CPU's own summation order, so a value near a rounding boundary lands
# one ulp (2e-3-4e-3 at the outputs' scale) over: tests/test_torch_entry.py's
# bf16 bounds against the JAX package.  (s_w max abs, logits max abs, logits
# mean abs).
ENTRY_CARD_TOL = {"float32": (1e-4, 1e-3, 1e-5), None: (2e-2, 2e-2, 2e-3)}


def entry_phase(K, launches, dev) -> dict:
    """Phase 4a: entry() (awm_tpu_torch/entry.py) on the card,
    counters zeroed just before: its example arguments' contract shapes,
    then four speech-like clips through its forward at the preset's bf16
    and at fp32 compute, each against entry(device="cpu") on the same
    inputs (the same seed-0 weights), and kernel A at width 64 launched in
    both types.  Returns the errors."""
    import torch

    from awm_tpu_torch.entry import entry

    zero_counts(K)
    s = torch.from_numpy(speechlike(4, seed=70))
    msg = torch.from_numpy(np.random.default_rng(71).integers(0, 2**16, 4))
    errs = {}
    for compute_dtype in (None, "float32"):
        label = compute_dtype or "bf16 (preset)"
        fn, (s0, m0) = entry(device=dev, compute_dtype=compute_dtype)
        sw0, lg0 = fn(s0, m0)
        torch.cuda.synchronize()
        check(s0.device.type == "cuda" and tuple(sw0.shape) == (4, T) and tuple(lg0.shape) == (8, T, 17)
              and bool(torch.isfinite(lg0).all()),
              f"entry() {label} on the card: example args {tuple(s0.shape)} {tuple(m0.shape)} -> s_w "
              f"{tuple(sw0.shape)}, logits {tuple(lg0.shape)}, finite")
        sw, lg = (a.cpu() for a in fn(s.to(dev), msg.to(dev)))
        fn_cpu, _ = entry(device="cpu", compute_dtype=compute_dtype)
        sw_c, lg_c = fn_cpu(s, msg)
        e_lg = (lg - lg_c).abs()
        errs[label] = {"s_w": float((sw - sw_c).abs().max()), "logits": float(e_lg.max()),
                       "logits_mean": float(e_lg.mean())}
        tol = ENTRY_CARD_TOL[compute_dtype]
        check(all(e <= t for e, t in zip(errs[label].values(), tol)),
              f"entry() {label}, 4 speech-like clips, card vs CPU: s_w max abs {errs[label]['s_w']:.2e}, "
              f"logits max abs {errs[label]['logits']:.2e}, mean {errs[label]['logits_mean']:.2e} "
              f"(tol {tol})")
        del fn, fn_cpu
    for dtype in (torch.bfloat16, torch.float32):
        name = K.instantiation("lstm_fwd", dtype, 64)
        check(K.launches[name] > 0, f"entry(): {name} (kernel A, width 64) launched {K.launches[name]} times")
    add_counts(K, launches, "entry phase")
    torch.cuda.empty_cache()
    return errs


# The dry run's fp32 step on the card against the same step on the CPU (its
# ranks on the card and on the host, the same seed-0 init, batch and drawn
# messages): loss terms relative (summation order only: the CPU's 4-rank
# step is within 1e-5 of the JAX package's, tests/test_torch_entry.py);
# gradients as groups, ||g - g_cpu|| / ||g_cpu||, within the bound that the
# CPU test holds the encoder's to (a 1e-6 change of the input moves it by
# 1.1e-3 there): the generator's encoder, its LSTM (kernels B and C at width
# 64), the rest of the generator, the detector.
DRY_CARD_TOL = {"terms": 1e-4, "drift": 5e-3}
DRY_GROUPS = {"gen.enc": r"^grad\.gen\.enc_", "gen.lstm": r"^grad\.gen\.lstm\.",
              "gen, the rest": r"^grad\.gen\.(?!enc_|lstm\.)", "det": r"^grad\.det\."}


def dryrun_phase(K, launches) -> dict:
    """Phase 13a: entry.dryrun_multichip(4), four ranks over gloo on the one
    card, mesh (2, 2), counters zeroed just before (the ranks report their
    own counts): the preset's bf16 step with the table sharded, then the
    sharded LSTM gradient at width 16 within 1e-4.  Every rank must have
    launched kernels B and C at width 64 (bf16, the step) and at width 16
    (fp32, the gradient check: one call each, and this card's plan for a
    rank's shard takes the short path and the fused backward, one
    cooperative launch a call).  Then the same dry run at fp32 on the card
    and on the CPU (entry.run_dry, rank 0's gradients kept), held together
    by DRY_CARD_TOL; its launches are a comparison's and are not counted.
    Returns the dry run's numbers."""
    import torch

    from awm_tpu_torch.entry import dry_spec, dryrun_multichip, run_dry

    zero_counts(K)
    torch.cuda.empty_cache()
    t0 = time.time()
    res = dryrun_multichip(4, "cuda")
    wall = time.time() - t0
    want = [K.instantiation(k, dt, w) for k in ("lstm_fwd_train", "lstm_bwd")
            for dt, w in ((torch.bfloat16, 64), (torch.float32, W16))]
    # each rank's gradient check: B then C once at width 16 on its data shard,
    # on the short path and the fused one by this card's plan
    w16 = [K.instantiation(k, torch.float32, W16) for k in ("lstm_fwd_train", "lstm_bwd")]
    shard = 4 // res["mesh"]["data"]  # entry.lstm_check_inputs(4): x (4, T, 16) over the data axis
    plan = K.device_plan(shard, DRY_T, torch.float32, torch.cuda.current_device(), W16)
    for r, counts in enumerate(res["launches"]):
        check(all(counts[n] > 0 for n in want) and all(counts[n] == 1 for n in w16),
              f"dry run rank {r}: {', '.join(f'{n} {counts[n]}' for n in want)} (width 16: one call each)")
        for name, n in counts.items():
            launches[name] += n
    check(plan.fwd_short and plan.bwd_fused and plan.bwd_blocks == shard,
          f"dry run: a rank's width-16 gradient check (B={shard}, T={DRY_T}, fp32) takes {fwd_kernel_name(plan)} "
          f"and kernel C {'in one cooperative launch' if plan.bwd_fused else 'in four launches'} of "
          f"{plan.bwd_blocks} block(s) on this card")
    check(res["mesh"] == {"data": 2, "model": 2} and np.isfinite(res["loss"]) and res["lstm_grad_err"] < 1e-4,
          f"dryrun_multichip(4) on the card in {wall:.1f} s: mesh {res['mesh']}, loss {res['loss']:.4f}, table "
          f"rows {res['table_rows']}, sharded LSTM grad err {res['lstm_grad_err']:.2e} (tol 1e-4)")

    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        runs = {}
        for device in ("cuda", "cpu"):
            out = os.path.join(d, device)
            runs[device] = run_dry(dry_spec(4, device, out, compute_dtype="float32", keep=True), timeout=600)
            with np.load(os.path.join(out, "state.npz")) as f:
                runs[device]["grads"] = {k: f[k].astype(np.float64) for k in f.files if k.startswith("grad.")}
    card, cpu = runs["cuda"], runs["cpu"]
    f32 = [K.instantiation(k, torch.float32, 64) for k in ("lstm_fwd_train", "lstm_bwd")]
    check(all(counts[n] > 0 for counts in card["launches"] for n in f32),
          f"fp32 dry run on the card: every rank launched {', '.join(f32)}")
    terms = {k: abs(card["terms"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["terms"].items()}
    drift = {}
    for group, pattern in DRY_GROUPS.items():
        names = [k for k in cpu["grads"] if re.search(pattern, k)]
        diff = sum(float(np.square(card["grads"][k] - cpu["grads"][k]).sum()) for k in names)
        drift[group] = (diff / sum(float(np.square(cpu["grads"][k]).sum()) for k in names)) ** 0.5
    check(sorted(card["grads"]) == sorted(cpu["grads"]) and max(terms.values()) <= DRY_CARD_TOL["terms"]
          and max(drift.values()) <= DRY_CARD_TOL["drift"],
          f"fp32 dry run, card vs CPU ({time.time() - t0:.1f} s): loss {card['loss']:.6f} vs {cpu['loss']:.6f}, "
          f"terms max rel err {max(terms.values()):.2e} (tol {DRY_CARD_TOL['terms']:.0e}); gradient drift "
          f"{', '.join(f'{g} {v:.2e}' for g, v in drift.items())} (tol {DRY_CARD_TOL['drift']:.0e})")
    return {**{k: res[k] for k in ("mesh", "loss", "table_rows", "lstm_grad_err")}, "wall_s": wall,
            "fp32_card_vs_cpu": {"terms_rel": max(terms.values()), "drift": drift}}


MEM_B = 256  # the bench's base preset, the largest train batch that fit before BatchNorm's Function (PERF.md 5)
MEM_B_LARGE = 512  # the batch that ran out of memory before it


def peak_live(trace: list) -> tuple[int, list]:
    """(index of the peak, [(index, size, frames) of each block live there])
    from a device trace of torch.cuda.memory._snapshot(): allocations
    replayed in order, each freed at its free_completed; blocks allocated
    before the recording began are not in it."""
    live, total, peak, at = {}, 0, -1, 0
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev["size"]
            total += ev["size"]
            if total > peak:
                peak, at = total, i
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])
    live = {}
    for i, ev in enumerate(trace[:at + 1]):
        if ev["action"] == "alloc":
            live[ev["addr"]] = (i, ev["size"], ev.get("frames", []))
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    return at, list(live.values())


def port_frame(frames: list, port: str = "awm_tpu_torch") -> str:
    """The innermost frame of the port's own files, as file:line function."""
    for f in frames:
        name = f.get("filename", "")
        if port in name:
            return f"{name[name.index(port):]}:{f.get('line')} {f.get('name')}"
    return "(no frame of the port)"


# C++ frames of an allocation that belong to the recorder and the caching
# allocator, not to the op that asked for the block; and those of ATen's
# factories and dispatch, between the op and the allocator.
RECORDER = re.compile(r"torch::unwind|CapturedTraceback|gather_with_cpp|CUDACachingAllocator")
FACTORY = re.compile(r"empty|create_out|set_output|TensorIterator|::meta::|wrap_kernel_functor|at::_ops::"
                     r"|c10::impl::|VariableType")


def aten_frame(frames: list, past_factories: bool = True) -> str:
    """The innermost C++ frame beyond the recorder and the allocator, and
    past ATen's factories and dispatch unless past_factories is False (then
    an ATen factory such as at::detail::empty_generic, or the cuDNN caller
    that allocates its own workspace): its function's name only."""
    for f in frames:
        name = f.get("name", "")
        if (name and name != "??" and not RECORDER.search(name) and not f.get("filename", "").endswith(".py")
                and not (past_factories and FACTORY.search(name))):
            return re.sub(r"\(.*", "", name.replace("(anonymous namespace)::", ""))
    return "(no C++ frame)"


def backward_kind(frames: list) -> str:
    """What a block the backward allocates is: cuDNN's workspace (allocated
    by the cuDNN convolution code itself), a layout copy made for a cuDNN
    call (a clone / contiguous / copy under a convolution), a convolution's
    gradient, or the gradient that an autograd node computes (its name)."""
    names = " ".join(f.get("name", "") for f in frames)
    if "convolution" in names or "cudnn" in names:
        if re.search("cudnn|conv", aten_frame(frames, past_factories=False), re.I):
            return "cuDNN workspace"
        if re.search(r"native::(clone|contiguous|_to_copy|copy_)", names):
            return "layout copies for cuDNN"
        return "convolution gradients"
    node = re.search(r"torch::autograd::generated::(\w+)::apply", names)
    return f"gradient of {node.group(1)}" if node else "other"


def memory_phase(dev) -> dict:
    """Phase 16a: where the train step's peak memory goes.  One bf16 step of
    the bench's base preset (its seed-0 init) at B=MEM_B, recorded with
    torch.cuda.memory._record_memory_history (Python and C++ stacks) after
    a warm-up step; the blocks live at the trace's peak split into what was
    there before the step (weights, Adam moments), what the forward
    allocated and is still live (what autograd saved, kernel B's c_{t-1}),
    the LSTM backward's scratch (kernel C's da and partials) and the rest of
    the backward by backward_kind: cuDNN's workspace, layout copies for
    cuDNN, convolution gradients, each autograd node's gradients; the ten
    largest groups by the innermost frame of the port's files (the
    forward's) or by autograd node and innermost ATen frame (the
    backward's, whose engine thread has no Python frame), GiB; the most of
    cuDNN's workspace and of its layout copies live at once anywhere in the
    backward; beside it the bytes autograd saves for the backward, read off
    its saved-tensor hooks in a forward of the same batch and counted once
    per storage, grouped by shape, and the part BatchNorm's forwards save.
    The backward's start is a marker block that a wrapped Tensor.backward
    allocates for the recorded step.  Then the same preset's bf16 step at
    B=MEM_B_LARGE: its peak memory and seconds a step (after a warm-up)."""
    import torch

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.config import get_config
    from awm_tpu_torch.models.layers import BatchNorm

    os.environ.setdefault("TORCH_SYMBOLIZE_MODE", "fast")  # torch's own ELF reader: seconds, not minutes
    cfg = get_config("base")
    state = tr.init_state(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    s = torch.from_numpy((0.3 * rng.standard_normal((MEM_B, cfg.audio_len))).astype(np.float32)).to(dev)
    tr.train_step(cfg, state, s)  # warm-up: Adam's moments exist from here on
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backward = torch.Tensor.backward

    def marked_backward(self, *args, **kw):
        marker = torch.empty(1, device=dev)  # its alloc event names this function
        backward(self, *args, **kw)
        del marker

    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="all")
    torch.Tensor.backward = marked_backward
    try:
        tr.train_step(cfg, state, s)
        torch.cuda.synchronize()
    finally:
        torch.Tensor.backward = backward
    t0 = time.time()
    snap = torch.cuda.memory._snapshot()
    snap_s = time.time() - t0
    torch.cuda.memory._record_memory_history(enabled=None)
    peak_bytes = torch.cuda.max_memory_allocated()
    trace = snap["device_traces"][dev.index or 0]
    at, blocks = peak_live(trace)
    start_bwd = next((i for i, ev in enumerate(trace) if ev["action"] == "alloc"
                      and any(f.get("name") == "marked_backward" for f in ev.get("frames", []))), len(trace))
    gib = 2.0**-30
    groups: dict[str, int] = {}
    split = {"before the step (weights, Adam moments, BN statistics)": base, "forward, still live (saved)": 0,
             "LSTM c_{t-1} (kernel B)": 0, "LSTM backward scratch (kernel C: da, partials)": 0,
             "backward, the rest": 0}
    kinds: dict[str, int] = {}
    for i, size, frames in blocks:
        names = {f.get("name", "") for f in frames}
        if i > start_bwd and not names & {"backward_kernel", "lstm_backward"}:
            kind = backward_kind(frames)
            kinds[kind] = kinds.get(kind, 0) + size
            key = f"(backward) {kind}: {aten_frame(frames)}"
        else:
            key = port_frame(frames)
        groups[key] = groups.get(key, 0) + size
        if names & {"forward_train_kernel", "lstm_forward_train"}:
            split["LSTM c_{t-1} (kernel B)"] += size
        elif names & {"backward_kernel", "lstm_backward"}:
            split["LSTM backward scratch (kernel C: da, partials)"] += size
        elif i > start_bwd:
            split["backward, the rest"] += size
        else:
            split["forward, still live (saved)"] += size
    # cuDNN's workspace and layout copies live at once, anywhere in the backward
    live, now, most = {}, {}, {}
    for ev in trace[start_bwd:]:
        if ev["action"] == "alloc":
            kind = backward_kind(ev.get("frames", []))
            live[ev["addr"]] = (kind, ev["size"])
            now[kind] = now.get(kind, 0) + ev["size"]
            most[kind] = max(most.get(kind, 0), now[kind])
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            kind, size = live.pop(ev["addr"])
            now[kind] -= size
    print(f"memory of one bf16 train step, base preset at its seed-0 init, B={MEM_B}: peak "
          f"{peak_bytes * gib:.2f} GiB (max_memory_allocated); at the trace's peak (event {at} of {len(trace)}) "
          f"{(base + sum(sz for _, sz, _ in blocks)) * gib:.2f} GiB live, {base * gib:.2f} of it before the step; "
          f"the backward from event {start_bwd}; C++ stacks symbolized in {snap_s:.1f} s",
          flush=True)
    for part, size in split.items():
        print(f"  {size * gib:8.3f} GiB  {part}", flush=True)
    for kind in ("cuDNN workspace", "layout copies for cuDNN", "convolution gradients"):
        kinds.setdefault(kind, 0)
    print("  the backward's blocks at the peak, by kind (backward_kind):", flush=True)
    for kind, size in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {size * gib:8.3f} GiB  {kind}", flush=True)
    print("  the most live at once anywhere in the backward: " + ", ".join(
        f"{kind} {most.get(kind, 0) * gib:.3f} GiB" for kind in ("cuDNN workspace", "layout copies for cuDNN",
                                                                 "convolution gradients")), flush=True)
    top = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
    print("  the ten largest groups of blocks live at the peak, by the innermost frame of the port (forward) "
          "or autograd node and ATen frame (backward):", flush=True)
    for key, size in top:
        print(f"  {size * gib:8.3f} GiB  {key}", flush=True)

    # what autograd saves: one forward and the loss of the same batch under
    # saved-tensor hooks, each storage counted once
    seen, by_shape, in_bn, bn_saved = set(), {}, [False], [0]

    def pack(t):
        key = (t.untyped_storage().data_ptr(), t.device.type)
        if t.device.type == "cuda" and key not in seen:
            seen.add(key)
            nbytes = t.untyped_storage().nbytes()
            sk = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            by_shape[sk] = by_shape.get(sk, 0) + nbytes
            bn_saved[0] += nbytes if in_bn[0] else 0
        return t

    bn_forward = BatchNorm.forward

    def tagged(self, x):
        in_bn[0] = True
        try:
            return bn_forward(self, x)
        finally:
            in_bn[0] = False

    BatchNorm.forward = tagged
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), tr._precision(cfg):
            message = tr.draw_messages(cfg, MEM_B, torch.Generator().manual_seed(0), dev)
            delta, s_w, logits = tr._forward(cfg, state.gen, state.det, s, message, train=True)
            terms = tr._terms(cfg, s, delta, s_w, logits, message)
    finally:
        BatchNorm.forward = bn_forward
    saved = sum(by_shape.values())
    act = MEM_B * cfg.audio_len
    print(f"  autograd saves {saved * gib:.3f} GiB in this forward ({len(seen)} storages; B x T = {act} samples, "
          f"{saved / act:.0f} bytes a sample); the largest by (shape, dtype):", flush=True)
    for (shape, dt), size in sorted(by_shape.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {size * gib:8.3f} GiB  {shape} {dt}", flush=True)
    print(f"  of it BatchNorm's forwards save {bn_saved[0] * gib:.3f} GiB (their inputs in their own dtype, "
          f"each storage once)", flush=True)
    del terms, delta, s_w, logits, s
    torch.cuda.empty_cache()
    # the step at the batch that ran out of memory before BatchNorm saved only its input
    s = torch.from_numpy((0.3 * rng.standard_normal((MEM_B_LARGE, cfg.audio_len))).astype(np.float32)).to(dev)
    tr.train_step(cfg, state, s)  # warm-up at this shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.train_step(cfg, state, s)
    torch.cuda.synchronize()
    large = {"batch": MEM_B_LARGE, "peak_gib": torch.cuda.max_memory_allocated() * gib,
             "step_s": time.perf_counter() - t0}
    large["clips_per_s"] = MEM_B_LARGE / large["step_s"]
    print(f"bf16 train step, base preset, B={MEM_B_LARGE}: peak {large['peak_gib']:.2f} GiB, "
          f"{large['step_s']:.3f} s ({large['clips_per_s']:.1f} clips/s)", flush=True)
    del state, s
    torch.cuda.empty_cache()
    return {"peak_gib": peak_bytes * gib, "split_gib": {k: v * gib for k, v in split.items()},
            "backward_gib": {k: v * gib for k, v in kinds.items()},
            "backward_most_live_gib": {k: v * gib for k, v in most.items()},
            "top_groups_gib": {k: v * gib for k, v in top}, "saved_by_autograd_gib": saved * gib,
            "batchnorm_saved_gib": bn_saved[0] * gib, "large_batch": large}


def rank_main(argv: list) -> int:
    """The processes that phases 13-15 start: under torchrun ``cli-rank OUT
    ARGV...`` and ``parallel-rank OUT DEVICE CHUNK CARD_FREE``; ``counted LOG
    -m MODULE ARGS...``."""
    if argv[0] == "cli-rank":
        cli_rank(argv[1], argv[2:])
    elif argv[0] == "parallel-rank":
        parallel_rank(*argv[1:])
    elif argv[0] == "counted":
        counted(argv[1], argv[2:])
    else:
        print(f"chip_smoke: unknown mode {argv[0]!r}; run it with no arguments", file=sys.stderr)
        return 2
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch; nothing to run", file=sys.stderr)
        return 1
    from awm_tpu_torch import api
    from awm_tpu_torch import eval as ev
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.augment import AugmentConfig, apply_augment, draw_augment, resample_roundtrip
    from awm_tpu_torch.dsp import (alaw_roundtrip, filters, lowpass_biquad, lowpass_biquad_coeffs,
                                   mulaw_roundtrip, quantize_int16)
    from awm_tpu_torch.__main__ import main as cli
    from awm_tpu_torch.checkpoint import ASSETS, SHAPECAP_NPZ, load_npz, variables_from_flax
    from awm_tpu_torch.ops import lstm_kernel as K
    from awm_tpu_torch.ops.bench_lstm import fit_line
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward, lstm_forward_train
    from awm_tpu_torch.utils.precision import no_tf32

    dev = torch.device("cuda")
    t_start = time.time()
    laps, last = {}, t_start

    def lap(label: str) -> None:
        """Print and keep the seconds since the previous lap."""
        nonlocal last
        now = time.time()
        laps[label], last = round(now - last, 1), now
        print(f"== phase {label}: {laps[label]:.1f} s", flush=True)
    KERNELS.update(kernel_table(K))

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build (and, beside it, lstm_wide.cu for phase 4b's gates check)
    from awm_tpu_torch.ops import cuda_build

    gates_build = threading.Thread(target=cuda_build.build_all, args=(["lstm_wide"], ("-DAWM_WIDE_GATES=1",)),
                                   daemon=True)
    gates_build.start()
    t0 = time.time()
    K.libraries()
    gates_build.join()
    print(f"== build {', '.join(K.SOURCES)} (parallel): {time.time() - t0:.1f} s\n{K.build_log}",
          flush=True)

    lap("1-2 card, build")

    # 3. kernels vs their plain versions
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    max_err, max_rel = {}, {}
    for sfx, dtype in dtypes.items():
        name, fname, bname = (K.instantiation(k, dtype, 64) for k in K.KERNELS)
        errs = []
        x, w_ih, w_hh, bias, _ = lstm_inputs(B_SERVE, dtype, dev, seed=B_SERVE)
        with no_tf32():
            ref = lstm_forward(x, w_ih, w_hh, bias)
        for b in (B_SERVE, ODD_B):  # the odd batch: the first rows, their plain output those rows of ref
            with no_tf32():
                y = K.lstm_fused_forward(x[:b].contiguous(), w_ih, w_hh, bias)
            torch.cuda.synchronize()
            err = float((y.float() - ref[:b].float()).abs().max())
            errs.append(err)
            check(y.dtype == dtype and y.shape == (b, T, 64) and bool(torch.isfinite(y).all())
                  and err <= KERNELS[name].tol,
                  f"{name} vs plain, B={b} T={T}: max abs err {err:.3e} (tol {KERNELS[name].tol:.0e})")
            del y
        del x, ref
        max_err[name] = max(errs)
        torch.cuda.empty_cache()

        ferrs, babs, brel = [], [], []
        train = None  # B_TRAIN's inputs and plain forward: the odd batch takes their first rows
        for b, t in ((B_TRAIN, T), (ODD_B, T), DRY_STEP_SHAPE):
            if b == ODD_B:
                (x, w_ih, w_hh, bias, dy), (ref_y, ref_c) = train
                x, dy, ref_y, ref_c = (v[:b].contiguous() for v in (x, dy, ref_y, ref_c))
                train = None
            else:
                x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=100 + b, t=t)
                ref_y = ref_c = None
            with no_tf32():
                y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
                grads = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
                torch.cuda.synchronize()
                if ref_y is None:
                    ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                ref_g = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
            if b == B_TRAIN:
                train = ((x, w_ih, w_hh, bias, dy), (ref_y, ref_c))
            err = max(float((y.float() - ref_y.float()).abs().max()), float((cprev - ref_c).abs().max()))
            ferrs.append(err)
            check(y.dtype == dtype and cprev.dtype == torch.float32 and bool(torch.isfinite(y).all())
                  and err <= KERNELS[fname].tol,
                  f"{fname} vs plain, B={b} T={t}: y and cprev max abs err {err:.3e} "
                  f"(tol {KERNELS[fname].tol:.0e})")
            again = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
            check(all(torch.equal(g, g2) for g, g2 in zip(grads, again)),
                  f"{bname}, B={b} T={t}: two runs give the same bits")
            del again
            rels = [rel_err(g, r) for g, r in zip(grads, ref_g)]
            babs.append(max(float((g.float() - r.float()).abs().max()) for g, r in zip(grads, ref_g)))
            brel.append(max(rels))
            check(grads[0].dtype == dtype and all(bool(torch.isfinite(g).all()) for g in grads)
                  and max(rels) <= KERNELS[bname].tol,
                  f"{bname} vs plain, B={b} T={t}: dx, dW_ih, dW_hh, db rel err "
                  f"{', '.join(f'{r:.2e}' for r in rels)} (tol {KERNELS[bname].tol:.0e})")
            del x, y, cprev, dy, grads, ref_y, ref_c, ref_g
            torch.cuda.empty_cache()
        max_err[fname], max_err[bname], max_rel[bname] = max(ferrs), max(babs), max(brel)

        # every rows-per-block variant the plan can pick, short T and ragged B
        for rows in K.FWD_ROWS:
            worst, worst_train = 0.0, 0.0
            for b, t in (*VARIANT_SHAPES, (B_SERVE, 50)):
                x, w_ih, w_hh, bias, _ = lstm_inputs(b, dtype, dev, seed=1000 + 10 * b + t, t=t)
                with no_tf32():
                    ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                    y0 = K.forward_kernel(x, w_ih, w_hh, bias, rows=rows)
                    y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows)
                worst = max(worst, float((y0.float() - ref_y.float()).abs().max()))
                worst_train = max(worst_train, float((y.float() - ref_y.float()).abs().max()),
                                  float((cprev - ref_c).abs().max()))
            check(worst <= KERNELS[name].tol and worst_train <= KERNELS[fname].tol,
                  f"{name} / {fname} vs plain, {rows} rows per block, (B, T) in "
                  f"{(*VARIANT_SHAPES, (B_SERVE, 50))}: max abs err {worst:.3e} / {worst_train:.3e} "
                  f"(tol {KERNELS[name].tol:.0e})")
        for rows in K.BWD_ROWS:
            worst = 0.0
            for b, t in VARIANT_SHAPES:
                x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=2000 + 10 * b + t, t=t)
                with no_tf32():
                    y, cprev = lstm_forward_train(x, w_ih, w_hh, bias)
                    ref_g = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
                    grads = K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=rows)
                worst = max(worst, *(rel_err(g, r) for g, r in zip(grads, ref_g)))
            check(worst <= KERNELS[bname].tol,
                  f"{bname} vs plain, {rows} rows per block, (B, T) in {VARIANT_SHAPES}: "
                  f"max rel err {worst:.3e} (tol {KERNELS[bname].tol:.0e})")

        # the Function vs autograd of the plain forward (independent of plain C)
        x, w_ih, w_hh, bias, _ = lstm_inputs(ODD_B, dtype, dev, seed=7, t=2000)
        a = [p.clone().requires_grad_() for p in (x, w_ih, w_hh, bias)]
        c = [p.clone().requires_grad_() for p in (x, w_ih, w_hh, bias)]
        with no_tf32():
            torch.sin(K.LSTMFunction.apply(*a).float()).sum().backward()
            torch.sin(lstm_forward(*c).float()).sum().backward()
        rels = [rel_err(p.grad, q.grad) for p, q in zip(a, c)]
        check(max(rels) <= FUNCTION_TOL[sfx] and all(p.grad.dtype == p.dtype for p in a),
              f"LSTMFunction {sfx} grads vs autograd of the plain forward, B={ODD_B} T=2000: rel err "
              f"{', '.join(f'{r:.2e}' for r in rels)} (tol {FUNCTION_TOL[sfx]:.0e})")

    width32_checks(K, dev, max_err, max_rel)
    width16_checks(K, dev, max_err, max_rel)
    masked_small_checks(K, dev, max_err, max_rel)

    lap("3 kernels vs plain")

    # 4. the serving path, counters zeroed just before
    with np.load(f"{ASSETS}/shapecap_golden.npz") as g:
        golden = {k: g[k] for k in g.files}
    launches = dict.fromkeys(K.launches, 0)
    for name in K.launches:
        K.launches[name] = 0

    sess32 = api.InferenceSession.from_npz(compute_dtype=torch.float32, device=dev)
    delta = sess32.embed_chunks(golden["chunks"], golden["messages"])
    summary = sess32.embed_detect(golden["chunks"], golden["messages"])
    errs = {"embed_delta": float(np.abs(delta - golden["embed_delta"]).max())}
    errs.update({k: float(np.abs(summary[k] - golden[k]).max()) for k in summary})
    for key, err in errs.items():
        check(err <= GOLDEN_TOL[key], f"fp32 session vs JAX golden, {key}: max abs err {err:.3e} "
                                      f"(tol {GOLDEN_TOL[key]:.0e})")
    rms = np.sqrt((delta**2).mean(axis=1))
    max_rms = sess32.shaping.max_rms
    check(float(rms.max()) <= max_rms, f"shaped delta RMS {rms.max():.6f} <= max_rms {max_rms}")

    sess16 = api.InferenceSession.from_npz(device=dev)
    message = 0xBEEF
    wav = speechlike(8, seed=1).reshape(-1)
    wm = api.watermark_array(wav, sess16, message=message)
    wm_rms = float(np.sqrt((wm["delta_waveform"] ** 2).mean()))
    det_wm = api.detect_array(wm["watermarked_waveform"], sess16)
    det_clean = api.detect_array(wav, sess16)
    ver = api.verify_array(wm["watermarked_waveform"], sess16, message)
    print(f"bf16 8-s waveform: delta rms {wm_rms:.5f}, wm_prob {det_wm['mean_probability']:.4f}, "
          f"clean_prob {det_clean['mean_probability']:.4f}, bit agreement {ver['bit_agreement']}/16, "
          f"p={ver['p_value']:.2e}, {ver['decision']}", flush=True)
    check(wm["watermarked_waveform"].shape == wav.shape and np.isfinite(wm["watermarked_waveform"]).all(),
          "watermark_array output finite, input shape")
    check(wm_rms <= max_rms, f"bf16 shaped delta RMS {wm_rms:.6f} <= {max_rms}")
    check(det_wm["is_watermarked"] and not det_clean["is_watermarked"],
          "detect_array: watermarked detected, clean not")
    # the shapecap checkpoint decodes ~75% of bits on its own eval set
    # (evidence/r5/shapecap/demo_eval.json), too few for AUTHENTIC on every
    # 8-s clip; the check is that the bf16 path decodes what the strict fp32
    # path decodes from the same audio.
    ver32 = api.verify_array(wm["watermarked_waveform"], sess32, message)
    same_bits = 16 - bin(ver["decoded_message"] ^ ver32["decoded_message"]).count("1")
    check(same_bits >= 14 and abs(ver["mean_probability"] - ver32["mean_probability"]) < 0.05,
          f"verify_array bf16 vs fp32: {same_bits}/16 decoded bits equal, mean probability "
          f"{ver['mean_probability']:.4f} vs {ver32['mean_probability']:.4f}")

    chunks512 = speechlike(B_SERVE, seed=2)
    msgs512 = np.random.default_rng(3).integers(0, 2**16, size=B_SERVE)
    big = sess16.embed_detect(chunks512, msgs512)
    bits = ((msgs512[:, None] >> np.arange(16)) & 1).astype(bool)
    bit_acc = float(((big["msg_logit_mean"] > 0) == bits).mean())
    print(f"bf16 embed_detect x{B_SERVE}: wm_prob {big['wm_prob'].mean():.4f}, "
          f"clean_prob {big['clean_prob'].mean():.4f}, bit accuracy {bit_acc:.4f}, "
          f"delta rms {big['delta_rms'].mean():.5f}", flush=True)
    check(all(np.isfinite(v).all() for v in big.values()) and big["msg_logit_mean"].shape == (B_SERVE, 16),
          "embed_detect x512: finite summaries of the expected shapes")
    check(float(big["wm_prob"].mean()) > float(big["clean_prob"].mean()),
          "embed_detect x512: watermarked probability above clean")
    # 8192 bits: chance is 0.5 +- 0.0055, so 0.55 is far outside it
    check(bit_acc > 0.55, f"embed_detect x512: bit accuracy {bit_acc:.4f} above chance")
    print(f"serving path launches: {K.launches}", flush=True)
    for name, n in K.launches.items():
        launches[name] += n

    lap("4 serving")

    # 4a. entry(), counters zeroed just before
    entry_errs = entry_phase(K, launches, dev)
    lap("4a entry")
    # 4b. the widths the kernels take masked and on the cluster path, and the
    # base family at channels 48 and 128, counters zeroed just before it
    wide_rows = {}
    wide_errs = widths_phase(K, launches, dev, max_err, max_rel, wide_rows)
    lap("4b widths")

    # 5. the train path, counters zeroed just before
    with np.load(f"{ASSETS}/train_golden.npz") as g:
        tgold = {k: g[k] for k in g.files}
    for name in K.launches:
        K.launches[name] = 0
    cfg32 = train_cfg("float32")
    state = shapecap_state(cfg32, dev)
    terms = tr.train_step(cfg32, state, torch.from_numpy(tgold["chunks"]).to(dev),
                          message=torch.from_numpy(tgold["messages"]).long().to(dev))
    check_train_golden(state, terms, tgold, dev, "fp32 train step vs JAX train golden")
    del state
    torch.cuda.empty_cache()

    t0 = time.time()
    out = cli(["train", "--device", "cuda", "--compute-dtype", "bfloat16", "--batch-size",
               str(B_TRAIN), "--synthetic-n", str(4 * B_TRAIN - B_TRAIN // 4), "--epochs", "1",
               "--workers", "4", "--init-from", SHAPECAP_NPZ, "--message-encoding", "bits",
               "--decode-head", "dilated", "--delta-band-hz", "3000", "--shape-max-rms", "0.01",
               "--dec-loss", "mean", "--lr", "1e-4"])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    row = out["history"][0]
    trained = out["state"]
    print(f"train CLI bf16 B={B_TRAIN}: {trained.step} steps + validation in {cli_s:.1f} s; "
          f"train {row['train_total']:.4f} val {row['val_total']:.4f}", flush=True)
    check(trained.step == 3 and all(np.isfinite(v) for k, v in row.items() if k != "epoch"),
          f"train CLI: {trained.step} steps, every loss term finite")
    start = variables_from_flax({"params": load_npz(SHAPECAP_NPZ)["params"]["gen"]})
    moved = [k for k, p in trained.gen.named_parameters()
             if not torch.equal(p.detach().cpu(), start[k])]
    check(len(moved) == len(start), f"train CLI: {len(moved)}/{len(start)} generator parameters moved")
    sess_t = api.InferenceSession(trained.gen, trained.det, device=dev, shaping=None)
    ed = sess_t.embed_detect(speechlike(64, seed=5), np.arange(64) * 977 % 2**16)
    print(f"session over the trained nets: wm_prob {ed['wm_prob'].mean():.4f}, "
          f"clean_prob {ed['clean_prob'].mean():.4f}", flush=True)
    check(float(ed["wm_prob"].mean()) > float(ed["clean_prob"].mean()),
          "session over the trained nets: watermarked probability above clean")
    del out, trained, sess_t
    torch.cuda.empty_cache()
    print(f"train path launches: {K.launches}", flush=True)
    for name, n in K.launches.items():
        launches[name] += n
    for name, n in launches.items():
        if name in KERNELS and KERNELS[name].width == 64:  # the base family's paths; width 32 is phase 12's
            check(n > 0, f"{name} launched {n} times on the serving and train paths")

    lap("5 train")

    # 6. the robust path, counters zeroed just before
    for name in K.launches:
        K.launches[name] = 0
    x_cpu = torch.from_numpy(speechlike(16, seed=11))
    x_dev = x_cpu.to(dev)
    torch.backends.cudnn.allow_tf32 = True  # torch's default: each op must turn it off itself
    for cutoff, q in ((7000.0, 0.707), (4000.0, 0.707), (1000.0, 200.0)):
        got, want = lowpass_biquad(x_dev, 16000, cutoff, q).cpu(), lowpass_biquad(x_cpu, 16000, cutoff, q)
        err = float((got - want).abs().max())
        scan = filters._biquad_fir_kernel(lowpass_biquad_coeffs(cutoff, 16000, q), dev) is None
        tol = OPS_TOL["scan_rel"] * float(want.abs().max()) if scan else OPS_TOL["fir"]
        check(scan == (q > 1) and err <= tol,
              f"lowpass_biquad {cutoff:.0f} Hz q={q} ({'scan fallback' if scan else 'FIR form'}) "
              f"card vs CPU: max abs err {err:.2e} (tol {tol:.1e})")
    for rate in (8000, 11025, 22050):
        got, want = resample_roundtrip(x_dev, rate).cpu(), resample_roundtrip(x_cpu, rate)
        err = float((got - want).abs().max())
        check(got.shape == x_cpu.shape and err <= OPS_TOL["fir"],
              f"resample_roundtrip {rate} Hz card vs CPU: max abs err {err:.2e} (tol {OPS_TOL['fir']:.0e})")
    for fn in (mulaw_roundtrip, alaw_roundtrip, quantize_int16):
        check(torch.equal(fn(x_dev).cpu(), fn(x_cpu)), f"{fn.__name__} card vs CPU: equal bits")
    # the backward of the attacks' convolutions runs outside any context of the caller's
    chain = lambda v: lowpass_biquad(resample_roundtrip(v, 22050), 16000, 4000.0)
    grads = []
    for v in (x_dev, x_cpu):
        v = v.clone().requires_grad_()
        torch.sin(3.0 * chain(v)).sum().backward()
        grads.append(v.grad.cpu())
    err = float((grads[0] - grads[1]).abs().max())
    check(err <= OPS_TOL["fir"] * float(grads[1].abs().max()),
          f"gradient through resample_roundtrip 22050 Hz and lowpass_biquad 4000 Hz card vs CPU: "
          f"max abs err {err:.2e} of max {float(grads[1].abs().max()):.2f} (tol {OPS_TOL['fir']:.0e} relative)")
    del x_dev

    with np.load(f"{ASSETS}/robust_train_golden.npz") as g:
        rgold = {k: g[k] for k in g.files}
    cfg32r = dataclasses.replace(cfg32, augment=AugmentConfig(**ROBUST_AUGMENT))
    state = shapecap_state(cfg32r, dev)
    draws = {k[5:]: torch.from_numpy(v).to(dev) for k, v in rgold.items() if k.startswith("draw/")}
    terms = tr.train_step(cfg32r, state, torch.from_numpy(rgold["chunks"]).to(dev),
                          message=torch.from_numpy(rgold["messages"]).long().to(dev), attack_draws=draws)
    check_train_golden(state, terms, rgold, dev, "fp32 robust train step vs JAX robust train golden")
    check(abs(float(terms["loc"]) - float(tgold["term/loc"])) > 1e-3,
          f"robust step's loc {float(terms['loc']):.4f} differs from the clean step's "
          f"{float(tgold['term/loc']):.4f}")
    del state, draws
    torch.cuda.empty_cache()

    t0 = time.time()
    out = cli(["train", "--device", "cuda", "--compute-dtype", "bfloat16", "--batch-size",
               str(B_TRAIN), "--synthetic-n", str(4 * B_TRAIN - B_TRAIN // 4), "--epochs", "1",
               "--workers", "4", "--init-from", SHAPECAP_NPZ, "--message-encoding", "bits",
               "--decode-head", "dilated", "--delta-band-hz", "3000", "--shape-max-rms", "0.01",
               "--dec-loss", "mean", "--lr", "1e-4", "--loss-weights", "dec=10,loud=3,mel=1",
               "--select-metric", "loc,dec", *ROBUST_FLAGS])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    row, trained = out["history"][0], out["state"]
    print(f"train --augment CLI bf16 B={B_TRAIN}: {trained.step} steps + attacked validation in "
          f"{cli_s:.1f} s; train {row['train_total']:.4f} val loc+dec {out['best_val']:.4f}", flush=True)
    check(trained.step == 3 and all(np.isfinite(v) for k, v in row.items() if k != "epoch")
          and np.isfinite(out["best_val"]),
          f"train --augment CLI: {trained.step} steps, every train and attacked-validation term finite")
    check(trained.attack_generator.device.type == "cuda", "train --augment CLI: attacks drawn on the card")
    del out, trained
    torch.cuda.empty_cache()
    step_launches = dict(K.launches)
    for name in ("lstm_fwd_train_f32", "lstm_bwd_f32", "lstm_fwd_train_bf16", "lstm_bwd_bf16"):
        check(step_launches[name] > 0, f"{name} launched {step_launches[name]} times in the robust steps")

    with np.load(f"{ASSETS}/robust_golden.npz") as g:
        qgold = {k: g[k] for k in g.files}
    rec = RecordingSession(sess32)
    deterministic = {k: v for k, v in ev.default_attacks(16000, seed=0).items()
                     if k not in STOCHASTIC_ATTACKS}
    table32 = ev.evaluate_robustness(rec, golden["chunks"], seed=0, attacks=deterministic)
    worst = dict.fromkeys(ROBUST_TOL, (0.0, "none"))
    for i, (name, row) in enumerate(table32.items()):
        (_, mlm_wm, _, p_wm), (_, _, _, p_clean) = rec.summaries[2 * i], rec.summaries[2 * i + 1]
        errs = {col: abs(v - float(qgold[f"table/{name}/{col}"])) for col, v in row.items()}
        for key, got in (("p_wm", p_wm), ("p_clean", p_clean), ("mlm", mlm_wm)):
            held_as = "mlm_quantised" if key == "mlm" and name in QUANTISER_ATTACKS else key
            errs[held_as] = float(np.abs(got - qgold[f"{key}/{name}"]).max())
        for key, err in errs.items():
            worst[key] = max(worst[key], (err, name))
    for key, (err, name) in worst.items():
        check(err <= ROBUST_TOL[key], f"fp32 sweep on the golden chunks vs the JAX robust golden, "
                                      f"{len(table32)} attacks, {key}: max abs err {err:.2e} at {name} "
                                      f"(tol {ROBUST_TOL[key]:.1e})")

    clips128 = test_split_clips(N_SWEEP)
    t0 = time.time()
    table16 = ev.evaluate_robustness(sess16, clips128, seed=0)
    sweep_s = time.time() - t0
    print(f"evaluate_robustness bf16 n={N_SWEEP}, 12 attacks, first call: {sweep_s:.2f} s")
    print(json.dumps({"robust_table_bf16": {k: {m: round(float(v), 4) for m, v in r.items()}
                                            for k, r in table16.items()}}), flush=True)
    with open(os.path.join(REPO, "evidence", "r5", "shapecap", "demo_eval.json")) as f:
        record = json.load(f)["robust"]
    check(list(table16) == list(record) and all(np.isfinite(v) for r in table16.values() for v in r.values()),
          "bf16 sweep: the reference's 12 rows in its order, every column finite")
    for col, tol in RECORD_TOL.items():
        diffs = {k: abs(table16[k][col] - record[k][col]) for k in table16 if k not in STOCHASTIC_ATTACKS}
        k = max(diffs, key=diffs.get)
        check(diffs[k] <= tol, f"bf16 sweep n={N_SWEEP} vs the reference's record, {col} on the ten "
                               f"deterministic rows: max diff {diffs[k]:.4f} at {k} "
                               f"({table16[k][col]:.4f} vs {record[k][col]:.4f}; tol {tol})")
    quality = ev.evaluate_model(sess16, [clips128], seed=0)
    print(json.dumps({"evaluate_model_bf16": {k: round(v, 5) for k, v in quality.items()}}), flush=True)
    check(quality["watermarked_prob"] > 0.5 > quality["clean_prob"] and quality["bit_accuracy_mean_logit"] > 0.6
          and all(np.isfinite(v) for v in quality.values()),
          "evaluate_model n=128: watermarked above 0.5 above clean, bits above chance")
    print(f"robust path launches: {K.launches}", flush=True)
    for name in ("lstm_fwd_f32", "lstm_fwd_bf16"):
        n = K.launches[name] - step_launches[name]
        check(n > 0, f"{name} launched {n} times in the attack sweeps")
    for name, n in K.launches.items():
        launches[name] += n

    lap("6 robust")

    # 7-12. checkpoints, trainer, curriculum, HTTP serving, tools, the strided
    # family, each with the counters zeroed just before
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    ckpt = checkpoint_phase(K, launches, dev, work, (chunks512, msgs512, big))
    lap("7 checkpoints")
    trainer_phase(K, launches, cli, dev, work, ckpt)
    lap("8 trainer")
    curriculum_phase(K, launches, cli, work, "cuda")
    lap("9 curriculum")
    http_phase(K, launches, dev, ckpt)
    lap("10 HTTP")
    demo = tools_phase(K, launches, ckpt, "cuda", work)
    lap("11 tools")
    strided_ckpt = strided_phase(K, launches, cli, dev, work)
    lap("12 strided")
    # 13. multi-process training, counters zeroed just before
    parallel = parallel_phase(K, launches, cli, dev, work)
    lap("13 multi-process")
    # 13a. the multi-device dry run, counters zeroed just before
    dry = dryrun_phase(K, launches)
    lap("13a dry run")
    # 14. the bench, counters zeroed just before; the sweeps and demo_table
    benched = bench_phase(K, launches, cli, work, demo)
    lap("14 bench")
    # 15. the corpus drill
    drill = drill_phase(K, launches, work)
    lap("15 drill")
    for name, n in launches.items():
        if name not in OFF_PATH:
            check(n > 0, f"{name} launched {n} times on the main paths")

    # 16. timing (card name and power limit printed above)
    times = {}
    for sfx, dtype in dtypes.items():
        name, fname, bname = (K.instantiation(k, dtype, 64) for k in K.KERNELS)
        x, w_ih, w_hh, bias, _ = lstm_inputs(B_SERVE, dtype, dev, seed=7)
        with no_tf32():
            ms = cuda_ms(lambda: K.lstm_fused_forward(x, w_ih, w_hh, bias), reps=5)
            plain_ms = cuda_ms(lambda: lstm_forward(x, w_ih, w_hh, bias), reps=1)
            m = cudnn_lstm(w_ih, w_hh, bias, dtype, dev)
            with torch.inference_mode():
                library_ms = yardstick(lambda: cuda_ms(lambda: m(x), reps=5), f"nn.LSTM {sfx}")
        bms, by = bound_ms(name, B_SERVE)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "library_ms": library_ms}
        print(f"{name} B={B_SERVE} T={T}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"cuDNN nn.LSTM {library_ms} ms, bound {bms:.3f} ms ({by})", flush=True)
        del x, m
        torch.cuda.empty_cache()

        x, w_ih, w_hh, bias, dy = lstm_inputs(B_TRAIN, dtype, dev, seed=8)
        with no_tf32():
            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
            f_ms = cuda_ms(lambda: K.forward_train_kernel(x, w_ih, w_hh, bias), reps=3)
            b_ms = cuda_ms(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), reps=3)
            split = backward_split(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), fused=False)
            f_plain = cuda_ms(lambda: lstm_forward_train(x, w_ih, w_hh, bias), reps=1, warmup=0)
            b_plain = cuda_ms(lambda: lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias), reps=1, warmup=0)
            m = cudnn_lstm(w_ih, w_hh, bias, dtype, dev)
            xg = x.clone().requires_grad_()
            f_lib = yardstick(lambda: cuda_ms(lambda: m(xg), reps=3), f"nn.LSTM {sfx} forward")
            ylib = m(xg)[0]
            b_lib = yardstick(lambda: cuda_ms(lambda: torch.autograd.grad(
                ylib, [xg, *m.parameters()], dy, retain_graph=True), reps=3),
                f"nn.LSTM {sfx} backward")
        for name, k_ms, p_ms, lib in ((fname, f_ms, f_plain, f_lib), (bname, b_ms, b_plain, b_lib)):
            bms, by = bound_ms(name, B_TRAIN)
            times[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                           "library_ms": lib}
            print(f"{name} B={B_TRAIN} T={T}: kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms, "
                  f"cuDNN nn.LSTM {'forward' if 'fwd' in name else 'backward'} {lib} ms, "
                  f"bound {bms:.3f} ms ({by})", flush=True)
        times[bname]["split_ms"] = split
        print(f"{bname} by launch: " + ", ".join(f"{k} {fmt_ms(v, 3)}" for k, v in split.items())
              + ("" if None not in split.values() else " (not measured: the profiler dropped that kernel)"),
              flush=True)
        both = None if f_lib is None or b_lib is None else f_lib + b_lib
        print(f"nn.LSTM {sfx} forward + backward B={B_TRAIN}: {both} ms; "
              f"kernels B + C {f_ms + b_ms:.3f} ms", flush=True)
        del x, y, cprev, dy, m, xg, ylib
        torch.cuda.empty_cache()

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    for sfx, dtype in dtypes.items():
        name, fname, bname = (K.instantiation(k, dtype, W32) for k in K.KERNELS)
        x, w_ih, w_hh, bias, _ = lstm_inputs(B_SERVE, dtype, dev, seed=17, t=T32, w=W32)
        with no_tf32():
            ms = cuda_ms(lambda: K.lstm_fused_forward(x, w_ih, w_hh, bias), reps=200, warmup=20)
            dev_ms = {name: lstm_device_ms(lambda: K.lstm_fused_forward(x, w_ih, w_hh, bias))}
            queued = {name: queued_ms(lambda: K.lstm_fused_forward(x, w_ih, w_hh, bias))}
            plain_ms = cuda_ms(lambda: lstm_forward(x, w_ih, w_hh, bias), reps=5)
            m = cudnn_lstm(w_ih, w_hh, bias, dtype, dev)
            with torch.inference_mode():
                library_ms = yardstick(lambda: cuda_ms(lambda: m(x), reps=200, warmup=20), f"nn.LSTM {sfx} w32")
        x, w_ih, w_hh, bias, dy = lstm_inputs(B_TRAIN, dtype, dev, seed=18, t=T32, w=W32)
        with no_tf32():
            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
            f_ms = cuda_ms(lambda: K.forward_train_kernel(x, w_ih, w_hh, bias), reps=200, warmup=20)
            b_ms = cuda_ms(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), reps=200, warmup=20)
            fused = K.launch_plan(B_TRAIN, T32, dtype, torch.cuda.get_device_properties(dev).multi_processor_count,
                                  W32).bwd_fused
            split = backward_split(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), fused, reps=50)
            f_plain = cuda_ms(lambda: lstm_forward_train(x, w_ih, w_hh, bias), reps=5)
            b_plain = cuda_ms(lambda: lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias), reps=5)
            m = cudnn_lstm(w_ih, w_hh, bias, dtype, dev)
            xg = x.clone().requires_grad_()
            f_lib = yardstick(lambda: cuda_ms(lambda: m(xg), reps=200, warmup=20), f"nn.LSTM {sfx} w32 forward")
            ylib = m(xg)[0]
            b_lib = yardstick(lambda: cuda_ms(lambda: torch.autograd.grad(
                ylib, [xg, *m.parameters()], dy, retain_graph=True), reps=200, warmup=20),
                f"nn.LSTM {sfx} w32 backward")
            dev_ms[fname] = lstm_device_ms(lambda: K.forward_train_kernel(x, w_ih, w_hh, bias))
            dev_ms[bname] = split_total(split)
            queued[fname] = queued_ms(lambda: K.forward_train_kernel(x, w_ih, w_hh, bias))
            queued[bname] = queued_ms(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias))
        for n, b, k_ms, p_ms, lib in ((name, B_SERVE, ms, plain_ms, library_ms), (fname, B_TRAIN, f_ms, f_plain, f_lib),
                                      (bname, B_TRAIN, b_ms, b_plain, b_lib)):
            bms, by = bound_ms(n, b, T32)
            lat = latency_bound_ms(T32, W32, clock_mhz)
            times[n] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib,
                        "device_ms": dev_ms[n], "queued_ms": queued[n]}
            print(f"{n} B={b} T={T32}: kernel {k_ms:.4f} ms a call ({fmt_ms(dev_ms[n])} of it on the device, "
                  f"{queued[n]:.4f} ms queued), plain "
                  f"{p_ms:.2f} ms, cuDNN nn.LSTM(32) {lib} ms, bound {bms:.5f} ms ({by}), {T32} dependent "
                  f"steps >= {lat:.5f} ms at {clock_mhz:.0f} MHz", flush=True)
        times[bname]["split_ms"] = split
        print(f"{bname} by launch: " + ", ".join(f"{k} {fmt_ms(v)}" for k, v in split.items()), flush=True)
        del x, y, cprev, dy, m, xg, ylib
        # the four-launch path, where the blocks do not fit one wave
        x, w_ih, w_hh, bias, dy = lstm_inputs(B_WAVES, dtype, dev, seed=19, t=T32, w=W32)
        with no_tf32():
            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
            b_ms = cuda_ms(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), reps=200, warmup=20)
            split = backward_split(lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), False, reps=50)
        times[bname]["four_launches_B300"] = {"ms": b_ms, "split_ms": split}
        print(f"{bname} B={B_WAVES} T={T32} (four launches): kernel {b_ms:.4f} ms a call, by launch "
              + ", ".join(f"{k} {fmt_ms(v)}" for k, v in split.items()), flush=True)
        del x, y, cprev, dy
        torch.cuda.empty_cache()
        # what a short call costs before its steps, and a step: device ms at
        # each T of W32_FIT_T and its least-squares line fixed + T x step
        for n, b in ((name, B_SERVE), (fname, B_TRAIN), (bname, B_TRAIN)):
            sweep = []
            for t in W32_FIT_T:
                x, w_ih, w_hh, bias, dy = lstm_inputs(b, dtype, dev, seed=20 + t, t=t, w=W32)
                with no_tf32():
                    y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
                    call = {name: lambda: K.forward_kernel(x, w_ih, w_hh, bias),
                            fname: lambda: K.forward_train_kernel(x, w_ih, w_hh, bias),
                            bname: lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)}[n]
                    frag = "lstm_bwd_" if n == bname else "lstm_fwd_"
                    sweep.append(device_split(call, {"all": frag}, reps=50)["all"])
            fixed, step = fit_line(W32_FIT_T, sweep)
            plan = K.launch_plan(b, T32, dtype, sm_count, W32)
            times[n]["fit"] = {"steps": list(W32_FIT_T), "device_ms": sweep, "fixed_ms": fixed, "step_ms": step}
            print(f"{n} B={b} fit of device ms = fixed + T x step over T {W32_FIT_T} "
                  f"({'backward ' + ('fused' if plan.bwd_fused else 'four launches') if n == bname else path_of(plan)}"
                  f" path at T={T32}): fixed {fmt_ms(fixed, 5)}, step {fmt_ms(step, 6)}; device ms "
                  + ", ".join(fmt_ms(v, 5) for v in sweep), flush=True)
        del x, y, cprev, dy
        torch.cuda.empty_cache()

    clips = {}
    for label, sess in (("bf16", sess16), ("fp32", sess32)):
        sess.embed_detect(chunks512, msgs512)  # warm-up
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            sess.embed_detect(chunks512, msgs512)  # returns host arrays: synchronised
        clips[label] = B_SERVE * reps / (time.perf_counter() - t0)
        print(f"embed+detect {label} session, B={B_SERVE}: {clips[label]:.1f} clips/s", flush=True)
    # the bf16 server under tools/serve_load.py's load, 32 clients, 8-s requests
    from awm_tpu_torch.serve import _decode_wav_bytes
    from awm_tpu_torch.tools import serve_load
    from awm_tpu_torch.utils.audio_io import encode_wav_bytes

    load, _ = cli_printed(serve_load.main, ["--self-serve", "--ckpt", ckpt, "--device", "cuda",
                                            "--clients", "32", "--requests", "256", "--seconds", "8"])
    body = encode_wav_bytes(speechlike(1, seed=60, chunk=8 * T)[0], 16000)
    t0 = time.perf_counter()
    for _ in range(10):
        encode_wav_bytes(_decode_wav_bytes(body, 16000), 16000)
    wav_ms = (time.perf_counter() - t0) * 100
    print(f"bf16 server, 32 clients, {load['requests_ok']} requests of 8 s (embed, detect): "
          f"{load['req_per_s']:.2f} requests/s, {load['audio_s_per_s']:.1f} audio s/s, "
          f"{load['clips_per_s']:.1f} clips/s through the model beside the session's embed+detect "
          f"{clips['bf16']:.1f} clips/s; latency p50 {load['latency_p50_ms']:.1f} ms, p99 "
          f"{load['latency_p99_ms']:.1f} ms; {load['device_batches']} device batches, "
          f"{load['chunks_per_device_batch']:.1f} chunks each; device calls {load['device_s']:.2f} s of "
          f"{load['wall_s']:.2f} s ({100 * load['device_busy_share']:.1f}%), "
          f"{1e3 * load['device_s'] / max(load['device_batches'], 1):.1f} ms a batch; host WAV decode + "
          f"encode of one 8-s request {wav_ms:.2f} ms", flush=True)
    check(load["errors"] == 0 and load["requests_ok"] == 256, f"serve_load: {load['errors']} errors")
    sweep_wall = {}
    for label, sess in (("bf16", sess16), ("fp32", sess32)):
        t0 = time.perf_counter()
        ev.evaluate_robustness(sess, clips128, seed=0)  # returns host numbers: synchronised
        sweep_wall[label] = time.perf_counter() - t0
        print(f"evaluate_robustness {label} session, n={N_SWEEP}, 12 attacks (warm): "
              f"{sweep_wall[label]:.2f} s", flush=True)
    del sess16, sess32
    torch.cuda.empty_cache()

    train_clips = {}
    batch = torch.from_numpy(speechlike(B_TRAIN, seed=9)).to(dev)
    curriculum = AugmentConfig(**ROBUST_AUGMENT)
    both = torch.cat([batch, batch])
    attack_gen = torch.Generator(device=dev).manual_seed(0)
    attacks_ms = cuda_ms(lambda: apply_augment(both, draw_augment(curriculum, 2 * B_TRAIN, T, attack_gen),
                                               curriculum), reps=3)
    print(f"attack chain alone (draw + apply, forward, 2B={2 * B_TRAIN} clips): {attacks_ms:.2f} ms", flush=True)
    del both
    for label, dt, augment in (("bf16", "bfloat16", None), ("fp32", "float32", None),
                               ("bf16_robust", "bfloat16", curriculum), ("fp32_robust", "float32", curriculum)):
        cfg = dataclasses.replace(train_cfg(dt), augment=augment)
        state = shapecap_state(cfg, dev)
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(cfg, state, batch)  # warm-up
        torch.cuda.synchronize()
        if label in ("bf16", "bf16_robust"):
            profile_step(lambda: tr.train_step(cfg, state, batch), label)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            tr.train_step(cfg, state, batch)
        torch.cuda.synchronize()
        train_clips[label] = B_TRAIN * reps / (time.perf_counter() - t0)
        print(f"train step {label}, B={B_TRAIN}: {train_clips[label]:.1f} clips/s "
              f"({1e3 * B_TRAIN / train_clips[label]:.1f} ms per step), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
        del state
        torch.cuda.empty_cache()

    # the strided family: embed+detect at the serving batch, the train step at
    # the training batch, from seeded weights and from the trained checkpoint
    from awm_tpu_torch.config import get_config

    scfg = get_config("strided")
    strided_clips, strided_train = {}, {}
    for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        sess = api.InferenceSession.from_checkpoint(strided_ckpt, compute_dtype=dt, device=dev)
        sess.embed_detect(chunks512, msgs512)  # warm-up
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            sess.embed_detect(chunks512, msgs512)
        strided_clips[label] = B_SERVE * reps / (time.perf_counter() - t0)
        print(f"strided embed+detect {label} session, B={B_SERVE}: {strided_clips[label]:.1f} clips/s", flush=True)
        del sess
    for label, dt in (("bf16", "bfloat16"), ("fp32", "float32")):
        cfg = dataclasses.replace(scfg, train=dataclasses.replace(scfg.train, compute_dtype=dt))
        state = tr.init_state(cfg, device=dev)
        for name, net in zip(("gen", "det"), seeded_nets(cfg, 7, dev)):
            getattr(state, name).load_state_dict(net.state_dict())
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(cfg, state, batch)  # warm-up
        torch.cuda.synchronize()
        if label == "bf16":
            profile_step(lambda: tr.train_step(cfg, state, batch), "strided bf16")
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            tr.train_step(cfg, state, batch)
        torch.cuda.synchronize()
        strided_train[label] = B_TRAIN * reps / (time.perf_counter() - t0)
        print(f"strided train step {label}, B={B_TRAIN}: {strided_train[label]:.1f} clips/s "
              f"({1e3 * B_TRAIN / strided_train[label]:.1f} ms per step), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        del state
        torch.cuda.empty_cache()

    # width 16 and 12 x 12 (capacity 16 masked) at the dry run's shape and at
    # the strided training shape; 24 x 24 (capacity 32 masked, the strided
    # family at hidden_dim 24) at its main path's (A B_SERVE, B and C B_TRAIN)
    for sfx, dtype in dtypes.items():
        for w in (W16, MASKED16):
            for b, t in ((DRY_B, DRY_T), (B_TRAIN, T32)):
                got = lstm_times(K, dtype, b, t, w, dev, clock_mhz)
                for n, row in got.items():
                    if (b, t) == (DRY_B, DRY_T):
                        times[n] = row
                    else:
                        times[n][f"B{b}_T{t}"] = row
        times.update(lstm_times(K, dtype, B_TRAIN, T32, MASKED32, dev, clock_mhz, b_fwd=B_SERVE))
    lap("16 timing")

    # 16a. where the train step's peak memory goes
    memory = memory_phase(dev)
    lap("16a memory")

    # 17. result lines
    kernels = []
    times.update(wide_rows)
    for name, k in KERNELS.items():
        steps = {W32: T32, W16: DRY_T, MASKED32: T32, MASKED16: DRY_T}.get(k.width, T)
        batch = DRY_B if k.width in (W16, MASKED16) else B_SERVE if k.kernel == "lstm_fwd" else B_TRAIN
        if K.is_wide(k.width):
            plan = K.launch_plan(batch, steps, dtypes[k.sfx], sm_count, k.width,
                                 wide_slots=K._wide_slots(dev.index or 0, dtypes[k.sfx], k.width))
        else:
            plan = K.device_plan(batch, steps, dtypes[k.sfx], dev.index or 0, k.width)
        path = ("wide" if plan.wide else ("fused" if plan.bwd_fused else "four launches") if k.kernel == "lstm_bwd"
                else path_of(plan))
        print(f"{name}: W={k.width} B={batch} T={steps}, {plan.bwd_rows if k.kernel == 'lstm_bwd' else plan.fwd_rows}"
              f" rows per block, {path} path", flush=True)
        entry = {"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                 "launches": launches[name], "max_abs_err": max_err[name], "path": path, **times[name]}
        if not (plan.wide or plan.cluster):  # the register-held capacity the call ran and its rows a block
            bwd = k.kernel == "lstm_bwd"
            entry.update(capacity=plan.capacity, rows=plan.bwd_rows if bwd else plan.fwd_rows)
        if name in max_rel:
            entry["max_rel_err"] = max_rel[name]
        kernels.append(entry)
    print(f"wall {time.time() - t_start:.1f} s; server bf16 {json.dumps(load)}; "
          f"embed+detect clips/s {json.dumps(clips)}; "
          f"train-step clips/s {json.dumps(train_clips)}; 12-attack sweep n={N_SWEEP} s "
          f"{json.dumps(sweep_wall)}; attack chain ms {attacks_ms:.2f}; strided embed+detect clips/s "
          f"{json.dumps(strided_clips)}; strided train-step clips/s {json.dumps(strided_train)}; "
          f"multi-process {json.dumps(parallel)}; bench {json.dumps(benched)}; drill {json.dumps(drill)}; "
          f"entry card vs CPU {json.dumps(entry_errs)}; widths {json.dumps(wide_errs)}; dry run {json.dumps(dry)}; "
          f"memory {json.dumps(memory)}; "
          f"phase s {json.dumps(laps)}")
    print(json.dumps({"kernels": kernels}))
    print(f"{smi}; wall {time.time() - t_start:.1f} s; phase s {json.dumps(laps)}", flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
