#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It imports ``repro_torch`` from
``src/`` (never ``jax`` or ``repro``) and, in order:

1. prints the card (``nvidia-smi``), turns TF32 off and cuDNN's
   deterministic algorithms on (the trainer's fp32 settings);
2. builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` and
   prints the build time and ``ptxas``'s report;
3. kernel phase: at every main-path shape holds each kernel against its
   plain PyTorch version on the card (conv 2e-4, LRN 2e-5, GEMM 2e-4)
   and times kernel, plain version, the library call that computes the
   same function (cuDNN conv, ``F.local_response_norm``, cuBLAS
   ``addmm``; yardsticks only, never called by the port) and the card's
   bound, one JSON line per kernel and shape.  Conv and LRN run at the
   serving batch (8) and the training batch (128 per replica), the conv
   rows with the kernel's tile, blocks and split, two conv and two LRN
   calls agreeing bit for bit; the GEMM runs the forward, dx and dw products of every
   conv of the im2col training phase (32 per replica), two calls agreeing
   bit for bit where the reduction is split over blocks.  Then the bf16
   entries the bf16 numerics preset runs, ``conv2d_fused_bf16`` (tensor
   cores; every conv must take its wgmma body) at the 5
   ``ALEXNET_FAITHFUL`` convs and ``lrn_bf16`` at its 2 LRNs, batch 128,
   bf16 operands, against their plain versions within 8e-3 of max |y| (2
   bf16 ulps), the conv also with its reduction split 3 ways, two calls
   bit-equal, timed beside the plain version, the entry's mma_sync body,
   cuDNN's bf16 conv on channels-last and ``F.local_response_norm`` in
   bf16 (yardsticks only) and the bound (989 TFLOP/s bf16 or 3.35 TB/s);
   then ``matmul_bias``'s bf16 entry (``gemm_bf16``) at Mixtral's expert
   products at capacity 640 (forward, dx, dw), the decode products at M
   = 16 and AlexNet's 14 im2col products at batch 32, each on the body
   the rule must pick (wgmma; swap_ab at M = 16; mma_sync for conv1's
   unaligned rows), each element within one bf16 ulp of the plain
   version (or 1e-5 of max |y| near zero), the differing elements
   counted, two calls bit-equal, timed beside the plain version, the
   mma_sync body at the same shape, ``torch.matmul`` in bf16 (both
   yardsticks) and the bound, with the body's width, units and blocks;
4. flash kernel phase: the flash-attention forward, dq and dk/dv kernels
   against their plain versions (fp32: 2e-4 forward, 2e-3 grads; bf16:
   3e-2) at the LM training shape (B=4, H=16, S=2048, hd=128, causal) and
   at GQA (32 / 8 heads, ragged S=1000), window-256, hd-64 and hd-256
   shapes and the ``recurrentgemma-9b`` attn layers' (B 2, 16 query
   heads on 1 KV head, hd 256, window 2048), in fp32 and bf16, timed
   beside their plain versions, ``F.scaled_dot_product_attention``'s
   forward and whole backward (a yardstick only) and the bound over the
   unmasked (q, k) pairs (bf16 at the tensor cores' 989 TFLOP/s, fp32 at
   67); two dq and two dk/dv calls must agree bit for bit;
5. decode kernel phase: the flash-decode kernels ``decode_ring`` and
   ``decode_table`` against their plain version (fp32 2e-4, bf16 outputs
   2e-2; int8 against the plain int8) at the serving tick's shape (B 8,
   cap 2048, Hkv 16, G 1, hd 128, rows mid-fill and wrapped, bf16; ring
   and a block table of bs 16) and at GQA (Hkv 8, G 4), window-256,
   hd-64, hd-256, G-16-at-hd-256 (bf16 and int8 K/V: the ring's
   tensor-core body), fp32-q, fp32 and int8 K/V shapes, two
   calls agreeing bit for bit, timed beside the plain version,
   ``F.scaled_dot_product_attention`` over the same slots with a mask (a
   yardstick only; for the table cases also the gather through the table
   plus SDPA) and the bound (the visible K/V bytes over 3.35 TB/s); the
   rows report the kernel's split of each row's slots;
6. recurrence kernel phase: the WKV kernel ``wkv_fwd`` against the
   plain chunked form (bf16 y 1e-2, fp32 2e-4; the final state 2e-4) at
   the ``rwkv6-7b`` training shape (B 4, T 2048, H 64, K 64, bf16), B 1
   with ragged T 1000, fp32 inputs, and, against the plain sequential
   form, one input with a w = 0 entry, two calls agreeing bit for bit,
   each row with the kernel's chunk of steps; the RG-LRU kernel
   ``rglru_fwd``, forward, reversed, and reversed with the backward's da
   in the same launch, against the plain loops (2e-4) at the
   ``recurrentgemma-9b`` training shape (B 2, T 2048, D 4096), ragged T
   and D, and strong decay, two calls agreeing bit for bit, each row with
   the kernel's chunk; timed beside the plain versions and the bounds
   (12 bytes an element forward, 20 reversed with da; no PyTorch call
   computes either recurrence, so no library yardstick).
   Then the WKV Function's grads against autograd through the plain
   chunked form, its plain chunk-recompute backward timed at the
   training shape, and the RG-LRU Function's grads (the reversed launch)
   against its plain route, its backward timed at the training shape;
7. serving phase: serves 32 random 227x227x3 images through
   ``ServingEngine`` on ``ALEXNET_FAITHFUL`` at full width (8 slots,
   greedy) with the launch counts set to 0 just before and read just
   after, checks 5 conv and 2 LRN launches per forward, and holds class
   ids and logits against the same engine under the plain policy; then
   times images/s and latency p50/p99 over three windows of 2048
   requests from 8 closed-loop clients, and one more window under
   ``torch.profiler`` gives the device time by kernel and the device's
   idle share;
8. training phase: ``TrainSession`` trains ``ALEXNET_FAITHFUL`` at full
   width, 2 replicas x 128 images, SGD momentum, every-step all-reduce of
   weights and momentum, pinned staging, fused conv.  Launch counts are
   set to 0 before 3 steps and read after (5 conv and 2 LRN per replica
   and step, no GEMM); losses and params are held against the same run
   under the plain policy on the card; the replicas' spread is 0 after
   every step.  Then three timed windows of 10 steps give images/s and
   step p50/p99, and a traced window the device time by family (the
   LRN backward's plain closed form booked apart, ``lrn_bwd``) and the
   idle share: once with the host preprocess (mean, crop, flip) in the
   loader thread for every batch, once over a pool preprocessed ahead;
   Then the same net under the bf16 numerics preset (``train_bf16``:
   bf16 params, images and activations, fp32 masters in the optimizer
   state, dynamic loss scaling), 3 steps, step 2's batch carrying one NaN
   pixel in replica 1: 5 ``conv2d_fused_bf16`` and 2 ``lrn_bf16``
   launches per replica and step and none of the fp32 entries, steps 1
   and 3 held against the plain policy under the same preset (2e-2), the
   poisoned step leaving both replicas' params, masters and velocity bit
   for bit as they were, the scale 2^15 -> 2^14 and one skip counted;
   then one timed and one traced window of 10 steps over the
   preprocessed pool and the peak memory.
   Then the exchanges (``train_exchange``): the same fp32 net, 2 x 128,
   over the preprocessed pool, each from a fresh state under delay=1
   uncompressed, delay=1 bf16, delay=1 top-k at 0.01 and delay=0 bf16:
   3 steps with the launch counts set to 0 before and read after (5
   conv and 2 LRN per replica and step), the losses held against 3
   steps under the plain policy, the consensus (the top-k and bf16
   base, the delay=0 state) spread 0 after every exchange, and under
   top-k each replica keeping k entries of every leaf (read as d - the
   new residual); then one timed and one traced window of 10 steps for
   each exchange and for delay=0 uncompressed, the exchange's device ms
   booked under its ``exchange`` range, with the peak memory;
9. im2col training phase: 3 steps at 2 x 32 under
   ``--conv-backend im2col_ref`` count the GEMM kernel's launches (5
   forward, 5 dw and 4 dx per replica and step: conv1's dx is not
   needed) and hold the losses against the fused backend; then the same
   under the bf16 preset on the bf16 GEMM entry, against the fused bf16
   conv (2e-2);
10. LM training phase: ``TrainSession`` trains ``olmo-1b`` at full width
   (16 layers, d_model 2048, bf16 params, fp32 velocity), 2 replicas x 4
   sequences x 2048 tokens, SGD momentum, every-step all-reduce, on
   ``markov_lm`` tokens.  Launch counts are set to 0 before 3 steps and
   read after (2 replicas x 16 layers of each flash kernel per step),
   the spread is 0 after every step; the same width at 4 layers in fp32
   (2 x 2 x 2048) holds kernel against plain (losses and params within
   1e-3 after 3 steps).  Then the peak memory, the device time of the
   update alone, three timed windows of 5 steps (tokens/s, step
   p50/p99, stage wait, idle share) and a traced window (device ms by
   family); then 3 steps of the same run under the bf16 numerics preset
   (fp32 masters, dynamic loss scaling): the flash launch counts, finite
   losses, the scale 2^15 after 3 clean steps, every updated param within
   1 bf16 ulp of its master's cast (read before each exchange) and the
   peak memory;
11. LM serving phase: ``ServingEngine`` serves ``olmo-1b`` at full width
   (16 layers, bf16, 8 slots, capacity 2048, greedy, prompts of 256-1024
   random tokens, 128 new tokens each).  First the same width at 4
   layers in fp32 serves 8 requests under the kernels and under the
   plain policy, ring and block pool (bs 16): the greedy streams must be
   equal.  At full depth the first decode tick's logits are held against
   the plain policy's from one prefilled state (relative L2 3e-2, and the
   same greedy token where the margin is clear); one wave of 8
   requests, ring and then block pool, with the launch counts set to 0
   just before and read just after, must show 16 ``flash_fwd`` launches
   per prefill and 16 ``decode_ring`` / ``decode_table`` launches per
   tick; then three timed windows of 32 requests from 8 closed-loop
   clients (generated tokens/s, TTFT and per-token latency p50/p99) and
   one more under ``torch.profiler`` (device ms by family, idle share);
   then ``rwkv6-7b`` and ``recurrentgemma-9b`` the same way at their
   published width and full depth (bf16, 8 slots, capacity 2048, 32 new
   tokens each): first greedy streams of 8 requests under the kernels
   and the plain policy equal in fp32 at 2 layers and at one ``rec, rec,
   attn`` superblock with its window cut to 256 (a wrapped ring); then
   the prefill's last logits under both policies and the first decode
   tick's from one prefilled state, each no further from the same
   weights' fp32 logits than 1.5x the plain policy's; one wave of 8
   requests with per prefill one
   ``wkv_fwd`` per rwkv layer (32), one ``rglru_fwd`` per rec layer (26)
   and one ``flash_fwd`` per attn layer (12), and per tick one
   ``decode_ring`` per attn layer (12); one timed window of 16 requests
   from 8 clients and one traced of 8 (device ms per tick by family, the
   ``decode_ring`` and state-update shares, booked by named ranges);
   then speculative serving of ``olmo-1b`` (16 layers), ``recurrentgemma-
   9b`` (38) and ``rwkv6-7b`` (32), each drafting 4 tokens a round with
   its own first 2, 3 (one ``rec, rec, attn`` superblock) and 2 layers,
   bf16, 8 slots, capacity 2048, 32 new tokens: first greedy streams of 8
   requests in fp32 at 4, 4 (``rec, rec, attn, rec``, window 256, a
   3-layer draft) and 2 layers, the spec engine's under the kernels equal
   to the plain engine's under the kernels and the spec engine's under
   the plain policy; one wave of 8 requests with per admission one
   ``flash_fwd`` per attention layer, ``wkv_fwd`` per rwkv layer and
   ``rglru_fwd`` per rec layer of target and draft, and per dispatch 4
   ``decode_ring`` per draft attention layer and 2 ``rglru_fwd`` per rec
   layer of either (56 for the hybrid); the verify logits of one round
   and 5 sequential decode ticks' from one prefilled state, each no
   further from the fp32 ticks' than 1.5x the other's; for ``olmo-1b``
   and the hybrid a timed window of 16 requests from 8 clients, spec and
   then plain (tokens/s, TTFT, per-token p50/p99, dispatches,
   acceptance);
12. recurrent LM training phases: ``rwkv6-7b`` (8 layers) and
   ``recurrentgemma-9b`` (5 layers: one ``rec, rec, attn`` superblock
   and two remainder ``rec`` layers) at the published width in bf16,
   2 replicas x 4 (x 2) sequences x 2048 tokens of ``markov_lm``, SGD
   momentum, every-step all-reduce, the state updated in place as in
   every training phase.  Kernel against plain first, fp32 at the same
   width: 3 steps of R=2 at 2 layers for ``rwkv6-7b`` (losses and params
   within 1e-3), one replica's loss and grads at 3 layers for
   ``recurrentgemma-9b`` (two fp32 replicas of its 2.1 B-param embedding
   and head do not fit).
   Then launch counts over 3 steps (per replica and step one
   ``wkv_fwd`` per rwkv layer, two ``rglru_fwd`` per rec layer, one of
   each flash kernel per attn layer), spread 0 after every step, the
   peak memory, three timed windows of 3 steps and a traced one (device
   ms by family, the WKV backward's plain recompute booked apart);
   Then Mixtral-8x7B (``moe_serving``, ``moe_train``): serving at full
   width and 16 of its 32 layers in bf16 (8 slots, capacity 2048,
   prompts of 256-1024, 32 new tokens): first a 2-layer bf16 prefill on
   the ``matmul="kernel"`` route (48 GEMM launches) anchored to fp32
   beside the batched product; one wave on the ring and one on the block
   pool (full attention) with 16 ``flash_fwd`` per prefill and 16 decode
   launches per tick; a timed window of 16 requests, one traced of 8
   (idle share, device ms by family) and a speculative wave drafting 4
   tokens with the first 2 layers; training at full width and 2 of 32
   layers, 2 x 2048 tokens, bf16 params, fp32 velocity: 4 steps on the
   batched product, then 3 on the GEMM kernel from a fresh state of the
   same seed (288 GEMM launches a step, all on the TMA bodies; its first
   step traced: the GEMM's device ms a step), the losses within 2e-2,
   step p50, tokens/s and peak memory of each;
13. tier phase: ``olmo-1b`` as a multi-process tier on the card, 2 engine
   workers of 8 slots (capacity 2048) and a prefill worker, each a
   ``python -m repro_torch.launch.serve --role ...`` process on the
   kernels, behind ``serving.Router``, 16 prompts of 256-1024 tokens and
   32 new tokens each: (a) full width at 4 layers in fp32, colocated
   (256 new tokens, an instance drained mid-stream once it holds 3 live
   rows; the drain must move at least 2) and disaggregated (an instance
   drained at its first row): every greedy stream equal, bit for bit, to
   one engine's in this process;
   (b) in this process, ``rwkv6-7b`` at 2 layers and
   ``recurrentgemma-9b`` at one superblock (window 256) in fp32: every
   live row drained mid-stream, packed, unpacked and imported into a
   second engine gives the uninterrupted streams; (c) full width at 8 of
   the 16 layers (TIER_BF16_LAYERS) in bf16: a warm-up, a timed run
   through the prefill worker and one without it, the workers' launch
   counts read just before and just after each (8 ``flash_fwd`` per
   prompt in the prefill worker or, colocated, in the instance that
   admits it; 8 ``decode_ring`` per tick in each instance; nothing
   else; colocated, every instance must
   have prefilled and ticked), a colocated run with an instance drained
   mid-stream (at 3 live rows, at least 2 moved), every stream equal to
   one engine's in this process, which is timed too (generated tokens/s
   and latency p50/p99 beside the tier's router latency); a worker that
   dies or fails to build fails the phase;
14. CLI phase: ``repro_torch.launch.serve --arch alexnet --requests 8``
   (fp32, and ``--numerics bf16``) and ``--arch olmo-1b --layers 2
   --requests 8 --capacity 512`` (ring,
   and ``--block-size 16``, and ``--tier 2 --disagg``, whose workers must
   launch ``flash_fwd`` and ``decode_ring``), ``--arch rwkv6-7b --layers
   2`` and ``--arch recurrentgemma-9b --layers 3`` (the same requests,
   speculative with ``--draft-layers 1 --spec-tokens 4``: a ``spec:``
   line), then
   ``repro_torch.launch.train --faithful --replicas 2 --batch 64``
   and ``--arch olmo-1b --layers 2 --seq-len 256 --batch 4``, each for 6
   steps with a checkpoint after step 4, resumed from it to 6 (steps 5
   and 6 against the uninterrupted run; the LM's losses equal bit for
   bit); ``--arch rwkv6-7b --layers 1`` for 5 steps with a checkpoint
   after step 4, resumed to 5 (bit for bit), and ``--arch
   recurrentgemma-9b --layers 3`` for 3 steps; the AlexNet train CLI
   on the mesh engine (``--engine mesh``: two rank processes on the one
   card, gloo) for 4 steps with a checkpoint after step 4, which the
   one-process engine resumes to step 6, all six losses held against
   the uninterrupted one-process run, then 3 steps of ``--exchange-delay
   1 --exchange-compression topk`` on the mesh held against the same on
   one process; ``--arch mixtral-8x7b`` trained at 1 layer (2 x 2 x
   256, 3 steps) and served at 2 layers; the chains of child processes
   (serve, speculative serve, tier, each train CLI's runs, the mesh
   runs, Mixtral's) run side by side, sharing the card;
15. prints the card again, the ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; it also does so without a CUDA device and outside a checkout.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SERVE_BATCH = 8
TRAIN_BATCH = 128        # per replica: the paper's global 256 over 2
IM2COL_BATCH = 32        # per replica, the im2col training phase
REPLICAS = 2
FP32_PEAK = 67e12        # H100 SXM fp32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12       # H100 SXM dense bf16 on the tensor cores, FLOP/s
HBM_RATE = 3.35e12       # H100 SXM HBM3, bytes/s
CONV_TOL = 2e-4          # registry tolerance of repro/kernels/conv2d/ops.py
LRN_TOL = 2e-5           # registry tolerance of repro/kernels/lrn/ops.py
BF16_TOL = 8e-3          # bf16 conv / LRN kernel vs plain, relative to
                         # max |y|: 2 bf16 ulps (2 x 2^-8)
BF16_LOSS_TOL = 2e-2     # bf16-preset training, kernels vs plain policy
GEMM_TOL = 2e-4          # the conv registry's, whose GEMM stage this is
LOGIT_TOL = 1e-3
LOSS_TOL = 1e-3          # kernel vs plain training losses on the card
BACKEND_LOSS_TOL = 5e-3  # im2col vs fused: the reference's cross-backend
                         # tolerance (tests/train_loop/test_golden_traces)
MARGIN = 1e-3            # class ids are compared where top-2 exceeds this
CYCLES_PER_MS = 1.0e6    # torch.cuda._sleep rate, measured in main()
# flash attention: fp32 forward at the registry tolerance
# (repro/kernels/flash_attention/ops.py:51), grads at its 10x
# (tests/kernels/test_grad_parity.py:203-205); bf16 at
# tests/kernels/test_flash_attention.py:36-43's
FLASH_TOL = {torch.float32: (2e-4, 2e-3), torch.bfloat16: (3e-2, 3e-2)}
LM_ARCH = "olmo-1b"
LM_SEQ = 2048            # OLMo-1B's training context (arXiv:2402.00838)
LM_BATCH = 4             # sequences per replica
LM_PARITY_LAYERS = 4     # kernel-vs-plain run: same width, fp32
LM_PARITY_BATCH = 2
# flash-decode: fp32 at the registry tolerance
# (repro/kernels/decode_attention/ops.py:69), bf16 outputs at 2e-2
DECODE_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SERVE_SLOTS = 8
SERVE_CAPACITY = 2048    # OLMo-1B's context
SERVE_NEW = 128          # new tokens per request
SERVE_PROMPT = (256, 1024)
# full depth bf16, first decode tick, kernel vs plain from one state: the
# relative L2 error of the logits.  Kernel and plain round their fp32
# attention to bf16 apart in about one output in 4,000, and 16 layers of
# bf16 math grow that: single logits move by up to ~4e-2 on the H100
# (PERF.md), so the gate is norm-wise, and every row whose plain top-2
# margin exceeds twice the largest |error| must pick the same next token.
SERVE_LOGIT_TOL = 3e-2


# serving the recurrent LMs at the published width and depth in bf16 (8
# slots, capacity 2048, prompts of SERVE_PROMPT tokens): the phase's name,
# and the fp32 kernel-vs-plain run's depth and window (the hybrid's cut to
# 256 slots, so its prompts wrap the ring)
RECURRENT_SERVE = {"rwkv6-7b": ("ssm_serving", 2, None),
                   "recurrentgemma-9b": ("hybrid_serving", 3, 256)}
RECURRENT_SERVE_NEW = 32       # new tokens per request
RECURRENT_SERVE_REQUESTS = 16  # the timed window
# the traced window: one wave of SERVE_SLOTS requests.  It records host
# activity for the named ranges, and exporting and reading that trace took
# ~65 s for 16 requests of rwkv6-7b on an H100 host
RECURRENT_TRACE_REQUESTS = 8
# bf16 at full depth, kernel against plain: how much further from the fp32
# logits the kernel may be than the plain version (anchored_check)
BF16_NOISE_RATIO = 1.5

# speculative serving at the published width and full depth in bf16 (8
# slots, capacity 2048, prompts of SERVE_PROMPT tokens), each target
# drafting with its own first layers: the phase's name, the draft's
# depth, the fp32 stream parity's target and draft depths and window,
# and whether the phase times a window of spec against plain serving
SPEC_SERVE = {"olmo-1b": ("spec_dense", 2, 4, 1, None, True),
              "recurrentgemma-9b": ("spec_hybrid", 3, 4, 3, 256, True),
              "rwkv6-7b": ("spec_ssm", 2, 2, 1, None, False)}
SPEC_TOKENS = 4                # gamma: draft tokens a round
SPEC_NEW = 32                  # new tokens per request
SPEC_REQUESTS = 16             # the timed windows


# the recurrent LMs: (depth, sequences per replica, parity depth, parity
# mode) at the published width; the depth is the cut that fits two
# replicas' bf16 params and grads and fp32 velocity on one 80 GB card
RECURRENT = {"rwkv6-7b": (8, 4, 2, "trace"),
             "recurrentgemma-9b": (5, 2, 3, "grads")}
WKV_TOL = {torch.float32: 2e-4,   # the registry's (rwkv6/ops.py:60)
           torch.bfloat16: 1e-2}  # y rounded to bf16 on both sides
RGLRU_TOL = 2e-4                  # the registry's (rglru/ops.py:50)
GRAD_REL_TOL = 1e-3  # kernel vs plain fp32 grads, relative to the leaf's max
WKV_CASES = [  # (case, B, T, H, K, r/k/v dtype, one w = 0 entry)
    ("train", 4, LM_SEQ, 64, 64, torch.bfloat16, False),
    ("ragged", 1, 1000, 64, 64, torch.bfloat16, False),
    ("fp32", 4, LM_SEQ, 64, 64, torch.float32, False),
    ("w_zero", 1, 256, 64, 64, torch.float32, True),
]
RGLRU_CASES = [  # (case, B, T, D, strong decay)
    ("train", 2, LM_SEQ, 4096, False),
    ("ragged", 1, 1000, 4000, False),
    ("strong_decay", 2, LM_SEQ, 4096, True),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def _sleep_cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, over ``reps`` calls each bracketed
    by CUDA events.  The calls are queued behind a sleep kernel that
    outlasts their host-side launch cost, so the events time the device's
    work and not the host's (a kernel of a few microseconds takes longer
    to launch from Python than to run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(CYCLES_PER_MS * (2.0 * host_ms * reps + 1.0)))
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_family(name: str) -> str:
    """The family a device kernel's time is booked under."""
    n = name.lower()
    for fam, keys in (("conv2d_fused", ("conv2d_fused",)),
                      ("lrn", ("lrn_vec_kernel", "lrn_vec8_kernel",
                               "lrn_generic_kernel")),
                      ("matmul_bias", ("matmul_bias",)),
                      ("max_pool", ("max_pool",)),
                      ("conv_grad", ("wgrad", "dgrad", "cudnn", "conv",
                                     "implicit", "winograd", "fft")),
                      ("gemm", ("gemm",)),
                      ("elementwise", ("elementwise", "reduce", "fill",
                                       "vectorized", "unrolled", "copy",
                                       "cat", "index", "gather",
                                       "scatter"))):
        if any(k in n for k in keys):
            return fam
    return "other"


def lm_family(name: str) -> str:
    """The family a device kernel of the LM step is booked under."""
    n = name.lower()
    for fam, keys in (("flash_fwd", ("flash_fwd_kernel",)),
                      ("wkv", ("wkv_chunk_kernel", "wkv_carry_kernel")),
                      ("rglru", ("rglru_scan_kernel",)),
                      ("decode", ("decode_kernel", "decode_mma_kernel",
                                  "decode_merge")),
                      ("flash_dq", ("flash_dq_kernel",)),
                      ("flash_dkv", ("flash_dkv_kernel",)),
                      ("matmul_bias", ("matmul_bias",)),
                      ("gemm", ("gemm", "nvjet", "xmma", "cutlass",
                                "cublas")),
                      ("embed_xent", ("embedding", "indexselect",
                                      "index_select", "gather", "scatter",
                                      "logsumexp", "softmax")),
                      ("elementwise", ("elementwise", "reduce", "fill",
                                       "vectorized", "unrolled", "copy",
                                       "cat", "norm", "index"))):
        if any(k in n for k in keys):
            return fam
    return "other"


def device_busy(trace_path: str, family=kernel_family,
                scopes=()) -> dict:
    """Device time by kernel family and the ten longest kernels from a
    ``torch.profiler`` chrome trace, and the union of the spans in which
    a kernel or a copy ran.  A kernel launched inside a
    ``record_function`` range named in ``scopes`` (a CPU-side range,
    matched to the launch through its correlation id) is booked under
    that name instead of its family, and so is a copy queued there."""
    with open(trace_path) as f:
        trace = json.load(f)["traceEvents"]
    events = [e for e in trace
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not any(e["cat"] == "kernel" for e in events):
        raise AssertionError("the profiler traced no kernel on the device")
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in trace
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in scopes)
    scoped = {}
    for e in trace:
        if ranges and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            for a, b, name in ranges:
                if a <= e["ts"] <= b:
                    scoped[e.get("args", {}).get("correlation")] = name
                    break
    by, names = {}, {}
    for e in events:
        fam = scoped.get(e.get("args", {}).get("correlation")) or (
            "copy" if e["cat"] != "kernel" else family(e["name"]))
        by[fam] = by.get(fam, 0.0) + e["dur"] / 1e3
        if e["cat"] == "kernel":
            key = e["name"][:100]
            names[key] = names.get(key, 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_ms": busy / 1e3, "ms_by_family": by, "top_kernels": top}


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(what, got, want, tol) -> float:
    err = max_err(got, want)
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: max |err| {err:.3e} beyond "
                             f"rtol=atol={tol}")
    return err


def conv_cases(cases):
    """(config, batch, layer, x shape, ConvSpec) of every conv the
    (config, batch) cases run; a layer seen before is not repeated."""
    seen, out = set(), []
    for cfg, batch in cases:
        c_in, hw = cfg.in_channels, cfg.image_size
        for i, cs in enumerate(cfg.convs):
            key = (batch, hw, c_in, cs)
            if key not in seen:
                seen.add(key)
                out.append((cfg.name, batch, f"conv{i + 1}",
                            (batch, hw, hw, c_in), cs))
            hw = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
            if cs.pool:
                hw = (hw - 3) // 2 + 1
            c_in = cs.out_channels
    return out


def lrn_cases(cases):
    """(config, batch, layer, x shape) of every LRN the cases run."""
    out = []
    for cfg, batch in cases:
        c_in, hw = cfg.in_channels, cfg.image_size
        for i, cs in enumerate(cfg.convs):
            hw = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
            c_in = cs.out_channels
            if cs.lrn and not cfg.faithful:
                out.append((cfg.name, batch, f"lrn{i + 1}",
                            (batch, hw, hw, c_in)))
            if cs.pool:
                hw = (hw - 3) // 2 + 1
            if cs.lrn and cfg.faithful:
                out.append((cfg.name, batch, f"lrn{i + 1}",
                            (batch, hw, hw, c_in)))
    return out


def gemm_cases(cfg, batch):
    """(layer, product, M, K, N, trans_a, trans_b) of every GEMM one
    replica-step of im2col training runs: per conv the forward
    patches @ W, dw = patches^T @ dy and, past conv1 (whose input needs
    no grad), dx = dy @ W^T.  trans_* say which operand is a transposed
    view of a contiguous matrix."""
    out = []
    c_in, hw = cfg.in_channels, cfg.image_size
    for i, cs in enumerate(cfg.convs):
        oh = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
        m, k, n = batch * oh * oh, c_in * cs.kernel ** 2, cs.out_channels
        out.append((f"conv{i + 1}", "forward", m, k, n, False, False))
        if i > 0:
            out.append((f"conv{i + 1}", "dx", m, n, k, False, True))
        out.append((f"conv{i + 1}", "dw", k, m, n, True, False))
        hw = (oh - 3) // 2 + 1 if cs.pool else oh
        c_in = cs.out_channels
    return out


def _bound(flops, nbytes, peak=FP32_PEAK):
    """(least ms, what sets it): the FLOPs at ``peak`` (the rate of the
    arithmetic's type) or the bytes at the HBM rate, the longer."""
    ops, mem = flops / peak, nbytes / HBM_RATE
    return max(ops, mem) * 1e3, ("operations" if ops >= mem else "bytes")


def conv_phase(gen, cases, account=None):
    """``conv2d_fused`` against its plain version at every conv of
    ``cases`` (2e-4), two calls bit-equal, timed beside the plain version,
    cuDNN (a yardstick only) and the bound; one row per layer with the
    kernel's tile width, blocks and split (``conv_tiles``).
    ``account(name, key, row)`` sees every row."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.ref import conv2d_ref

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for cfg_name, batch, layer, xs, cs in conv_cases(cases):
        cin = xs[-1]
        cg = cin // cs.groups
        x = torch.randn(xs, generator=gen, device=dev)
        w = torch.randn((cs.kernel, cs.kernel, cg, cs.out_channels),
                        generator=gen, device=dev) * (2.0 / (
                            cs.kernel * cs.kernel * cg)) ** 0.5
        b = torch.randn((cs.out_channels,), generator=gen, device=dev) * 0.1
        kw = dict(stride=cs.stride, padding=cs.padding, bias=b, relu=True,
                  groups=cs.groups)
        with torch.inference_mode():
            got = conv_ops.conv2d_fused(x, w, backend="cuda", **kw)
            torch.cuda.synchronize()
            want = conv2d_ref(x, w, cs.stride, cs.padding, cs.groups,
                              bias=b, relu=True)
            err = check_close(f"conv2d_fused {cfg_name} b{batch} {layer}",
                              got, want, CONV_TOL)
            if not torch.equal(got, conv_ops.conv2d_fused(
                    x, w, backend="cuda", **kw)):
                raise AssertionError(f"conv2d_fused {cfg_name} b{batch} "
                                     f"{layer}: two calls differ")
            # cuDNN yardstick: the same function in channels-last NCHW
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def library():
                return F.relu(F.conv2d(x_cl, w_cl, b, cs.stride, cs.padding,
                                       1, cs.groups))

            lib_err = max_err(library().permute(0, 2, 3, 1), got)
            k_ms = time_ms(lambda: conv_ops.conv2d_fused(
                x, w, backend="cuda", **kw))
            p_ms = time_ms(lambda: conv2d_ref(x, w, cs.stride, cs.padding,
                                              cs.groups, bias=b, relu=True),
                           reps=5)
            l_ms = time_ms(library)
        oh, ow = got.shape[1], got.shape[2]
        m = batch * oh * ow
        npg = cs.out_channels // cs.groups
        bn, split = conv_ops.conv_tiles(m, npg, cs.kernel ** 2 * cg,
                                        cs.groups, sms)
        flops = 2.0 * m * cs.out_channels * cs.kernel ** 2 * cg
        nbytes = 4.0 * (x.numel() + w.numel() + b.numel() + got.numel())
        bound, bound_by = _bound(flops, nbytes)
        row = {"phase": "kernel", "kernel": "conv2d_fused",
               "config": cfg_name, "batch": batch, "layer": layer,
               "x": list(xs), "w": list(w.shape), "stride": cs.stride,
               "padding": cs.padding, "groups": cs.groups,
               "tile": [conv_ops.CONV_BM, bn],
               "blocks": (-(-m // conv_ops.CONV_BM) * -(-npg // bn)
                          * cs.groups * split),
               "split": split,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "assumes": "67 TFLOP/s fp32 non-tensor, 3.35 TB/s",
               "flops": flops, "bytes": nbytes,
               "tflops": flops / (k_ms * 1e-3) / 1e12,
               "max_err": err, "library_err": lib_err}
        emit(row)
        if account:
            account("conv2d_fused", (cfg_name, batch), row)


def kernel_phase(gen, main, cases):
    """Kernel rows at every shape of ``cases``; the totals sum the rows
    of ``main`` = (config name, batch), the training path's forward."""
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "max_abs_err": 0.0, "flops": 0.0,
                     "bytes": 0.0}
              for name in ("conv2d_fused", "lrn", "matmul_bias")}

    def account(name, key, row):
        tot = totals[name]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_err"])
        if key == main or name == "matmul_bias":
            for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
                src = "kernel_ms" if k == "ms" else k
                tot[k] += row[src]
            tot["flops"] += row["flops"]
            tot["bytes"] += row["bytes"]

    conv_phase(gen, cases, account)
    lrn_phase(gen, cases, account)
    gemm_phase(gen, totals, account)
    return totals


def lrn_phase(gen, cases, account=None):
    """``lrn`` against its plain version at every LRN of ``cases``
    (2e-5), two calls bit-equal, timed beside the plain version,
    ``F.local_response_norm`` (a yardstick only) and the bound; one row
    per layer.  ``account(name, key, row)`` sees every row."""
    import torch.nn.functional as F

    from repro_torch.kernels.lrn import ops as lrn_ops
    from repro_torch.kernels.lrn.ref import lrn_ref

    dev = torch.device("cuda")
    for cfg_name, batch, layer, xs in lrn_cases(cases):
        cfg = next(c for c, _ in cases if c.name == cfg_name)
        n, alpha, beta, k = cfg.lrn_n, cfg.lrn_alpha, cfg.lrn_beta, cfg.lrn_k
        x = torch.randn(xs, generator=gen, device=dev) * 10.0
        with torch.inference_mode():
            got = lrn_ops.lrn(x, n=n, alpha=alpha, beta=beta, k=k,
                              backend="cuda")
            torch.cuda.synchronize()
            want = lrn_ref(x, n=n, alpha=alpha, beta=beta, k=k)
            err = check_close(f"lrn {cfg_name} b{batch} {layer}", got, want,
                              LRN_TOL)
            if not torch.equal(got, lrn_ops.lrn(x, n=n, alpha=alpha,
                                                beta=beta, k=k,
                                                backend="cuda")):
                raise AssertionError(f"lrn {cfg_name} b{batch} {layer}: "
                                     "two calls differ")
            # PyTorch's LRN divides alpha by the window size
            x_nchw = x.permute(0, 3, 1, 2).contiguous()

            def library():
                return F.local_response_norm(x_nchw, n, alpha=n * alpha,
                                             beta=beta, k=k)

            lib_err = max_err(library().permute(0, 2, 3, 1), got)
            k_ms = time_ms(lambda: lrn_ops.lrn(x, n=n, alpha=alpha,
                                               beta=beta, k=k,
                                               backend="cuda"))
            p_ms = time_ms(lambda: lrn_ref(x, n=n, alpha=alpha, beta=beta,
                                           k=k))
            l_ms = time_ms(library)
        nbytes = 8.0 * x.numel()
        row = {"phase": "kernel", "kernel": "lrn", "config": cfg_name,
               "batch": batch, "layer": layer, "x": list(xs), "n": n,
               "alpha": alpha, "beta": beta, "k": k, "kernel_ms": k_ms,
               "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": nbytes / HBM_RATE * 1e3, "bound_by": "bytes",
               "assumes": "3.35 TB/s", "flops": 0.0, "bytes": nbytes,
               "gbps": nbytes / (k_ms * 1e-3) / 1e9, "max_err": err,
               "library_err": lib_err}
        emit(row)
        if account:
            account("lrn", (cfg_name, batch), row)


def bf16_check(what, got, want) -> tuple:
    """(max |err|, max |err| / max |want|), raising beyond BF16_TOL of
    max |want|."""
    err = max_err(got, want)
    top = want.float().abs().max().item()
    if not err <= BF16_TOL * top:
        raise AssertionError(f"{what}: max |err| {err:.3e} beyond "
                             f"{BF16_TOL} x max |y| = {BF16_TOL * top:.3e}")
    return err, err / top


def bf16_flips(a, b) -> dict:
    """How many outputs of two bf16 tensors differ, their share, and the
    most bf16 ulps between two of them (bit patterns mapped to one ordered
    integer line, so +0 and -0 are 0 apart)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)

    ulps = (ordered(a) - ordered(b)).abs()
    differ = int((ulps > 0).sum().item())
    return {"differ": differ, "share": differ / ulps.numel(),
            "max_ulps": int(ulps.max().item())}


def bf16_kernel_phase(gen, cfg, batch):
    """``conv2d_fused_bf16`` at the 5 convs and ``lrn_bf16`` at the LRNs
    of ``cfg`` at ``batch``, bf16 operands, against their plain versions
    (upcast, fp32 math, one rounding; BF16_TOL relative to max |y|), two
    calls bit-equal, the conv also with its reduction split 3 ways;
    timed beside the plain version, the library call in bf16 (cuDNN on
    channels-last, ``F.local_response_norm``; yardsticks only) and the
    bound (the tensor cores' 989 TFLOP/s or 3.35 TB/s).  Each conv must
    take the wgmma body (it raises otherwise); its row names the body,
    tile and split, the TFLOP/s and the share of the bound, and times the
    entry's mma_sync body at the same shape beside it (a yardstick, held
    to the same tolerance).  Each LRN row names its path and counts the
    outputs where its SFU power and the full-accuracy one (the 4-channel
    path, taken by the same values at an 8-byte offset) round apart, and
    where each differs from the plain version, with the most bf16 ulps
    between them.  Returns the totals of the two entries."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.lrn import ops as lrn_ops
    from repro_torch.kernels.lrn.ref import lrn_ref

    dev, bf = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "max_abs_err": 0.0,
                     "max_rel_err": 0.0, "flops": 0.0, "bytes": 0.0}
              for name in ("conv2d_fused_bf16", "lrn_bf16")}

    def account(name, row):
        tot = totals[name]
        if "mma_sync_ms" in row:
            tot["mma_sync_ms"] = tot.get("mma_sync_ms", 0.0) + \
                row["mma_sync_ms"]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_err"])
        tot["max_rel_err"] = max(tot["max_rel_err"], row["rel_err"])
        for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
            tot[k] += row["kernel_ms" if k == "ms" else k]
        tot["flops"] += row["flops"]
        tot["bytes"] += row["bytes"]

    for cfg_name, _, layer, xs, cs in conv_cases([(cfg, batch)]):
        cg = xs[-1] // cs.groups
        x = torch.randn(xs, generator=gen, device=dev).to(bf)
        w = (torch.randn((cs.kernel, cs.kernel, cg, cs.out_channels),
                         generator=gen, device=dev)
             * (2.0 / (cs.kernel * cs.kernel * cg)) ** 0.5).to(bf)
        b = (torch.randn((cs.out_channels,), generator=gen, device=dev)
             * 0.1).to(bf)
        kw = dict(stride=cs.stride, padding=cs.padding, bias=b, relu=True,
                  groups=cs.groups)
        what = f"conv2d_fused_bf16 {cfg_name} b{batch} {layer}"
        with torch.inference_mode():
            wgmma0 = conv_ops.conv2d_fused.launches_bf16_wgmma
            got = conv_ops.conv2d_fused(x, w, backend="cuda", **kw)
            torch.cuda.synchronize()
            if conv_ops.conv2d_fused.launches_bf16_wgmma != wgmma0 + 1:
                raise AssertionError(f"{what}: did not take the wgmma body")
            want = conv2d_ref(x, w, cs.stride, cs.padding, cs.groups,
                              bias=b, relu=True)
            if got.dtype != bf or want.dtype != bf:
                raise AssertionError(f"{what}: dtypes {got.dtype} / "
                                     f"{want.dtype}")
            err, rel = bf16_check(what, got, want)
            if not torch.equal(got, conv_ops.conv2d_fused(
                    x, w, backend="cuda", **kw)):
                raise AssertionError(f"{what}: two calls differ")
            m = got.shape[0] * got.shape[1] * got.shape[2]
            npg = cs.out_channels // cs.groups
            body, bn, split = conv_ops.conv_plan_bf16(
                xs, cs.out_channels, cs.kernel, cs.stride, cs.padding,
                cs.groups, sms)
            split3 = conv_ops._conv_forward(x, w, b, cs.stride, cs.padding,
                                            True, cs.groups, "cuda",
                                            tiles=(bn, 3))
            split_err, _ = bf16_check(what + " split 3", split3, want)

            def mma_sync():
                return conv_ops._conv_forward(x, w, b, cs.stride, cs.padding,
                                              True, cs.groups, "cuda",
                                              body="mma_sync")

            mma_err, _ = bf16_check(what + " mma_sync body", mma_sync(),
                                    want)
            _, mma_bn, mma_split = conv_ops.conv_plan_bf16(
                xs, cs.out_channels, cs.kernel, cs.stride, cs.padding,
                cs.groups, sms, body="mma_sync")
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def library():
                return F.relu(F.conv2d(x_cl, w_cl, b, cs.stride, cs.padding,
                                       1, cs.groups))

            lib_err = max_err(library().permute(0, 2, 3, 1), got)
            k_ms = time_ms(lambda: conv_ops.conv2d_fused(
                x, w, backend="cuda", **kw))
            p_ms = time_ms(lambda: conv2d_ref(x, w, cs.stride, cs.padding,
                                              cs.groups, bias=b, relu=True),
                           reps=5)
            l_ms = time_ms(library)
            mma_ms = time_ms(mma_sync)
        flops = 2.0 * m * cs.out_channels * cs.kernel ** 2 * cg
        nbytes = 2.0 * (x.numel() + w.numel() + b.numel() + got.numel())
        bound, bound_by = _bound(flops, nbytes, BF16_PEAK)
        row = {"phase": "kernel", "kernel": "conv2d_fused_bf16",
               "config": cfg_name, "batch": batch, "layer": layer,
               "x": list(xs), "w": list(w.shape), "groups": cs.groups,
               "body": body, "tile": [conv_ops.CONV_BF16_BM, bn],
               "split": split,
               "blocks": (-(-m // conv_ops.CONV_BF16_BM) * -(-npg // bn)
                          * cs.groups * split),
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "mma_sync_ms": mma_ms,
               "mma_sync_tile": [conv_ops.CONV_BM, mma_bn],
               "mma_sync_split": mma_split,
               "bound_ms": bound, "bound_by": bound_by,
               "bound_share": bound / k_ms,
               "assumes": "989 TFLOP/s bf16 tensor cores, 3.35 TB/s",
               "flops": flops, "bytes": nbytes,
               "tflops": flops / (k_ms * 1e-3) / 1e12, "max_err": err,
               "rel_err": rel, "split3_err": split_err,
               "mma_sync_err": mma_err, "library_err": lib_err}
        emit(row)
        account("conv2d_fused_bf16", row)
    for cfg_name, _, layer, xs in lrn_cases([(cfg, batch)]):
        n, alpha, beta, k = cfg.lrn_n, cfg.lrn_alpha, cfg.lrn_beta, cfg.lrn_k
        x = (torch.randn(xs, generator=gen, device=dev) * 10.0).to(bf)
        kw = dict(n=n, alpha=alpha, beta=beta, k=k)
        what = f"lrn_bf16 {cfg_name} b{batch} {layer}"
        with torch.inference_mode():
            got = lrn_ops.lrn(x, backend="cuda", **kw)
            torch.cuda.synchronize()
            want = lrn_ref(x, **kw)
            err, rel = bf16_check(what, got, want)
            if not torch.equal(got, lrn_ops.lrn(x, backend="cuda", **kw)):
                raise AssertionError(f"{what}: two calls differ")
            path = lrn_ops.lrn_path(xs[-1], n, bf, k, alpha)
            # the full-accuracy form: the same values 8 bytes off a
            # 16-byte boundary take the 4-channel path (exp2f / log2f)
            x8 = torch.empty(x.numel() + 4, device=dev, dtype=bf)[4:]
            x8 = x8.view(xs).copy_(x)
            if lrn_ops.lrn_path(xs[-1], n, bf, k, alpha, align=8) != "vec4":
                raise AssertionError(f"{what}: the offset copy does not "
                                     "take the 4-channel path")
            full = lrn_ops.lrn(x8, backend="cuda", **kw)
            flips = {"sfu_vs_full": bf16_flips(got, full),
                     "sfu_vs_plain": bf16_flips(got, want),
                     "full_vs_plain": bf16_flips(full, want)}
            x_nchw = x.permute(0, 3, 1, 2).contiguous()

            def library():
                return F.local_response_norm(x_nchw, n, alpha=n * alpha,
                                             beta=beta, k=k)

            lib_err = max_err(library().permute(0, 2, 3, 1), got)
            k_ms = time_ms(lambda: lrn_ops.lrn(x, backend="cuda", **kw))
            p_ms = time_ms(lambda: lrn_ref(x, **kw))
            l_ms = time_ms(library)
        nbytes = 4.0 * x.numel()
        row = {"phase": "kernel", "kernel": "lrn_bf16", "config": cfg_name,
               "batch": batch, "layer": layer, "x": list(xs),
               "path": path, "flips": flips,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": nbytes / HBM_RATE * 1e3, "bound_by": "bytes",
               "assumes": "3.35 TB/s", "flops": 0.0, "bytes": nbytes,
               "gbps": nbytes / (k_ms * 1e-3) / 1e9, "max_err": err,
               "rel_err": rel, "library_err": lib_err}
        emit(row)
        account("lrn_bf16", row)
    for name, tot in totals.items():
        tot["bound_by"] = _bound(tot["flops"], tot["bytes"], BF16_PEAK)[1]
        tot["tolerance"] = f"{BF16_TOL} x max |y|"
    return totals


def gemm_phase(gen, totals, account):
    """``matmul_bias`` at every GEMM of one replica-step of im2col
    training on ALEXNET_FAITHFUL (batch 32 per replica).  The plain
    version (``x @ w + b``, ReLU) and the library yardstick (``addmm`` +
    ReLU, or ``mm`` for the bias-free backward products) are both cuBLAS
    fp32 GEMMs: nearly the same call, timed apart all the same."""
    from repro_torch.configs import ALEXNET_FAITHFUL
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.ref import matmul_bias_ref

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for layer, product, m, k, n, ta, tb in gemm_cases(ALEXNET_FAITHFUL,
                                                       IM2COL_BATCH):
        # unit-variance a and b ~ N(0, 1/K), as He-scaled weights or a
        # normalized cotangent: outputs are O(1) whatever the depth K, so
        # the mixed abs/rel tolerance means the same at K = 363 and 96,800
        a = torch.randn((k, m) if ta else (m, k), generator=gen, device=dev)
        b = torch.randn((n, k) if tb else (k, n), generator=gen,
                        device=dev) * k ** -0.5
        a, b = (a.t() if ta else a), (b.t() if tb else b)
        bias = (torch.randn((n,), generator=gen, device=dev)
                if product == "forward" else None)
        relu = product == "forward"
        with torch.inference_mode():
            got = conv_ops.matmul_bias(a, b, bias, relu=relu, backend="cuda")
            torch.cuda.synchronize()
            want = matmul_bias_ref(a, b, bias, relu)
            err = check_close(f"matmul_bias {layer} {product}", got, want,
                              GEMM_TOL)
            split = conv_ops.gemm_split(m, n, k, sms)
            if not torch.equal(got, conv_ops.matmul_bias(
                    a, b, bias, relu=relu, backend="cuda")):
                raise AssertionError(f"matmul_bias {layer} {product}: two "
                                     f"calls differ (split {split}; the "
                                     "split-K sum must be deterministic)")

            def library():
                y = torch.addmm(bias, a, b) if relu else torch.mm(a, b)
                return torch.relu(y) if relu else y

            lib_err = max_err(library(), got)
            k_ms = time_ms(lambda: conv_ops.matmul_bias(
                a, b, bias, relu=relu, backend="cuda"), reps=10)
            p_ms = time_ms(lambda: matmul_bias_ref(a, b, bias, relu),
                           reps=10)
            l_ms = time_ms(library, reps=10)
        flops = 2.0 * m * n * k
        nbytes = 4.0 * (m * k + k * n + m * n + (n if relu else 0))
        bound, bound_by = _bound(flops, nbytes)
        row = {"phase": "kernel", "kernel": "matmul_bias",
               "config": ALEXNET_FAITHFUL.name, "batch": IM2COL_BATCH,
               "layer": layer, "product": product, "m": m, "k": k, "n": n,
               "trans_a": ta, "trans_b": tb, "relu": relu,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "library": "plain and library are both cuBLAS fp32 GEMMs",
               "bound_ms": bound, "bound_by": bound_by,
               "assumes": "67 TFLOP/s fp32 non-tensor, 3.35 TB/s",
               "flops": flops, "bytes": nbytes,
               "tflops": flops / (k_ms * 1e-3) / 1e12,
               "blocks": (-(-m // conv_ops.GEMM_BM)
                          * -(-n // conv_ops.gemm_bn(n)) * split),
               "split": split,
               "max_err": err, "library_err": lib_err}
        emit(row)
        account("matmul_bias", None, row)


def closed_loop(engine, pool, n_req: int, clients: int):
    """Serve ``n_req`` requests from ``clients`` closed-loop clients, each
    sending its next image (cycled from ``pool``) when its answer comes
    back.  Returns (wall seconds, sorted latencies in seconds)."""
    from repro_torch.serving import Request

    sent, lats = 0, []
    t0 = time.perf_counter()
    for _ in range(clients):
        engine.submit(Request(image=pool[sent % len(pool)]))
        sent += 1
    while len(lats) < n_req:
        for res in engine.step():
            lats.append(res.latency)
            if sent < n_req:
                engine.submit(Request(image=pool[sent % len(pool)]))
                sent += 1
    return time.perf_counter() - t0, sorted(lats)


def percentile(sorted_xs, q: float) -> float:
    return sorted_xs[min(int(q * len(sorted_xs)), len(sorted_xs) - 1)]


def timing_phase(model, cfg, seed, slots, n_req=2048, windows=3,
                 pool_size=256):
    """images/s and latency p50/p99 of ``windows`` windows of ``n_req``
    full-width requests from ``slots`` closed-loop clients (one forward
    of bucket ``slots`` per wave), then one more window under
    ``torch.profiler`` for the device's busy time.  The idle share is
    1 - busy / wall of each unprofiled window: the profiler's own host
    cost stretches its window's wall but not the device's work."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import ServingEngine

    rs = np.random.default_rng(seed + 1)
    pool = rs.standard_normal((pool_size, cfg.image_size, cfg.image_size,
                               cfg.in_channels), dtype=np.float32)
    engine = ServingEngine(model, cfg, slots=slots)
    closed_loop(engine, pool, 4 * slots, slots)          # warm-up
    rows = []
    for i in range(windows):
        wall, lats = closed_loop(engine, pool, n_req, slots)
        rows.append({"window": i, "wall_s": wall,
                     "images_per_s": n_req / wall,
                     "latency_p50_ms": percentile(lats, 0.5) * 1e3,
                     "latency_p99_ms": percentile(lats, 0.99) * 1e3})
    if engine._buckets_used != {("img", slots)}:
        raise AssertionError(f"buckets {engine._buckets_used}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall, _ = closed_loop(engine, pool, n_req, slots)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve_trace.json")
        prof.export_chrome_trace(path)
        busy = device_busy(path)
    forwards = n_req // slots
    for row in rows:
        row["device_idle_share"] = 1.0 - busy["busy_ms"] / 1e3 / row["wall_s"]
        emit({"phase": "serving_window", "config": cfg.name, "slots": slots,
              "clients": slots, "requests": n_req, **row})

    def spread(key):
        xs = sorted(r[key] for r in rows)
        return {"min": xs[0], "median": statistics.median(xs), "max": xs[-1]}

    emit({"phase": "serving_timing", "config": cfg.name, "slots": slots,
          "clients": slots, "requests_per_window": n_req,
          "windows": windows, "forwards_per_window": forwards,
          **{k: spread(k) for k in ("images_per_s", "latency_p50_ms",
                                    "latency_p99_ms", "device_idle_share")},
          "profiled_wall_s": prof_wall,
          "profiled_idle_share": 1.0 - busy["busy_ms"] / 1e3 / prof_wall,
          "device_busy_ms_per_forward": busy["busy_ms"] / forwards,
          "device_ms_per_forward_by_family": {
              k: v / forwards for k, v in busy["ms_by_family"].items()},
          "top_kernels_ms": busy["top_kernels"]})


def serving_phase(model_cfg, seed):
    """Correctness of the served path: 32 requests through the engine with
    the launch counts set to 0 just before and read just after, held
    against the same engine under the plain policy.  Then the timing
    windows on the same model."""
    import dataclasses

    from repro_torch import models
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.kernels.conv2d.ops import conv2d_fused
    from repro_torch.kernels.lrn.ops import lrn
    from repro_torch.models.alexnet import AlexNet
    from repro_torch.serving import Request, ServingEngine

    dev = torch.device("cuda")
    slots, n_req = 8, 32
    cfg = dataclasses.replace(model_cfg, kernels=KernelPolicy("auto"))
    plain_cfg = dataclasses.replace(model_cfg, kernels=KernelPolicy("plain"))
    t0 = time.perf_counter()
    model = models.init(cfg, torch.Generator().manual_seed(seed), device=dev)
    plain = AlexNet(plain_cfg, device=dev)
    plain.load_state_dict(model.state_dict())
    init_s = time.perf_counter() - t0
    rs = np.random.default_rng(seed)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    imgs = rs.standard_normal((n_req,) + shape).astype(np.float32)
    warm = rs.standard_normal((slots,) + shape).astype(np.float32)

    # warm-up wave (cuBLAS handles, allocator); not counted
    ServingEngine(model, cfg, slots=slots).run(
        [Request(image=im) for im in warm])
    torch.cuda.synchronize()

    engine = ServingEngine(model, cfg, slots=slots)
    conv2d_fused.launches = 0
    lrn.launches = 0
    results = engine.run([Request(image=im) for im in imgs])
    launches = {"conv2d_fused": conv2d_fused.launches, "lrn": lrn.launches}

    forwards = math.ceil(n_req / slots)
    n_conv = len(cfg.convs)
    n_lrn = sum(cs.lrn for cs in cfg.convs)
    if launches != {"conv2d_fused": n_conv * forwards,
                    "lrn": n_lrn * forwards}:
        raise AssertionError(f"launches {launches} != {n_conv} conv and "
                             f"{n_lrn} LRN per forward x {forwards}")
    if len(results) != n_req or any(len(r.tokens) != 1 for r in results):
        raise AssertionError("every request must finish with one class id")
    if engine.decode_steps != 0:
        raise AssertionError(f"decode_steps {engine.decode_steps} != 0")
    if engine._buckets_used != {("img", slots)}:
        raise AssertionError(f"buckets {engine._buckets_used}")
    ids = {r.rid: r.tokens[0] for r in results}

    plain_results = ServingEngine(plain, plain_cfg, slots=slots).run(
        [Request(image=im) for im in imgs])
    plain_ids = {r.rid: r.tokens[0] for r in plain_results}

    with torch.inference_mode():
        x = torch.from_numpy(imgs).to(dev)
        logits = torch.cat([model(x[i:i + slots])
                            for i in range(0, n_req, slots)])
        plain_logits = torch.cat([plain(x[i:i + slots])
                                  for i in range(0, n_req, slots)])
        fwd_ms = time_ms(lambda: model(x[:slots]), reps=10)
        plain_fwd_ms = time_ms(lambda: plain(x[:slots]), reps=5)
    if logits.shape != (n_req, cfg.n_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    logit_err = check_close("serving logits vs plain", logits, plain_logits,
                            LOGIT_TOL)
    top2 = torch.topk(plain_logits, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu()
    argmax = logits.argmax(-1).cpu()
    compared = 0
    for rid in range(n_req):
        if ids[rid] != int(argmax[rid]):
            raise AssertionError(f"rid {rid}: served {ids[rid]}, the "
                                 f"batched forward says {int(argmax[rid])}")
        if margin[rid] > MARGIN:
            compared += 1
            if ids[rid] != plain_ids[rid]:
                raise AssertionError(f"rid {rid}: kernel class {ids[rid]} "
                                     f"!= plain class {plain_ids[rid]}")
    emit({"phase": "serving", "config": cfg.name, "slots": slots,
          "requests": n_req, "forwards": forwards, "launches": launches,
          "forward_ms_b8": fwd_ms, "plain_forward_ms_b8": plain_fwd_ms,
          "logit_max_err": logit_err, "ids_compared": compared,
          "init_s": init_s})
    timing_phase(model, cfg, seed, slots)
    return launches


def host_pool(cfg, batch: int, n: int, seed: int):
    """``n`` host batches of the trainer's synthetic stream, drawn once
    (drawing a full-width batch of 256 costs the host most of a second,
    which would time numpy, not the card), and their mean image."""
    from repro_torch.data import synthetic

    it = synthetic.blob_images(cfg.n_classes, batch, cfg.image_size + 8,
                               seed=seed)
    pool = [next(it) for _ in range(n)]
    return pool, synthetic.mean_image(iter(pool), n)


def pool_stream(pool, mean, cfg, seed):
    """A ``make_stream`` for ``TrainSession``: the pool cycled through the
    trainer's preprocess (mean, crop, flip) and replica reshape."""
    from repro_torch.core.steps import reshape_for_replicas
    from repro_torch.data.preprocess import make_image_preprocess

    def make():
        prep = make_image_preprocess(mean, cfg.image_size, seed=seed)
        return (reshape_for_replicas(prep(b), REPLICAS)
                for b in itertools.cycle(pool))
    return make


def sgd(numerics=None):
    """The trainer's SGD momentum, with fp32 masters under a policy that
    keeps them."""
    from repro_torch.optim.optimizers import for_numerics, get_optimizer
    return for_numerics(get_optimizer("sgd_momentum"), numerics)


def init_state(cfg, seed, exchange=None):
    from repro_torch.core.steps import init_param_avg_state
    from repro_torch.models import alexnet
    from repro_torch.tree import tree_map

    def init_fn(gen):
        model = alexnet.init(cfg, gen, device="cuda")
        return tree_map(lambda p: p.detach(), model.params())

    return init_param_avg_state(torch.Generator().manual_seed(seed), init_fn,
                                sgd(cfg.numerics), REPLICAS,
                                exchange=exchange, numerics=cfg.numerics)


def alexnet_loss(cfg):
    from repro_torch.models import alexnet

    def loss(params, batch):
        return alexnet.loss_fn(params, cfg, batch["images"],
                               batch["labels"])
    return loss


def lm_loss(cfg):
    from repro_torch import models
    return lambda params, batch: models.loss_fn(params, cfg, batch)


def session(loss, state, make_stream, steps, items_per_step, *,
            staging="pinned", metrics_path=None, spreads=None,
            numerics=None, wrap=None, strategy="all_reduce"):
    """The trainer's session on the loss ``loss(params, batch)``: SGD
    momentum (m 0.9, wd 5e-4), LR 0.01, every-step all-reduce of weights
    and momentum, under the ``numerics`` policy (fp32 masters and loss
    scaling with the bf16 preset).  The step updates ``state`` in place
    (it is consumed), so a second run from the same start takes a fresh
    state.  With ``spreads`` each step appends the replicas' spread
    after it; ``wrap(step)`` wraps the step; ``strategy`` may be an
    ``Exchanger`` of the same schedule or an ``ExchangeConfig``."""
    from repro_torch.core.param_avg import replica_spread
    from repro_torch.core.steps import make_param_avg_step
    from repro_torch.optim import schedules
    from repro_torch.train_loop import TrainSession

    opt = sgd(numerics)

    def build_step(sched):
        step = make_param_avg_step(loss, opt, sched, strategy=strategy,
                                   numerics=numerics)
        if wrap is not None:
            step = wrap(step)
        if spreads is None:
            return step

        def checked(st, batch):
            st, out = step(st, batch)
            spreads.append(replica_spread((st.params, st.opt_state)))
            return st, out
        return checked

    return TrainSession(
        state=state, build_step=build_step, make_stream=make_stream,
        controller=schedules.constant(0.01), steps=steps,
        device=torch.device("cuda"), staging=staging, log_every=10 ** 9,
        images_per_step=items_per_step, metrics_path=metrics_path)


def launch_counts():
    """{entry: (wrapper, its counter attribute)}: the bf16 conv and LRN
    entries count apart from the fp32 ones on the same wrappers."""
    from repro_torch.kernels.conv2d.ops import conv2d_fused, matmul_bias
    from repro_torch.kernels.decode_attention.ops import (decode_ring,
                                                          decode_table)
    from repro_torch.kernels.flash_attention.ops import (flash_dkv, flash_dq,
                                                         flash_fwd)
    from repro_torch.kernels.lrn.ops import lrn
    from repro_torch.kernels.rglru.ops import rglru_fwd
    from repro_torch.kernels.rwkv6.ops import wkv_fwd
    out = {k: (fn, "launches") for k, fn in (
        ("conv2d_fused", conv2d_fused), ("lrn", lrn),
        ("matmul_bias", matmul_bias), ("flash_fwd", flash_fwd),
        ("flash_dq", flash_dq), ("flash_dkv", flash_dkv),
        ("decode_ring", decode_ring), ("decode_table", decode_table),
        ("wkv_fwd", wkv_fwd), ("rglru_fwd", rglru_fwd))}
    out["conv2d_fused_bf16"] = (conv2d_fused, "launches_bf16")
    out["lrn_bf16"] = (lrn, "launches_bf16")
    out["matmul_bias_bf16"] = (matmul_bias, "launches_bf16")
    return out


def read_counts() -> dict:
    return {k: getattr(fn, attr)
            for k, (fn, attr) in launch_counts().items()}


def zero_counts() -> None:
    for fn, attr in launch_counts().values():
        setattr(fn, attr, 0)


def want_counts(**nonzero) -> dict:
    """Every entry's expected launches: 0 but for ``nonzero``."""
    want = {k: 0 for k in launch_counts()}
    want.update(nonzero)
    return want


def losses_of(result) -> list:
    return [loss for _, loss in result.losses]


def train_phase(model_cfg, seed):
    """Full-width training: launch counts and parity against the plain
    policy over 3 steps, then timed and traced windows."""
    import dataclasses

    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(model_cfg, kernels=KernelPolicy("auto"))
    plain_cfg = dataclasses.replace(model_cfg, kernels=KernelPolicy("plain"))
    t0 = time.perf_counter()
    pool, mean = host_pool(cfg, TRAIN_BATCH * REPLICAS, 4, seed + 7)
    make_stream = pool_stream(pool, mean, cfg, seed)
    state0 = init_state(cfg, seed)
    setup_s = time.perf_counter() - t0
    steps = 3
    spreads = []
    items = TRAIN_BATCH * REPLICAS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.jsonl")
        sess = session(alexnet_loss(cfg), state0, make_stream, steps, items,
                       metrics_path=path, spreads=spreads)
        torch.cuda.synchronize()
        zero_counts()
        res = sess.run()
        torch.cuda.synchronize()
        launches = read_counts()
    n_conv = len(cfg.convs)
    n_lrn = sum(cs.lrn for cs in cfg.convs)
    want = want_counts(conv2d_fused=n_conv * REPLICAS * steps,
                       lrn=n_lrn * REPLICAS * steps)
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    losses = losses_of(res)
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training losses {losses}")
    if len(spreads) != steps or max(spreads) != 0.0:
        raise AssertionError(f"replica spread after each sync {spreads}")
    plain = session(alexnet_loss(plain_cfg), init_state(plain_cfg, seed),
                    make_stream, steps, items,
                    metrics_path=os.devnull).run()
    plain_losses = losses_of(plain)
    loss_errs = [abs(a - b) for a, b in zip(losses, plain_losses)]
    if max(loss_errs) > LOSS_TOL:
        raise AssertionError(f"kernel vs plain losses {losses} / "
                             f"{plain_losses}")
    param_err = max(max_err(a, b) for a, b in zip(
        tree_leaves(res.state.params), tree_leaves(plain.state.params)))
    emit({"phase": "train", "config": cfg.name, "replicas": REPLICAS,
          "per_replica_batch": TRAIN_BATCH, "steps": steps,
          "launches": launches, "losses": losses,
          "plain_losses": plain_losses, "loss_abs_err": loss_errs,
          "params_max_abs_err": param_err, "replica_spread": spreads,
          "staging": "pinned", "setup_s": setup_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del plain
    state = train_timing(alexnet_loss(cfg), res.state, make_stream,
                         cfg.name, "preprocess per batch", items,
                         scopes=("lrn_bwd",))
    # the same windows with the pool preprocessed once: the loader thread
    # then only copies into pinned memory, so the step shows the trainer
    # and the card rather than the host's numpy
    pre = make_stream()
    prepped = [next(pre) for _ in pool]
    train_timing(alexnet_loss(cfg), state, lambda: itertools.cycle(prepped),
                 cfg.name, "preprocessed pool", items, scopes=("lrn_bwd",))
    return launches, prepped


def train_timing(loss, state, make_stream, config, stream, items, *,
                 windows=3, steps=10, family=kernel_family,
                 tokens_per_item=None, scopes=(), numerics=None,
                 strategy="all_reduce", out=None):
    """``windows`` sessions of 1 warm-up + ``steps`` timed steps: items
    (images or sequences; ``items`` per step) per second and step
    p50/p99 from the session's Table-1 summary, and tokens/s when
    ``tokens_per_item`` is given.  One more session of ``steps`` steps
    under ``torch.profiler`` gives the device's busy time per step by
    ``family``; the idle share of a window is 1 - busy per step / its
    mean step time.  ``strategy`` is the exchange (``session``'s);
    ``out`` (a dict) receives the emitted ``train_timing`` record.
    Returns the state."""
    from torch.profiler import ProfilerActivity, profile

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(windows):
            path = os.path.join(tmp, f"w{i}.jsonl")
            res = session(loss, state, make_stream, steps + 1, items,
                          metrics_path=path, numerics=numerics,
                          strategy=strategy).run()
            state = res.state
            summ = res.summary
            rows.append({"window": i, "timed_steps": summ["timed_steps"],
                         "images_per_s": summ["images_per_sec"],
                         "step_ms_p50": summ["step_ms_p50"],
                         "step_ms_p99": summ["step_ms_p99"],
                         "step_ms_mean": 1e3 * items
                         / summ["images_per_sec"],
                         "stage_wait_ms_mean": summ.get(
                             "stage_wait_ms_mean")})
            if tokens_per_item:
                rows[-1]["tokens_per_s"] = (summ["images_per_sec"]
                                            * tokens_per_item)
        sess = session(loss, state, make_stream, steps, items,
                       metrics_path=os.path.join(tmp, "traced.jsonl"),
                       numerics=numerics, strategy=strategy)
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if scopes
                                          else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state = sess.run().state
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        trace = os.path.join(tmp, "train_trace.json")
        prof.export_chrome_trace(trace)
        busy = device_busy(trace, family, scopes)
    busy_step = busy["busy_ms"] / steps
    for row in rows:
        row["device_idle_share"] = 1.0 - busy_step / row["step_ms_mean"]
        emit({"phase": "train_window", "config": config,
              "stream": stream, **row})

    def spread(key):
        xs = sorted(r[key] for r in rows)
        return {"min": xs[0], "median": statistics.median(xs), "max": xs[-1]}

    keys = ["images_per_s", "step_ms_p50", "step_ms_p99",
            "device_idle_share", "stage_wait_ms_mean"]
    if tokens_per_item:
        keys.append("tokens_per_s")
    record = {"phase": "train_timing", "config": config, "stream": stream,
              "numerics": "fp32" if numerics is None
              else numerics.describe(),
              "replicas": REPLICAS, "items_per_step": items,
              "windows": windows, "timed_steps_per_window": steps,
              **{k: spread(k) for k in keys},
              "traced_wall_s": prof_wall,
              "device_busy_ms_per_step": busy_step,
              "device_ms_per_step_by_family": {
                  k: v / steps for k, v in busy["ms_by_family"].items()},
              "top_kernels_ms": busy["top_kernels"]}
    emit(record)
    if out is not None:
        out.update(record)
    return state


def poisoned(make_stream, at: int, replica: int):
    """``make_stream`` whose batch ``at`` (0-based) carries one NaN pixel
    in ``replica``'s first image only."""
    def make():
        for i, b in enumerate(make_stream()):
            if i == at:
                b = dict(b, images=np.array(b["images"], copy=True))
                b["images"][replica, 0, 0, 0, 0] = np.nan
            yield b
    return make


def train_bf16_phase(model_cfg, seed):
    """The faithful AlexNet at full width under the bf16 numerics preset
    (bf16 params, images and activations, fp32 masters, dynamic loss
    scaling), 2 x 128, 3 steps on the pool, step 2's batch poisoned with
    one NaN pixel in replica 1: the launch counts (the bf16 conv and LRN
    entries only, every conv launch on the wgmma body), losses against
    the plain policy under the same preset, the poisoned step
    bit-unchanged on both replicas (params, masters, velocity) with the
    scale halved and one skip counted, step 3 clean.  Then one timed and
    one traced window of 10 steps over the preprocessed pool."""
    import dataclasses

    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.kernels.conv2d.ops import conv2d_fused
    from repro_torch.numerics import get_policy
    from repro_torch.train_loop.metrics import read_jsonl
    from repro_torch.tree import tree_leaves

    npol = get_policy("bf16")
    cfg = dataclasses.replace(model_cfg, kernels=KernelPolicy("auto"),
                              numerics=npol)
    plain_cfg = dataclasses.replace(cfg, kernels=KernelPolicy("plain"))
    t0 = time.perf_counter()
    pool, mean = host_pool(cfg, TRAIN_BATCH * REPLICAS, 4, seed + 7)
    make_stream = poisoned(pool_stream(pool, mean, cfg, seed), 1, 1)
    state0 = init_state(cfg, seed)
    setup_s = time.perf_counter() - t0
    dtypes = sorted({str(x.dtype) for x in tree_leaves(state0.params)})
    if dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"bf16-preset params in {dtypes}")
    steps, items = 3, TRAIN_BATCH * REPLICAS
    checks = {}

    def wrap(step):
        def checked(st, batch):
            before = None
            if st.step == 1:          # the poisoned step
                before = [x.clone() for x in tree_leaves(
                    (st.params, st.opt_state))]
            st, loss = step(st, batch)
            if before is not None:
                after = tree_leaves((st.params, st.opt_state))
                checks["unchanged"] = all(torch.equal(a, b) for a, b in
                                          zip(before, after))
                checks["leaves"] = len(after)
            return st, loss
        return checked

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_bf16.jsonl")
        sess = session(alexnet_loss(cfg), state0, make_stream, steps, items,
                       metrics_path=path, numerics=npol, wrap=wrap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        conv2d_fused.launches_bf16_wgmma = 0
        res = sess.run()
        torch.cuda.synchronize()
        launches = read_counts()
        wgmma = conv2d_fused.launches_bf16_wgmma
        peak = torch.cuda.max_memory_allocated()
        records = read_jsonl(path, "train")
    n_conv = len(cfg.convs)
    n_lrn = sum(cs.lrn for cs in cfg.convs)
    want = want_counts(conv2d_fused_bf16=n_conv * REPLICAS * steps,
                       lrn_bf16=n_lrn * REPLICAS * steps)
    if launches != want:
        raise AssertionError(f"bf16 training launches {launches} != {want}")
    if wgmma != n_conv * REPLICAS * steps:
        raise AssertionError(f"bf16 training: {wgmma} of the "
                             f"{n_conv * REPLICAS * steps} conv launches "
                             "took the wgmma body")
    losses = losses_of(res)
    if len(losses) != steps or not math.isfinite(losses[0]) or \
            not math.isfinite(losses[2]) or math.isfinite(losses[1]):
        raise AssertionError(f"bf16 losses {losses}: steps 1 and 3 finite, "
                             "the poisoned step 2 not")
    if not checks.get("unchanged"):
        raise AssertionError(f"the poisoned step moved the state: {checks}")
    scales = [r["loss_scale"] for r in records]
    skipped = [r["skipped_steps"] for r in records]
    ns = res.state.numerics
    if scales != [2.0 ** 15, 2.0 ** 14, 2.0 ** 14] or \
            skipped != [0, 1, 1] or int(ns["good_steps"]) != 1:
        raise AssertionError(f"loss scale {scales}, skipped {skipped}, "
                             f"good steps {int(ns['good_steps'])}")
    plain = session(alexnet_loss(plain_cfg), init_state(plain_cfg, seed),
                    make_stream, steps, items, metrics_path=os.devnull,
                    numerics=npol).run()
    plain_losses = losses_of(plain)
    loss_errs = [abs(losses[i] - plain_losses[i]) for i in (0, 2)]
    if not max(loss_errs) <= BF16_LOSS_TOL:
        raise AssertionError(f"bf16 kernel vs plain losses {losses} / "
                             f"{plain_losses}")
    del plain
    emit({"phase": "train_bf16", "config": cfg.name,
          "numerics": npol.describe(), "replicas": REPLICAS,
          "per_replica_batch": TRAIN_BATCH, "steps": steps,
          "launches": launches, "wgmma_launches": wgmma, "losses": losses,
          "plain_losses": plain_losses, "loss_abs_err_steps_1_3": loss_errs,
          "loss_tol": BF16_LOSS_TOL, "poisoned": "step 2, replica 1, one "
          "pixel", "poisoned_step_bit_unchanged": checks["unchanged"],
          "leaves_compared": checks["leaves"], "loss_scale": scales,
          "skipped_steps": skipped, "setup_s": setup_s,
          "peak_mem_gb": peak / 1e9})
    pre = pool_stream(pool, mean, cfg, seed)()
    prepped = [next(pre) for _ in pool]
    torch.cuda.reset_peak_memory_stats()
    train_timing(alexnet_loss(cfg), res.state,
                 lambda: itertools.cycle(prepped), cfg.name,
                 "preprocessed pool", items, windows=1,
                 scopes=("lrn_bwd",), numerics=npol)
    emit({"phase": "train_bf16_memory", "config": cfg.name,
          "peak_mem_gb_timed_windows":
          torch.cuda.max_memory_allocated() / 1e9})
    return launches


def im2col_phase(model_cfg, seed):
    """3 steps at 2 x 32 under the im2col_ref conv: the GEMM kernel's
    launch count, and the losses against the fused conv."""
    import dataclasses

    from repro_torch.kernels.common import KernelPolicy

    cfg = dataclasses.replace(model_cfg, kernels=KernelPolicy(
        "auto", conv2d="im2col_ref"))
    fused_cfg = dataclasses.replace(model_cfg, kernels=KernelPolicy("auto"))
    pool, mean = host_pool(cfg, IM2COL_BATCH * REPLICAS, 3, seed + 11)
    make_stream = pool_stream(pool, mean, cfg, seed)
    state0 = init_state(cfg, seed)
    steps = 3
    items = IM2COL_BATCH * REPLICAS
    sess = session(alexnet_loss(cfg), state0, make_stream, steps, items,
                   staging="queue", metrics_path=os.devnull)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = sess.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    # per replica and step: 5 forward + 5 dw + 4 dx (conv1's input, the
    # images, needs no grad); LRN still runs its kernel; no fused conv
    want = want_counts(
        lrn=sum(cs.lrn for cs in cfg.convs) * REPLICAS * steps,
        matmul_bias=(3 * len(cfg.convs) - 1) * REPLICAS * steps)
    if launches != want:
        raise AssertionError(f"im2col launches {launches} != {want}")
    losses = losses_of(res)
    fused = losses_of(session(alexnet_loss(fused_cfg),
                              init_state(fused_cfg, seed), make_stream,
                              steps, items, staging="queue",
                              metrics_path=os.devnull).run())
    errs = [abs(a - b) for a, b in zip(losses, fused)]
    if not all(math.isfinite(v) for v in losses) or \
            max(errs) > BACKEND_LOSS_TOL:
        raise AssertionError(f"im2col vs fused losses {losses} / {fused}")
    emit({"phase": "train_im2col", "config": cfg.name,
          "replicas": REPLICAS, "per_replica_batch": IM2COL_BATCH,
          "steps": steps, "launches": launches,
          "matmul_per_replica_step": "5 forward + 5 dw + 4 dx",
          "losses": losses, "fused_losses": fused, "loss_abs_err": errs,
          "wall_s": wall})
    return launches


EXCHANGES = [  # the train_exchange phase's exchanges (ExchangeConfig)
    dict(delay=1), dict(delay=1, compression="bf16"),
    dict(delay=1, compression="topk", topk_frac=0.01),
    dict(compression="bf16")]


def topk_kept_check(exchanger, counts):
    """``wrap`` for ``session``: around each step, the entries each
    replica's top-k kept of every non-scalar leaf, read as d - the new
    residual with d = (incoming - base) + residual taken before the step;
    it must be k, or every nonzero of d where d has fewer.  Appends
    (kept, k) totals to ``counts``."""
    from repro_torch.tree import tree_leaves

    def wrap(step):
        def checked(st, batch):
            aux = st.exchange
            with torch.no_grad():
                d = [(w.float() - b.float() + r) for w, b, r in zip(
                    tree_leaves((st.params, st.opt_state)),
                    tree_leaves(aux["base"]), tree_leaves(aux["residual"]))]
            st, loss = step(st, batch)
            kept_total = k_total = 0
            with torch.no_grad():
                for dl, res in zip(d, tree_leaves(aux["residual"])):
                    if dl.dim() == 0:
                        continue
                    n = dl[0].numel()
                    k = exchanger.topk_k(n)
                    kept = (dl - res).reshape(dl.shape[0], -1).ne(0).sum(1)
                    want = torch.clamp(dl.reshape(dl.shape[0], -1).ne(0)
                                       .sum(1), max=k)
                    if not torch.equal(kept, want):
                        raise AssertionError(
                            f"top-k kept {kept.tolist()} entries of a leaf "
                            f"of {n}, want {want.tolist()} (k {k})")
                    kept_total += int(kept.sum())
                    k_total += k * dl.shape[0]
            counts.append((kept_total, k_total))
            return st, loss
        return checked
    return wrap


def exchange_phase(model_cfg, seed, prepped):
    """The faithful AlexNet at full width, 2 x 128, fp32, over the train
    phase's preprocessed pool ``prepped``, under each exchange of
    ``EXCHANGES`` from a fresh state: 3 steps with the kernels (launch
    counts: 5 conv and 2 LRN per replica and step; the consensus base's
    spread 0 after every exchange; under top-k each replica keeps k
    entries of every leaf) and 3 under the plain policy (losses within
    LOSS_TOL).  Then one timed and one traced window of 10 steps each
    for every exchange and for the synchronous uncompressed baseline,
    the exchange's device ms booked under its ``exchange`` range, and
    each run's peak memory.  Returns {path: launches}."""
    import dataclasses

    from repro_torch.core.param_avg import ExchangeConfig, replica_spread
    from repro_torch.kernels.common import KernelPolicy

    cfg = dataclasses.replace(model_cfg, kernels=KernelPolicy("auto"))
    plain_cfg = dataclasses.replace(model_cfg, kernels=KernelPolicy("plain"))
    items = TRAIN_BATCH * REPLICAS
    steps = 3
    n_conv = len(cfg.convs)
    n_lrn = sum(cs.lrn for cs in cfg.convs)

    def stream():
        return itertools.cycle(prepped)

    by_path = {}
    for kw in EXCHANGES:
        ex = ExchangeConfig(**kw)
        t0 = time.perf_counter()
        spreads, kept = [], []
        wrap = topk_kept_check(ex.exchanger(), kept) \
            if ex.compression == "topk" else None

        def consensus(st):
            """The spread of what the exchange left replica-identical:
            the base under a compressed delay=1, the state under delay=0
            (an uncompressed delay=1 keeps no consensus apart)."""
            if st.exchange is not None:
                return replica_spread(st.exchange["base"])
            if ex.delay == 0:
                return replica_spread((st.params, st.opt_state))
            return None

        def both(step):
            inner = wrap(step) if wrap else step

            def checked(st, batch):
                st, loss = inner(st, batch)
                spreads.append(consensus(st))
                return st, loss
            return checked

        sess = session(alexnet_loss(cfg), init_state(cfg, seed, ex), stream,
                       steps, items, metrics_path=os.devnull, strategy=ex,
                       wrap=both)
        torch.cuda.synchronize()
        zero_counts()
        res = sess.run()
        torch.cuda.synchronize()
        launches = read_counts()
        want = want_counts(conv2d_fused=n_conv * REPLICAS * steps,
                           lrn=n_lrn * REPLICAS * steps)
        if launches != want:
            raise AssertionError(f"{ex.describe()} launches {launches} != "
                                 f"{want}")
        losses = losses_of(res)
        plain = losses_of(session(
            alexnet_loss(plain_cfg), init_state(plain_cfg, seed, ex), stream,
            steps, items, metrics_path=os.devnull, strategy=ex).run())
        errs = [abs(a - b) for a, b in zip(losses, plain)]
        if len(losses) != steps or not all(map(math.isfinite, losses)) or \
                max(errs) > LOSS_TOL:
            raise AssertionError(f"{ex.describe()} kernel vs plain losses "
                                 f"{losses} / {plain}")
        measured = [v for v in spreads if v is not None]
        if any(measured):
            raise AssertionError(f"{ex.describe()}: consensus spread "
                                 f"{spreads}")
        if ex.compression == "topk" and len(kept) != steps:
            raise AssertionError("the top-k check did not run")
        by_path[f"train_exchange/{ex.describe()}"] = launches
        emit({"phase": "train_exchange", "config": cfg.name,
              "exchange": ex.describe(), "replicas": REPLICAS,
              "per_replica_batch": TRAIN_BATCH, "steps": steps,
              "launches": launches, "losses": losses, "plain_losses": plain,
              "loss_abs_err": errs, "consensus_spread": spreads,
              "topk_kept_of_k": kept, "seconds": time.perf_counter() - t0})
    rows = []
    for kw in [dict()] + EXCHANGES:
        ex = ExchangeConfig(**kw)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        record = {}
        train_timing(alexnet_loss(cfg), init_state(cfg, seed, ex), stream,
                     f"{cfg.name} {ex.describe()}", "preprocessed pool",
                     items, windows=1, scopes=("lrn_bwd", "exchange"),
                     strategy=ex, out=record)
        fams = record["device_ms_per_step_by_family"]
        rows.append({"exchange": ex.describe(),
                     "step_ms_p50": record["step_ms_p50"]["median"],
                     "images_per_s": record["images_per_s"]["median"],
                     "device_busy_ms_per_step":
                         record["device_busy_ms_per_step"],
                     "exchange_ms_per_step": fams.get("exchange", 0.0),
                     "exchange_share_of_busy": fams.get("exchange", 0.0)
                     / record["device_busy_ms_per_step"],
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    base = rows[0]
    for row in rows:
        row["step_vs_delay0"] = row["step_ms_p50"] / base["step_ms_p50"]
        row["peak_mem_vs_delay0_gb"] = row["peak_mem_gb"] \
            - base["peak_mem_gb"]
    emit({"phase": "exchange_timing", "config": cfg.name,
          "replicas": REPLICAS, "per_replica_batch": TRAIN_BATCH,
          "rows": rows})
    return by_path


def visible_pairs(s: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head: the work the flash
    kernels must do, whatever tiles they visit."""
    rows = np.arange(s)
    hi = rows if causal else np.full(s, s - 1)
    lo = np.maximum(0, rows - window + 1) if window else np.zeros(s, int)
    return int((hi - lo + 1).sum())


FLASH_CASES = [  # (case, B, Hq, Hkv, S, hd, causal, window)
    ("train", LM_BATCH, 16, 16, LM_SEQ, 128, True, None),
    ("gqa", 1, 32, 8, 1000, 128, True, None),
    ("window", 1, 16, 16, LM_SEQ, 128, True, 256),
    ("hd64", 1, 16, 16, LM_SEQ, 64, True, None),
    ("hd256", 1, 16, 16, LM_SEQ, 256, True, None),
    # the recurrentgemma-9b training phase's attn layers: MQA, window 2048
    ("hybrid", 2, 16, 1, LM_SEQ, 256, True, 2048),
]


def flash_phase(gen):
    """The three flash kernels against their plain versions at every
    case of ``FLASH_CASES``, in fp32 and bf16, timed beside the plain
    versions and the library's fused attention (yardstick only).
    Returns per kernel the totals of the main path's case (``train``,
    bf16: one launch at the LM training shape) and the worst error.
    bf16 rows are bounded at the tensor cores' dense bf16 rate (the card
    could do that work there), fp32 rows at the fp32 rate outside them;
    the library time of dq and dk/dv is SDPA's whole backward (dq, dk
    and dv in one call)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    dev = torch.device("cuda")
    totals = {k: {"max_abs_err": 0.0} for k in ("flash_fwd", "flash_dq",
                                                 "flash_dkv")}
    for case, b, hq, hkv, s, hd, causal, window in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            fwd_tol, grad_tol = FLASH_TOL[dtype]
            q, k, v, do = (torch.randn((b * h, s, hd), generator=gen,
                                       device=dev).to(dtype)
                           for h in (hq, hkv, hkv, hq))
            kw = dict(n_q_heads=hq, n_kv_heads=hkv, causal=causal,
                      window=window, scale=hd ** -0.5)
            what = f"{case} {str(dtype)[6:]}"
            row = {"phase": "flash_kernel", "case": case,
                   "shape": [b, hq, hkv, s, hd], "causal": causal,
                   "window": window, "dtype": str(dtype)[6:]}
            with torch.inference_mode():
                o, lse = ops.flash_fwd(q, k, v, **kw)
                torch.cuda.synchronize()
                want_o, want_lse = ops.flash_fwd(q, k, v, backend="plain",
                                                 **kw)
                fwd_err = check_close(f"flash_fwd {what}", o.float(),
                                      want_o.float(), fwd_tol)
                lse_err = check_close(f"flash_fwd lse {what}", lse,
                                      want_lse, FLASH_TOL[torch.float32][0])
                delta = (do.float() * want_o.float()).sum(-1)
                args = (q, k, v, do, want_lse, delta)
                dq = ops.flash_dq(*args, **kw)
                dk, dv = ops.flash_dkv(*args, **kw)
                torch.cuda.synchronize()
                if not torch.equal(ops.flash_dq(*args, **kw), dq):
                    raise AssertionError(f"flash_dq {what}: two calls differ "
                                         "(the backward must be "
                                         "deterministic)")
                dq_err = check_close(f"flash_dq {what}", dq.float(),
                                     ops.flash_dq(*args, backend="plain",
                                                  **kw).float(), grad_tol)
                want_dk, want_dv = ops.flash_dkv(*args, backend="plain",
                                                 **kw)
                dkv_err = max(check_close(f"flash_dkv dk {what}", dk.float(),
                                          want_dk.float(), grad_tol),
                              check_close(f"flash_dkv dv {what}", dv.float(),
                                          want_dv.float(), grad_tol))
                again = ops.flash_dkv(*args, **kw)   # a split group's sum
                if not (torch.equal(again[0], dk)
                        and torch.equal(again[1], dv)):
                    raise AssertionError(f"flash_dkv {what}: two calls "
                                         "differ (the backward must be "
                                         "deterministic)")
                timed = {
                    "flash_fwd": (lambda: ops.flash_fwd(q, k, v, **kw),
                                  lambda: ops.flash_fwd(
                                      q, k, v, backend="plain", **kw)),
                    "flash_dq": (lambda: ops.flash_dq(*args, **kw),
                                 lambda: ops.flash_dq(
                                     *args, backend="plain", **kw)),
                    "flash_dkv": (lambda: ops.flash_dkv(*args, **kw),
                                  lambda: ops.flash_dkv(
                                      *args, backend="plain", **kw))}
                ms = {name: (time_ms(kern, reps=10), time_ms(plain, reps=3))
                      for name, (kern, plain) in timed.items()}
            # the library's fused attention on the (B, H, S, hd) views
            q4, k4, v4, do4 = (x.view(b, -1, s, hd) for x in (q, k, v, do))
            mask = None
            if window is not None:
                r = torch.arange(s, device=dev)
                mask = (r[None, :] > r[:, None] - window) & (
                    r[None, :] <= r[:, None])

            def sdpa(q_, k_, v_):
                return F.scaled_dot_product_attention(
                    q_, k_, v_, attn_mask=mask,
                    is_causal=causal and mask is None, scale=hd ** -0.5,
                    enable_gqa=hq != hkv)

            with torch.inference_mode():
                sdpa_err = max_err(sdpa(q4, k4, v4).reshape(o.shape), o)
                sdpa_fwd = time_ms(lambda: sdpa(q4, k4, v4), reps=10)
            leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            out = sdpa(*leaves)
            sdpa_bwd = time_ms(lambda: torch.autograd.grad(
                out, leaves, do4, retain_graph=True), reps=10)
            pairs = b * hq * visible_pairs(s, causal, window)
            elt = q.element_size()
            qo = b * hq * s * hd * elt          # q, o, do or dq
            kv = b * hkv * s * hd * elt         # k, v, dk or dv
            rows = b * hq * s * 4               # lse or delta
            work = {"flash_fwd": (4 * hd * pairs, 2 * qo + 2 * kv + rows),
                    "flash_dq": (6 * hd * pairs,
                                 3 * qo + 2 * kv + 2 * rows),
                    "flash_dkv": (8 * hd * pairs,
                                  2 * qo + 4 * kv + 2 * rows)}
            errs = {"flash_fwd": fwd_err, "flash_dq": dq_err,
                    "flash_dkv": dkv_err}
            peak = BF16_PEAK if dtype == torch.bfloat16 else FP32_PEAK
            for name, (flops, nbytes) in work.items():
                bound, bound_by = _bound(flops, nbytes, peak)
                k_ms, p_ms = ms[name]
                row[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                             "bound_by": bound_by, "flops": flops,
                             "bytes": nbytes,
                             "tflops": flops / (k_ms * 1e-3) / 1e12,
                             "max_err": errs[name]}
                tot = totals[name]
                tot["max_abs_err"] = max(tot["max_abs_err"], errs[name])
                if case == "train" and dtype == torch.bfloat16:
                    fwd = name == "flash_fwd"
                    tot.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                               bound_by=bound_by,
                               library_ms=sdpa_fwd if fwd else sdpa_bwd,
                               library=("SDPA forward" if fwd else
                                        "SDPA's whole backward (dq, dk "
                                        "and dv)"))
            row.update(lse_err=lse_err, pairs=pairs, sdpa_fwd_ms=sdpa_fwd,
                       sdpa_bwd_ms=sdpa_bwd, sdpa_fwd_err=sdpa_err,
                       assumes=("989 TFLOP/s dense bf16 tensor-core"
                                if dtype == torch.bfloat16 else
                                "67 TFLOP/s fp32 non-tensor")
                       + ", 3.35 TB/s; FLOPs over the unmasked pairs; "
                       "sdpa_bwd_ms is the whole backward")
            emit(row)
    return totals


def lm_pool(cfg, batch: int, n: int, seed: int):
    """``n`` host batches of ``markov_lm`` (batch x LM_SEQ tokens), drawn
    once, for the timed windows to cycle."""
    from repro_torch.data import synthetic

    it = synthetic.markov_lm(cfg.vocab_size, batch, LM_SEQ, seed=seed)
    return [next(it) for _ in range(n)]


def lm_stream(pool):
    from repro_torch.core.steps import reshape_for_replicas
    return lambda: (reshape_for_replicas(b, REPLICAS)
                    for b in itertools.cycle(pool))


def lm_state(cfg, seed):
    from repro_torch.core.steps import init_param_avg_state
    from repro_torch.models import transformer

    return init_param_avg_state(
        torch.Generator().manual_seed(seed),
        lambda gen: transformer.init(cfg, gen, device="cuda"),
        sgd(cfg.numerics), REPLICAS, numerics=cfg.numerics)


def lm_parity(seed):
    """The full width at LM_PARITY_LAYERS layers in fp32, 2 x 2 x 2048,
    3 steps under the kernels and under the plain policy from one
    state: losses and params within LOSS_TOL."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.tree import tree_leaves

    base = dataclasses.replace(ARCHS[LM_ARCH], n_layers=LM_PARITY_LAYERS,
                               dtype="float32")
    cfg = dataclasses.replace(base, kernels=KernelPolicy("auto"))
    plain_cfg = dataclasses.replace(base, kernels=KernelPolicy("plain"))
    make_stream = lm_stream(lm_pool(cfg, LM_PARITY_BATCH * REPLICAS, 3,
                                    seed + 13))
    items = LM_PARITY_BATCH * REPLICAS
    res = session(lm_loss(cfg), lm_state(cfg, seed), make_stream, 3,
                  items, staging="queue", metrics_path=os.devnull).run()
    plain = session(lm_loss(plain_cfg), lm_state(plain_cfg, seed),
                    make_stream, 3, items, staging="queue",
                    metrics_path=os.devnull).run()
    losses, plain_losses = losses_of(res), losses_of(plain)
    loss_errs = [abs(a - b) for a, b in zip(losses, plain_losses)]
    param_err = max(max_err(a, b) for a, b in zip(
        tree_leaves(res.state.params), tree_leaves(plain.state.params)))
    if not all(math.isfinite(v) for v in losses) or \
            max(loss_errs) > LOSS_TOL or param_err > LOSS_TOL:
        raise AssertionError(f"LM kernel vs plain: losses {losses} / "
                             f"{plain_losses}, params max |err| {param_err}")
    emit({"phase": "lm_parity", "config": cfg.name,
          "layers": LM_PARITY_LAYERS, "dtype": "float32",
          "replicas": REPLICAS, "per_replica_batch": LM_PARITY_BATCH,
          "seq_len": LM_SEQ, "steps": 3, "losses": losses,
          "plain_losses": plain_losses, "loss_abs_err": loss_errs,
          "params_max_abs_err": param_err})


def lm_train_phase(seed):
    """olmo-1b at full width and depth in its bf16 params: launch counts
    and spread over 3 steps, then the timed and traced windows and the
    peak memory.  The fp32 kernel-vs-plain check runs first, at 4
    layers."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy

    lm_parity(seed)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(ARCHS[LM_ARCH], kernels=KernelPolicy("auto"))
    t0 = time.perf_counter()
    make_stream = lm_stream(lm_pool(cfg, LM_BATCH * REPLICAS, 4, seed + 17))
    state0 = lm_state(cfg, seed)
    setup_s = time.perf_counter() - t0
    steps, items = 3, LM_BATCH * REPLICAS
    spreads = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = session(lm_loss(cfg), state0, make_stream, steps, items,
                  metrics_path=os.devnull, spreads=spreads).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    per_step = REPLICAS * cfg.n_layers
    want = want_counts(flash_fwd=per_step * steps,
                       flash_dq=per_step * steps,
                       flash_dkv=per_step * steps)
    if launches != want:
        raise AssertionError(f"LM training launches {launches} != {want}")
    losses = losses_of(res)
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"LM training losses {losses}")
    if len(spreads) != steps or max(spreads) != 0.0:
        raise AssertionError(f"LM replica spread after each sync {spreads}")
    peak = torch.cuda.max_memory_allocated()
    del state0
    # the update is timed on the state the windows leave: it writes into
    # it (stand-in grads), which the windows must not train on
    state = train_timing(lm_loss(cfg), res.state, make_stream, cfg.name,
                         "markov_lm pool", items, steps=5, family=lm_family,
                         tokens_per_item=LM_SEQ)
    emit({"phase": "lm_train", "config": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": cfg.n_params(), "dtype": cfg.dtype,
          "replicas": REPLICAS, "per_replica_batch": LM_BATCH,
          "seq_len": LM_SEQ, "steps": steps, "launches": launches,
          "launches_per_step": {k: v // steps for k, v in launches.items()},
          "losses": losses, "replica_spread": spreads, "wall_s": wall,
          "setup_s": setup_s, "peak_mem_gb": peak / 1e9,
          "optimizer_exchange_ms": lm_update_ms(state)})
    del state, res
    gc.collect()
    torch.cuda.empty_cache()
    lm_bf16_window(seed)
    return launches


def bf16_ulps(a, b) -> int:
    """The most bf16 ulps between two bf16 tensors of one shape (ordered
    bit patterns, so -0 and +0 are 0 apart), taken chunk by chunk."""
    from repro_torch.core.param_avg import chunks

    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return max(int((ordered(x) - ordered(y)).abs().max().item())
               for x, y in zip(chunks(a, read_only=True),
                               chunks(b, read_only=True)))


def lm_bf16_window(seed):
    """3 steps of olmo-1b at full width and depth under the bf16 preset
    (fp32 masters in the optimizer state, dynamic loss scaling), 2 x 4 x
    2048: the flash launch counts, finite losses, the scale still 2^15
    after 3 clean steps, every param of every replica within 1 bf16 ulp
    of its master's cast after each update (read just before the
    exchange, which averages the bf16 params and the fp32 masters each
    on its own, as the reference's does: a mean of opposite-signed
    replicas near 0 can then sit many of its own ulps from the masters'
    mean), and the peak memory beside the fp32-velocity run's."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.core.param_avg import Exchanger
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.numerics import get_policy
    from repro_torch.tree import tree_leaves

    npol = get_policy("bf16")
    cfg = dataclasses.replace(ARCHS[LM_ARCH], kernels=KernelPolicy("auto"),
                              numerics=npol)
    make_stream = lm_stream(lm_pool(cfg, LM_BATCH * REPLICAS, 3, seed + 19))
    steps, items = 3, LM_BATCH * REPLICAS
    ulps = []

    class UlpChecked(Exchanger):
        """The all-reduce, after reading how far each updated param lies
        from its master's cast."""
        def average_(self, tree):
            params, opt_state = tree
            ulps.append(max(bf16_ulps(p, m.to(torch.bfloat16)) for p, m in
                            zip(tree_leaves(params),
                                tree_leaves(opt_state["master"]))))
            super().average_(tree)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state0 = lm_state(cfg, seed)
    zero_counts()
    t0 = time.perf_counter()
    res = session(lm_loss(cfg), state0, make_stream, steps, items,
                  metrics_path=os.devnull, numerics=npol,
                  strategy=UlpChecked("all_reduce")).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = REPLICAS * cfg.n_layers
    want = want_counts(flash_fwd=per_step * steps,
                       flash_dq=per_step * steps,
                       flash_dkv=per_step * steps)
    if launches != want:
        raise AssertionError(f"bf16-preset LM launches {launches} != "
                             f"{want}")
    losses = losses_of(res)
    ns = res.state.numerics
    scale, good = float(ns["scale"]), int(ns["good_steps"])
    if len(losses) != steps or not all(math.isfinite(v) for v in losses) \
            or scale != 2.0 ** 15 or good != steps:
        raise AssertionError(f"bf16-preset LM losses {losses}, scale "
                             f"{scale}, good steps {good}")
    params = tree_leaves(res.state.params)
    if len(ulps) != steps or max(ulps) > 1 or \
            {p.dtype for p in params} != {torch.bfloat16}:
        raise AssertionError(f"updated params {ulps} bf16 ulps from their "
                             "masters' cast")
    after = max(bf16_ulps(p, m.to(torch.bfloat16)) for p, m in zip(
        params, tree_leaves(res.state.opt_state["master"])))
    emit({"phase": "lm_train_bf16", "config": cfg.name,
          "numerics": npol.describe(), "layers": cfg.n_layers,
          "replicas": REPLICAS, "per_replica_batch": LM_BATCH,
          "seq_len": LM_SEQ, "steps": steps, "launches": launches,
          "losses": losses, "loss_scale": scale, "good_steps": good,
          "updated_params_max_ulps_from_master": ulps,
          "exchanged_params_max_ulps_from_master": after, "wall_s": wall,
          "peak_mem_gb": peak / 1e9})


def lm_update_ms(state) -> float:
    """Device time of the step's update alone, as the step runs it in
    place: SGD momentum (fp32 velocity) on each replica's slices, the
    fp32 add into the bf16 params, and the all-reduce of params and
    velocity; bf16 grads of one replica's shapes stand in for the real
    ones, so ``state`` is spoiled for training."""
    from repro_torch.core.param_avg import Exchanger
    from repro_torch.core.steps import update_replica_
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_leaves

    opt, ex = get_optimizer("sgd_momentum"), Exchanger("all_reduce")
    ones = [torch.ones_like(x[0]) for x in tree_leaves(state.params)]

    def update():
        with torch.no_grad():
            for r in range(REPLICAS):
                update_replica_(opt, list(ones), state.params,
                                state.opt_state, r, 0.01)
            ex.average_((state.params, state.opt_state))

    return time_ms(update, reps=5, warmup=1)


def wkv_inputs(gen, b, t, h, k, dtype, w_zero):
    """r, k, v (dtype), w and u (fp32) in the model's range: w =
    exp(-exp(z)) with z around the init's decay base of -4; with
    ``w_zero`` one w entry underflowed to 0."""
    dev = torch.device("cuda")
    r, kk, v = (torch.randn((b, t, h, k), generator=gen, device=dev).to(
        dtype) for _ in range(3))
    z = -4.0 + torch.randn((b, t, h, k), generator=gen, device=dev)
    w = torch.exp(-torch.exp(z))
    if w_zero:
        w[0, t // 2, h // 2, k // 3] = 0.0
    u = torch.randn((h, k), generator=gen, device=dev) * 0.5
    return r, kk, v, w, u


def recurrence_phase(gen):
    """The WKV kernel against the plain chunked form (the plain
    sequential form where one w underflowed to 0) at every case of
    ``WKV_CASES``, and the RG-LRU kernel, forward and reversed (alone
    and with da), against the plain loops at every case of
    ``RGLRU_CASES``, two calls bit-equal, timed beside the plain versions
    and the bounds (no PyTorch call computes either recurrence, so there
    is no library yardstick).  Then the backward:
    the WKV Function's grads (kernel forward, chunk-recompute backward)
    against autograd through the plain chunked form, its backward timed
    at the training shape, and the RG-LRU Function's grads (the reversed
    launch) against its plain route.  Returns per kernel the totals of
    the main path's case (``train``) and the worst error."""
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru import ref as rg_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    totals = {"wkv_fwd": {"max_abs_err": 0.0},
              "rglru_fwd": {"max_abs_err": 0.0}}
    assumes = "67 TFLOP/s fp32 non-tensor, 3.35 TB/s"
    for case, b, t, h, k, dtype, w_zero in WKV_CASES:
        xs = wkv_inputs(gen, b, t, h, k, dtype, w_zero)

        def plain():
            if w_zero:
                return wkv_ref.wkv_sequential(*xs)
            return wkv_ref.wkv_chunked(*xs, chunk=min(64, t))

        with torch.inference_mode():
            y, s = wkv_ops.wkv_fwd(*xs, backend="cuda")
            torch.cuda.synchronize()
            want_y, want_s = plain()
            what = f"wkv_fwd {case}"
            err = max(check_close(what, y.float(),
                                  want_y.to(dtype).float(), WKV_TOL[dtype]),
                      check_close(f"{what} state", s, want_s,
                                  WKV_TOL[torch.float32]))
            if not all(torch.equal(first, again) for first, again in zip(
                    (y, s), wkv_ops.wkv_fwd(*xs, backend="cuda"))):
                raise AssertionError(f"{what}: two calls differ")
            k_ms = time_ms(lambda: wkv_ops.wkv_fwd(*xs, backend="cuda"),
                           reps=10)
            p_ms = time_ms(plain, reps=3, warmup=1)
        n = b * t * h * k
        flops = 4.0 * n * k
        nbytes = float(n * (4 * xs[0].element_size() + 4) + 4 * h * k
                       + 4 * b * h * k * k)
        bound, bound_by = _bound(flops, nbytes)
        chunk = wkv_ops.wkv_chunk(t, b * h, sms)
        row = {"phase": "recurrence_kernel", "kernel": "wkv_fwd",
               "case": case, "shape": [b, t, h, k], "chunk": chunk,
               "n_chunks": len(wkv_ops.wkv_chunks(t, chunk)),
               "dtype": str(dtype)[6:], "plain": "sequential" if w_zero
               else "chunked", "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": bound, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "gbps": nbytes / (k_ms * 1e-3) / 1e9,
               "max_err": err, "assumes": assumes,
               "finite": bool(torch.isfinite(y).all())}
        emit(row)
        tot = totals["wkv_fwd"]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        if case == "train":
            tot.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=None)

    for case, b, t, d, strong in RGLRU_CASES:
        z = torch.randn((b, t, d), generator=gen, device=dev)
        if strong:
            a = torch.exp(-10.0 + 0.1 * z)
        else:   # the model's a = exp(-8 softplus(Lambda) sigmoid(.))
            lam = torch.rand((d,), generator=gen, device=dev) * 0.6 + 0.3
            a = torch.exp(-8.0 * torch.nn.functional.softplus(lam)
                          * torch.sigmoid(z))
        x = torch.randn((b, t, d), generator=gen, device=dev)
        with torch.inference_mode():
            h = rg_ops.rglru_fwd(a, x, backend="cuda")
            g, da = rg_ops.rglru_transpose_grads(a, x, h, backend="cuda")
            g_only = rg_ops.rglru_fwd(a, x, reverse=True, backend="cuda")
            torch.cuda.synchronize()
            want_g, want_da = rg_ref.rglru_transpose_grads(a, x, h)
            err = max(check_close(f"rglru_fwd {case}", h,
                                  rg_ref.rglru_sequential(a, x)[0],
                                  RGLRU_TOL),
                      check_close(f"rglru_fwd reverse {case}", g_only,
                                  want_g, RGLRU_TOL),
                      check_close(f"rglru_fwd reverse+da {case} g", g,
                                  want_g, RGLRU_TOL),
                      check_close(f"rglru_fwd reverse+da {case} da", da,
                                  want_da, RGLRU_TOL))
            again = rg_ops.rglru_transpose_grads(a, x, h, backend="cuda")
            if not (torch.equal(h, rg_ops.rglru_fwd(a, x, backend="cuda"))
                    and torch.equal(g, again[0])
                    and torch.equal(da, again[1])):
                raise AssertionError(f"rglru_fwd {case}: two calls differ")
            k_ms = time_ms(lambda: rg_ops.rglru_fwd(a, x, backend="cuda"),
                           reps=10)
            rev_ms = time_ms(lambda: rg_ops.rglru_transpose_grads(
                a, x, h, backend="cuda"), reps=10)
            p_ms = time_ms(lambda: rg_ref.rglru_sequential(a, x), reps=3,
                           warmup=1)
            rev_p_ms = time_ms(lambda: rg_ref.rglru_transpose_grads(
                a, x, h), reps=3, warmup=1)
        n = b * t * d
        bound, bound_by = _bound(2.0 * n, 12.0 * n)
        # the reversed launch with da: a, dh, h read, g and da written
        rev_bound, rev_bound_by = _bound(3.0 * n, 20.0 * n)
        chunk = rg_ops.rglru_chunk(t, b * d, sms)
        row = {"phase": "recurrence_kernel", "kernel": "rglru_fwd",
               "case": case, "shape": [b, t, d], "chunk": chunk,
               "n_chunks": rg_ops.rglru_grid(b, t, d, chunk)[1],
               "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
               "bound_by": bound_by, "flops": 2.0 * n, "bytes": 12.0 * n,
               "gbps": 12.0 * n / (k_ms * 1e-3) / 1e9,
               "reverse_ms": rev_ms, "reverse": "g and da, one launch",
               "reverse_plain_ms": rev_p_ms, "reverse_bytes": 20.0 * n,
               "reverse_bound_ms": rev_bound,
               "reverse_bound_by": rev_bound_by,
               "reverse_gbps": 20.0 * n / (rev_ms * 1e-3) / 1e9,
               "max_err": err, "assumes": assumes,
               "finite": bool(torch.isfinite(h).all()
                              and torch.isfinite(g).all()
                              and torch.isfinite(da).all())}
        emit(row)
        tot = totals["rglru_fwd"]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        if case == "train":
            tot.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=None,
                       reverse_ms=rev_ms, reverse_bound_ms=rev_bound)
    recurrence_backward(gen, totals)
    return totals


def recurrence_backward(gen, totals):
    """The two Functions' grads on the card: WKV (kernel forward,
    chunk-recompute backward) against autograd through the plain chunked
    form at a small shape, and its backward's time at the training
    shape; RG-LRU (the reversed launch) against its plain route at the
    training shape, and its backward's time there."""
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref

    dev = torch.device("cuda")
    xs = wkv_inputs(gen, 1, 256, 4, 64, torch.float32, False)
    dy = torch.randn(xs[0].shape, generator=gen, device=dev)
    ds = torch.randn((1, 4, 64, 64), generator=gen, device=dev)
    got, want = [], []
    for out, fn in ((got, lambda *a: wkv_ops.wkv(*a, backend="cuda")),
                    (want, lambda *a: wkv_ref.wkv_chunked(*a, chunk=64))):
        leaves = [x.clone().requires_grad_() for x in xs]
        y, s = fn(*leaves)
        out.extend(torch.autograd.grad((y, s), leaves, (dy, ds)))
    wkv_err = max(check_close(f"wkv grad d{n}", g, w_, 1e-5)
                  for n, g, w_ in zip("rkvwu", got, want))
    wkv_shape = list(WKV_CASES[0][1:5])
    b, _, h, k = wkv_shape
    xs = wkv_inputs(gen, *wkv_shape, WKV_CASES[0][5], False)
    dy = torch.randn(xs[0].shape, generator=gen, device=dev)
    ds = torch.zeros((b, h, k, k), device=dev)
    bwd_ms = time_ms(lambda: wkv_ops.wkv_bwd(*xs, dy, ds), reps=3,
                     warmup=1)

    b, t, d = RGLRU_CASES[0][1:4]
    a = torch.rand((b, t, d), generator=gen, device=dev)
    x = torch.randn((b, t, d), generator=gen, device=dev)
    dh = torch.randn((b, t, d), generator=gen, device=dev)
    grads = []
    for backend in ("cuda", "plain"):
        ta, tx = a.clone().requires_grad_(), x.clone().requires_grad_()
        grads.append(torch.autograd.grad(
            rg_ops.rglru_scan(ta, tx, backend=backend), (ta, tx), dh))
    rg_err = max(check_close(f"rglru grad d{n}", g, w_, RGLRU_TOL)
                 for n, g, w_ in zip("ab", *grads))
    # the Function's whole backward (the reversed launch with da) alone
    ta, tx = a.clone().requires_grad_(), x.clone().requires_grad_()
    h = rg_ops.rglru_scan(ta, tx, backend="cuda")
    rg_bwd_ms = time_ms(lambda: torch.autograd.grad(
        h, (ta, tx), dh, retain_graph=True), reps=10)
    totals["rglru_fwd"]["max_abs_err"] = max(
        totals["rglru_fwd"]["max_abs_err"], rg_err)
    emit({"phase": "recurrence_backward",
          "wkv_grad_shape": [1, 256, 4, 64], "wkv_grad_max_err": wkv_err,
          "wkv_bwd_shape": wkv_shape, "wkv_bwd_ms": bwd_ms,
          "wkv_bwd": "plain chunk-recompute (no kernel)",
          "rglru_grad_shape": [b, t, d], "rglru_grad_max_err": rg_err,
          "rglru_bwd_ms": rg_bwd_ms,
          "rglru_bwd": "one reversed launch writing g and da"})
    return bwd_ms


def recurrent_kinds(cfg) -> dict:
    from repro_torch.models import transformer
    kinds = transformer.layer_kinds(cfg)
    return {k: kinds.count(k) for k in ("rwkv", "rec", "attn")}


def recurrent_launches(cfg, steps) -> dict:
    """The launches ``steps`` training steps of ``cfg`` make: per replica
    and step one ``wkv_fwd`` per rwkv layer, two ``rglru_fwd`` (forward
    and backward) per rec layer and one of each flash kernel per attn
    layer."""
    n = recurrent_kinds(cfg)
    want = {k: 0 for k in launch_counts()}
    want.update(wkv_fwd=REPLICAS * n["rwkv"] * steps,
                rglru_fwd=2 * REPLICAS * n["rec"] * steps)
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        want[k] = REPLICAS * n["attn"] * steps
    return want


def recurrent_parity(arch, seed):
    """Kernels against the plain policy at the published width in fp32,
    at the parity depth: ``trace`` runs 3 steps of R=2 from one state
    under each (losses and params within LOSS_TOL); ``grads`` compares
    one replica's loss (LOSS_TOL) and every param grad (GRAD_REL_TOL of
    the leaf's largest), where two fp32 replicas of the embedding do
    not fit."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves

    _, batch, layers, mode = RECURRENT[arch]
    base = dataclasses.replace(ARCHS[arch], n_layers=layers,
                               dtype="float32")
    cfgs = [dataclasses.replace(base, kernels=KernelPolicy(be))
            for be in ("auto", "plain")]
    pool = lm_pool(base, batch * REPLICAS, 3, seed + 23)
    row = {"phase": "recurrent_parity", "config": base.name,
           "layers": layers, "dtype": "float32", "mode": mode,
           "seq_len": LM_SEQ}
    if mode == "trace":
        items = batch * REPLICAS
        runs = [session(lm_loss(c), lm_state(c, seed), lm_stream(pool), 3,
                        items, staging="queue",
                        metrics_path=os.devnull).run() for c in cfgs]
        losses, plain_losses = (losses_of(r) for r in runs)
        loss_errs = [abs(a - b) for a, b in zip(losses, plain_losses)]
        param_err = max(max_err(a, b) for a, b in zip(
            *(tree_leaves(r.state.params) for r in runs)))
        del runs
        if not all(math.isfinite(v) for v in losses) or \
                max(loss_errs) > LOSS_TOL or param_err > LOSS_TOL:
            raise AssertionError(f"{arch} kernel vs plain: losses {losses}"
                                 f" / {plain_losses}, params max |err| "
                                 f"{param_err}")
        row.update(replicas=REPLICAS, per_replica_batch=batch, steps=3,
                   losses=losses, plain_losses=plain_losses,
                   loss_abs_err=loss_errs, params_max_abs_err=param_err)
    else:
        params = transformer.init(base, torch.Generator().manual_seed(seed),
                                  device="cuda")
        tokens = torch.from_numpy(pool[0]["tokens"][:batch]).cuda()
        bt = {"tokens": tokens, "labels": tokens}
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        out = []
        for c in cfgs:
            loss = models.loss_fn(params, c, bt)
            out.append((loss.item(), torch.autograd.grad(loss, leaves)))
        (loss, grads), (plain_loss, plain_grads) = out
        rel = max(max_err(g, pg) / max(pg.abs().max().item(), 1e-30)
                  for g, pg in zip(grads, plain_grads))
        del out, grads, plain_grads, params, leaves
        if not math.isfinite(loss) or abs(loss - plain_loss) > LOSS_TOL \
                or rel > GRAD_REL_TOL:
            raise AssertionError(f"{arch} kernel vs plain: loss {loss} / "
                                 f"{plain_loss}, grads max relative err "
                                 f"{rel}")
        row.update(replicas=1, batch=batch, loss=loss,
                   plain_loss=plain_loss,
                   loss_abs_err=abs(loss - plain_loss),
                   grads_max_rel_err=rel)
    emit(row)


def recurrent_train_phase(arch, seed):
    """``arch`` at the published width in its bf16 params, cut in depth
    (``RECURRENT``), 2 replicas x b x 2048 tokens, SGD momentum, every-
    step all-reduce, the state updated in place: launch
    counts and spread over 3 steps, the peak memory, then the timed and
    traced windows (device ms by family, the WKV backward's plain
    recompute booked apart).  The fp32 kernel-vs-plain check runs
    first."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.tree import tree_leaves

    recurrent_parity(arch, seed)
    gc.collect()
    torch.cuda.empty_cache()
    layers, batch, _, _ = RECURRENT[arch]
    cfg = dataclasses.replace(ARCHS[arch], n_layers=layers,
                              kernels=KernelPolicy("auto"))
    t0 = time.perf_counter()
    make_stream = lm_stream(lm_pool(cfg, batch * REPLICAS, 4, seed + 29))
    state = lm_state(cfg, seed)
    setup_s = time.perf_counter() - t0
    steps, items = 3, batch * REPLICAS
    spreads = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = session(lm_loss(cfg), state, make_stream, steps, items,
                  metrics_path=os.devnull, spreads=spreads).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = recurrent_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"{arch} training launches {launches} != "
                             f"{want}")
    losses = losses_of(res)
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{arch} training losses {losses}")
    if len(spreads) != steps or max(spreads) != 0.0:
        raise AssertionError(f"{arch} replica spread after each sync "
                             f"{spreads}")
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "recurrent_train", "config": cfg.name,
          "layers": cfg.n_layers, "layer_kinds": recurrent_kinds(cfg),
          "d_model": cfg.d_model,
          "params": sum(x[0].numel() for x in tree_leaves(res.state.params)),
          "dtype": cfg.dtype, "replicas": REPLICAS,
          "per_replica_batch": batch, "seq_len": LM_SEQ, "steps": steps,
          "launches": launches,
          "launches_per_step": {k: v // steps for k, v in launches.items()
                                if v},
          "losses": losses, "replica_spread": spreads, "wall_s": wall,
          "setup_s": setup_s, "peak_mem_gb": peak / 1e9,
          "peak_mem_reserved_gb": torch.cuda.max_memory_reserved() / 1e9})
    train_timing(lm_loss(cfg), res.state, make_stream, cfg.name,
                 "markov_lm pool", items, steps=3, family=lm_family,
                 tokens_per_item=LM_SEQ, scopes=("wkv_bwd",))
    return launches


def recurrent_cli_phase():
    """The train CLI on the two recurrent archs at full width:
    ``rwkv6-7b --layers 1`` for 5 steps with a checkpoint after step 4,
    resumed from it to 5 (step 5's loss equal bit for bit), and
    ``recurrentgemma-9b --layers 3`` for 3 steps (its two replicas'
    state, 32 GB, is not checkpointed here)."""
    base = ["--seq-len", "256", "--batch", "4", "--replicas", "2",
            "--log-every", "1"]
    straight, resumed, seconds = resume_runs(
        ["--arch", "rwkv6-7b", "--layers", "1"] + base, 4, 5, "rwkv6-7b")
    if resumed[5] != straight[5]:
        raise AssertionError(f"resumed vs uninterrupted rwkv6-7b losses "
                             f"differ: {resumed} / {straight}")
    lines, seconds["recurrentgemma"] = _run_cli(
        "repro_torch.launch.train", ["--arch", "recurrentgemma-9b",
                                     "--layers", "3", "--steps", "3"]
        + base)
    if not lines or not lines[-1].startswith("done: steps 0 -> 3"):
        raise AssertionError("recurrentgemma-9b train CLI did not end in "
                             "'done: steps 0 -> 3'")
    emit({"phase": "recurrent_cli", "seconds": seconds,
          "rwkv_losses": [straight[st] for st in range(1, 6)],
          "bit_exact_resume": True, "recurrentgemma_done": lines[-1]})


# rows mid-fill and wrapped
DECODE_POS = [100, 517, 1023, 1500, 2047, 2048, 3000, 5000]
DECODE_CASES = [  # (case, B, cap, Hkv, G, hd, window, q dtype, kv dtype, bs)
    ("serve", 8, 2048, 16, 1, 128, None, "bfloat16", "bfloat16", 0),
    ("serve_table", 8, 2048, 16, 1, 128, None, "bfloat16", "bfloat16", 16),
    ("fp32_q", 8, 2048, 16, 1, 128, None, "float32", "bfloat16", 0),
    ("gqa", 8, 2048, 8, 4, 128, None, "bfloat16", "bfloat16", 0),
    ("window", 8, 2048, 16, 1, 128, 256, "bfloat16", "bfloat16", 0),
    ("hd64", 8, 2048, 16, 1, 64, None, "bfloat16", "bfloat16", 0),
    ("hd256", 8, 2048, 16, 1, 256, None, "bfloat16", "bfloat16", 0),
    # the hybrid's attn layers: 16 query heads on one KV head, hd 256
    # (the ring's tensor-core body), bf16 and int8 K/V
    ("g16_hd256", 8, 2048, 1, 16, 256, None, "bfloat16", "bfloat16", 0),
    ("g16_hd256_int8", 8, 2048, 1, 16, 256, None, "bfloat16", "int8", 0),
    ("int8", 8, 2048, 16, 1, 128, None, "float32", "int8", 0),
    ("int8_bf16_q", 8, 2048, 16, 1, 128, None, "bfloat16", "int8", 0),
    ("int8_table", 8, 2048, 16, 1, 128, None, "float32", "int8", 16),
    ("fp32", 8, 2048, 16, 1, 128, None, "float32", "float32", 0),
]


def decode_inputs(gen, b, cap, hkv, g, hd, q_dtype, kv_dtype, bs):
    """q, k, v, pos, scales and table of one decode case: the ring
    (B, cap, Hkv, hd), or a pool of B * cap / bs blocks (plus the trash
    block) that a shuffled table spreads each row over."""
    dev = torch.device("cuda")
    q = torch.randn((b, hkv, g, hd), generator=gen, device=dev).to(q_dtype)
    table = None
    shape = (b, cap, hkv, hd)
    if bs:
        n_k = cap // bs
        table = (torch.randperm(b * n_k, generator=gen, device=dev)
                 + 1).reshape(b, n_k).to(torch.int32)
        shape = (b * n_k + 1, bs, hkv, hd)
    ks = vs = None
    if kv_dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev)
                .to(torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:3], generator=gen, device=dev) * 0.02
                  + 1e-3 for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
                for _ in range(2))
    pos = torch.tensor(DECODE_POS[:b], dtype=torch.int32, device=dev)
    return q, k, v, pos, ks, vs, table


def decode_phase(gen):
    """The two flash-decode kernels against their plain version at every
    case of ``DECODE_CASES`` (two calls bit-equal), timed beside it and
    beside ``F.scaled_dot_product_attention`` over the same slots with a
    mask (a yardstick only: on the gathered ring for the table cases,
    ``library_ms``, and there also the gather through the table plus SDPA,
    ``gather_sdpa_ms``; on the dequantized cache for int8).  Each row
    reports the kernel's split of the slots (``chunk`` slots each,
    ``n_split`` blocks per row).
    Returns per kernel the main path's case (``serve`` / ``serve_table``:
    one launch at the serving tick's shape) and the worst error."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops, ref

    totals = {k: {"max_abs_err": 0.0} for k in ("decode_ring",
                                                 "decode_table")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (case, b, cap, hkv, g, hd, window, qd, kvd,
         bs) in DECODE_CASES:
        q_dtype, kv_dtype = getattr(torch, qd), getattr(torch, kvd)
        q, k, v, pos, ks, vs, table = decode_inputs(
            gen, b, cap, hkv, g, hd, q_dtype, kv_dtype, bs)
        kw = dict(window=window, scale=hd ** -0.5, k_scale=ks, v_scale=vs,
                  table=table)
        name = "decode_table" if bs else "decode_ring"
        with torch.inference_mode():
            got = ops.decode_attention(q, k, v, pos, **kw)
            torch.cuda.synchronize()
            want = ops.decode_attention(q, k, v, pos, backend="plain", **kw)
            err = check_close(f"{name} {case}", got.float(), want.float(),
                              DECODE_TOL[q_dtype])
            if not torch.equal(got, ops.decode_attention(q, k, v, pos,
                                                         **kw)):
                raise AssertionError(f"{name} {case}: two calls differ")
            k_ms = time_ms(lambda: ops.decode_attention(q, k, v, pos, **kw),
                           reps=50)
            p_ms = time_ms(lambda: ops.decode_attention(
                q, k, v, pos, backend="plain", **kw), reps=5)
            # the library's attention over the same slots: the ring in
            # (B, Hkv, cap, hd) views, in q's dtype
            sp = ref.slot_positions(pos, cap)
            valid = sp >= 0
            if window is not None:
                valid &= sp > pos.long()[:, None] - window
            mask = valid[:, None, None, :]
            q4 = q.reshape(b, hkv * g, 1, hd)

            def ring_views(k, v, ks, vs):
                if bs:
                    k, v = (ref.gather_pool(x, table) for x in (k, v))
                    if ks is not None:
                        ks, vs = (ref.gather_pool(x, table)
                                  for x in (ks, vs))
                if ks is not None:
                    k, v = k.float() * ks[..., None], v.float() * vs[..., None]
                return (x.to(q_dtype).permute(0, 2, 1, 3) for x in (k, v))

            kr, vr = ring_views(k, v, ks, vs)

            def sdpa(kr, vr):
                return F.scaled_dot_product_attention(
                    q4, kr, vr, attn_mask=mask, scale=hd ** -0.5,
                    enable_gqa=g > 1)

            def library():
                return sdpa(kr, vr)

            lib_err = max_err(library().reshape(got.shape), got)
            l_ms = time_ms(library, reps=50)
            # the table cases: the gather through the table, then SDPA
            g_ms = (time_ms(lambda: sdpa(*ring_views(k, v, ks, vs)),
                            reps=50) if bs else None)
        n_vis = int(valid.sum())                 # visible (row, slot) pairs
        elt = k.element_size()
        nbytes = (2 * n_vis * hkv * hd * elt + 2 * q.numel()
                  * q.element_size() + (8 * n_vis * hkv if ks is not None
                                        else 0))
        flops = 4.0 * n_vis * hkv * g * hd
        tensor_cores = not bs and ops.tensor_core_ring(g, q_dtype, kv_dtype)
        bound, bound_by = _bound(flops, nbytes,
                                 BF16_PEAK if tensor_cores else FP32_PEAK)
        chunk = ops.kernel_chunk(q, k, table, sms)
        row = {"phase": "decode_kernel", "kernel": name, "case": case,
               "body": "tensor cores" if tensor_cores else "simt",
               "shape": [b, cap, hkv, g, hd], "window": window,
               "block_size": bs, "q_dtype": qd, "kv_dtype": kvd,
               "pos": DECODE_POS[:b], "visible_slots": n_vis,
               "chunk": chunk,
               "n_split": len(ops.decode_chunks(cap, chunk)),
               "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms,
               "library": ("SDPA on the gathered ring" if bs
                           else "SDPA on the ring"),
               "gather_sdpa_ms": g_ms,
               "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
               "flops": flops, "gbps": nbytes / (k_ms * 1e-3) / 1e9,
               "bound_share": bound / k_ms, "max_err": err,
               "library_err": lib_err,
               "assumes": ("3.35 TB/s, " + ("989 TFLOP/s dense bf16 "
                                            "tensor-core" if tensor_cores
                                            else "67 TFLOP/s fp32 "
                                            "non-tensor")
                           + "; bytes of the visible K/V (+ scales, q, o)")}
        emit(row)
        tot = totals[name]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        if case in ("serve", "serve_table"):
            tot.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=l_ms)
        if tensor_cores:   # the hybrid's attn layers (hybrid_serving)
            tot.setdefault("tensor_core_cases", {})[case] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err}
    return totals


def serve_prompts(vocab: int, n: int, seed: int):
    """``n`` random prompts of SERVE_PROMPT tokens, the last a repeat of
    the first (an exact-prompt admission in block mode)."""
    rs = np.random.default_rng(seed)
    out = [rs.integers(0, vocab, int(rs.integers(*SERVE_PROMPT)))
           for _ in range(n - 1)]
    return out + [out[0].copy()]


def lm_closed_loop(engine, prompts, n_req: int, clients: int,
                   new: int = SERVE_NEW):
    """Serve ``n_req`` requests of ``new`` tokens from ``clients``
    closed-loop clients, each sending its next prompt (cycled from
    ``prompts``) when its answer comes back.  Returns (wall seconds,
    results)."""
    from repro_torch.serving import Request

    sent, results = 0, []

    def send():
        nonlocal sent
        engine.submit(Request(prompt=prompts[sent % len(prompts)],
                              max_new_tokens=new))
        sent += 1

    t0 = time.perf_counter()
    for _ in range(clients):
        send()
    while len(results) < n_req:
        for res in engine.step():
            results.append(res)
            if sent < n_req:
                send()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, results


def serve_metrics(wall, results) -> dict:
    toks = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft for r in results)
    per_tok = sorted((r.t_done - r.t_first) / (len(r.tokens) - 1)
                     for r in results)
    return {"wall_s": wall, "generated_tokens": toks,
            "generated_tokens_per_s": toks / wall,
            "ttft_p50_ms": percentile(ttft, 0.5) * 1e3,
            "ttft_p99_ms": percentile(ttft, 0.99) * 1e3,
            "per_token_p50_ms": percentile(per_tok, 0.5) * 1e3,
            "per_token_p99_ms": percentile(per_tok, 0.99) * 1e3}


def lm_serve_parity(seed):
    """The full width at LM_PARITY_LAYERS layers in fp32: greedy streams
    under the kernels equal those under the plain policy, ring and block
    pool alike (and ring equals block)."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.serving import Request, ServingEngine

    base = dataclasses.replace(ARCHS[LM_ARCH], n_layers=LM_PARITY_LAYERS,
                               dtype="float32")
    cfg = dataclasses.replace(base, kernels=KernelPolicy("auto"))
    plain_cfg = dataclasses.replace(base, kernels=KernelPolicy("plain"))
    params = models.init(cfg, torch.Generator().manual_seed(seed),
                         device="cuda")
    prompts = serve_prompts(cfg.vocab_size, SERVE_SLOTS, seed + 19)
    streams = {}
    for policy, c in (("kernel", cfg), ("plain", plain_cfg)):
        for mode, bs in (("ring", 0), ("block", 16)):
            eng = ServingEngine(params, c, slots=SERVE_SLOTS,
                                capacity=SERVE_CAPACITY, block_size=bs)
            res = eng.run([Request(prompt=p, max_new_tokens=32)
                           for p in prompts])
            streams[policy, mode] = {r.rid: r.tokens for r in res}
    for mode in ("ring", "block"):
        if streams["kernel", mode] != streams["plain", mode]:
            raise AssertionError(f"LM serving ({mode}): kernel and plain "
                                 "greedy streams differ")
    if streams["kernel", "ring"] != streams["kernel", "block"]:
        raise AssertionError("LM serving: ring and block streams differ")
    emit({"phase": "lm_serve_parity", "config": cfg.name,
          "layers": LM_PARITY_LAYERS, "dtype": "float32",
          "requests": len(prompts), "new_tokens": 32,
          "streams_equal": True,
          "tokens_compared": sum(len(t) for t in
                                 streams["kernel", "ring"].values())})
    del params


def lm_serve_counts(params, cfg, prompts, block_size, new=SERVE_NEW):
    """One wave of SERVE_SLOTS requests of ``new`` tokens with the launch
    counts set to 0 just before and read just after: n_layers flash_fwd
    launches per prefill and n_layers decode launches per tick."""
    from repro_torch.serving import Request, ServingEngine

    # the pool holds every slot's blocks and its tail snapshot, so the
    # wave is admitted at once (the default pool, slots x capacity / bs + 1,
    # defers the last request until the first retires)
    nb = SERVE_SLOTS * (SERVE_CAPACITY // block_size + 1) + 1 \
        if block_size else 0
    eng = ServingEngine(params, cfg, slots=SERVE_SLOTS,
                        capacity=SERVE_CAPACITY, block_size=block_size,
                        num_blocks=nb)
    reqs = [Request(prompt=p, max_new_tokens=new)
            for p in prompts[:SERVE_SLOTS]]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    skipped = eng.block_mgr.prefills_skipped if eng.block_mgr else 0
    prefills = len(reqs) - skipped
    decode = "decode_table" if block_size else "decode_ring"
    want = {k: 0 for k in launches}
    want.update(flash_fwd=cfg.n_layers * prefills)
    want[decode] = cfg.n_layers * eng.decode_steps
    if launches != want:
        raise AssertionError(f"{cfg.name} serving launches {launches} != "
                             f"{want}")
    if any(len(r.tokens) != new for r in res):
        raise AssertionError("every request must get its new tokens")
    return {"block_size": block_size, "launches": launches,
            "prefills": prefills, "prefills_skipped": skipped,
            "decode_ticks": eng.decode_steps,
            "launches_per_tick": launches[decode] // eng.decode_steps,
            "wall_s": wall, **serve_metrics(wall, res)}


def lm_serving_phase(seed, windows=3, n_req=32):
    """olmo-1b at full width and depth in bf16, 8 slots, capacity 2048:
    launch counts over one wave (ring, then block pool), the first decode
    tick's logits against the plain policy from the same state, then
    ``windows`` timed windows of ``n_req`` requests from 8 closed-loop
    clients and one more under ``torch.profiler``.  The 4-layer fp32
    stream parity runs first."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.serving import ServingEngine

    lm_serve_parity(seed)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(ARCHS[LM_ARCH], kernels=KernelPolicy("auto"))
    plain_cfg = dataclasses.replace(cfg, kernels=KernelPolicy("plain"))
    t0 = time.perf_counter()
    params = models.init(cfg, torch.Generator().manual_seed(seed),
                         device="cuda")
    prompts = serve_prompts(cfg.vocab_size, 4 * SERVE_SLOTS, seed + 23)
    setup_s = time.perf_counter() - t0

    # first decode tick, kernel vs plain, from one prefilled state
    with torch.inference_mode():
        b = SERVE_SLOTS
        toks = torch.zeros((b, SERVE_PROMPT[1]), dtype=torch.long,
                           device="cuda")
        lengths = torch.tensor([len(p) for p in prompts[:b]], device="cuda")
        for i, p in enumerate(prompts[:b]):
            toks[i, :len(p)] = torch.as_tensor(p)
        logits, state = models.prefill(params, cfg, toks, SERVE_CAPACITY,
                                       length=lengths)
        nxt = logits[torch.arange(b), lengths - 1].argmax(-1)[:, None]
        out = {}
        for name, c in (("kernel", cfg), ("plain", plain_cfg)):
            out[name], _ = models.decode_step(
                params, c, models.read_slots(state, range(b)), nxt)
        del logits, state
    lk, lp = out["kernel"][:, 0], out["plain"][:, 0]
    if lk.shape != (b, cfg.vocab_size) or not torch.isfinite(lk).all():
        raise AssertionError("first-tick logits: bad shape or non-finite")
    tick_err = max_err(lk, lp)
    tick_rel = ((lk - lp).norm() / lp.norm()).item()
    top2 = torch.topk(lp, 2, dim=-1)
    clear = (top2.values[:, 0] - top2.values[:, 1]) > 2 * tick_err
    if tick_rel > SERVE_LOGIT_TOL or not torch.equal(
            lk.argmax(-1)[clear], top2.indices[clear, 0]):
        raise AssertionError(f"olmo-1b bf16 first decode tick vs plain: "
                             f"relative L2 {tick_rel:.3e} (bar "
                             f"{SERVE_LOGIT_TOL}), max |err| {tick_err:.3e}, "
                             "or a clear greedy token differs")
    del out

    counts = [lm_serve_counts(params, cfg, prompts, bs) for bs in (0, 16)]
    emit({"phase": "lm_serving", "config": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "dtype": cfg.dtype, "slots": SERVE_SLOTS,
          "capacity": SERVE_CAPACITY, "prompt_tokens": list(SERVE_PROMPT),
          "new_tokens": SERVE_NEW, "first_tick_logit_max_err": tick_err,
          "first_tick_logit_rel_l2": tick_rel,
          "first_tick_rows_compared": int(clear.sum()),
          "waves": counts, "setup_s": setup_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    engine = ServingEngine(params, cfg, slots=SERVE_SLOTS,
                           capacity=SERVE_CAPACITY)
    rows = []
    for i in range(windows):
        wall, res = lm_closed_loop(engine, prompts, n_req, SERVE_SLOTS)
        rows.append({"window": i, **serve_metrics(wall, res)})
    ticks0 = engine.decode_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall, _ = lm_closed_loop(engine, prompts, n_req, SERVE_SLOTS)
    ticks = engine.decode_steps - ticks0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm_serve_trace.json")
        prof.export_chrome_trace(path)
        busy = device_busy(path, lm_family)
    for row in rows:
        row["device_idle_share"] = 1.0 - busy["busy_ms"] / 1e3 / row[
            "wall_s"]
        emit({"phase": "lm_serving_window", "config": cfg.name,
              "slots": SERVE_SLOTS, "clients": SERVE_SLOTS,
              "requests": n_req, **row})

    def spread(key):
        xs = sorted(r[key] for r in rows)
        return {"min": xs[0], "median": statistics.median(xs), "max": xs[-1]}

    emit({"phase": "lm_serving_timing", "config": cfg.name,
          "slots": SERVE_SLOTS, "requests_per_window": n_req,
          "windows": windows,
          **{k: spread(k) for k in ("generated_tokens_per_s", "ttft_p50_ms",
                                    "ttft_p99_ms", "per_token_p50_ms",
                                    "per_token_p99_ms",
                                    "device_idle_share")},
          "profiled_wall_s": prof_wall, "profiled_ticks": ticks,
          "profiled_idle_share": 1.0 - busy["busy_ms"] / 1e3 / prof_wall,
          "device_busy_ms": busy["busy_ms"],
          "device_ms_by_family": busy["ms_by_family"],
          "top_kernels_ms": busy["top_kernels"]})
    return {"ring": counts[0]["launches"], "block": counts[1]["launches"]}


def anchored_check(what, lk, lp, l32):
    """bf16 logits under the kernels ``lk`` and the plain policy ``lp``
    (B, V) against the fp32 logits ``l32`` of the same weights and
    inputs: finite, and the kernel's relative L2 distance to ``l32`` at
    most BF16_NOISE_RATIO times the plain version's.  Kernel and plain
    differ only in where their fp32 sums round to bf16, so at full depth
    their distance to each other is bf16 noise that the layers amplify;
    their distances to fp32 measure that noise for each."""
    if not torch.isfinite(lk).all():
        raise AssertionError(f"{what}: non-finite logits")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    out = {"kernel_vs_plain_rel_l2": rel(lk, lp),
           "kernel_vs_plain_max_abs_err": max_err(lk, lp),
           "kernel_vs_fp32_rel_l2": rel(lk, l32),
           "plain_vs_fp32_rel_l2": rel(lp, l32),
           "same_greedy_token_rows": int((lk.argmax(-1)
                                          == lp.argmax(-1)).sum())}
    if out["kernel_vs_fp32_rel_l2"] > \
            BF16_NOISE_RATIO * out["plain_vs_fp32_rel_l2"]:
        raise AssertionError(f"{what}: kernel further from fp32 than "
                             f"{BF16_NOISE_RATIO} x plain: {out}")
    return out


def recurrent_serve_parity(arch, seed):
    """The published width at a few layers in fp32 (``RECURRENT_SERVE``):
    greedy streams of SERVE_SLOTS requests under the kernels equal those
    under the plain policy.  The hybrid runs one ``rec, rec, attn``
    superblock with its window cut to 256 slots, below every prompt, so
    that prefill and decode run on a wrapped ring."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.serving import Request, ServingEngine

    _, layers, window = RECURRENT_SERVE[arch]
    base = dataclasses.replace(ARCHS[arch], n_layers=layers, dtype="float32")
    if window:
        base = dataclasses.replace(base, sliding_window=window)
    params = models.init(base, torch.Generator().manual_seed(seed),
                         device="cuda")
    prompts = serve_prompts(base.vocab_size, SERVE_SLOTS, seed + 31)
    streams = {}
    for policy in ("auto", "plain"):
        eng = ServingEngine(params, dataclasses.replace(
            base, kernels=KernelPolicy(policy)), slots=SERVE_SLOTS,
            capacity=SERVE_CAPACITY)
        res = eng.run([Request(prompt=p, max_new_tokens=RECURRENT_SERVE_NEW)
                       for p in prompts])
        streams[policy] = {r.rid: r.tokens for r in res}
    if streams["auto"] != streams["plain"]:
        raise AssertionError(f"{arch} serving: kernel and plain greedy "
                             "streams differ")
    emit({"phase": "recurrent_serve_parity", "config": base.name,
          "layers": layers, "layer_kinds": recurrent_kinds(base),
          "window": window, "dtype": "float32", "requests": len(prompts),
          "prompt_tokens": [len(p) for p in prompts],
          "new_tokens": RECURRENT_SERVE_NEW, "streams_equal": True,
          "tokens_compared": sum(len(t) for t in streams["auto"].values())})
    del params


def recurrent_serving_phase(arch, seed):
    """``arch`` at its published width and depth in bf16, 8 slots,
    capacity 2048, ring cache, greedy.  The fp32 stream parity runs first;
    then, from one bf16 batch of SERVE_SLOTS prompts, the prefill's last
    logits under the kernel and the plain policy (each prefilled under
    its own) and the first decode tick's under both from the kernel
    policy's state, each held to fp32 (``anchored_check``); one wave of
    SERVE_SLOTS requests with the launch counts set to 0 just before and
    read just after (per prefill one
    ``wkv_fwd`` per rwkv layer, one ``rglru_fwd`` per rec layer and one
    ``flash_fwd`` per attn layer; per tick one ``decode_ring`` per attn
    layer); one timed window of RECURRENT_SERVE_REQUESTS requests from 8
    closed-loop clients and one traced window of RECURRENT_TRACE_REQUESTS
    (device ms per tick by family, ``decode_ring``'s and the state
    update's shares)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.tree import tree_leaves, tree_map

    phase = RECURRENT_SERVE[arch][0]
    seconds, t_phase = {}, time.perf_counter()

    def lap(name):
        seconds[name] = time.perf_counter() - t_phase

    recurrent_serve_parity(arch, seed)
    gc.collect()
    torch.cuda.empty_cache()
    lap("fp32_parity")
    cfg = dataclasses.replace(ARCHS[arch], kernels=KernelPolicy("auto"))
    plain_cfg = dataclasses.replace(cfg, kernels=KernelPolicy("plain"))
    t0 = time.perf_counter()
    params = models.init(cfg, torch.Generator().manual_seed(seed),
                         device="cuda")
    prompts = serve_prompts(cfg.vocab_size, 2 * SERVE_SLOTS, seed + 37)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # bf16 kernel against plain, each anchored to fp32 (the same weights
    # in fp32 under the plain policy): the prefill's last logits, each
    # policy prefilling the batch itself (fp32: row by row at its length),
    # and the first decode tick from the kernel policy's state (fp32: that
    # state cast to fp32)
    b = SERVE_SLOTS
    cfg32 = dataclasses.replace(plain_cfg, dtype="float32")
    with torch.inference_mode():
        toks = torch.zeros((b, SERVE_PROMPT[1]), dtype=torch.long,
                           device="cuda")
        lengths = torch.tensor([len(p) for p in prompts[:b]], device="cuda")
        for i, p in enumerate(prompts[:b]):
            toks[i, :len(p)] = torch.as_tensor(p)
        rows = torch.arange(b, device="cuda")
        last, states = {}, {}
        for name, c in (("kernel", cfg), ("plain", plain_cfg)):
            logits, states[name] = models.prefill(params, c, toks,
                                                  SERVE_CAPACITY,
                                                  length=lengths)
            last[name] = logits[rows, lengths - 1].float()
            del logits
            lap(f"{name}_prefill")
        del states["plain"]
        params32 = tree_map(lambda x: x.float(), params)
        last["fp32"] = torch.cat([models.prefill(
            params32, cfg32, toks[i:i + 1, :len(p)], SERVE_CAPACITY)[0][:, -1]
            for i, p in enumerate(prompts[:b])])
        lap("fp32_prefill")
        prefill_check = anchored_check(f"{arch} bf16 prefill", last["kernel"],
                                       last["plain"], last["fp32"])
        nxt = last["kernel"].argmax(-1)[:, None]
        tick = {}
        for name, c, prm in (("kernel", cfg, params),
                             ("plain", plain_cfg, params),
                             ("fp32", cfg32, params32)):
            st = models.read_slots(states["kernel"], range(b))
            if name == "fp32":
                st = models.DecodeState(cache=models.map_cache(
                    lambda leaf, axis: leaf.float(), st.cache), pos=st.pos)
            tick[name] = models.decode_step(prm, c, st, nxt)[0][:, 0].float()
        del states, last, params32
    tick_check = anchored_check(f"{arch} bf16 first decode tick",
                                tick["kernel"], tick["plain"], tick["fp32"])
    del tick
    gc.collect()
    torch.cuda.empty_cache()
    lap("first_tick")

    n = recurrent_kinds(cfg)
    eng = ServingEngine(params, cfg, slots=SERVE_SLOTS,
                        capacity=SERVE_CAPACITY)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = eng.run([Request(prompt=p, max_new_tokens=RECURRENT_SERVE_NEW)
                   for p in prompts[:b]])
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    launches = read_counts()
    want = {k: 0 for k in launches}
    want.update(wkv_fwd=n["rwkv"] * b, rglru_fwd=n["rec"] * b,
                flash_fwd=n["attn"] * b,
                decode_ring=n["attn"] * eng.decode_steps)
    if launches != want:
        raise AssertionError(f"{arch} serving launches {launches} != {want}")
    if any(len(r.tokens) != RECURRENT_SERVE_NEW for r in res):
        raise AssertionError("every request must get its new tokens")
    emit({"phase": phase, "config": cfg.name, "layers": cfg.n_layers,
          "layer_kinds": n, "d_model": cfg.d_model, "dtype": cfg.dtype,
          "params": sum(x.numel() for x in tree_leaves(params)),
          "slots": SERVE_SLOTS, "capacity": SERVE_CAPACITY,
          "prompt_tokens": list(SERVE_PROMPT),
          "new_tokens": RECURRENT_SERVE_NEW,
          "prefill_logits": prefill_check, "first_tick_logits": tick_check,
          "logit_gate": f"kernel-to-fp32 relative L2 <= {BF16_NOISE_RATIO}"
                        " x plain-to-fp32",
          "launches": launches, "prefills": b,
          "decode_ticks": eng.decode_steps,
          "launches_per_prefill": {k: launches[k] // b for k in
                                   ("wkv_fwd", "rglru_fwd", "flash_fwd")},
          "launches_per_tick": launches["decode_ring"] // eng.decode_steps,
          "wave": serve_metrics(wave_s, res), "setup_s": setup_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    lap("wave")
    wall, res = lm_closed_loop(eng, prompts, RECURRENT_SERVE_REQUESTS,
                               SERVE_SLOTS, RECURRENT_SERVE_NEW)
    window = serve_metrics(wall, res)
    ticks0 = eng.decode_steps
    # CPU activity too: the named ranges are host-side events
    with profile(activities=[ProfilerActivity.CUDA,
                             ProfilerActivity.CPU]) as prof:
        prof_wall, _ = lm_closed_loop(eng, prompts, RECURRENT_TRACE_REQUESTS,
                                      SERVE_SLOTS, RECURRENT_SERVE_NEW)
    ticks = eng.decode_steps - ticks0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{phase}_trace.json")
        prof.export_chrome_trace(path)
        busy = device_busy(path, lm_family,
                           scopes=("prefill", "wkv_decode", "rglru_decode"))
    by = busy["ms_by_family"]
    tick_ms = sum(v for k, v in by.items() if k != "prefill")
    update = by.get("wkv_decode", 0.0) + by.get("rglru_decode", 0.0)
    emit({"phase": f"{phase}_timing", "config": cfg.name,
          "slots": SERVE_SLOTS, "clients": SERVE_SLOTS,
          "requests_per_window": RECURRENT_SERVE_REQUESTS,
          "traced_requests": RECURRENT_TRACE_REQUESTS,
          **window,
          # the traced window's host also records the trace: an upper
          # bound on the timed windows' idle share
          "profiled_idle_share": 1.0 - busy["busy_ms"] / 1e3 / prof_wall,
          "profiled_wall_s": prof_wall, "profiled_ticks": ticks,
          "device_busy_ms": busy["busy_ms"],
          "prefill_device_ms": by.get("prefill", 0.0),
          "decode_device_ms_per_tick": tick_ms / ticks,
          "decode_ring_share_of_tick": by.get("decode", 0.0) / tick_ms,
          "state_update_share_of_tick": update / tick_ms,
          "device_ms_by_family": by, "top_kernels_ms": busy["top_kernels"]})
    lap("windows")
    emit({"phase": f"{phase}_seconds", "seconds_at_end_of": seconds})
    return launches


def attn_layers(cfg) -> int:
    from repro_torch.models import transformer
    kinds = transformer.layer_kinds(cfg)
    return kinds.count("dense") + kinds.count("attn")


def first_difference(params, cfg, prompts, got, want):
    """Where two greedy stream sets part first: the rid, the token's
    index and the top-2 margin of ``cfg``'s logits there (a prefill of
    the prompt and the tokens both streams agree on)."""
    from repro_torch import models

    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
        if k is None:
            continue
        seq = torch.as_tensor(np.concatenate([prompts[rid], b[:k]]),
                              device="cuda")[None]
        with torch.inference_mode():
            top = models.prefill(params, cfg, seq, SERVE_CAPACITY)[0][
                0, -1].topk(2).values
        return {"rid": rid, "token": k,
                "top2_margin": (top[0] - top[1]).item()}
    return None


def spec_serve_parity(arch, seed):
    """The published width at a few layers in fp32 (``SPEC_SERVE``),
    drafting with the target's first layers: the spec engine's greedy
    streams of SERVE_SLOTS requests under the kernels must equal, per
    rid, the plain engine's under the kernels and the spec engine's under
    the plain policy."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.spec_decode import truncated_draft

    _, _, layers, dlayers, window, _ = SPEC_SERVE[arch]
    base = dataclasses.replace(ARCHS[arch], n_layers=layers, dtype="float32")
    if window:
        base = dataclasses.replace(base, sliding_window=window)
    params = models.init(base, torch.Generator().manual_seed(seed),
                         device="cuda")
    prompts = serve_prompts(base.vocab_size, SERVE_SLOTS, seed + 41)
    streams, accepted = {}, {}
    for policy, spec in (("auto", True), ("auto", False), ("plain", True)):
        cfg = dataclasses.replace(base, kernels=KernelPolicy(policy))
        dcfg, dparams = truncated_draft(cfg, params, dlayers)
        kw = {"draft_params": dparams, "draft_cfg": dcfg,
              "spec_tokens": SPEC_TOKENS} if spec else {}
        eng = ServingEngine(params, cfg, slots=SERVE_SLOTS,
                            capacity=SERVE_CAPACITY, **kw)
        res = eng.run([Request(prompt=p, max_new_tokens=SPEC_NEW)
                       for p in prompts])
        streams[policy, spec] = {r.rid: r.tokens for r in res}
        accepted[f"{policy}_{'spec' if spec else 'plain'}"] = (
            eng.spec_accepted, eng.spec_proposed, eng.dispatches)
    for other in (("auto", False), ("plain", True)):
        if streams[other] != streams["auto", True]:
            where = first_difference(params, dataclasses.replace(
                base, kernels=KernelPolicy("plain")), prompts,
                streams["auto", True], streams[other])
            raise AssertionError(f"{arch} spec serving: the kernels' spec "
                                 f"streams differ from {other}: {where}")
    emit({"phase": "spec_serve_parity", "config": base.name,
          "layers": layers, "draft_layers": dlayers,
          "layer_kinds": recurrent_kinds(base), "window": window,
          "dtype": "float32", "requests": len(prompts),
          "prompt_tokens": [len(p) for p in prompts],
          "new_tokens": SPEC_NEW, "spec_tokens": SPEC_TOKENS,
          "streams_equal": True,
          "accepted_proposed_dispatches": accepted,
          "tokens_compared": sum(len(t) for t in
                                 streams["auto", True].values())})
    del params


def spec_serving_phase(arch, seed):
    """Speculative serving: ``arch`` at its published width and depth in
    bf16, 8 slots, capacity 2048, greedy, drafting SPEC_TOKENS tokens a
    round with its own first layers.  The fp32 stream parity runs first;
    then one wave of SERVE_SLOTS requests with the launch counts set to 0
    just before and read just after: per admission one ``flash_fwd`` per
    attention layer, one ``wkv_fwd`` per rwkv layer and one ``rglru_fwd``
    per rec layer, target and draft; per dispatch SPEC_TOKENS
    ``decode_ring`` per draft attention layer (the target's verify has
    no kernel) and two ``rglru_fwd`` per rec layer of either (verify or
    the draft's chunk, then the commit).  From one prefilled state the
    verify logits of one round (``decode_seq_pending``) and SPEC_TOKENS
    + 1 sequential ``decode_step`` logits, both bf16, are each held to
    the same weights' fp32 sequential logits (``anchored_check``, both
    ways).  Then, for the targets that time it, a window of SPEC_REQUESTS
    requests from 8 closed-loop clients, spec and then plain serving."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.spec_decode import truncated_draft
    from repro_torch.tree import tree_map

    phase, dlayers, _, _, _, timed = SPEC_SERVE[arch]
    seconds, t_phase = {}, time.perf_counter()

    def lap(name):
        seconds[name] = time.perf_counter() - t_phase

    spec_serve_parity(arch, seed)
    gc.collect()
    torch.cuda.empty_cache()
    lap("fp32_parity")
    cfg = dataclasses.replace(ARCHS[arch], kernels=KernelPolicy("auto"))
    params = models.init(cfg, torch.Generator().manual_seed(seed),
                         device="cuda")
    dcfg, dparams = truncated_draft(cfg, params, dlayers)
    prompts = serve_prompts(cfg.vocab_size, 2 * SERVE_SLOTS, seed + 43)
    b = SERVE_SLOTS
    eng = ServingEngine(params, cfg, slots=b, capacity=SERVE_CAPACITY,
                        draft_params=dparams, draft_cfg=dcfg,
                        spec_tokens=SPEC_TOKENS)
    torch.cuda.synchronize()
    lap("setup")
    zero_counts()
    t0 = time.perf_counter()
    res = eng.run([Request(prompt=p, max_new_tokens=SPEC_NEW)
                   for p in prompts[:b]])
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    launches = read_counts()
    tk, dk = recurrent_kinds(cfg), recurrent_kinds(dcfg)
    n_attn = attn_layers(cfg) + attn_layers(dcfg)
    n_rec = tk["rec"] + dk["rec"]
    want = {k: 0 for k in launches}
    want.update(flash_fwd=n_attn * b, wkv_fwd=(tk["rwkv"] + dk["rwkv"]) * b,
                rglru_fwd=n_rec * b + 2 * n_rec * eng.dispatches,
                decode_ring=SPEC_TOKENS * attn_layers(dcfg) * eng.dispatches)
    if launches != want:
        raise AssertionError(f"{arch} spec serving launches {launches} != "
                             f"{want}")
    if any(len(r.tokens) != SPEC_NEW for r in res):
        raise AssertionError("every request must get its new tokens")
    wave = serve_metrics(wave_s, res)
    wave.update(dispatches=eng.dispatches,
                accepted=eng.spec_accepted, proposed=eng.spec_proposed)
    lap("wave")

    # the verify logits of one round against SPEC_TOKENS + 1 sequential
    # decode steps, both bf16 from one prefilled state, each anchored to
    # the fp32 sequential logits of the same weights from that state
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                kernels=KernelPolicy("plain"))
    with torch.inference_mode():
        toks = torch.zeros((b, SERVE_PROMPT[1]), dtype=torch.long,
                           device="cuda")
        lengths = torch.tensor([len(p) for p in prompts[:b]], device="cuda")
        for i, p in enumerate(prompts[:b]):
            toks[i, :len(p)] = torch.as_tensor(p)
        _, state = models.prefill(params, cfg, toks, SERVE_CAPACITY,
                                  length=lengths)
        x = torch.randint(0, cfg.vocab_size, (b, SPEC_TOKENS + 1),
                          device="cuda", generator=torch.Generator(
                              "cuda").manual_seed(seed + 47))
        verify = models.decode_seq_pending(params, cfg, state, x)[0]
        del toks

        def sequential(prm, c, st):
            out = []
            for j in range(SPEC_TOKENS + 1):
                logits, st = models.decode_step(prm, c, st, x[:, j:j + 1])
                out.append(logits[:, 0])
            return torch.stack(out, 1)

        seq = sequential(params, cfg, models.read_slots(state, range(b)))
        params32 = tree_map(lambda t: t.float(), params)
        seq32 = sequential(params32, cfg32, models.DecodeState(
            cache=models.map_cache(lambda leaf, _: leaf.float(),
                                   state.cache), pos=state.pos.clone()))
        del params32, state
    flat = [t.reshape(-1, t.shape[-1]).float() for t in (verify, seq, seq32)]
    verify_check = anchored_check(f"{arch} bf16 spec verify", *flat)
    sequential_check = anchored_check(f"{arch} bf16 sequential ticks",
                                      flat[1], flat[0], flat[2])
    del verify, seq, seq32, flat
    gc.collect()
    torch.cuda.empty_cache()
    lap("verify_logits")
    emit({"phase": phase, "config": cfg.name, "layers": cfg.n_layers,
          "draft": dcfg.name, "draft_layers": dlayers,
          "layer_kinds": tk, "draft_layer_kinds": dk,
          "attention_layers": [attn_layers(cfg), attn_layers(dcfg)],
          "d_model": cfg.d_model, "dtype": cfg.dtype, "slots": b,
          "capacity": SERVE_CAPACITY, "prompt_tokens": list(SERVE_PROMPT),
          "new_tokens": SPEC_NEW, "spec_tokens": SPEC_TOKENS,
          "launches": launches, "admissions": b,
          "dispatches": eng.dispatches,
          "launches_per_admission": {
              "flash_fwd": n_attn, "wkv_fwd": tk["rwkv"] + dk["rwkv"],
              "rglru_fwd": n_rec},
          "launches_per_dispatch": {
              "decode_ring": SPEC_TOKENS * attn_layers(dcfg),
              "rglru_fwd": 2 * n_rec},
          "wave": wave, "verify_logits": verify_check,
          "sequential_logits": sequential_check,
          "logit_gate": f"each one's relative L2 to fp32 <= "
                        f"{BF16_NOISE_RATIO} x the other's",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    if timed:
        windows = {}
        for name, engine in (
                ("spec", eng),
                ("plain", ServingEngine(params, cfg, slots=b,
                                        capacity=SERVE_CAPACITY))):
            d0, a0, p0 = (engine.dispatches, engine.spec_accepted,
                          engine.spec_proposed)
            wall, res = lm_closed_loop(engine, prompts, SPEC_REQUESTS, b,
                                       SPEC_NEW)
            windows[name] = serve_metrics(wall, res)
            proposed = engine.spec_proposed - p0
            windows[name].update(
                dispatches=engine.dispatches - d0,
                accepted=engine.spec_accepted - a0, proposed=proposed,
                acceptance=(engine.spec_accepted - a0) / proposed
                if proposed else None)
            lap(f"{name}_window")
        emit({"phase": f"{phase}_timing", "config": cfg.name,
              "draft": dcfg.name, "slots": b, "clients": b,
              "requests_per_window": SPEC_REQUESTS, "new_tokens": SPEC_NEW,
              "spec_tokens": SPEC_TOKENS, **windows})
    del eng, params, dparams
    gc.collect()
    emit({"phase": f"{phase}_seconds", "seconds_at_end_of": seconds})
    return launches


# the multi-process tier (queue A item 11): olmo-1b behind the router,
# TIER_INSTANCES engine workers of SERVE_SLOTS slots each (capacity
# SERVE_CAPACITY) plus a prefill worker, TIER_REQUESTS prompts of
# SERVE_PROMPT tokens and TIER_NEW new tokens each; the fp32 streams at
# LM_PARITY_LAYERS layers, the bf16 ones at full depth; the in-process
# handoffs of the recurrent LMs at their RECURRENT_SERVE parity depth.
# A colocated drain waits until the instance holds TIER_DRAIN_ROWS + 1
# live rows (one may retire before the drain reaches it) and must move
# TIER_DRAIN_ROWS; the fp32 colocated run makes TIER_PARITY_NEW tokens a
# request, so that its short ticks still leave rows live on both
# instances while the router submits (its other runs' streams are the
# first TIER_NEW of those)
TIER_INSTANCES = 2
TIER_REQUESTS = 16
TIER_NEW = 32
TIER_PARITY_NEW = 256
TIER_DRAIN_ROWS = 2
TIER_TIMEOUT = 300             # seconds a tier run may take to finish
# the bf16 runs' depth: half of olmo-1b's 16 layers, which halves the
# 268 MB snapshot a disaggregated request ships and keeps the whole run
# within its time limit (959.4 s at 16 layers on an H100 80GB HBM3 at
# 700 W, chip_smoke.py's total line)
TIER_BF16_LAYERS = 8


def tier_argv(seed, *extra):
    """Serve CLI flags of olmo-1b's tier instances: full width, the
    kernels (``--kernel-backend auto`` on the card)."""
    return ["--arch", LM_ARCH, "--slots", str(SERVE_SLOTS),
            "--capacity", str(SERVE_CAPACITY), "--seed", str(seed),
            "--kernel-backend", "auto", *extra]


def tier_engine(argv):
    """The engine the workers of ``argv`` build, in this process (the
    serve CLI's own ``build_cfg`` and ``build_engine``)."""
    from repro_torch.launch import serve as serve_cli

    def error(msg):
        raise AssertionError(msg)

    args = serve_cli.build_parser().parse_args(argv)
    cfg = serve_cli.build_cfg(args, error)
    return serve_cli.build_engine(args, cfg, torch.device("cuda"), error)


def spawn_tier(argv, roles, logdir):
    """Start one worker per (name, role), each writing to its own log in
    ``logdir``: their handles, not yet connected."""
    from repro_torch.serving.tier import spawn_worker

    handles = []
    for name, role in roles:
        log = open(os.path.join(logdir, f"{name}.log"), "w")
        handles.append(spawn_worker(role, argv, name=name, stdout=log))
        log.close()             # the child holds its own descriptor
    return handles


def stop_tier(handles):
    """Ask every worker to exit, then wait for each (killing it after
    10 s): they wind down at once."""
    for h in handles:
        h.stop()
    for h in handles:
        h.close(timeout=10)


def close_tier(handles, logdir, failed: bool):
    """Shut every worker down; after a failure print the end of each
    worker's log."""
    stop_tier(handles)
    if failed:
        for h in handles:
            with open(os.path.join(logdir, f"{h.name}.log")) as f:
                print(f"--- {h.name} (exit {h.proc.returncode}):\n"
                      + f.read()[-3000:], flush=True)


def single_streams(engine, prompts, new=TIER_NEW):
    """One run of ``prompts`` through a single-process engine, all
    submitted at once: ({rid: tokens}, wall seconds, results)."""
    from repro_torch.serving import Request

    rids = [engine.submit(Request(prompt=p, max_new_tokens=new))
            for p in prompts]
    t0 = time.perf_counter()
    res = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_rid = {r.rid: r.tokens for r in res}
    return {i: by_rid[rid] for i, rid in enumerate(rids)}, wall, res


def worker_stats(handles) -> dict:
    return {h.name: h.call("stats")[1] for h in handles}


def tier_run(instances, prefill, prompts, drain=None, rows=1,
             new=TIER_NEW):
    """One run of ``prompts`` through a ``Router`` over ``instances``
    (and ``prefill``).  With ``drain``, the drain of that instance
    mid-stream: after each submit its stats are read, and once it holds
    ``rows`` live rows (``rows`` + 1 for ``rows`` > 1, one of which may
    retire first) and has ticked twice more, it is drained; the drain
    must move at least ``rows``.
    Fails if a worker died or the prefill worker was dropped (the router
    would place the work again elsewhere), or a request was lost.
    Returns ({grid: tokens}, router results, a dict of the wall and
    submit seconds, the rows the drain moved and the queued requests it
    placed again)."""
    from repro_torch.serving import Request, Router

    router = Router(instances, prefill=prefill)
    at = rows + (rows > 1)
    moved = requeued = seen = 0
    live = None                     # live rows when the drain was due
    t0 = time.perf_counter()
    for p in prompts:
        router.submit(Request(prompt=p, max_new_tokens=new))
        if drain is not None and live is None:
            st = drain.call("stats")[1]
            seen = max(seen, st["active"])
            if st["active"] >= at:
                live = st["active"]
                deadline = time.monotonic() + TIER_TIMEOUT
                while drain.call("stats")[1]["decode_steps"] \
                        < st["decode_steps"] + 2:
                    if time.monotonic() > deadline:
                        raise AssertionError("the instance to drain never "
                                             "ticked")
                    router.pump()
                    time.sleep(0.002)
                moved, requeued = router.drain_instance(
                    drain, timeout=TIER_TIMEOUT)
    submit_s = time.perf_counter() - t0
    if drain is not None and moved < rows:
        raise AssertionError(f"the drain moved {moved} rows, not {rows} "
                             f"(at most {seen} were live at once)")
    res = router.run_until_done(timeout=TIER_TIMEOUT)
    wall = time.perf_counter() - t0
    st = router.stats()
    workers = instances + ([prefill] if prefill else [])
    if st["dead"] or router.prefill_worker is not prefill or any(
            h.proc.poll() is not None for h in workers):
        raise AssertionError(f"a tier worker failed: dead {st['dead']}, "
                             f"prefill worker {router.prefill_worker}")
    if len(res) != len(prompts):
        raise AssertionError(f"the tier dropped {len(prompts) - len(res)} "
                             "requests")
    return ({r["grid"]: r["tokens"] for r in res}, res,
            {"wall_s": wall, "submit_s": submit_s, "rows_moved": moved,
             "rows_live": live, "requeued": requeued,
             "deferred": router.deferred})


def check_streams(what, got, want, params, cfg, prompts):
    if got != want:
        at = first_difference(params, cfg, prompts, got, want)
        raise AssertionError(f"{what}: the tier's streams differ from the "
                             f"single-process engine's, first at {at}")


def tier_metrics(res, wall) -> dict:
    """Aggregate generated tokens/s and the router's latency p50/p99."""
    lat = sorted(r["router_latency"] for r in res)
    return {"generated_tokens_per_s": sum(len(r["tokens"]) for r in res)
            / wall,
            "router_latency_p50_ms": percentile(lat, 0.5) * 1e3,
            "router_latency_p99_ms": percentile(lat, 0.99) * 1e3}


def stats_delta(before, after, key) -> dict:
    """Per worker, the change of its counters ``key`` (``launches`` or
    ``seconds``) between two ``worker_stats``."""
    return {name: {k: n - before[name][key][k] for k, n in st[key].items()}
            for name, st in after.items()}


def held_launches(what, before, after, insts, pre, layers, requests):
    """The workers' kernel launches between two ``worker_stats``, held
    exactly: a prefill worker launches ``layers`` ``flash_fwd`` a prompt
    and nothing else; an instance ``layers`` ``decode_ring`` a tick and,
    colocated, ``layers`` ``flash_fwd`` a prompt it admits (``requests``
    prompts over all of them), and nothing else.  Colocated, every
    instance must have ticked.  Returns (launches by worker, ticks by
    instance)."""
    delta = stats_delta(before, after, "launches")
    ticks = {h.name: after[h.name]["decode_steps"]
             - before[h.name]["decode_steps"] for h in insts}
    flash = {h.name: delta[h.name]["flash_fwd"] for h in insts}
    if pre is not None:
        want = {pre.name: {"flash_fwd": layers * requests}}
        want.update({n: {"flash_fwd": 0} for n in flash})
    else:
        if sum(flash.values()) != layers * requests or any(
                f % layers or not f or not ticks[n]
                for n, f in flash.items()):
            raise AssertionError(f"{what}: not every instance prefilled "
                                 f"and ticked, or {flash} flash_fwd for "
                                 f"{requests} prompts of {layers} layers "
                                 f"(ticks {ticks})")
        want = {n: {"flash_fwd": f} for n, f in flash.items()}
    for n in ticks:
        want[n]["decode_ring"] = layers * ticks[n]
    for name, counts in delta.items():
        expect = {k: 0 for k in counts}
        expect.update(want.get(name, {}))      # an idle worker: nothing
        if counts != expect:
            raise AssertionError(f"{what}: tier worker {name} launches "
                                 f"{counts} != {expect}")
    return delta, ticks


def recurrent_handoff(arch, seed):
    """In one process, no sockets: ``arch`` at its fp32 parity depth and
    window (``RECURRENT_SERVE``), SERVE_SLOTS requests; every live row is
    drained mid-stream (``export_slot``), packed, unpacked and imported
    into a second engine, whose streams must equal an uninterrupted
    run's."""
    import dataclasses

    from repro_torch import checkpoint, models
    from repro_torch.configs import ARCHS
    from repro_torch.serving import Request, ServingEngine, tier

    _, layers, window = RECURRENT_SERVE[arch]
    cfg = dataclasses.replace(ARCHS[arch], n_layers=layers, dtype="float32")
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    params = models.init(cfg, torch.Generator().manual_seed(seed),
                         device="cuda")
    prompts = serve_prompts(cfg.vocab_size, SERVE_SLOTS, seed + 37)

    def engine():
        return ServingEngine(params, cfg, slots=SERVE_SLOTS,
                             capacity=SERVE_CAPACITY)

    want, _, _ = single_streams(engine(), prompts)
    first = engine()
    rids = {first.submit(Request(prompt=p, max_new_tokens=TIER_NEW)): i
            for i, p in enumerate(prompts)}
    for _ in range(5):
        if first.step():
            raise AssertionError("a row finished before the handoff")
    t0 = time.perf_counter()
    snaps, queued = first.drain()
    bufs = [tier.pack_snapshot(s) for s in snaps]
    second = engine()
    like = tier.snapshot_like(cfg, SERVE_CAPACITY)
    moved = {}
    for buf in bufs:
        rid = second.import_snapshot(tier.unpack_snapshot(buf, like))
        moved[rid] = rids[checkpoint.peek_meta(buf)["rid"]]
    handoff_s = time.perf_counter() - t0
    if len(snaps) != SERVE_SLOTS or queued:
        raise AssertionError(f"{arch}: drained {len(snaps)} rows, "
                             f"{len(queued)} queued")
    got = {moved[r.rid]: r.tokens for r in second.run()}
    if got != want:
        at = first_difference(params, cfg, prompts, got, want)
        raise AssertionError(f"{arch}: streams after the handoff differ "
                             f"from the uninterrupted run's, first at {at}")
    out = {"config": cfg.name, "layers": layers, "window": window,
           "dtype": "float32", "rows_moved": len(snaps),
           "snapshot_mb": sum(map(len, bufs)) / 1e6,
           "handoff_s": handoff_s, "streams_equal": True,
           "tokens_compared": sum(map(len, got.values()))}
    del params, first, second
    return out


def tier_phase(seed):
    """The multi-process tier on the card (see TIER_*): (a) fp32 olmo-1b
    at LM_PARITY_LAYERS layers, colocated and disaggregated, an instance
    drained mid-stream each time, streams bit for bit those of one
    engine in this process; (b) the recurrent LMs' in-process handoffs;
    (c) olmo-1b at TIER_BF16_LAYERS layers in bf16: a warm-up, timed runs
    with and
    without the prefill worker (tokens/s, router latency p50/p99, the
    workers' launch counts held over each), a colocated run with a
    drain, and
    one engine in this process over the same requests for comparison,
    every run's streams equal to that engine's.  All workers start at
    once, while this process computes the streams to hold them to.
    Returns the launches summed over the two timed runs."""
    fp32 = tier_argv(seed, "--layers", str(LM_PARITY_LAYERS),
                     "--dtype", "float32")
    bf16 = tier_argv(seed, "--layers", str(TIER_BF16_LAYERS))
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as logdir:
        a_roles = [("a_eng0", "engine"), ("a_eng1", "engine"),
                   ("a_eng2", "engine"), ("a_pre", "prefill")]
        c_roles = [("c_eng0", "engine"), ("c_eng1", "engine"),
                   ("c_pre", "prefill")]
        a = spawn_tier(fp32, a_roles, logdir)
        c = spawn_tier(bf16, c_roles, logdir)
        failed = True
        try:
            out = _tier_checks(seed, fp32, bf16, a, c, t_start)
            failed = False
        finally:
            close_tier(a + c, logdir, failed)
    out["seconds"] = time.perf_counter() - t_start
    emit({"phase": "tier", **out})
    return out["launches"]


def _tier_checks(seed, fp32, bf16, a, c, t_start):
    from repro_torch.tree import tree_leaves

    # the streams to hold the tier to, from one engine here each, while
    # the workers start (fp32 at TIER_PARITY_NEW; a run of TIER_NEW
    # tokens makes the first TIER_NEW of them)
    eng = tier_engine(fp32)
    prompts = serve_prompts(eng.cfg.vocab_size, TIER_REQUESTS, seed + 29)
    want_long, _, _ = single_streams(eng, prompts, new=TIER_PARITY_NEW)
    want = {i: t[:TIER_NEW] for i, t in want_long.items()}
    eng16 = tier_engine(bf16)
    want16, _, _ = single_streams(eng16, prompts)
    # (a) fp32: colocated, the first instance drained once it holds
    # TIER_DRAIN_ROWS + 1 live rows; disaggregated, drained at its first
    # row (a row ends before the prefill worker ships the next one)
    for h in a:
        h.connect(timeout=TIER_TIMEOUT)
    ready_s = time.perf_counter() - t_start
    runs = {}
    for mode, insts, pre, rows, new, ref in (
            ("colocated", a[0:2], None, TIER_DRAIN_ROWS, TIER_PARITY_NEW,
             want_long),
            ("disaggregated", a[1:3], a[3], 1, TIER_NEW, want)):
        got, _, runs[mode] = tier_run(insts, pre, prompts, drain=insts[0],
                                      rows=rows, new=new)
        check_streams(f"fp32 tier ({mode})", got, ref, eng.params,
                      eng.cfg, prompts)
        emit({"phase": "tier_run", "what": f"fp32 {mode}", **runs[mode]})
    stop_tier(a)
    del eng
    torch.cuda.empty_cache()
    fp32_out = {"layers": LM_PARITY_LAYERS, "dtype": "float32",
                "streams_equal": True, "runs": runs,
                "new_tokens": {"colocated": TIER_PARITY_NEW,
                               "disaggregated": TIER_NEW},
                "tokens_compared": sum(map(len, want_long.values()))
                + sum(map(len, want.values())),
                "seconds_at_end": time.perf_counter() - t_start}

    # (b) the recurrent LMs' handoffs in this process
    handoffs = {arch: recurrent_handoff(arch, seed)
                for arch in RECURRENT_SERVE}
    handoffs["seconds_at_end"] = time.perf_counter() - t_start
    torch.cuda.empty_cache()

    # (c) TIER_BF16_LAYERS layers, bf16: a timed run of the engine
    # here, then the tier: 2 requests to warm the instances, a timed run
    # through the prefill worker and a timed run without it, the workers'
    # launches held exactly over each, and last (a drained instance
    # admits no more) a colocated run in which c_eng0 is drained
    # mid-stream
    eng, want = eng16, want16
    got, wall, res = single_streams(eng, prompts)
    if got != want:
        raise AssertionError("the single-process bf16 engine repeats "
                             "itself differently")
    lat = sorted(r.latency for r in res)
    single = {"slots": SERVE_SLOTS, "wall_s": wall,
              "generated_tokens_per_s": sum(map(len, got.values())) / wall,
              "latency_p50_ms": percentile(lat, 0.5) * 1e3,
              "latency_p99_ms": percentile(lat, 0.99) * 1e3}
    row_mb = sum(t.nbytes for t in tree_leaves(eng.state.cache)) \
        / SERVE_SLOTS / 1e6
    for h in c:
        h.connect(timeout=TIER_TIMEOUT)
    insts, pre = c[:TIER_INSTANCES], c[TIER_INSTANCES]
    layers = eng.cfg.n_layers
    got, _, warm = tier_run(insts, None, prompts[:TIER_INSTANCES])
    check_streams("bf16 tier (warm-up)", got,
                  {i: want[i] for i in range(TIER_INSTANCES)}, eng.params,
                  eng.cfg, prompts)
    timed = {}
    for mode, p in (("disaggregated", pre), ("colocated", None)):
        before = worker_stats(c)
        got, res, timed[mode] = tier_run(insts, p, prompts)
        after = worker_stats(c)
        check_streams(f"bf16 tier ({mode})", got, want, eng.params,
                      eng.cfg, prompts)
        delta, ticks = held_launches(f"bf16 tier ({mode})", before, after,
                                     insts, p, layers, TIER_REQUESTS)
        timed[mode].update(tier_metrics(res, timed[mode]["wall_s"]),
                           decode_ticks=ticks, launches_by_worker=delta,
                           worker_seconds=stats_delta(before, after,
                                                      "seconds"))
        emit({"phase": "tier_run", "what": f"bf16 {mode}", **timed[mode]})
    got, _, drained = tier_run(insts, None, prompts, drain=insts[0],
                               rows=TIER_DRAIN_ROWS)
    check_streams("bf16 tier (drain)", got, want, eng.params, eng.cfg,
                  prompts)
    emit({"phase": "tier_run", "what": "bf16 drain", **drained})
    launches = {k: sum(d[k] for r in timed.values()
                       for d in r["launches_by_worker"].values())
                for k in next(iter(delta.values()))}
    del eng
    return {"card": card(), "config": LM_ARCH, "instances": TIER_INSTANCES,
            "slots": SERVE_SLOTS, "capacity": SERVE_CAPACITY,
            "requests": TIER_REQUESTS, "new_tokens": TIER_NEW,
            "prompt_tokens": [len(p) for p in prompts],
            "workers_ready_s": ready_s, "fp32": fp32_out,
            "recurrent_handoffs": handoffs,
            "bf16": {"layers": layers, "streams_equal": True,
                     "snapshot_row_mb": row_mb, "warm_up": warm,
                     "drain": drained, "timed": timed["disaggregated"],
                     "colocated": timed["colocated"],
                     "single_process": single},
            "launches": launches}


# ------------------------------------------------ the moe family (A8b) ----

MOE_ARCH = "mixtral-8x7b"
MOE_SERVE_LAYERS = 16          # of 32: 47 GB of bf16 weights on 80 GB
MOE_PARITY_LAYERS = 2
MOE_TRAIN_LAYERS = 2           # of 32: two replicas' state is 23 GB a layer
MOE_TRAIN_SEQ = 2048           # tokens per replica
MOE_SERVE_NEW = 32
MOE_SERVE_REQUESTS = 16        # the timed and the traced windows
MOE_DRAFT_LAYERS = 2
MOE_TRAIN_STEPS = 3            # a route's steps; the einsum route runs one
                               # more first, untimed
GEMM_BF16_ATOL = 1e-5          # of max |y|: near-zero outputs (see below)


def mixtral_gemm_cases(cfg, cap):
    """(group, product, M, K, N, trans_a, trans_b, launches per expert in
    a replica's training step) of the expert FFN's GEMMs at capacity
    ``cap``: the forward of w_in and w_gate ((C, d) @ (d, f), twice) and
    w_out ((C, f) @ (f, d)), then each one's dx = dy @ w^T and dw = x^T @
    dy."""
    d, f = cfg.d_model, cfg.d_ff
    return [("mixtral", "fwd w_in/w_gate", cap, d, f, False, False, 2),
            ("mixtral", "fwd w_out", cap, f, d, False, False, 1),
            ("mixtral", "dx w_in/w_gate", cap, f, d, False, True, 2),
            ("mixtral", "dw w_in/w_gate", d, cap, f, True, False, 2),
            ("mixtral", "dx w_out", cap, d, f, False, True, 1),
            ("mixtral", "dw w_out", f, cap, d, True, False, 1)]


def gemm_bf16_ulp_check(what, got, want) -> float:
    """Every element of ``got`` within one bf16 ulp of ``want``'s, or,
    near zero, within GEMM_BF16_ATOL of max |want| (where a bf16 ulp is
    below the fp32 sums' own error); all finite.  Returns max |err|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133),
                      2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
    top = w.abs().max().item()
    beyond = int(((err > ulp * 1.0001)
                  & (err > GEMM_BF16_ATOL * top)).sum().item())
    if beyond or not torch.isfinite(g).all():
        raise AssertionError(f"{what}: {beyond} elements beyond one bf16 "
                             f"ulp (max |err| {err.max().item():.3e})")
    return err.max().item()


def gemm_bf16_cases():
    """(group, product, M, K, N, trans_a, trans_b, launches per expert in
    a replica's training step, the body the rule must pick) of the bf16
    GEMM's main-path shapes: Mixtral's expert FFN at C = 640 (2048 tokens
    x top-2 x 1.25 / 8), a decode tick's products at M = 16 (8 slots x
    top-2, dropless), and AlexNet's 14 im2col products at batch 32
    (conv1's 363-wide patch rows on the mma_sync body)."""
    from repro_torch.configs import ALEXNET_FAITHFUL, ARCHS
    from repro_torch.models.moe import capacity

    mix = ARCHS[MOE_ARCH]
    cap = capacity(MOE_TRAIN_SEQ, mix.moe.top_k, mix.moe.capacity_factor,
                   mix.moe.n_experts)
    cases = [c + ("wgmma",) for c in mixtral_gemm_cases(mix, cap)]
    cases += [("decode", "fwd w_in/w_gate", 16, mix.d_model, mix.d_ff,
               False, False, 0, "swap_ab"),
              ("decode", "fwd w_out", 16, mix.d_ff, mix.d_model, False,
               False, 0, "swap_ab")]
    cases += [(f"alexnet {layer}", product, m, k, n, ta, tb, 0,
               "mma_sync" if layer == "conv1" else "wgmma")
              for layer, product, m, k, n, ta, tb in gemm_cases(
                  ALEXNET_FAITHFUL, IM2COL_BATCH)]
    return cases


def gemm_bf16_operands(gen, m, k, n, ta, tb, relu):
    """bf16 operands of one product, made on the card: x (M,K) (a
    transposed view where ``ta``), w (K,N) scaled by K^-1/2 (where ``tb``
    a transposed view), and a bias where ``relu``."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    a = torch.randn((k, m) if ta else (m, k), generator=gen,
                    device=dev).to(bf)
    b = (torch.randn((n, k) if tb else (k, n), generator=gen, device=dev)
         * k ** -0.5).to(bf)
    bias = (torch.randn((n,), generator=gen, device=dev).to(bf)
            if relu else None)
    return (a.t() if ta else a), (b.t() if tb else b), bias


def gemm_bf16_units(conv_ops, m, n, body, bn, split) -> int:
    """The work units of one launch: output tiles times splits (a TMA
    body's 128-row tiles run along N on swap_ab)."""
    rows, cols = (n, m) if body == "swap_ab" else (m, n)
    bm = (conv_ops.GEMM_BF16_BM if body == "mma_sync"
          else conv_ops.GEMM_BF16_TMA_BM)
    return -(-rows // bm) * -(-cols // bn) * split


def device_ms_by_kernel(fn, calls=5) -> dict:
    """Device ms a call of each kernel that ``fn`` launches (its name up
    to its arguments), from a ``torch.profiler`` trace of ``calls`` warm
    calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gemm_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    out = {}
    for e in trace:
        if e.get("cat") == "kernel":
            name = e["name"].replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0][:80]
            out[name] = out.get(name, 0.0) + e["dur"] / 1e3 / calls
    if not out:
        raise AssertionError("the profiler traced no kernel on the device")
    return out


def gemm_bf16_phase(gen):
    """``matmul_bias``'s bf16 entry at the products the main paths give
    it (``gemm_bf16_cases``), bf16 operands, each on the body
    ``gemm_plan_bf16`` picks, which must be the one the case names
    (``launches_bf16_wgmma`` counting the TMA bodies' launches).  Each
    against the plain version (fp32 sum, one rounding): every element
    within one bf16 ulp, or, near zero, within GEMM_BF16_ATOL of max |y|
    (``gemm_bf16_ulp_check``); the count of elements that differ
    (``bf16_flips``); two calls bit-equal.  Timed beside the plain
    version, the ``mma_sync`` body at the same shape (a yardstick where
    the rule picks a TMA body), ``torch.matmul`` in bf16 (+ bias, ReLU;
    a yardstick only) and the bound, max(2MNK / 989 TFLOP/s, bytes / 3.35
    TB/s).  Mixtral's and decode's products, where the kernel and
    ``torch.matmul`` are closest, are also traced: each one's device ms a
    call by kernel (``device_ms_by_kernel``: the body beside the split's
    sum, the library's kernels).  The totals sum one expert's 9 products
    of a training step (the main path); one more line sums the decode and
    AlexNet groups."""
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.ref import matmul_bias_ref

    dev, bf = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "mma_sync_ms": 0.0, "max_abs_err": 0.0, "flops": 0.0,
           "bytes": 0.0}
    sums = {}
    for group, product, m, k, n, ta, tb, per_expert, want_body in \
            gemm_bf16_cases():
        relu = group.startswith("alexnet") and product == "forward"
        a, b, bias = gemm_bf16_operands(gen, m, k, n, ta, tb, relu)
        what = f"matmul_bias_bf16 {group} {product}"
        body, bn, split = conv_ops.gemm_plan_bf16(
            m, n, k, ta, tb, conv_ops._aligned(a, ta),
            conv_ops._aligned(b, tb), sms)
        if body != want_body:
            raise AssertionError(f"{what}: the rule picks {body}, not "
                                 f"{want_body}")
        with torch.inference_mode():
            wg0 = conv_ops.matmul_bias.launches_bf16_wgmma
            got = conv_ops.matmul_bias(a, b, bias, relu=relu, backend="cuda")
            torch.cuda.synchronize()
            if (conv_ops.matmul_bias.launches_bf16_wgmma - wg0
                    != (body != "mma_sync")):
                raise AssertionError(f"{what}: launches_bf16_wgmma did not "
                                     f"count the {body} body")
            want = matmul_bias_ref(a, b, bias, relu)
            err = gemm_bf16_ulp_check(what, got, want)
            flips = bf16_flips(got, want)
            if not torch.equal(got, conv_ops.matmul_bias(
                    a, b, bias, relu=relu, backend="cuda")):
                raise AssertionError(f"{what}: two calls differ (split "
                                     f"{split})")

            def old():
                return conv_ops._matmul(a, b, bias, relu, "cuda",
                                        body="mma_sync")

            def library():
                y = torch.matmul(a, b)
                if bias is not None:
                    y = y + bias
                return torch.relu(y) if relu else y

            lib_flips = bf16_flips(library(), want)
            k_ms = time_ms(lambda: conv_ops.matmul_bias(
                a, b, bias, relu=relu, backend="cuda"), reps=10)
            traced = {}
            if group in ("mixtral", "decode"):
                traced = {
                    "device_ms_by_kernel": device_ms_by_kernel(
                        lambda: conv_ops.matmul_bias(
                            a, b, bias, relu=relu, backend="cuda")),
                    "library_device_ms_by_kernel":
                        device_ms_by_kernel(library)}
            if body == "mma_sync":
                o_ms = k_ms
            else:
                gemm_bf16_ulp_check(what + " mma_sync", old(), want)
                o_ms = time_ms(old, reps=10)
            p_ms = time_ms(lambda: matmul_bias_ref(a, b, bias, relu),
                           reps=10)
            l_ms = time_ms(library, reps=10)
        flops = 2.0 * m * n * k
        nbytes = 2.0 * (m * k + k * n + m * n + (n if bias is not None
                                                 else 0))
        bound, bound_by = _bound(flops, nbytes, BF16_PEAK)
        units = gemm_bf16_units(conv_ops, m, n, body, bn, split)
        row = {"phase": "kernel", "kernel": "matmul_bias_bf16",
               "group": group, "product": product, "m": m, "k": k, "n": n,
               "trans_a": ta, "trans_b": tb, "relu": relu,
               "launches_per_expert_step": per_expert,
               "body": body, "bn": bn, "split": split, "units": units,
               "blocks": (units if body == "mma_sync" else min(units, sms)),
               "kernel_ms": k_ms, "mma_sync_ms": o_ms, "plain_ms": p_ms,
               "library_ms": l_ms,
               "library": "torch.matmul in bf16 (+ bias, ReLU)",
               "bound_ms": bound, "bound_by": bound_by,
               "assumes": "989 TFLOP/s bf16 tensor cores, 3.35 TB/s",
               "flops": flops, "bytes": nbytes,
               "tflops": flops / (k_ms * 1e-3) / 1e12,
               "share_of_bound": bound / k_ms, "max_err": err,
               "bf16_flips": flips, "library_flips": lib_flips, **traced}
        emit(row)
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_err"])
        for key, src in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                         ("bound_ms", "bound_ms"),
                         ("library_ms", "library_ms"),
                         ("mma_sync_ms", "mma_sync_ms"), ("flops", "flops"),
                         ("bytes", "bytes")):
            tot[key] += per_expert * row[src]
        key = group.split()[0] + ("" if body == "mma_sync"
                                  or group == "decode" else " tma")
        agg = sums.setdefault(key, {"kernel_ms": 0.0, "mma_sync_ms": 0.0,
                                    "library_ms": 0.0, "bound_ms": 0.0,
                                    "products": 0})
        for k_ in ("kernel_ms", "mma_sync_ms", "library_ms", "bound_ms"):
            agg[k_] += row[k_]
        agg["products"] += 1
        del a, b, got, want
    tot["bound_by"] = _bound(tot["flops"], tot["bytes"], BF16_PEAK)[1]
    tot["tolerance"] = (f"1 bf16 ulp, or {GEMM_BF16_ATOL} x max |y| near "
                        "zero")
    tot["library"] = "torch.matmul in bf16"
    emit({"phase": "gemm_bf16_sums", "one_expert_step": {
        k_: tot[k_] for k_ in ("ms", "mma_sync_ms", "library_ms",
                               "bound_ms")}, "groups": sums})
    return {"matmul_bias_bf16": tot}


def moe_layers(cfg) -> int:
    from repro_torch.models import transformer
    return transformer.layer_kinds(cfg).count("moe")


def moe_serve_parity(seed):
    """Mixtral at full width and MOE_PARITY_LAYERS layers in bf16: the
    prefill's logits on the ``matmul`` opt-in (the bf16 GEMM kernel) and
    on the library's batched product, each held to the same weights'
    fp32 logits (``anchored_check``), with the GEMM's launches counted:
    3 per expert and moe layer in one forward."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.tree import tree_map

    base = dataclasses.replace(ARCHS[MOE_ARCH], n_layers=MOE_PARITY_LAYERS)
    cfg = dataclasses.replace(base, kernels=KernelPolicy("auto"))
    kcfg = dataclasses.replace(base, kernels=KernelPolicy("auto",
                                                          matmul="kernel"))
    cfg32 = dataclasses.replace(base, dtype="float32",
                                kernels=KernelPolicy("auto"))
    params = models.init(cfg, torch.Generator().manual_seed(seed),
                         device="cuda")
    prompts = serve_prompts(cfg.vocab_size, SERVE_SLOTS, seed + 61)
    b = SERVE_SLOTS
    out, counts = {}, {}
    with torch.inference_mode():
        toks = torch.zeros((b, SERVE_PROMPT[1]), dtype=torch.long,
                           device="cuda")
        lengths = torch.tensor([len(p) for p in prompts], device="cuda")
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = torch.as_tensor(p)
        last = lengths - 1
        for name, c, prm in (("einsum", cfg, params), ("kernel", kcfg,
                                                       params)):
            torch.cuda.synchronize()
            zero_counts()
            logits, _ = models.prefill(prm, c, toks, SERVE_CAPACITY,
                                       length=lengths)
            torch.cuda.synchronize()
            counts[name] = read_counts()
            out[name] = logits[torch.arange(b), last].float()
            del logits
        params32 = tree_map(lambda t: t.float(), params)
        del params, prm
        logits, _ = models.prefill(params32, cfg32, toks, SERVE_CAPACITY,
                                   length=lengths)
        out["fp32"] = logits[torch.arange(b), last].float()
        del logits, params32
    n_moe = moe_layers(cfg)
    gemm = 3 * cfg.moe.n_experts * n_moe
    for name, want in (("einsum", want_counts(flash_fwd=cfg.n_layers)),
                       ("kernel", want_counts(flash_fwd=cfg.n_layers,
                                              matmul_bias_bf16=gemm))):
        if counts[name] != want:
            raise AssertionError(f"mixtral {name} prefill launches "
                                 f"{counts[name]} != {want}")
    check = anchored_check("mixtral bf16 prefill, GEMM kernel vs batched "
                           "product", out["kernel"], out["einsum"],
                           out["fp32"])
    emit({"phase": "moe_serve_parity", "config": cfg.name,
          "layers": MOE_PARITY_LAYERS, "d_model": cfg.d_model,
          "dtype": cfg.dtype, "rows": b, "prompt_tokens": list(SERVE_PROMPT),
          "capacity_factor": cfg.moe.capacity_factor,
          "kernel_route_launches": counts["kernel"],
          "gemm_launches_per_prefill": gemm,
          "tolerance": f"kernel's relative L2 to fp32 <= {BF16_NOISE_RATIO}"
          " x the batched product's", **check})
    return counts["kernel"]


def moe_serve_phase(seed):
    """Mixtral-8x7B at full width and MOE_SERVE_LAYERS of its 32 layers
    in bf16 (47 GB of weights), 8 slots, capacity 2048, greedy, prompts
    of 256-1024 tokens, MOE_SERVE_NEW new tokens, the default route (the
    library's batched expert product; prefill at the configured capacity
    factor, decode dropless).  The 2-layer GEMM-kernel parity runs
    first.  One wave on the ring and one on the block pool (full
    attention: the window of 4096 lies beyond the capacity of 2048, so
    no token sees it, and the pool, like the reference's, takes no
    window) with the launch counts read around each (no GEMM kernel on
    the default route).  Then a timed window of
    MOE_SERVE_REQUESTS requests from 8 closed-loop clients, one more
    under ``torch.profiler`` (device ms a tick, idle share), and one
    speculative wave drafting SPEC_TOKENS tokens with the first
    MOE_DRAFT_LAYERS layers."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.spec_decode import truncated_draft

    seconds, t_phase = {}, time.perf_counter()

    def lap(name):
        seconds[name] = time.perf_counter() - t_phase

    parity = moe_serve_parity(seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lap("parity")
    cfg = dataclasses.replace(ARCHS[MOE_ARCH], n_layers=MOE_SERVE_LAYERS,
                              kernels=KernelPolicy("auto"))
    params = models.init(cfg, torch.Generator().manual_seed(seed),
                         device="cuda")
    weights_gb = torch.cuda.memory_allocated() / 1e9
    prompts = serve_prompts(cfg.vocab_size, 2 * SERVE_SLOTS, seed + 67)
    lap("setup")
    ring = lm_serve_counts(params, cfg, prompts, 0, MOE_SERVE_NEW)
    block = lm_serve_counts(params, dataclasses.replace(
        cfg, sliding_window=None), prompts, 16, MOE_SERVE_NEW)
    lap("waves")
    engine = ServingEngine(params, cfg, slots=SERVE_SLOTS,
                           capacity=SERVE_CAPACITY)
    wall, res = lm_closed_loop(engine, prompts, MOE_SERVE_REQUESTS,
                               SERVE_SLOTS, new=MOE_SERVE_NEW)
    timed = serve_metrics(wall, res)
    ticks0 = engine.decode_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall, _ = lm_closed_loop(engine, prompts, SERVE_SLOTS,
                                      SERVE_SLOTS, new=MOE_SERVE_NEW)
    ticks = engine.decode_steps - ticks0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe_serve_trace.json")
        prof.export_chrome_trace(path)
        busy = device_busy(path, lm_family)
    del engine
    lap("timed")
    dcfg, dparams = truncated_draft(cfg, params, MOE_DRAFT_LAYERS)
    eng = ServingEngine(params, cfg, slots=SERVE_SLOTS,
                        capacity=SERVE_CAPACITY, draft_params=dparams,
                        draft_cfg=dcfg, spec_tokens=SPEC_TOKENS)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    sres = eng.run([Request(prompt=p, max_new_tokens=MOE_SERVE_NEW)
                    for p in prompts[:SERVE_SLOTS]])
    torch.cuda.synchronize()
    spec_wall = time.perf_counter() - t0
    spec_launches = read_counts()
    want = want_counts(
        flash_fwd=(cfg.n_layers + dcfg.n_layers) * SERVE_SLOTS,
        decode_ring=SPEC_TOKENS * dcfg.n_layers * eng.dispatches)
    if spec_launches != want:
        raise AssertionError(f"mixtral spec serving launches "
                             f"{spec_launches} != {want}")
    if any(len(r.tokens) != MOE_SERVE_NEW for r in sres):
        raise AssertionError("every spec request must get its new tokens")
    spec = {**serve_metrics(spec_wall, sres), "dispatches": eng.dispatches,
            "accepted": eng.spec_accepted, "proposed": eng.spec_proposed,
            "launches": spec_launches}
    del eng, dparams
    lap("spec")
    emit({"phase": "moe_serving", "config": cfg.name,
          "layers": cfg.n_layers, "of_layers": ARCHS[MOE_ARCH].n_layers,
          "d_model": cfg.d_model, "experts": cfg.moe.n_experts,
          "top_k": cfg.moe.top_k, "dtype": cfg.dtype,
          "params": cfg.n_params(), "weights_gb": weights_gb,
          "slots": SERVE_SLOTS, "capacity": SERVE_CAPACITY,
          "prompt_tokens": list(SERVE_PROMPT), "new_tokens": MOE_SERVE_NEW,
          "waves": [ring, block],
          "timed_window": {"requests": MOE_SERVE_REQUESTS, **timed,
                           "device_idle_share":
                           1.0 - busy["busy_ms"] / 1e3 / prof_wall},
          "profiled_wall_s": prof_wall, "profiled_ticks": ticks,
          "profiled_idle_share": 1.0 - busy["busy_ms"] / 1e3 / prof_wall,
          # the window's 8 prefills are in the busy time too
          "device_ms_per_tick_with_prefills": busy["busy_ms"] / max(ticks,
                                                                    1),
          "device_busy_ms": busy["busy_ms"],
          "device_ms_by_family": busy["ms_by_family"],
          "top_kernels_ms": busy["top_kernels"],
          "spec": {"draft_layers": MOE_DRAFT_LAYERS,
                   "spec_tokens": SPEC_TOKENS, **spec},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": seconds})
    del params
    return {"moe_serving": ring["launches"],
            "moe_serving_block": block["launches"],
            "moe_serve_parity": parity}


def moe_train_phase(seed):
    """Mixtral-8x7B at full width and MOE_TRAIN_LAYERS of its 32 layers,
    bf16 params and grads, fp32 velocity, 2 replicas x MOE_TRAIN_SEQ
    ``markov_lm`` tokens, every-step all-reduce: 1 + MOE_TRAIN_STEPS
    steps on the default route (the library's batched expert product),
    then MOE_TRAIN_STEPS steps on the ``matmul`` opt-in (the bf16 GEMM
    kernel, forward and backward) from a fresh state from the same seed.
    Launch counts over each route's steps (flash per layer; the GEMM 9
    per expert and moe layer on the kernel route, none on the other),
    the losses (aux included) of the two routes within BF16_LOSS_TOL at
    every step, spread 0, step p50 and tokens/s of each, peak memory.
    The kernel route's launches all take the TMA bodies
    (``launches_bf16_wgmma``), and its first step (untimed) is traced:
    the GEMM kernel's device ms a step beside the step p50."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.kernels.conv2d.ops import matmul_bias

    base = dataclasses.replace(ARCHS[MOE_ARCH], n_layers=MOE_TRAIN_LAYERS)
    pool = lm_pool(base, REPLICAS, MOE_TRAIN_STEPS + 1, seed + 71)
    make_stream = lm_stream(pool)
    items = REPLICAS
    out = {}
    for route, pol, steps in (
            ("einsum", KernelPolicy("auto"), MOE_TRAIN_STEPS + 1),
            ("kernel", KernelPolicy("auto", matmul="kernel"),
             MOE_TRAIN_STEPS)):
        cfg = dataclasses.replace(base, kernels=pol)
        gc.collect()
        torch.cuda.empty_cache()
        state0 = lm_state(cfg, seed)
        spreads, step_s = [], []

        traced = []

        def wrap(step):
            def timed(st, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if route == "kernel" and not step_s:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        st, loss = step(st, batch)
                        torch.cuda.synchronize()
                    traced.append(prof)
                else:
                    st, loss = step(st, batch)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                return st, loss
            return timed

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        matmul_bias.launches_bf16_wgmma = 0
        res = session(lm_loss(cfg), state0, make_stream, steps, items,
                      metrics_path=os.devnull, spreads=spreads,
                      wrap=wrap).run()
        torch.cuda.synchronize()
        launches = read_counts()
        if matmul_bias.launches_bf16_wgmma != launches["matmul_bias_bf16"]:
            raise AssertionError(
                f"mixtral training ({route}): "
                f"{matmul_bias.launches_bf16_wgmma} of "
                f"{launches['matmul_bias_bf16']} GEMM launches on the TMA "
                "bodies")
        per_step = REPLICAS * cfg.n_layers
        gemm = 9 * cfg.moe.n_experts * moe_layers(cfg) * REPLICAS
        want = want_counts(flash_fwd=per_step * steps,
                           flash_dq=per_step * steps,
                           flash_dkv=per_step * steps,
                           matmul_bias_bf16=gemm * steps
                           if route == "kernel" else 0)
        if launches != want:
            raise AssertionError(f"mixtral training ({route}) launches "
                                 f"{launches} != {want}")
        losses = losses_of(res)
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"mixtral training ({route}) losses "
                                 f"{losses}")
        if max(spreads) != 0.0:
            raise AssertionError(f"mixtral replica spread {spreads}")
        timed = sorted(step_s[1:])
        out[route] = {"steps": steps, "losses": losses,
                      "launches": launches,
                      "gemm_launches_per_step": gemm if route == "kernel"
                      else 0,
                      "step_s": step_s,
                      "step_p50_ms": statistics.median(timed) * 1e3,
                      "tokens_per_s": REPLICAS * MOE_TRAIN_SEQ
                      / statistics.median(timed),
                      "peak_mem_gb": torch.cuda.max_memory_allocated()
                      / 1e9}
        if traced:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "moe_train_trace.json")
                traced[0].export_chrome_trace(path)
                busy = device_busy(path, lm_family)
            out[route]["traced_step"] = {
                "step": 1, "busy_ms": busy["busy_ms"],
                "matmul_bias_bf16_ms": busy["ms_by_family"].get(
                    "matmul_bias", 0.0),
                "ms_by_family": busy["ms_by_family"],
                "top_kernels": busy["top_kernels"]}
        del state0, res, traced
    errs = [abs(a - b) for a, b in zip(out["kernel"]["losses"],
                                       out["einsum"]["losses"])]
    if max(errs) > BF16_LOSS_TOL:
        raise AssertionError(f"mixtral GEMM kernel vs batched product "
                             f"losses {out['kernel']['losses']} / "
                             f"{out['einsum']['losses']}")
    emit({"phase": "moe_train", "config": base.name,
          "layers": MOE_TRAIN_LAYERS, "of_layers": ARCHS[MOE_ARCH].n_layers,
          "d_model": base.d_model, "params": base.n_params(),
          "dtype": base.dtype, "replicas": REPLICAS,
          "tokens_per_replica": MOE_TRAIN_SEQ,
          "capacity_factor": base.moe.capacity_factor, "routes": out,
          "loss_abs_err_kernel_vs_einsum": errs,
          "loss_tol": BF16_LOSS_TOL})
    gc.collect()
    torch.cuda.empty_cache()
    return out["kernel"]["launches"]


def im2col_bf16_phase(model_cfg, seed):
    """The faithful AlexNet under the bf16 preset on the im2col route
    (``F.unfold`` + the bf16 GEMM kernel), 2 x 32, 3 steps: the GEMM
    kernel's launches (14 per replica and step) and the bf16 LRN's, no
    conv kernel, and the losses against the fused bf16 conv route within
    BF16_LOSS_TOL."""
    import dataclasses

    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.kernels.conv2d.ops import matmul_bias
    from repro_torch.numerics import get_policy

    npol = get_policy("bf16")
    cfg = dataclasses.replace(model_cfg, numerics=npol,
                              kernels=KernelPolicy("auto",
                                                   conv2d="im2col_ref"))
    fused_cfg = dataclasses.replace(cfg, kernels=KernelPolicy("auto"))
    pool, mean = host_pool(cfg, IM2COL_BATCH * REPLICAS, 3, seed + 73)
    make_stream = pool_stream(pool, mean, cfg, seed)
    steps, items = 3, IM2COL_BATCH * REPLICAS
    sess = session(alexnet_loss(cfg), init_state(cfg, seed), make_stream,
                   steps, items, staging="queue", metrics_path=os.devnull,
                   numerics=npol)
    torch.cuda.synchronize()
    zero_counts()
    matmul_bias.launches_bf16_wgmma = 0
    t0 = time.perf_counter()
    res = sess.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = want_counts(
        lrn_bf16=sum(cs.lrn for cs in cfg.convs) * REPLICAS * steps,
        matmul_bias_bf16=(3 * len(cfg.convs) - 1) * REPLICAS * steps)
    if launches != want:
        raise AssertionError(f"bf16 im2col launches {launches} != {want}")
    # all but conv1's two products (363-wide patch rows) on the wgmma body
    tma = (3 * len(cfg.convs) - 3) * REPLICAS * steps
    if matmul_bias.launches_bf16_wgmma != tma:
        raise AssertionError(f"bf16 im2col: {matmul_bias.launches_bf16_wgmma}"
                             f" GEMM launches on the wgmma body, not {tma}")
    losses = losses_of(res)
    fused = losses_of(session(alexnet_loss(fused_cfg),
                              init_state(fused_cfg, seed), make_stream,
                              steps, items, staging="queue",
                              metrics_path=os.devnull, numerics=npol).run())
    errs = [abs(a - b) for a, b in zip(losses, fused)]
    if not all(map(math.isfinite, losses)) or max(errs) > BF16_LOSS_TOL:
        raise AssertionError(f"bf16 im2col vs fused losses {losses} / "
                             f"{fused}")
    emit({"phase": "train_im2col_bf16", "config": cfg.name,
          "numerics": npol.describe(), "replicas": REPLICAS,
          "per_replica_batch": IM2COL_BATCH, "steps": steps,
          "launches": launches,
          "matmul_per_replica_step": "5 forward + 5 dw + 4 dx",
          "matmul_wgmma_launches": matmul_bias.launches_bf16_wgmma,
          "losses": losses, "fused_bf16_losses": fused,
          "loss_abs_err": errs, "loss_tol": BF16_LOSS_TOL, "wall_s": wall})
    return launches


def moe_cli_phase():
    """The CLIs on Mixtral at full width, cut in depth to fit beside the
    other chains: the train CLI at 1 layer, 2 replicas x 2 x 256 tokens,
    3 steps (27 GB of state), and the serve CLI at 2 layers (6 GB of
    weights), 8 requests on the ring."""
    losses, train_s, head = _train_losses(
        ["--arch", MOE_ARCH, "--layers", "1", "--seq-len", "256",
         "--batch", "4", "--replicas", "2", "--steps", "3",
         "--log-every", "1"], "mixtral")
    if sorted(losses) != [1, 2, 3] or "arch=mixtral-8x7b" not in head:
        raise AssertionError(f"the mixtral train CLI: steps "
                             f"{sorted(losses)}, header {head!r}")
    _, serve_s = _serve_cli(["--arch", MOE_ARCH, "--layers", "2",
                             "--requests", "8", "--capacity", "512"],
                            "mixtral")
    emit({"phase": "moe_cli", "train_layers": 1, "serve_layers": 2,
          "train_losses": [losses[s] for s in (1, 2, 3)],
          "seconds": {"train": train_s, "serve": serve_s}})


def lm_cli_phase():
    """The LM train CLI at full width, 2 layers, 2 x 2 x 256: 6 steps
    with a checkpoint after step 4, resumed from it to 6; steps 5 and 6
    must give the same losses bit for bit."""
    base = ["--arch", LM_ARCH, "--layers", "2", "--seq-len", "256",
            "--batch", "4", "--replicas", "2", "--log-every", "1"]
    straight, resumed, seconds = resume_runs(base, 4, 6, "LM")
    diffs = {st: resumed[st] - straight[st] for st in resumed}
    if any(diffs.values()):
        raise AssertionError(f"resumed vs uninterrupted LM losses differ: "
                             f"{diffs}")
    emit({"phase": "lm_cli", "seconds": seconds,
          "losses": [straight[st] for st in range(1, 7)],
          "bit_exact_resume": True})


def resume_runs(base, ckpt_at: int, steps: int, what: str):
    """The train CLI with ``base`` for ``steps`` uninterrupted steps,
    writing one checkpoint after step ``ckpt_at`` (``steps`` < 2 x
    ``ckpt_at``), then resumed from it to ``steps``.  Returns (the
    uninterrupted run's loss per step, the resumed run's for the steps
    after ``ckpt_at``, each run's seconds); every loss finite."""
    from repro_torch.train_loop.metrics import read_jsonl

    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck, a, b = (os.path.join(tmp, n) for n in ("ck", "a.jsonl",
                                                   "b.jsonl"))
        for name, extra in (
                ("straight", ["--steps", str(steps), "--ckpt-dir", ck,
                              "--ckpt-every", str(ckpt_at),
                              "--metrics-out", a]),
                ("resumed", ["--steps", str(steps), "--ckpt-dir", ck,
                             "--resume", "--metrics-out", b])):
            lines, seconds[name] = _run_cli("repro_torch.launch.train",
                                            base + extra)
            if not lines or not lines[-1].startswith("done:"):
                raise AssertionError(f"{what} train CLI ({name}) did not "
                                     "end in 'done:'")
        if not lines[-1].startswith(f"done: steps {ckpt_at} -> {steps}"):
            raise AssertionError(f"the resumed {what} run: {lines[-1]}")
        straight = {r["step"]: r["loss"] for r in read_jsonl(a, "train")}
        resumed = {r["step"]: r["loss"] for r in read_jsonl(b, "train")}
    if sorted(straight) != list(range(1, steps + 1)) or \
            sorted(resumed) != list(range(ckpt_at + 1, steps + 1)):
        raise AssertionError(f"{what} CLI steps {sorted(straight)} / "
                             f"{sorted(resumed)}")
    if not all(map(math.isfinite, list(straight.values())
                   + list(resumed.values()))):
        raise AssertionError(f"non-finite loss in the {what} CLI runs")
    return straight, resumed, seconds


def _run_cli(module, args, timeout=900):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    print(proc.stdout, end="", flush=True)
    if proc.returncode:
        raise AssertionError(f"{module} failed (exit {proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    return proc.stdout.strip().splitlines(), time.perf_counter() - t0


def side_by_side(*chains):
    """Run each callable in a thread of its own, at once (each is a chain
    of CLI child processes on the card), and return their results in
    order; every chain runs to its end, then the first failure is
    raised."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(chains)) as pool:
        futures = [pool.submit(c) for c in chains]
    return [f.result() for f in futures]


def _serve_cli(args, what):
    lines, seconds = _run_cli("repro_torch.launch.serve", args)
    if not lines or lines[-1] != "serve OK":
        raise AssertionError(f"the {what} serve CLI did not end in "
                             "'serve OK'")
    return lines, seconds


def _serve_clis():
    """alexnet (fp32, then under the bf16 preset); olmo-1b on the ring and
    the block pool: {what: seconds}."""
    out = {"serve": _serve_cli(["--arch", "alexnet", "--requests", "8"],
                               "alexnet")[1]}
    lines, out["serve_bf16"] = _serve_cli(
        ["--arch", "alexnet", "--requests", "8", "--numerics", "bf16"],
        "alexnet bf16")
    if "numerics=param=bfloat16," not in lines[0]:
        raise AssertionError(f"the bf16 serve CLI's header: {lines[0]!r}")
    for mode, extra in (("ring", []), ("block", ["--block-size", "16"])):
        out[mode] = _serve_cli(["--arch", LM_ARCH, "--layers", "2",
                                "--requests", "8", "--capacity", "512",
                                *extra], f"LM ({mode})")[1]
    return out


def _spec_serve_clis():
    """The recurrent archs serve speculatively, drafting with their first
    layer: {arch: seconds}."""
    out = {}
    for arch, layers in (("rwkv6-7b", "2"), ("recurrentgemma-9b", "3")):
        lines, out[arch] = _serve_cli(
            ["--arch", arch, "--layers", layers, "--requests", "8",
             "--capacity", "512", "--draft-layers", "1", "--spec-tokens",
             "4"], arch)
        if not any(line.startswith("spec: ") and "draft tokens accepted"
                   in line for line in lines):
            raise AssertionError(f"the {arch} serve CLI printed no 'spec:' "
                                 "line")
    return out


def _tier_cli():
    """The tier: two engine workers and a prefill worker behind the
    router; its workers must launch both kernels.  Returns seconds."""
    lines, seconds = _serve_cli(["--arch", LM_ARCH, "--layers", "2",
                                 "--requests", "8", "--capacity", "512",
                                 "--tier", "2", "--disagg"], "tier")
    launched = next((line for line in lines
                     if line.startswith("worker kernel launches: ")), "")
    if "flash_fwd=" not in launched or "decode_ring=" not in launched:
        raise AssertionError(f"the tier's workers launched no flash_fwd or "
                             f"no decode_ring: {launched!r}")
    return seconds


def _train_losses(args, what):
    """The train CLI with ``args`` and a metrics trace: ({step: loss},
    seconds, its header line)."""
    from repro_torch.train_loop.metrics import read_jsonl

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.jsonl")
        lines, seconds = _run_cli("repro_torch.launch.train",
                                  args + ["--metrics-out", path])
        if not lines or not lines[-1].startswith("done:"):
            raise AssertionError(f"the {what} train CLI did not end in "
                                 "'done:'")
        losses = {r["step"]: r["loss"] for r in read_jsonl(path, "train")}
    if not all(map(math.isfinite, losses.values())):
        raise AssertionError(f"non-finite loss in the {what} run: {losses}")
    return losses, seconds, lines[0]


def _mesh_resumed(base):
    """The train CLI on the mesh engine: two ranks on the one card (gloo
    wire), 4 steps with a checkpoint after step 4, which the one-process
    engine resumes to step 6.  Returns ({step: loss} of steps 1-6,
    {run: seconds})."""
    seconds = {}
    with tempfile.TemporaryDirectory() as ck:
        mesh, seconds["mesh"], head = _train_losses(
            base + ["--engine", "mesh", "--steps", "4", "--ckpt-dir", ck,
                    "--ckpt-every", "4"], "mesh")
        if "engine=mesh backend=gloo " not in head:
            raise AssertionError(f"the mesh CLI's header: {head!r}")
        resumed, seconds["resumed_on_reference"], _ = _train_losses(
            base + ["--steps", "6", "--ckpt-dir", ck, "--resume"],
            "resumed mesh")
    if sorted(mesh) != [1, 2, 3, 4] or sorted(resumed) != [5, 6]:
        raise AssertionError(f"mesh / resumed steps {sorted(mesh)} / "
                             f"{sorted(resumed)}")
    return {**mesh, **resumed}, seconds


def _topk_run(base, engine):
    """3 steps of the delayed top-k exchange on ``engine``: ({step: loss},
    seconds)."""
    losses, seconds, _ = _train_losses(
        base + ["--exchange-delay", "1", "--exchange-compression", "topk",
                "--steps", "3", "--engine", engine], f"top-k {engine}")
    if sorted(losses) != [1, 2, 3]:
        raise AssertionError(f"top-k {engine} steps {sorted(losses)}")
    return losses, seconds


def cli_phase():
    """The serving CLI (alexnet; olmo-1b on the ring and the block pool;
    rwkv6-7b at 2 layers and recurrentgemma-9b at 3, full width, each
    drafting speculatively with its first layer; olmo-1b as a tier of two
    engine workers and a prefill worker) beside the training CLI: 6
    steps with a checkpoint after step 4, resumed from it to 6; the mesh
    engine's run resumed on one process (``_mesh_resumed``), held against
    that uninterrupted run; and the delayed top-k exchange on the mesh
    and on one process (``_topk_run``), held against each other."""
    base = ["--arch", "alexnet", "--faithful", "--replicas", "2",
            "--batch", "64", "--log-every", "1"]
    serve_s, spec_s, tier_s, (straight, resumed, seconds), \
        (mesh, mesh_s), (topk_mesh, s_mesh), (topk_one, s_one) = \
        side_by_side(
            _serve_clis, _spec_serve_clis, _tier_cli,
            lambda: resume_runs(base, 4, 6, "AlexNet"),
            lambda: _mesh_resumed(base),
            lambda: _topk_run(base, "mesh"),
            lambda: _topk_run(base, "reference"))
    mesh_s.update(topk_mesh=s_mesh, topk_reference=s_one)
    topk = {"mesh": topk_mesh, "reference": topk_one}
    lm_serve_s = {k: serve_s.pop(k) for k in ("ring", "block")}
    lm_serve_s.update(spec_s, tier=tier_s)
    seconds.update(serve=serve_s.pop("serve"),
                   serve_bf16=serve_s.pop("serve_bf16"), serve_lm=lm_serve_s,
                   mesh=mesh_s)
    diffs = {s: abs(resumed[s] - straight[s]) for s in resumed}
    if max(diffs.values()) > LOSS_TOL:
        raise AssertionError(f"resumed vs uninterrupted losses {diffs}")
    mesh_diffs = {s: abs(mesh[s] - straight[s]) for s in straight}
    if max(mesh_diffs.values()) > LOSS_TOL:
        raise AssertionError(f"mesh (+ resume) vs one-process losses "
                             f"{mesh} / {straight}")
    topk_diffs = {s: abs(topk["mesh"][s] - topk["reference"][s])
                  for s in topk["reference"]}
    if max(topk_diffs.values()) > LOSS_TOL:
        raise AssertionError(f"top-k mesh vs one-process losses {topk}")
    emit({"phase": "cli", "seconds": seconds,
          "resumed_losses": [resumed[5], resumed[6]],
          "straight_losses": [straight[5], straight[6]],
          "abs_diff_by_step": diffs,
          "bit_exact_resume": all(v == 0.0 for v in diffs.values())})
    emit({"phase": "cli_mesh", "backend": "gloo", "ranks": 2,
          "losses": [mesh[s] for s in range(1, 7)],
          "one_process_losses": [straight[s] for s in range(1, 7)],
          "abs_diff_by_step": mesh_diffs,
          "bit_equal": all(v == 0.0 for v in mesh_diffs.values()),
          "topk_losses": topk, "topk_abs_diff_by_step": topk_diffs,
          "topk_bit_equal": all(v == 0.0 for v in topk_diffs.values()),
          "seconds": mesh_s})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU "
              "only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import ALEXNET, ALEXNET_FAITHFUL
    from repro_torch.kernels import _build
    from repro_torch.launch.train import fp32_numerics

    t_start = time.perf_counter()
    print(card(), flush=True)
    fp32_numerics(torch.device("cuda"))
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "library": str(lib)})
    for line in (lib.parent / "build.log").read_text().splitlines():
        if ("ptxas info" in line or "error" in line.lower()
                or line.startswith("== ")):
            print(line)

    global CYCLES_PER_MS
    CYCLES_PER_MS = _sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    totals = kernel_phase(
        gen, (ALEXNET_FAITHFUL.name, TRAIN_BATCH),
        [(ALEXNET_FAITHFUL, SERVE_BATCH), (ALEXNET, SERVE_BATCH),
         (ALEXNET_FAITHFUL, TRAIN_BATCH)])
    seconds = {}

    def mark(name):
        seconds[name] = time.perf_counter() - t_start
        gc.collect()
        torch.cuda.empty_cache()

    totals.update(bf16_kernel_phase(gen, ALEXNET_FAITHFUL, TRAIN_BATCH))
    totals.update(gemm_bf16_phase(gen))
    mark("kernel")
    totals.update(flash_phase(gen))
    mark("flash")
    totals.update(decode_phase(gen))
    mark("decode")
    totals.update(recurrence_phase(gen))
    mark("recurrence")
    by_path = {"serving": serving_phase(ALEXNET_FAITHFUL, args.seed)}
    mark("serving")
    by_path["train"], prepped = train_phase(ALEXNET_FAITHFUL, args.seed)
    mark("train")
    by_path.update(exchange_phase(ALEXNET_FAITHFUL, args.seed, prepped))
    del prepped
    mark("train_exchange")
    by_path["train_bf16"] = train_bf16_phase(ALEXNET_FAITHFUL, args.seed)
    mark("train_bf16")
    by_path["train_im2col"] = im2col_phase(ALEXNET_FAITHFUL, args.seed)
    mark("train_im2col")
    by_path["train_im2col_bf16"] = im2col_bf16_phase(ALEXNET_FAITHFUL,
                                                     args.seed)
    mark("train_im2col_bf16")
    by_path["lm_train"] = lm_train_phase(args.seed)
    mark("lm_train")
    serve_waves = lm_serving_phase(args.seed)
    by_path["lm_serving"] = serve_waves["ring"]
    by_path["lm_serving_block"] = serve_waves["block"]
    mark("lm_serving")
    for arch, (phase, _, _) in RECURRENT_SERVE.items():
        by_path[phase] = recurrent_serving_phase(arch, args.seed)
        mark(phase)
    for arch, (phase, *_) in SPEC_SERVE.items():
        by_path[phase] = spec_serving_phase(arch, args.seed)
        mark(phase)
    by_path["rwkv_train"] = recurrent_train_phase("rwkv6-7b", args.seed)
    mark("rwkv_train")
    by_path["rg_train"] = recurrent_train_phase("recurrentgemma-9b",
                                                args.seed)
    mark("rg_train")
    by_path.update(moe_serve_phase(args.seed))
    mark("moe_serving")
    by_path["moe_train"] = moe_train_phase(args.seed)
    # the tier's workers and the CLIs run in child processes: mark() hands
    # the cached memory back
    mark("moe_train")
    by_path["lm_tier"] = tier_phase(args.seed)
    mark("tier")
    # each CLI chain is child processes at 1-3 layers: they share the card
    side_by_side(cli_phase, lm_cli_phase, recurrent_cli_phase,
                 moe_cli_phase)
    mark("cli")

    src = "src/repro_torch/kernels"
    meta = {
        "conv2d_fused": (f"{src}/conv2d/csrc/conv2d_fused.cu",
                         "src/repro/kernels/conv2d/conv2d.py:152", "train"),
        "lrn": (f"{src}/lrn/csrc/lrn.cu", "src/repro/kernels/lrn/lrn.py:37",
                "train"),
        "matmul_bias": (f"{src}/conv2d/csrc/matmul_bias.cu",
                        "src/repro/kernels/conv2d/conv2d.py:50",
                        "train_im2col"),
        # the bf16 numerics preset's entries of the same two TPU kernels
        "conv2d_fused_bf16": (f"{src}/conv2d/csrc/conv2d_fused_bf16.cu",
                              "src/repro/kernels/conv2d/conv2d.py:152",
                              "train_bf16"),
        "lrn_bf16": (f"{src}/lrn/csrc/lrn.cu",
                     "src/repro/kernels/lrn/lrn.py:37", "train_bf16"),
        # the GEMM's bf16 entry: Mixtral's expert FFN under the matmul
        # opt-in (also the bf16 im2col route's)
        "matmul_bias_bf16": (f"{src}/conv2d/csrc/matmul_bias_bf16.cu",
                             "src/repro/kernels/conv2d/conv2d.py:50",
                             "moe_train"),
    }
    # the main path is bf16: the tensor-core forward, dq and dk/dv (their
    # fp32 kernels are flash_fwd.cu and flash_bwd.cu)
    flash = "src/repro/kernels/flash_attention/flash_attention.py"
    for name, source, line in (("flash_fwd", "flash_fwd_sm90.cu", 78),
                               ("flash_dq", "flash_dq_sm90.cu", 168),
                               ("flash_dkv", "flash_dkv_sm90.cu", 206)):
        meta[name] = (f"{src}/flash_attention/csrc/{source}",
                      f"{flash}:{line}", "lm_train")
    decode = "src/repro/kernels/decode_attention/decode_attention.py"
    for name, line, path in (("decode_ring", 41, "lm_serving"),
                             ("decode_table", 145, "lm_serving_block")):
        meta[name] = (f"{src}/decode_attention/csrc/decode_attention.cu",
                      f"{decode}:{line}", path)
    meta["wkv_fwd"] = (f"{src}/rwkv6/csrc/wkv.cu",
                       "src/repro/kernels/rwkv6/rwkv6.py:41", "rwkv_train")
    meta["rglru_fwd"] = (f"{src}/rglru/csrc/rglru.cu",
                         "src/repro/kernels/rglru/rglru.py:40", "rg_train")
    kernels = []
    for name, (source, replaces, path) in meta.items():
        tot = totals[name]
        bound_by = tot.get("bound_by") or _bound(tot["flops"],
                                                 tot["bytes"])[1]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[path][name],
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": bound_by, "library_ms": tot["library_ms"],
            **({"library": tot["library"]} if "library" in tot else {}),
            **({"tensor_core_cases": tot["tensor_core_cases"]}
               if "tensor_core_cases" in tot else {}),
            **{k: tot[k] for k in ("max_rel_err", "tolerance",
                                   "mma_sync_ms") if k in tot}})
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError("a kernel was not launched on its main path: "
                             + str({k["name"]: k["launches"]
                                    for k in kernels}))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "seconds_at_end_of": seconds})
    print(card(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
