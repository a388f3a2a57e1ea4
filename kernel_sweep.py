#!/usr/bin/env python3
"""Time the split, chunk and tile choices of the GEMM (fp32 and bf16),
fused conv (fp32 and bf16), decode, WKV and RG-LRU kernels on one NVIDIA
GPU.

    python3 kernel_sweep.py [--kernels decode wkv rglru conv conv_bf16 gemm
                             gemm_bf16]

Run from the root of a checkout; it imports ``repro_torch`` from ``src/``
and ``chip_smoke``'s helpers (never ``jax`` or ``repro``), builds the
kernels, and prints one JSON line per shape, each result within the
kernel's ``chip_smoke`` tolerance of its plain version:

* ``matmul_bias``, each of the 14 GEMM products of one im2col
  replica-step (``chip_smoke.gemm_cases``): the time at the split
  ``gemm_split`` picks and at every split of ``SPLITS`` that leaves no
  split shorter than ``GEMM_MIN_CHUNKS`` chunks;
* ``matmul_bias_bf16``, each main-path product of the bf16 GEMM
  (``chip_smoke.gemm_bf16_cases``: Mixtral's 6 expert-FFN product kinds
  at C = 640, decode's 2 at M = 16, AlexNet's 14 im2col products at batch
  32), and decode's two at M = 32 and 64: the time of the body
  ``gemm_plan_bf16`` picks at its (width, split) and at every width of
  that body (``GEMM_BF16_BNS``, or the swap_ab width that holds M) with
  every split of ``BF16_SPLITS`` that leaves no split shorter than
  ``GEMM_BF16_MIN_CHUNKS`` chunks, and of the mma_sync body at its rule
  (``gemm_split``) and at every split of ``SPLITS`` that leaves no split
  shorter than ``GEMM_MIN_CHUNKS``; then the least-squares fit of the
  rules' constants to those times (``fit_gemm_bf16``: the source of the
  ``GEMM_BF16_*`` chunk-times);
* ``conv2d_fused``, each AlexNet conv at the serving batch (8, both
  AlexNets) and the training batch (128): the time at the (width, split)
  ``conv_tiles`` picks and at every width of ``CONV_BNS`` with every split
  of ``CONV_SPLITS`` that leaves no split shorter than
  ``GEMM_MIN_CHUNKS`` chunks;
* ``conv2d_fused_bf16``, the same convs in bf16: the time of the
  entry's mma_sync body at its rule (``conv_tiles``), and of its wgmma
  body at the (width, split) ``conv_tiles_bf16`` picks and at every width
  of ``CONV_BF16_BNS`` that divides the group's channels with every split
  of ``CONV_SPLITS`` that leaves no split shorter than
  ``CONV_BF16_MIN_CHUNKS`` chunks (the source of ``CONV_BF16_CHUNK_US``);
* ``decode_table`` at the serving tick's shape (``chip_smoke``'s
  ``serve_table`` and ``int8_table`` cases) and ``decode_ring`` at its
  ``serve``, ``gqa`` and ``window`` cases: the time at the chunk
  ``kernel_chunk`` picks and at every chunk of ``DECODE_CHUNKS`` (for the
  ring, those that are whole steps of its warps);
* ``wkv_fwd`` at ``chip_smoke``'s ``train`` and ``ragged`` cases: the
  time at the chunk ``wkv_chunk`` picks and at every chunk of
  ``WKV_CHUNKS``;
* ``rglru_fwd`` at every ``chip_smoke`` RG-LRU case, forward and reversed
  with da: the time at the chunk ``rglru_chunk`` picks and at every chunk
  the kernel is built for (``RGLRU_CHUNKS``);

then, per kernel, the sums over its shapes of the rule's times and of
each shape's fastest choice.  Exits non-zero without a CUDA device or
when a check fails.
"""
import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SPLITS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 88]
CONV_SPLITS = [1, 2, 3, 4, 6, 8]
BF16_SPLITS = [1, 2, 3, 4, 6, 8, 12]
DECODE_CHUNKS = [64, 128, 256, 512, 1024, 2048]
RING_CASES = ("serve", "gqa", "window")
WKV_CHUNKS = [16, 32, 64, 128, 256, 512]
WKV_CASES = ("train", "ragged")


def gemm_sweep(cs, gen, dev, sms):
    from repro_torch.configs import ALEXNET_FAITHFUL
    from repro_torch.kernels.conv2d import ops
    from repro_torch.kernels.conv2d.ref import matmul_bias_ref

    rule_sum = best_sum = 0.0
    for layer, product, m, k, n, ta, tb in cs.gemm_cases(ALEXNET_FAITHFUL,
                                                          cs.IM2COL_BATCH):
        a = torch.randn((k, m) if ta else (m, k), generator=gen, device=dev)
        w = torch.randn((n, k) if tb else (k, n), generator=gen,
                        device=dev) * k ** -0.5
        a, w = (a.t() if ta else a), (w.t() if tb else w)
        relu = product == "forward"
        bias = torch.randn((n,), generator=gen, device=dev) if relu else None
        want = matmul_bias_ref(a, w, bias, relu)
        rule = ops.gemm_split(m, n, k, sms)
        most = max(1, -(-k // ops.GEMM_BK) // ops.GEMM_MIN_CHUNKS)
        times = {}
        for split in sorted({rule} | {len(ops.gemm_ranges(k, z))
                                      for z in SPLITS if z <= most}):
            def call(split=split):
                return ops._matmul(a, w, bias, relu, "cuda", n_split=split)

            with torch.inference_mode():
                cs.check_close(f"matmul_bias {layer} {product} split "
                               f"{split}", call(), want, cs.GEMM_TOL)
                times[split] = cs.time_ms(call, reps=5)
        best = min(times, key=times.get)
        rule_sum += times[rule]
        best_sum += times[best]
        cs.emit({"kernel": "matmul_bias", "layer": layer,
                 "product": product, "m": m, "k": k, "n": n, "rule": rule,
                 "rule_ms": times[rule], "best": best,
                 "best_ms": times[best],
                 "ms_by_split": {str(z): t for z, t in times.items()}})
    cs.emit({"matmul_bias_rule_sum_ms": rule_sum,
             "matmul_bias_best_sum_ms": best_sum})


def gemm_bf16_sweep_cases(cs):
    """``chip_smoke.gemm_bf16_cases`` and decode's two products at M = 32
    and 64 (the swap_ab body's other widths: a short prompt's prefill on
    the GEMM kernel)."""
    cases = cs.gemm_bf16_cases()
    for m in (32, 64):
        cases += [(f"decode m{m}", c[1], m) + c[3:]
                  for c in cases if c[0] == "decode"]
    return cases


def _tma_model_terms(ops, m, n, k, body, bn, split, sms, fill):
    """The terms of ``gemm_tiles_bf16``'s cost for one (body, bn, split)
    at fill ``fill``: the chunk-time's factor, whether the sum kernel
    runs, and the partials' HBM time in us."""
    bf = torch.bfloat16
    rows, cols = (n, m) if body == "swap_ab" else (m, n)
    runs = ops.gemm_ranges(k, split, bf, body)
    split, per = len(runs), runs[0][1]
    tiles = -(-rows // ops.GEMM_BF16_TMA_BM) * -(-cols // bn)
    waves = -(-tiles * split // sms)
    partial_us = (split > 1) * split * 8.0 * m * n / ops.HBM_RATE * 1e6
    return waves * (per + fill), float(split > 1), partial_us


def fit_gemm_bf16(points, sms):
    """Least-squares fits (relative error) of the bf16 GEMM rules' models
    to timed points ``(m, n, k, planned_body, {(body, bn, split): ms})``:

    * the TMA bodies (``gemm_tiles_bf16``): a launch's fixed time, one
      chunk-time per (body, width), ``GEMM_BF16_SUM_US`` and, by a search
      over a grid, ``GEMM_BF16_FILL_CHUNKS``, on every TMA point;
    * the mma_sync body (``gemm_split``, ``GEMM_BF16_RESIDENT`` blocks an
      SM): a launch's time and ``GEMM_BF16_CHUNK_S``, on the points of the
      shapes the plan gives that body (the narrow copy path it runs on
      the main path).

    Then, with the fitted TMA model, which timed choice it would pick at
    each TMA shape against the fastest one.  Returns a dict."""
    import numpy as np
    from repro_torch.kernels.conv2d import ops

    bf = torch.bfloat16
    keys = ([("wgmma", w) for w in ops.GEMM_BF16_BNS]
            + [("swap_ab", w) for w in ops.GEMM_BF16_SWAP_BNS])
    tma = [(m, n, k, c, t) for m, n, k, _, times in points
           for c, t in times.items() if c[0] != "mma_sync"]

    def solve(fill):
        a = np.zeros((len(tma), len(keys) + 2))
        y = np.zeros(len(tma))
        for i, (m, n, k, (body, bn, split), ms) in enumerate(tma):
            factor, summed, partial_us = _tma_model_terms(
                ops, m, n, k, body, bn, split, sms, fill)
            us = ms * 1e3
            a[i, 0] = 1.0 / us
            a[i, 1 + keys.index((body, bn))] = factor / us
            a[i, -1] = summed / us
            y[i] = (us - partial_us) / us
        used = a.any(axis=0)
        x = np.zeros(a.shape[1])
        x[used] = np.linalg.lstsq(a[:, used], y, rcond=None)[0]
        return x, float(np.sqrt(np.mean((a @ x - y) ** 2)))

    fill, (x, rms) = min(((f, solve(f)) for f in np.arange(0.0, 8.01, 0.25)),
                         key=lambda p: p[1][1])

    def model_us(m, n, k, choice):
        factor, summed, partial_us = _tma_model_terms(
            ops, m, n, k, *choice, sms, fill)
        return (x[0] + factor * x[1 + keys.index(choice[:2])]
                + summed * x[-1] + partial_us)

    fastest, shapes, pick_sum, best_sum = 0, 0, 0.0, 0.0
    for m, n, k, planned, times in points:
        if planned == "mma_sync":
            continue
        mine = {c: t for c, t in times.items() if c[0] == planned}
        pick = min(mine, key=lambda c: model_us(m, n, k, c))
        best = min(mine, key=mine.get)
        shapes += 1
        fastest += pick == best
        pick_sum += mine[pick]
        best_sum += mine[best]

    rows, y = [], []
    for m, n, k, planned, times in points:
        if planned != "mma_sync":
            continue
        tiles = (-(-m // ops.GEMM_BF16_BM)
                 * -(-n // ops.gemm_bn(n, bf)))
        for (body, _, split), ms in times.items():
            if body != "mma_sync":
                continue
            runs = ops.gemm_ranges(k, split, bf)
            split, per = len(runs), runs[0][1]
            waves = -(-tiles * split // (sms * ops.GEMM_BF16_RESIDENT))
            partial_s = (split > 1) * split * 8.0 * m * n / ops.HBM_RATE
            s_ = ms * 1e-3
            rows.append([1.0 / s_, waves * (per + ops.GEMM_FILL_CHUNKS)
                         / s_])
            y.append((s_ - partial_s) / s_)
    mma = {}
    if rows:
        a, y = np.array(rows), np.array(y)
        z = np.linalg.lstsq(a, y, rcond=None)[0]
        mma = {"launch_us": float(z[0] * 1e6), "chunk_s": float(z[1]),
               "points": len(rows),
               "rms": float(np.sqrt(np.mean((a @ z - y) ** 2)))}
    return {"tma": {"launch_us": float(x[0]),
                    "chunk_us": {str(w): float(x[1 + keys.index(("wgmma", w))])
                                 for w in ops.GEMM_BF16_BNS},
                    "swap_chunk_us": {
                        str(w): float(x[1 + keys.index(("swap_ab", w))])
                        for w in ops.GEMM_BF16_SWAP_BNS},
                    "sum_us": float(x[-1]), "fill_chunks": float(fill),
                    "points": len(tma), "rms": rms},
            "mma_sync": mma,
            "fitted_model_picks": {"shapes": shapes, "fastest": fastest,
                                   "pick_sum_ms": pick_sum,
                                   "best_sum_ms": best_sum}}


def gemm_bf16_sweep(cs, gen, sms):
    from repro_torch.kernels.conv2d import ops
    from repro_torch.kernels.conv2d.ref import matmul_bias_ref

    bf = torch.bfloat16
    rule_sum = best_sum = mma_sum = 0.0
    points = []
    for group, product, m, k, n, ta, tb, _, _ in gemm_bf16_sweep_cases(cs):
        relu = group.startswith("alexnet") and product == "forward"
        a, w, bias = cs.gemm_bf16_operands(gen, m, k, n, ta, tb, relu)
        with torch.inference_mode():
            want = matmul_bias_ref(a, w, bias, relu)
        body, *rule = ops.gemm_plan_bf16(m, n, k, ta, tb,
                                         ops._aligned(a, ta),
                                         ops._aligned(w, tb), sms)
        rule = tuple(rule)
        what = f"matmul_bias_bf16 {group} {product}"
        choices = {("mma_sync",) + (ops.GEMM_BF16_BN, z)
                   for z in {ops.gemm_split(m, n, k, sms, bf)} | {
                       len(ops.gemm_ranges(k, z, bf)) for z in SPLITS
                       if z <= max(1, -(-k // ops.GEMM_BF16_BK)
                                   // ops.GEMM_MIN_CHUNKS)}}
        if body != "mma_sync":
            chunks = -(-k // ops.GEMM_BF16_TMA_BK)
            most = max(1, chunks // ops.GEMM_BF16_MIN_CHUNKS)
            choices |= {(body, bn, len(ops.gemm_ranges(k, z, bf, body)))
                        for bn in ops.gemm_widths_bf16(m, body == "swap_ab",
                                                       tb)
                        for z in BF16_SPLITS if z <= most}
            choices.add((body,) + rule)
        picked = (body,) + rule
        times = {}
        for choice in sorted(choices):
            def call(choice=choice):
                return ops._matmul(a, w, bias, relu, "cuda", body=choice[0],
                                   bn=choice[1], n_split=choice[2])

            with torch.inference_mode():
                # the rule's pick within one bf16 ulp; the others, whose
                # fp32 sums may run in long unsplit chains (conv1's dw: 96,800
                # terms), within chip_smoke's bf16 kernel tolerance
                if choice == picked:
                    cs.gemm_bf16_ulp_check(f"{what} {choice}", call(), want)
                else:
                    cs.bf16_check(f"{what} {choice}", call(), want)
                times[choice] = cs.time_ms(call, reps=5)
        mma = min((c for c in times if c[0] == "mma_sync"), key=times.get)
        best = min(times, key=times.get)
        points.append((m, n, k, body, times))
        if not group.startswith("decode m"):
            rule_sum += times[picked]
            best_sum += times[best]
            mma_sum += times[mma]
        cs.emit({"kernel": "matmul_bias_bf16", "group": group,
                 "product": product, "m": m, "k": k, "n": n,
                 "trans_a": ta, "trans_b": tb, "rule": list(picked),
                 "rule_ms": times[picked], "best": list(best),
                 "best_ms": times[best], "mma_sync_best": list(mma),
                 "mma_sync_best_ms": times[mma],
                 "ms_by_choice": {"x".join(map(str, c)): t
                                  for c, t in times.items()}})
        del a, w, want
    cs.emit({"matmul_bias_bf16_rule_sum_ms": rule_sum,
             "matmul_bias_bf16_best_sum_ms": best_sum,
             "matmul_bias_bf16_mma_sync_best_sum_ms": mma_sum})
    cs.emit({"matmul_bias_bf16_fit": fit_gemm_bf16(points, sms)})


def conv_sweep(cs, gen, dev, sms):
    from repro_torch.configs import ALEXNET, ALEXNET_FAITHFUL
    from repro_torch.kernels.conv2d import ops
    from repro_torch.kernels.conv2d.ref import conv2d_ref

    sums = {}
    for cfg_name, batch, layer, xs, c in cs.conv_cases(
            [(ALEXNET_FAITHFUL, cs.SERVE_BATCH), (ALEXNET, cs.SERVE_BATCH),
             (ALEXNET_FAITHFUL, cs.TRAIN_BATCH)]):
        cg = xs[-1] // c.groups
        x = torch.randn(xs, generator=gen, device=dev)
        w = torch.randn((c.kernel, c.kernel, cg, c.out_channels),
                        generator=gen, device=dev) * (
                            2.0 / (c.kernel ** 2 * cg)) ** 0.5
        b = torch.randn((c.out_channels,), generator=gen, device=dev) * 0.1
        want = conv2d_ref(x, w, c.stride, c.padding, c.groups, bias=b,
                          relu=True)
        oh = want.shape[1]
        m, npg, kdim = batch * oh * oh, c.out_channels // c.groups, \
            c.kernel ** 2 * cg
        rule = ops.conv_tiles(m, npg, kdim, c.groups, sms)
        most = max(1, -(-kdim // ops.CONV_BK) // ops.GEMM_MIN_CHUNKS)
        choices = {rule} | {(bn, len(ops.conv_ranges(kdim, z)))
                            for bn in ops.CONV_BNS
                            for z in CONV_SPLITS if z <= most}
        times = {}
        for tiles in sorted(choices):
            def call(tiles=tiles):
                return ops._conv_forward(x, w, b, c.stride, c.padding, True,
                                         c.groups, "cuda", tiles=tiles)

            with torch.inference_mode():
                cs.check_close(f"conv2d_fused {cfg_name} b{batch} {layer} "
                               f"{tiles}", call(), want, cs.CONV_TOL)
                times[tiles] = cs.time_ms(call, reps=5)
        best = min(times, key=times.get)
        tot = sums.setdefault(batch, [0.0, 0.0])
        tot[0] += times[rule]
        tot[1] += times[best]
        cs.emit({"kernel": "conv2d_fused", "config": cfg_name,
                 "batch": batch, "layer": layer, "m": m, "npg": npg,
                 "kdim": kdim, "groups": c.groups, "rule": list(rule),
                 "rule_ms": times[rule], "best": list(best),
                 "best_ms": times[best],
                 "ms_by_tiles": {f"{bn}x{z}": t
                                 for (bn, z), t in times.items()}})
    for batch, (rule_ms, best_ms) in sorted(sums.items()):
        cs.emit({"conv2d_fused_batch": batch, "rule_sum_ms": rule_ms,
                 "best_sum_ms": best_ms})


def conv_bf16_sweep(cs, gen, dev, sms):
    from repro_torch.configs import ALEXNET, ALEXNET_FAITHFUL
    from repro_torch.kernels.conv2d import ops
    from repro_torch.kernels.conv2d.ref import conv2d_ref

    bf = torch.bfloat16
    sums = {}
    for cfg_name, batch, layer, xs, c in cs.conv_cases(
            [(ALEXNET_FAITHFUL, cs.SERVE_BATCH), (ALEXNET, cs.SERVE_BATCH),
             (ALEXNET_FAITHFUL, cs.TRAIN_BATCH)]):
        cin = xs[-1]
        cg = cin // c.groups
        x = torch.randn(xs, generator=gen, device=dev).to(bf)
        w = (torch.randn((c.kernel, c.kernel, cg, c.out_channels),
                         generator=gen, device=dev)
             * (2.0 / (c.kernel ** 2 * cg)) ** 0.5).to(bf)
        b = (torch.randn((c.out_channels,), generator=gen, device=dev)
             * 0.1).to(bf)
        want = conv2d_ref(x, w, c.stride, c.padding, c.groups, bias=b,
                          relu=True)
        m = want.shape[0] * want.shape[1] * want.shape[2]
        npg = c.out_channels // c.groups
        route = ops.conv_route_bf16(cin, c.out_channels, c.kernel,
                                    c.padding, c.groups)
        chunks = ops.conv_chunks_bf16(route, c.kernel, cg)
        _, *rule = ops.conv_plan_bf16(xs, c.out_channels, c.kernel,
                                      c.stride, c.padding, c.groups, sms)
        rule = tuple(rule)
        most = max(1, chunks // ops.CONV_BF16_MIN_CHUNKS)
        widths = [bn for bn in ops.CONV_BF16_BNS if npg % bn == 0]
        choices = {rule} | {(bn, len(ops.conv_ranges_bf16(chunks, z)))
                            for bn in widths for z in CONV_SPLITS
                            if z <= most}
        what = f"conv2d_fused_bf16 {cfg_name} b{batch} {layer}"
        times = {}
        with torch.inference_mode():
            def mma_sync():
                return ops._conv_forward(x, w, b, c.stride, c.padding, True,
                                         c.groups, "cuda", body="mma_sync")

            cs.bf16_check(what + " mma_sync", mma_sync(), want)
            mma_ms = cs.time_ms(mma_sync, reps=5)
            for tiles in sorted(choices):
                def call(tiles=tiles):
                    return ops._conv_forward(x, w, b, c.stride, c.padding,
                                             True, c.groups, "cuda",
                                             tiles=tiles, body="wgmma")

                cs.bf16_check(f"{what} {tiles}", call(), want)
                times[tiles] = cs.time_ms(call, reps=5)
        best = min(times, key=times.get)
        tot = sums.setdefault(batch, [0.0, 0.0, 0.0])
        tot[0] += times[rule]
        tot[1] += times[best]
        tot[2] += mma_ms
        cs.emit({"kernel": "conv2d_fused_bf16", "config": cfg_name,
                 "batch": batch, "layer": layer, "m": m, "npg": npg,
                 "chunks": chunks, "route": route, "groups": c.groups,
                 "rule": list(rule), "rule_ms": times[rule],
                 "best": list(best), "best_ms": times[best],
                 "mma_sync_ms": mma_ms,
                 "ms_by_tiles": {f"{bn}x{z}": t
                                 for (bn, z), t in times.items()}})
    for batch, (rule_ms, best_ms, mma_ms) in sorted(sums.items()):
        cs.emit({"conv2d_fused_bf16_batch": batch, "rule_sum_ms": rule_ms,
                 "best_sum_ms": best_ms, "mma_sync_sum_ms": mma_ms})


def decode_sweep(cs, gen, sms):
    from repro_torch.kernels.decode_attention import ops

    for case in cs.DECODE_CASES:
        name, b, cap, hkv, g, hd, window, qd, kvd, bs = case
        if not (bs or name in RING_CASES):
            continue
        q_dtype, kv_dtype = getattr(torch, qd), getattr(torch, kvd)
        q, k, v, pos, ks, vs, table = cs.decode_inputs(
            gen, b, cap, hkv, g, hd, q_dtype, kv_dtype, bs)
        want = ops.decode_attention(q, k, v, pos, window=window,
                                    scale=hd ** -0.5, k_scale=ks,
                                    v_scale=vs, table=table,
                                    backend="plain")
        rule = ops.kernel_chunk(q, k, table, sms)
        unit = bs or ops.warp_step(hd, k.element_size(), g)
        kernel = "decode_table" if bs else "decode_ring"
        times = {}
        for chunk in sorted({rule} | {z for z in DECODE_CHUNKS
                                      if z % unit == 0}):
            def call(chunk=chunk):
                if bs:
                    return ops._table(q, k, v, pos, table, window,
                                      hd ** -0.5, ks, vs, chunk=chunk)
                return ops._ring(q, k, v, pos, window, hd ** -0.5, ks, vs,
                                 chunk=chunk)

            with torch.inference_mode():
                cs.check_close(f"{kernel} {name} chunk {chunk}",
                               call().float(), want.float(),
                               cs.DECODE_TOL[q_dtype])
                times[chunk] = cs.time_ms(call, reps=50)
        best = min(times, key=times.get)
        cs.emit({"kernel": kernel, "case": name, "rule": rule,
                 "rule_ms": times[rule], "best": best,
                 "best_ms": times[best],
                 "ms_by_chunk": {str(z): t for z, t in times.items()}})


def wkv_sweep(cs, gen, sms):
    from repro_torch.kernels.rwkv6 import ops, ref

    rule_sum = best_sum = 0.0
    for case, b, t, h, k, dtype, w_zero in cs.WKV_CASES:
        if case not in WKV_CASES:
            continue
        xs = cs.wkv_inputs(gen, b, t, h, k, dtype, w_zero)
        with torch.inference_mode():
            want_y, want_s = ref.wkv_chunked(*xs, chunk=min(64, t))
        rule = ops.wkv_chunk(t, b * h, sms)
        times = {}
        for chunk in sorted({rule} | set(WKV_CHUNKS)):
            def call(chunk=chunk):
                return ops._fwd(*xs, chunk=chunk)

            with torch.inference_mode():
                y, s = call()
                cs.check_close(f"wkv_fwd {case} chunk {chunk}", y.float(),
                               want_y.to(dtype).float(), cs.WKV_TOL[dtype])
                cs.check_close(f"wkv_fwd {case} chunk {chunk} state", s,
                               want_s, cs.WKV_TOL[torch.float32])
                times[chunk] = cs.time_ms(call, reps=10)
        best = min(times, key=times.get)
        rule_sum += times[rule]
        best_sum += times[best]
        cs.emit({"kernel": "wkv_fwd", "case": case, "shape": [b, t, h, k],
                 "rule": rule, "rule_ms": times[rule], "best": best,
                 "best_ms": times[best],
                 "ms_by_chunk": {str(z): ms for z, ms in times.items()}})
    cs.emit({"wkv_fwd_rule_sum_ms": rule_sum, "wkv_fwd_best_sum_ms": best_sum})


def rglru_sweep(cs, gen, sms):
    from repro_torch.kernels.rglru import ops, ref

    rule_sum = best_sum = 0.0
    for case, b, t, d, strong in cs.RGLRU_CASES:
        z = torch.randn((b, t, d), generator=gen, device="cuda")
        a = torch.exp(-10.0 + 0.1 * z) if strong else torch.sigmoid(z + 2)
        x = torch.randn((b, t, d), generator=gen, device="cuda")
        with torch.inference_mode():
            want_h = ref.rglru_sequential(a, x)[0]
            want_g, want_da = ref.rglru_transpose_grads(a, x, want_h)
        rule = ops.rglru_chunk(t, b * d, sms)
        times = {}
        for chunk in ops.RGLRU_CHUNKS:
            def fwd(chunk=chunk):
                return ops._launch(a, x, reverse=False, chunk=chunk)[0]

            def rev(chunk=chunk):
                return ops._launch(a, x, reverse=True, h=want_h, chunk=chunk)

            with torch.inference_mode():
                cs.check_close(f"rglru_fwd {case} chunk {chunk}", fwd(),
                               want_h, cs.RGLRU_TOL)
                g, da = rev()
                cs.check_close(f"rglru_fwd reverse {case} chunk {chunk}", g,
                               want_g, cs.RGLRU_TOL)
                cs.check_close(f"rglru_fwd da {case} chunk {chunk}", da,
                               want_da, cs.RGLRU_TOL)
                times[chunk] = (cs.time_ms(fwd, reps=10),
                                cs.time_ms(rev, reps=10))
        best = min(times, key=lambda c: sum(times[c]))
        rule_sum += sum(times[rule])
        best_sum += sum(times[best])
        cs.emit({"kernel": "rglru_fwd", "case": case, "shape": [b, t, d],
                 "rule": rule, "rule_ms": list(times[rule]), "best": best,
                 "best_ms": list(times[best]),
                 "ms_by_chunk": {str(c): {"forward": f, "reverse_da": r}
                                 for c, (f, r) in times.items()}})
    cs.emit({"rglru_fwd_rule_sum_ms": rule_sum,
             "rglru_fwd_best_sum_ms": best_sum})


SWEEPS = ("decode", "wkv", "rglru", "conv", "conv_bf16", "gemm",
          "gemm_bf16")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", default=list(SWEEPS),
                    choices=SWEEPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.launch.train import fp32_numerics

    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    fp32_numerics(dev)
    _build.build()
    _build.load()
    cs.CYCLES_PER_MS = cs._sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sweeps = {"decode": lambda: decode_sweep(cs, gen, sms),
              "wkv": lambda: wkv_sweep(cs, gen, sms),
              "rglru": lambda: rglru_sweep(cs, gen, sms),
              "conv": lambda: conv_sweep(cs, gen, dev, sms),
              "conv_bf16": lambda: conv_bf16_sweep(cs, gen, dev, sms),
              "gemm": lambda: gemm_sweep(cs, gen, dev, sms),
              "gemm_bf16": lambda: gemm_bf16_sweep(cs, gen, sms)}
    for name in args.kernels:
        sweeps[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
