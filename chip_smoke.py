#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It imports ``repro_torch`` from
``src/`` (never ``jax`` or ``repro``) and, in order:

1. prints the card (``nvidia-smi``) and turns TF32 off for fp32 parity;
2. builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` and
   prints the build time and ``ptxas``'s report;
3. kernel phase: at every main-path shape (batch 8) holds each kernel
   against its plain PyTorch version on the card (conv 2e-4, LRN 2e-5)
   and times kernel, plain version, the library call that computes the
   same function (cuDNN conv, ``F.local_response_norm``; yardsticks
   only, never called by the port) and the card's bound, one JSON line
   per kernel and shape;
4. serving phase: serves 32 random 227x227x3 images through
   ``ServingEngine`` on ``ALEXNET_FAITHFUL`` at full width (8 slots,
   greedy) with the launch counts set to 0 just before and read just
   after, checks 5 conv and 2 LRN launches per forward, and holds class
   ids and logits against the same engine under the plain policy; then
   times images/s and latency p50/p99 over three windows of 4096
   requests from 8 closed-loop clients on the same model, and one more
   window under ``torch.profiler`` gives the device time by kernel and,
   against the unprofiled windows' wall time, the device's idle share;
5. CLI phase: ``python -m repro_torch.launch.serve --arch alexnet
   --requests 8`` (legacy ``ALEXNET``) in a subprocess, which must end in
   ``serve OK``;
6. prints the card again, the ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; it also does so without a CUDA device and outside a checkout.
"""
from __future__ import annotations

import argparse
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
BATCH = 8
FP32_PEAK = 67e12        # H100 SXM fp32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12       # H100 SXM HBM3, bytes/s
CONV_TOL = 2e-4          # registry tolerance of repro/kernels/conv2d/ops.py
LRN_TOL = 2e-5           # registry tolerance of repro/kernels/lrn/ops.py
LOGIT_TOL = 1e-3
MARGIN = 1e-3            # class ids are compared where top-2 exceeds this
CYCLES_PER_MS = 1.0e6    # torch.cuda._sleep rate, measured in main()


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


def device_busy(trace_path: str) -> dict:
    """Device time by kernel family from a ``torch.profiler`` chrome trace,
    and the union of the spans in which a kernel or a copy ran."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not any(e["cat"] == "kernel" for e in events):
        raise AssertionError("the profiler traced no kernel on the device")
    by = {}
    for e in events:
        name = e["name"]
        fam = ("copy" if e["cat"] != "kernel" else
               "conv2d_fused" if "conv2d_fused" in name else
               "lrn" if "lrn_kernel" in name else
               "gemm" if "gemm" in name.lower() else
               "max_pool" if "max_pool" in name else "other")
        by[fam] = by.get(fam, 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"busy_ms": busy / 1e3, "ms_by_family": by}


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(what, got, want, tol) -> float:
    err = max_err(got, want)
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: max |err| {err:.3e} beyond "
                             f"rtol=atol={tol}")
    return err


def conv_cases(cfgs):
    """(config, layer, x shape, ConvSpec) of every conv the configs run
    at batch 8; a layer seen in an earlier config is not repeated."""
    seen, cases = set(), []
    for cfg in cfgs:
        c_in, hw = cfg.in_channels, cfg.image_size
        for i, cs in enumerate(cfg.convs):
            key = (hw, c_in, cs)
            if key not in seen:
                seen.add(key)
                cases.append((cfg.name, f"conv{i + 1}",
                              (BATCH, hw, hw, c_in), cs))
            hw = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
            if cs.pool:
                hw = (hw - 3) // 2 + 1
            c_in = cs.out_channels
    return cases


def lrn_cases(cfgs):
    """(config, layer, x shape) of every LRN the configs run at batch 8."""
    cases = []
    for cfg in cfgs:
        c_in, hw = cfg.in_channels, cfg.image_size
        for i, cs in enumerate(cfg.convs):
            hw = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
            c_in = cs.out_channels
            if cs.lrn and not cfg.faithful:
                cases.append((cfg.name, f"lrn{i + 1}", (BATCH, hw, hw, c_in)))
            if cs.pool:
                hw = (hw - 3) // 2 + 1
            if cs.lrn and cfg.faithful:
                cases.append((cfg.name, f"lrn{i + 1}", (BATCH, hw, hw, c_in)))
    return cases


def kernel_phase(gen, main_cfg, cfgs):
    import torch.nn.functional as F

    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.lrn import ops as lrn_ops
    from repro_torch.kernels.lrn.ref import lrn_ref

    dev = torch.device("cuda")
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "max_abs_err": 0.0, "flops": 0.0,
                     "bytes": 0.0}
              for name in ("conv2d_fused", "lrn")}

    def account(name, cfg_name, row):
        tot = totals[name]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_err"])
        if cfg_name == main_cfg.name:      # the main path's forward
            for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
                src = "kernel_ms" if k == "ms" else k
                tot[k] += row[src]
            tot["flops"] += row["flops"]
            tot["bytes"] += row["bytes"]

    for cfg_name, layer, xs, cs in conv_cases(cfgs):
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
            err = check_close(f"conv2d_fused {cfg_name} {layer}", got, want,
                              CONV_TOL)
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
                                              cs.groups, bias=b, relu=True))
            l_ms = time_ms(library)
        oh, ow = got.shape[1], got.shape[2]
        flops = 2.0 * BATCH * oh * ow * cs.out_channels * cs.kernel ** 2 * cg
        nbytes = 4.0 * (x.numel() + w.numel() + b.numel() + got.numel())
        bound = max(flops / FP32_PEAK, nbytes / HBM_RATE) * 1e3
        row = {"phase": "kernel", "kernel": "conv2d_fused",
               "config": cfg_name, "layer": layer, "x": list(xs),
               "w": list(w.shape), "stride": cs.stride,
               "padding": cs.padding, "groups": cs.groups,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": bound,
               "bound_by": ("operations" if flops / FP32_PEAK
                            >= nbytes / HBM_RATE else "bytes"),
               "assumes": "67 TFLOP/s fp32 non-tensor, 3.35 TB/s",
               "flops": flops, "bytes": nbytes,
               "tflops": flops / (k_ms * 1e-3) / 1e12,
               "max_err": err, "library_err": lib_err}
        emit(row)
        account("conv2d_fused", cfg_name, row)

    cfg = main_cfg
    n, alpha, beta, k = cfg.lrn_n, cfg.lrn_alpha, cfg.lrn_beta, cfg.lrn_k
    for cfg_name, layer, xs in lrn_cases(cfgs):
        x = torch.randn(xs, generator=gen, device=dev) * 10.0
        with torch.inference_mode():
            got = lrn_ops.lrn(x, n=n, alpha=alpha, beta=beta, k=k,
                              backend="cuda")
            torch.cuda.synchronize()
            want = lrn_ref(x, n=n, alpha=alpha, beta=beta, k=k)
            err = check_close(f"lrn {cfg_name} {layer}", got, want, LRN_TOL)
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
               "layer": layer, "x": list(xs), "n": n, "alpha": alpha,
               "beta": beta, "k": k, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": nbytes / HBM_RATE * 1e3,
               "bound_by": "bytes", "assumes": "3.35 TB/s", "flops": 0.0,
               "bytes": nbytes,
               "gbps": nbytes / (k_ms * 1e-3) / 1e9, "max_err": err,
               "library_err": lib_err}
        emit(row)
        account("lrn", cfg_name, row)
    return totals


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


def timing_phase(model, cfg, seed, slots, n_req=4096, windows=3,
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
              k: v / forwards for k, v in busy["ms_by_family"].items()}})


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


def cli_phase():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "alexnet", "--requests", "8"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="")
    lines = proc.stdout.strip().splitlines()
    if proc.returncode or not lines or lines[-1] != "serve OK":
        raise AssertionError(f"serve CLI failed (exit {proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    emit({"phase": "cli", "seconds": time.perf_counter() - t0})


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

    print(card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "library": str(lib)})
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "ptxas info" in line or "error" in line.lower():
            print(line)

    global CYCLES_PER_MS
    CYCLES_PER_MS = _sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    totals = kernel_phase(gen, ALEXNET_FAITHFUL, [ALEXNET_FAITHFUL, ALEXNET])
    launches = serving_phase(ALEXNET_FAITHFUL, args.seed)
    cli_phase()

    src = "src/repro_torch/kernels"
    meta = {
        "conv2d_fused": (f"{src}/conv2d/csrc/conv2d_fused.cu",
                         "src/repro/kernels/conv2d/conv2d.py:152"),
        "lrn": (f"{src}/lrn/csrc/lrn.cu", "src/repro/kernels/lrn/lrn.py:37"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        tot = totals[name]
        bound_by = ("operations" if tot["flops"] / FP32_PEAK
                    >= tot["bytes"] / HBM_RATE else "bytes")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": bound_by, "library_ms": tot["library_ms"]})
    print(card(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
