"""Serving CLI of the port: image classification with AlexNet on one
GPU (or, when asked, on the CPU).

Builds AlexNet with random weights from ``--seed``, starts
``repro_torch.serving.ServingEngine`` with ``--slots`` slots, feeds it
``--requests`` random raw-pixel images and reports images/s and
per-request p50/p99 latency, ending in ``serve OK``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch alexnet
    PYTHONPATH=src python -m repro_torch.launch.serve --arch alexnet \
        --smoke --device cpu

``--arch alexnet`` is the reference CLI's legacy net (``ALEXNET``:
ungrouped, LRN before the pool) at full width, 227x227x3 images and 1000
classes; ``--smoke`` serves the reduced ``ALEXNET_SMOKE``.  It runs on
``cuda`` unless ``--device cpu`` is given, and exits non-zero when CUDA
is asked for and absent.  The LM archs, the replica mesh, the tier, spec
decode, the block pool and numerics presets are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ALEXNET, ALEXNET_SMOKE
from repro_torch.kernels.common import BACKENDS, KernelPolicy, device_of
from repro_torch.serving import Request, ServingEngine


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="alexnet", choices=["alexnet"],
                    help="only the conv family is ported so far")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--slots", type=int, default=4,
                    help="fixed slots (images classified per forward)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--kernel-backend", default="auto", choices=BACKENDS,
                    help="KernelPolicy backend: auto runs the CUDA kernels "
                    "on the GPU and their plain versions on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def build_cfg(args):
    cfg = ALEXNET_SMOKE if args.smoke else ALEXNET
    return dataclasses.replace(
        cfg, kernels=KernelPolicy(backend=args.kernel_backend))


def make_requests(args, cfg):
    rs = np.random.default_rng(args.seed)
    return [Request(image=rs.standard_normal(
        (cfg.image_size, cfg.image_size, cfg.in_channels)))
        for _ in range(args.requests)]


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        device = device_of(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    cfg = build_cfg(args)
    gen = torch.Generator().manual_seed(args.seed)
    model = models.init(cfg, gen, device=device)
    engine = ServingEngine(model, cfg, slots=args.slots,
                           temperature=args.temperature, top_k=args.top_k,
                           seed=args.seed)
    reqs = make_requests(args, cfg)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={cfg.name} family={cfg.family} device={device} ({name}) "
          f"slots={args.slots} kernels={cfg.kernels.describe()}")
    t0 = time.perf_counter()
    results = engine.run(reqs)
    wall = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    lats = sorted(r.latency for r in results)
    p = lambda q: lats[min(int(q * len(lats)), len(lats) - 1)]  # noqa: E731
    print(f"served {len(results)} requests / {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} images/s, {engine.decode_steps} decode "
          f"ticks, {len(engine._buckets_used)} image buckets)")
    print(f"latency p50 {p(0.5) * 1e3:.0f}ms p99 {p(0.99) * 1e3:.0f}ms "
          f"ttft p50 {sorted(r.ttft for r in results)[len(results) // 2] * 1e3:.0f}ms")
    print("serve OK")


if __name__ == "__main__":
    main()
