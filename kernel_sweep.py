#!/usr/bin/env python3
"""Time the GEMM kernel's split-K choices on one NVIDIA GPU.

    python3 kernel_sweep.py

Run from the root of a checkout; it imports ``repro_torch`` from ``src/``
and ``chip_smoke``'s helpers (never ``jax`` or ``repro``), builds the
kernels, and prints one JSON line for each of the 14 GEMM products of one
im2col replica-step (``chip_smoke.gemm_cases``): the kernel's time at the
split ``gemm_split`` picks and at every split of ``SPLITS`` that leaves no
split shorter than ``GEMM_MIN_CHUNKS`` chunks, each result within
``chip_smoke.GEMM_TOL`` of the plain version; then the sums over the 14
products of the rule's times and of each product's fastest split.  Exits
non-zero without a CUDA device or when a check fails.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SPLITS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 88]


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import ALEXNET_FAITHFUL
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d import ops
    from repro_torch.kernels.conv2d.ref import matmul_bias_ref
    from repro_torch.launch.train import fp32_numerics

    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    fp32_numerics(dev)
    _build.build()
    _build.load()
    cs.CYCLES_PER_MS = cs._sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
