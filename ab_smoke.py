#!/usr/bin/env python3
"""Time phases of ``chip_smoke.py`` for another checkout and this one, in
turns, on one NVIDIA GPU.

    python3 ab_smoke.py OTHER_DIR [--phases flash lm_train] [--log-dir DIR]

A is the checkout at OTHER_DIR (say, the parent commit unpacked with
``git archive``), B the checkout this script sits in; they take turns in
the order A, B, B, A, all at seed 0.  Each turn is a fresh
process in that tree's root: it builds the tree's kernels, sets up as
``chip_smoke.main`` does (TF32 off, the sleep kernel's rate) and calls the
tree's own phase functions, so each tree is measured by its own code on the
same card.  Phases: ``flash`` (``flash_phase``), ``gemm`` (``gemm_phase``,
the 14 GEMM products of one im2col replica-step), ``im2col``
(``im2col_phase``'s 3 im2col training steps, then ``train_timing``'s
windows of 10 warm steps each at the same 2 x 32 over a preprocessed
pool: images/s, step p50 and the device's busy ms per step by family),
``lm_train`` (``lm_train_phase``, olmo-1b), ``rg_train``
(``recurrent_train_phase`` of recurrentgemma-9b), ``lm_serving``
(``lm_serving_phase``).

Every turn's output goes to ``<log-dir>/ab_<turn>.log`` (``build/ab`` by
default, gitignored); the JSON lines of the phases come out here too, each
prefixed by its turn (``A1``, ``B1``, ``B2``, ``A2``).  Exits
non-zero if a turn fails or no CUDA device is present.
"""
import argparse
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = {
    "flash": "cs.flash_phase(gen)",
    # the GEMM rows alone: no totals to keep, nothing to account
    "gemm": "cs.gemm_phase(gen, {}, lambda *row: None)",
    "im2col": """cs.im2col_phase(ALEXNET_FAITHFUL, seed)
cfg = dataclasses.replace(ALEXNET_FAITHFUL, kernels=KernelPolicy(
    "auto", conv2d="im2col_ref"))
items = cs.IM2COL_BATCH * cs.REPLICAS
pool, mean = cs.host_pool(cfg, items, 3, seed + 11)
pre = cs.pool_stream(pool, mean, cfg, seed)()
prepped = [next(pre) for _ in pool]
cs.train_timing(cs.alexnet_loss(cfg), cs.init_state(cfg, seed),
                lambda: itertools.cycle(prepped), cfg.name + " im2col",
                "preprocessed pool", items)""",
    "lm_train": "cs.lm_train_phase(seed)",
    "rg_train": "cs.recurrent_train_phase('recurrentgemma-9b', seed)",
    "lm_serving": "cs.lm_serving_phase(seed)",
}
TURN = """
import dataclasses, itertools, sys, torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs import ALEXNET_FAITHFUL
from repro_torch.kernels import _build
from repro_torch.kernels.common import KernelPolicy
from repro_torch.launch.train import fp32_numerics
print(cs.card(), flush=True)
fp32_numerics(torch.device("cuda"))
_build.build()
_build.load()
cs.CYCLES_PER_MS = cs._sleep_cycles_per_ms()
seed = 0
gen = torch.Generator(device="cuda").manual_seed(seed)
{calls}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the A checkout")
    ap.add_argument("--phases", nargs="+", default=["flash", "lm_train"],
                    choices=sorted(PHASES))
    ap.add_argument("--log-dir", default=os.path.join(HERE, "build", "ab"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_smoke: no CUDA device", file=sys.stderr)
        return 1
    trees = {"A": os.path.abspath(args.other), "B": HERE}
    code = TURN.format(calls="\n".join(
        PHASES[p] + "\ntorch.cuda.empty_cache()" for p in args.phases))
    os.makedirs(args.log_dir, exist_ok=True)
    seen = {"A": 0, "B": 0}
    for tree in "ABBA":
        seen[tree] += 1
        turn = f"{tree}{seen[tree]}"
        print(f"== {turn}: {trees[tree]}", flush=True)
        log = os.path.join(args.log_dir, f"ab_{turn}.log")
        with open(log, "w") as out:
            proc = subprocess.run([sys.executable, "-c", code],
                                  cwd=trees[tree], stdout=out,
                                  stderr=subprocess.STDOUT, text=True)
        with open(log) as f:
            for line in f:
                if line.startswith("{"):
                    print(turn, line, end="")
        if proc.returncode:
            print(f"ab_smoke: turn {turn} failed (exit {proc.returncode}); "
                  f"see {log}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
