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
``lm_train`` (``lm_train_phase``, olmo-1b), ``rg_train`` and
``rwkv_train`` (``recurrent_train_phase`` of recurrentgemma-9b and of
rwkv6-7b), ``recurrence`` (``recurrence_phase``: the WKV and RG-LRU
kernels' rows, then their Functions' grads), ``lm_serving``
(``lm_serving_phase``), ``conv`` (the fused conv's rows at the serving
batch, 8, of both AlexNets and the training batch, 128; a turn's sums of
the rows by config and batch follow its rows as ``conv_sum`` lines),
``lrn`` (``lrn_phase``, the LRN rows at the same batches, summed the
same way as ``lrn_sum`` lines), ``decode``
(``decode_phase``, then every case's output digest; the last line says,
per case, whether the two turns of each tree agree and whether the two
trees do), ``alexnet_train`` (``train_timing``'s windows of the
fused-conv AlexNet at 2 x 128 over a preprocessed pool, as
``train_phase`` ends) and ``lm_ticks`` (``lm_serve_counts``' waves of
olmo-1b on the ring and on the block pool, each traced: device ms per
decode tick by family, and the wave's generated tokens/s, which the host
bounds).

Every turn's output goes to ``<log-dir>/ab_<turn>.log`` (``build/ab`` by
default, gitignored); the JSON lines of the phases come out here too, each
prefixed by its turn (``A1``, ``B1``, ``B2``, ``A2``).  Exits
non-zero if a turn fails or no CUDA device is present.
"""
import argparse
import json
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
    "rwkv_train": "cs.recurrent_train_phase('rwkv6-7b', seed)",
    "recurrence": "cs.recurrence_phase(gen)",
    "lm_serving": "cs.lm_serving_phase(seed)",
    # a tree without lrn_phase runs its kernel phase with the conv and GEMM
    # rows left out, which leaves its LRN rows
    "lrn": """cases = [(ALEXNET_FAITHFUL, cs.SERVE_BATCH), (ALEXNET, cs.SERVE_BATCH),
         (ALEXNET_FAITHFUL, cs.TRAIN_BATCH)]
if hasattr(cs, "lrn_phase"):
    cs.lrn_phase(gen, cases)
else:
    saved = cs.conv_phase, cs.gemm_phase
    cs.conv_phase = cs.gemm_phase = lambda *args, **kw: None
    cs.kernel_phase(gen, (ALEXNET_FAITHFUL.name, cs.TRAIN_BATCH), cases)
    cs.conv_phase, cs.gemm_phase = saved""",
    # a tree without conv_phase runs its whole kernel phase (conv rows
    # first, then LRN and GEMM)
    "conv": """cases = [(ALEXNET_FAITHFUL, cs.SERVE_BATCH), (ALEXNET, cs.SERVE_BATCH),
         (ALEXNET_FAITHFUL, cs.TRAIN_BATCH)]
if hasattr(cs, "conv_phase"):
    cs.conv_phase(gen, cases)
else:
    cs.kernel_phase(gen, (ALEXNET_FAITHFUL.name, cs.TRAIN_BATCH), cases)""",
    # then every case's output digest, from inputs drawn here: each
    # tree's two turns must agree (a change to a kernel's order of sums
    # shows as trees that differ)
    "decode": """cs.decode_phase(gen)
import hashlib
from repro_torch.kernels.decode_attention import ops as dops
gen = torch.Generator(device="cuda").manual_seed(seed + 1)
for case, b, cap, hkv, g, hd, window, qd, kvd, bs in cs.DECODE_CASES:
    q, k, v, pos, ks, vs, table = cs.decode_inputs(
        gen, b, cap, hkv, g, hd, getattr(torch, qd), getattr(torch, kvd), bs)
    with torch.inference_mode():
        o = dops.decode_attention(q, k, v, pos, window=window,
                                  scale=hd ** -0.5, k_scale=ks, v_scale=vs,
                                  table=table)
    cs.emit({"phase": "decode_digest", "case": case, "digest":
             hashlib.sha256(o.float().cpu().numpy().tobytes()).hexdigest()})""",
    "alexnet_train": """cfg = dataclasses.replace(ALEXNET_FAITHFUL,
                          kernels=KernelPolicy("auto"))
items = cs.TRAIN_BATCH * cs.REPLICAS
pool, mean = cs.host_pool(cfg, items, 4, seed + 7)
pre = cs.pool_stream(pool, mean, cfg, seed)()
prepped = [next(pre) for _ in pool]
cs.train_timing(cs.alexnet_loss(cfg), cs.init_state(cfg, seed),
                lambda: itertools.cycle(prepped), cfg.name,
                "preprocessed pool", items, scopes=("lrn_bwd",))""",
    "lm_ticks": """from torch.profiler import ProfilerActivity, profile
from repro_torch import models
from repro_torch.configs import ARCHS
cfg = dataclasses.replace(ARCHS[cs.LM_ARCH], kernels=KernelPolicy("auto"))
params = models.init(cfg, torch.Generator().manual_seed(seed), device="cuda")
prompts = cs.serve_prompts(cfg.vocab_size, 4 * cs.SERVE_SLOTS, seed + 23)
for bs in (0, 16):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wave = cs.lm_serve_counts(params, cfg, prompts, bs)
    trace = os.path.join(tempfile.mkdtemp(), "trace.json")
    prof.export_chrome_trace(trace)
    busy = cs.device_busy(trace, cs.lm_family)
    n = wave["decode_ticks"]
    cs.emit({"phase": "lm_ticks", "block_size": bs, "decode_ticks": n,
             "host_bound_generated_tokens_per_s":
                 wave["generated_tokens_per_s"],
             "device_busy_ms_per_tick": busy["busy_ms"] / n,
             "device_ms_per_tick_by_family": {
                 k: v / n for k, v in busy["ms_by_family"].items()},
             "wall_s": wave["wall_s"]})""",
}
TURN = """
import dataclasses, itertools, os, sys, tempfile, torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs import ALEXNET, ALEXNET_FAITHFUL
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
    digests = {}
    for tree in "ABBA":
        seen[tree] += 1
        turn = f"{tree}{seen[tree]}"
        print(f"== {turn}: {trees[tree]}", flush=True)
        log = os.path.join(args.log_dir, f"ab_{turn}.log")
        with open(log, "w") as out:
            proc = subprocess.run([sys.executable, "-c", code],
                                  cwd=trees[tree], stdout=out,
                                  stderr=subprocess.STDOUT, text=True)
        sums = {}
        with open(log) as f:
            for line in f:
                if line.startswith("{"):
                    print(turn, line, end="")
                    row = json.loads(line)
                    if "digest" in row:
                        digests.setdefault(row["case"], {}).setdefault(
                            tree, set()).add(row["digest"])
                    if row.get("kernel") in ("conv2d_fused", "lrn"):
                        key = ("conv" if row["kernel"] == "conv2d_fused"
                               else "lrn", row["config"], row["batch"])
                        tot = sums.setdefault(key, {
                            "layers": 0, "kernel_ms": 0.0, "plain_ms": 0.0,
                            "library_ms": 0.0, "bound_ms": 0.0})
                        tot["layers"] += 1
                        for k in ("kernel_ms", "plain_ms", "library_ms",
                                  "bound_ms"):
                            tot[k] += row[k]
        for (kind, config, batch), tot in sorted(sums.items()):
            print(turn, json.dumps({"phase": f"{kind}_sum",
                                    "config": config, "batch": batch,
                                    **tot}))
        if proc.returncode:
            print(f"ab_smoke: turn {turn} failed (exit {proc.returncode}); "
                  f"see {log}", file=sys.stderr)
            return 1
    if digests:
        print(json.dumps({"phase": "decode_digests", **{
            c: {"each_tree_agrees_with_itself": all(
                len(x) == 1 for x in d.values()),
                "trees_agree": len(set.union(*d.values())) == 1}
            for c, d in digests.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
