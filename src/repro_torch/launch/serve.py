"""Serving CLI of the port: image classification with AlexNet, or token
generation with a dense, ssm or hybrid LM of the zoo, on one GPU (or,
when asked, on the CPU), in one process or as a multi-process tier.

Builds the model with random weights from ``--seed``, starts
``repro_torch.serving.ServingEngine`` with ``--slots`` slots, feeds it
``--requests`` random requests and reports throughput and latency,
ending in ``serve OK``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --capacity 2048 --prompt-len 512 --max-new 128 --slots 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --device cpu --block-size 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch alexnet \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --smoke --layers 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --device cpu --draft-layers 1 --spec-tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --tier 2 --disagg

``--arch alexnet`` is the reference CLI's legacy net (``ALEXNET``:
ungrouped, LRN before the pool) at full width, 227x227x3 images and 1000
classes; ``--smoke`` serves the reduced ``ALEXNET_SMOKE``.  An LM (a
dense one such as ``olmo-1b`` or ``gemma-7b``, a mixture-of-experts one,
``mixtral-8x7b`` or ``llama4-maverick-400b-a17b``, ``rwkv6-7b`` or
``recurrentgemma-9b``) serves at its published width in its config's
dtype (bf16; ``--dtype`` sets the numerics policy's ``param_dtype``
over it); ``--layers`` cuts its depth, and
``--smoke`` takes the reference's reduced fp32 config (``--layers`` /
``--d-model`` size it).  Prompts are random tokens, their lengths drawn
around ``--prompt-len``; the run reports generated tokens/s, TTFT
p50/p99 and the per-token latency of each request's decode (p50/p99).
``--block-size`` serves from the shared-prefix block pool (the dense and
moe families with full attention only: the engine refuses it for the
recurrent state and for a sliding window, as the reference's),
``--ticks-per-dispatch`` runs K decode ticks per host read, and
``--kv-cache-dtype`` stores the KV cache in another type (int8 with
fp32 scales).  ``--draft-layers k`` decodes speculatively (greedy)
with a draft of the target's own first k layers, ``--draft-arch A``
with an independent draft of arch A (reduced under ``--smoke``, the
target's vocabulary, weights from ``--seed`` + 1); ``--spec-tokens``
draft tokens a round, and the report adds the accepted share.

``--tier N`` spawns N engine worker processes (``--role engine`` with
the same model flags, ``worker_argv``, each on a free port) behind a
``serving.Router`` and routes the requests through them; ``--disagg``
adds a prefill worker, and the instances then admit prefilled
snapshots only.  The kernels are built once before any worker starts.
The tier reports aggregate generated tokens/s, the router's latency
p50/p99 and the kernel launches of its workers.

It runs on ``cuda`` unless ``--device cpu`` is given, and exits non-zero
when CUDA is asked for and absent.  TF32 is off on the card, in every
process of a tier alike.  ``--numerics bf16`` serves under the bf16
preset: bf16 params (AlexNet's images are cast to them and run the bf16
conv and LRN kernels) and a bf16 KV cache for the LMs.  A moe arch's
prefill dispatches at its configured (dropping) capacity factor and its
decode is dropless, as the reference's.  The vlm (queue A item 8, A8b)
and encdec (A8c) families and the replica mesh (item 12) are not ported
yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ALEXNET, ALEXNET_SMOKE, ARCHS, reduced
from repro_torch.kernels.common import BACKENDS, KernelPolicy, device_of
from repro_torch.launch import not_ported
from repro_torch.numerics import (DTYPES, KV_CACHE_DTYPES, dtype_name,
                                  fp32_numerics, get_policy, param_dtype)
from repro_torch.serving import Request, Router, ServingEngine
from repro_torch.serving.spec_decode import truncated_draft

LM_ARCHS = sorted(a for a, c in ARCHS.items()
                  if c.family in ("dense", "moe", "ssm", "hybrid"))
# the LM families still to port, and their ROADMAP items
NOT_PORTED_ITEMS = {"vlm": "queue A item 8 (A8b, the vlm family)",
                    "encdec": "queue A item 8 (A8c, the encdec family)"}


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmo-1b",
                    choices=["alexnet"] + sorted(ARCHS),
                    help="alexnet or an LM of the zoo ("
                    + ", ".join(LM_ARCHS) + "); the other families do not "
                    "serve yet")
    ap.add_argument("--images", action="store_true",
                    help="vlm: attach random raw pixels to every request "
                    "(the vlm family is not ported)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=None,
                    help="LM depth (with --smoke the reduced config's; "
                    "without, a depth cut of the published width)")
    ap.add_argument("--d-model", type=int, default=None,
                    help="LM width of the reduced config (--smoke only)")
    ap.add_argument("--slots", type=int, default=4,
                    help="fixed slots: the continuous batch (images "
                    "classified per forward for alexnet)")
    ap.add_argument("--capacity", type=int, default=128,
                    help="per-request position budget (the ring's "
                    "capacity; a sliding window keeps less)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="mean prompt length (lengths vary around it)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--ticks-per-dispatch", type=int, default=1,
                    help="decode ticks per host read of the sampled tokens")
    ap.add_argument("--draft-arch", default=None,
                    help="speculative decoding (greedy) with this arch as "
                    "the draft model (reduced under --smoke)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="> 0: speculative decoding with a draft of the "
                    "target's own first k layers")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="draft tokens proposed per verify round (gamma)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="> 0: shared-prefix block-pool KV cache with this "
                    "many ring positions per block (full-attention dense "
                    "archs)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="pool size for --block-size (default: full "
                    "private provisioning, slots*capacity/bs + trash)")
    ap.add_argument("--numerics", default="fp32", choices=["fp32", "bf16"],
                    help="NumericsPolicy preset of the served model: bf16 "
                    "= bf16 params and a bf16 KV cache")
    ap.add_argument("--kv-cache-dtype", default="auto",
                    choices=KV_CACHE_DTYPES,
                    help="KV-cache storage: auto follows the model dtype; "
                    "int8 quantizes per head and slot with fp32 scales")
    ap.add_argument("--kernel-backend", default="auto", choices=BACKENDS,
                    help="KernelPolicy backend: auto runs the CUDA kernels "
                    "on the GPU and their plain versions on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="the numerics policy's param_dtype: the params' "
                    "and activations' dtype (default: the preset's, else "
                    "the config's, bf16 at the published width and fp32 "
                    "under --smoke); fp32 parity runs set float32")
    # the multi-process tier
    ap.add_argument("--tier", "--instances", type=int, default=0,
                    dest="tier", help="> 0: engine worker processes behind "
                    "a router")
    ap.add_argument("--disagg", action="store_true",
                    help="tier mode: add a dedicated prefill worker; the "
                    "instances admit prefilled snapshots only")
    ap.add_argument("--role", default="driver",
                    choices=["driver", "router", "engine", "decode",
                             "prefill"],
                    help="worker roles serve one router connection on "
                    "--port; router is an alias for --tier")
    ap.add_argument("--port", type=int, default=0,
                    help="worker roles: localhost port to listen on (0 "
                    "with --port-fd: any free port)")
    ap.add_argument("--port-fd", type=int, default=None,
                    help="worker roles: a pipe to write the bound port "
                    "to once the worker accepts (set by spawn_worker)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="worker backpressure bound (default 2x slots): "
                    "beyond it submits answer 'defer'")
    return ap


def check_ported(args) -> None:
    """Raise for the reference flag values the port does not run yet,
    naming their ROADMAP item."""
    if args.arch != "alexnet" and args.arch not in LM_ARCHS:
        family = ARCHS[args.arch].family
        raise not_ported(f"serving --arch {args.arch} ({family})",
                         NOT_PORTED_ITEMS.get(family, "queue A item 8"))
    if args.images:
        raise not_ported("--images", "queue A item 8 (A8b, the vlm family)")


def numerics_policy(args):
    """The ``--numerics`` preset, with ``--kv-cache-dtype`` over its KV
    cache dtype when set and ``--dtype`` as its ``param_dtype``."""
    npol = get_policy(args.numerics)
    if args.kv_cache_dtype != "auto":
        npol = dataclasses.replace(npol, kv_cache_dtype=args.kv_cache_dtype)
    if args.dtype is not None:
        npol = dataclasses.replace(npol, param_dtype=args.dtype)
    return npol


def build_cfg(args, error):
    pol = KernelPolicy(backend=args.kernel_backend)
    if args.arch == "alexnet":
        cfg = ALEXNET_SMOKE if args.smoke else ALEXNET
        return dataclasses.replace(cfg, kernels=pol,
                                   numerics=numerics_policy(args))
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduced(cfg, n_layers=args.layers or 2,
                      d_model=args.d_model or 256)
    else:
        if args.d_model is not None:
            error("--d-model sizes the reduced config: add --smoke (the "
                  "published width is kept otherwise)")
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return dataclasses.replace(cfg, kernels=pol,
                               numerics=numerics_policy(args))


def build_spec(args, cfg, params, device, error) -> dict:
    """The engine's speculative-decoding arguments: none without
    ``--draft-layers`` or ``--draft-arch``; a draft of the target's own
    first k layers sharing its leaves (``truncated_draft``), or an
    independent arch with the target's kernel policy, numerics and
    vocabulary and weights drawn from ``--seed`` + 1."""
    if not args.draft_arch and not args.draft_layers:
        return {}
    if cfg.family == "conv":
        error(f"speculative decoding needs an LM target, not {cfg.name}")
    if args.draft_layers:
        dcfg, dparams = truncated_draft(cfg, params, args.draft_layers)
    else:
        if args.draft_arch not in ARCHS:
            error(f"--draft-arch {args.draft_arch}: not an LM of the zoo "
                  f"({', '.join(LM_ARCHS)})")
        dcfg = ARCHS[args.draft_arch]
        if args.smoke:
            dcfg = reduced(dcfg, n_layers=args.layers or 2,
                           d_model=args.d_model or 256)
        dcfg = dataclasses.replace(dcfg, kernels=cfg.kernels,
                                   numerics=cfg.numerics,
                                   vocab_size=cfg.vocab_size)
        dparams = models.init(dcfg, torch.Generator().manual_seed(
            args.seed + 1), device=device)
    return {"draft_params": dparams, "draft_cfg": dcfg,
            "spec_tokens": args.spec_tokens}


def make_requests(args, cfg):
    rs = np.random.default_rng(args.seed)
    if cfg.family == "conv":
        return [Request(image=rs.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels)))
            for _ in range(args.requests)]
    hi = max(args.capacity - args.max_new, 2)
    reqs = []
    for _ in range(args.requests):
        ln = int(np.clip(rs.integers(max(args.prompt_len // 2, 1),
                                     args.prompt_len * 2), 1, hi))
        reqs.append(Request(prompt=rs.integers(0, cfg.vocab_size, size=ln),
                            max_new_tokens=args.max_new))
    return reqs


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)]


def report(engine, results, wall: float, family: str) -> None:
    toks = sum(len(r.tokens) for r in results)
    ttft = [r.ttft for r in results]
    if family == "conv":
        print(f"served {len(results)} requests / {toks} tokens in "
              f"{wall:.2f}s ({toks / wall:.1f} images/s, "
              f"{engine.decode_steps} decode ticks, "
              f"{len(engine._buckets_used)} image buckets)")
        lats = [r.latency for r in results]
        print(f"latency p50 {percentile(lats, 0.5) * 1e3:.0f}ms p99 "
              f"{percentile(lats, 0.99) * 1e3:.0f}ms ttft p50 "
              f"{percentile(ttft, 0.5) * 1e3:.0f}ms")
        return
    # per-token latency: each request's decode time over its decoded tokens
    per_tok = [(r.t_done - r.t_first) / (len(r.tokens) - 1)
               for r in results if len(r.tokens) > 1]
    print(f"served {len(results)} requests / {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} generated tok/s, {engine.decode_steps} "
          f"decode ticks / {engine.dispatches} dispatches, "
          f"{engine.prefill_compiles} prefill buckets)")
    if engine.spec_proposed:
        print(f"spec: {engine.spec_accepted}/{engine.spec_proposed} draft "
              f"tokens accepted "
              f"({engine.spec_accepted / engine.spec_proposed:.2f})")
    if engine.block_mgr is not None:
        print(f"blocks: peak {engine.block_mgr.peak}/{engine.block_mgr.nb} "
              f"in use, {engine.block_mgr.prefills_skipped} prefills "
              f"skipped")
    line = (f"ttft p50 {percentile(ttft, 0.5) * 1e3:.1f}ms p99 "
            f"{percentile(ttft, 0.99) * 1e3:.1f}ms")
    if per_tok:
        line += (f"; per-token p50 {percentile(per_tok, 0.5) * 1e3:.2f}ms "
                 f"p99 {percentile(per_tok, 0.99) * 1e3:.2f}ms")
    print(line)


def build_engine(args, cfg, device, error) -> ServingEngine:
    """The engine of these flags: weights drawn from ``--seed``, as every
    process of a tier draws them."""
    params = models.init(cfg, torch.Generator().manual_seed(args.seed),
                         device=device)
    spec = build_spec(args, cfg, params, device, error)
    return ServingEngine(params, cfg, slots=args.slots,
                         capacity=args.capacity,
                         temperature=args.temperature, top_k=args.top_k,
                         seed=args.seed,
                         ticks_per_dispatch=args.ticks_per_dispatch,
                         block_size=args.block_size,
                         num_blocks=args.num_blocks, **spec)


def worker_argv(args) -> list:
    """The flags a spawned worker needs to build the same engine as this
    process would: a tier's instances must be alike for a handoff to
    replay a snapshot."""
    argv = ["--arch", args.arch, "--slots", str(args.slots),
            "--capacity", str(args.capacity),
            "--temperature", str(args.temperature),
            "--top-k", str(args.top_k),
            "--ticks-per-dispatch", str(args.ticks_per_dispatch),
            "--kernel-backend", args.kernel_backend,
            "--numerics", args.numerics,
            "--kv-cache-dtype", args.kv_cache_dtype,
            "--seed", str(args.seed), "--device", args.device]
    if args.smoke:
        argv.append("--smoke")
    if args.layers is not None:
        argv += ["--layers", str(args.layers)]
    if args.d_model is not None:
        argv += ["--d-model", str(args.d_model)]
    if args.dtype is not None:
        argv += ["--dtype", args.dtype]
    if args.max_queue:
        argv += ["--max-queue", str(args.max_queue)]
    return argv


def run_worker(args, cfg, device, error) -> None:
    """Serve one engine (or, for ``--role prefill``, a prefill worker) to
    one router connection.  The port (``--port``, or any free one) is
    bound before the model is built, and written to ``--port-fd`` once
    the worker accepts."""
    from repro_torch.serving import tier
    if not args.port and args.port_fd is None:
        error("worker roles need --port or --port-fd")
    listener = tier.worker_listener(args.port)
    if args.role == "prefill":
        params = models.init(cfg, torch.Generator().manual_seed(args.seed),
                             device=device)
        obj = tier.PrefillWorker(params, cfg, capacity=args.capacity,
                                 temperature=args.temperature,
                                 top_k=args.top_k, seed=args.seed)
    else:
        obj = build_engine(args, cfg, device, error)
    tier.worker_serve(obj, listener, max_queue=args.max_queue or None,
                      port_fd=args.port_fd)


def run_tier(args, cfg, device) -> None:
    """``--tier`` engine workers (and with ``--disagg`` a prefill worker)
    behind a ``Router``; the requests go through it."""
    from repro_torch.serving import tier
    if cfg.family == "conv":
        raise SystemExit("the tier routes token requests; image "
                         "classification serves in one process")
    if device.type == "cuda":
        # build once: N workers starting together would each run nvcc
        from repro_torch.kernels import _build
        _build.build()
    argv = worker_argv(args)
    # the workers write to this process's stdout: their errors show here
    instances = [tier.spawn_worker("engine", argv, name=f"engine{i}",
                                   stdout=None) for i in range(args.tier)]
    prefill = (tier.spawn_worker("prefill", argv, name="prefill",
                                 stdout=None) if args.disagg else None)
    router = Router(instances, prefill=prefill)
    try:
        for h in instances + ([prefill] if prefill else []):
            h.connect()
        reqs = make_requests(args, cfg)
        print(f"tier: {args.tier} instance(s)"
              + (" + prefill worker" if prefill else "")
              + f", arch={cfg.name} device={device} slots={args.slots}/"
              f"instance capacity={args.capacity} layers={cfg.n_layers} "
              f"dtype={dtype_name(param_dtype(cfg))} "
              f"kernels={cfg.kernels.describe()}",
              flush=True)
        t0 = time.perf_counter()
        for r in reqs:
            router.submit(r)
        results = router.run_until_done()
        wall = time.perf_counter() - t0
        st = router.stats()
        launches = {}
        for h in instances + ([prefill] if prefill else []):
            for k, n in h.call("stats")[1]["launches"].items():
                launches[k] = launches.get(k, 0) + n
    finally:
        router.shutdown()
    toks = sum(len(r["tokens"]) for r in results)
    lats = [r["router_latency"] for r in results]
    print(f"served {len(results)} requests / {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} generated tok/s aggregate, "
          f"{router.deferred} deferred admissions, "
          f"dead={st['dead'] or 'none'})")
    print(f"router latency p50 {percentile(lats, 0.5) * 1e3:.0f}ms "
          f"p99 {percentile(lats, 0.99) * 1e3:.0f}ms")
    print("worker kernel launches: " + (", ".join(
        f"{k}={n}" for k, n in launches.items() if n) or "none"))


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    check_ported(args)
    try:
        device = device_of(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    fp32_numerics(device)
    cfg = build_cfg(args, ap.error)
    if cfg.family != "conv" and args.max_new >= args.capacity:
        ap.error(f"--max-new {args.max_new} must be < --capacity "
                 f"{args.capacity}: the ring holds capacity positions, "
                 "prompt included")
    if args.role in ("engine", "decode", "prefill"):
        run_worker(args, cfg, device, ap.error)
        return
    if args.tier or args.role == "router":
        if not args.tier:
            ap.error("--role router needs --tier N (instances to spawn)")
        run_tier(args, cfg, device)
        print("serve OK")
        return
    engine = build_engine(args, cfg, device, ap.error)
    spec = engine.draft_cfg is not None
    reqs = make_requests(args, cfg)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={cfg.name} family={cfg.family} device={device} ({name}) "
          f"slots={args.slots} "
          + ("" if cfg.family == "conv" else
             f"capacity={args.capacity} layers={cfg.n_layers} "
             f"d_model={cfg.d_model} dtype={dtype_name(param_dtype(cfg))} "
             f"kv={args.kv_cache_dtype} block_size={args.block_size} "
             f"ticks_per_dispatch={args.ticks_per_dispatch} ")
          + (f"draft={engine.draft_cfg.name} "
             f"spec_tokens={args.spec_tokens} " if spec else "")
          + f"numerics={cfg.numerics.describe()} "
          f"kernels={cfg.kernels.describe()}", flush=True)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    report(engine, results, time.perf_counter() - t0, cfg.family)
    print("serve OK")


if __name__ == "__main__":
    main()
