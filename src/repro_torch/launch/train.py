"""Training CLI of the port: the paper's parameter-averaging data
parallelism on one GPU (or, when asked, on the CPU), for the paper's
AlexNet and for the dense, mixture-of-experts and recurrent LMs of the
zoo (``--arch olmo-1b``, ``--arch mixtral-8x7b``, ``--arch rwkv6-7b``,
``--arch recurrentgemma-9b``, ...).

Builds the model, loss and data streams, the optimizer (SGD momentum or
AdamW), the LR controller and the exchange, and hands the loop to
``repro_torch.train_loop.TrainSession`` (checkpoint/resume, eval +
plateau LR, Table-1 metrics).  On the reference engine the R replicas
live on the one device with a leading replica axis and run one after
another; after every update they exchange and average their weights and
optimizer state.  ``--engine mesh`` runs them as R processes, one
replica each, that exchange through ``torch.distributed`` collectives
(NCCL when each rank has a card of its own, gloo when they share one or
run on the CPU; the header line names it); the CLI starts the R ranks
itself, and ``--engine auto`` picks the mesh when ``--replicas`` equals
the number of cards and is above 1.  ``--exchange-delay 1`` exchanges
the incoming state one step stale and grafts the update onto it;
``--exchange-compression bf16`` halves the wire, ``topk`` (with
``--exchange-delay 1``) sends the ``--topk-frac`` largest entries of
each leaf's delta from the consensus, with error feedback.

    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --faithful --replicas 2 --batch 256 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --replicas 2 --batch 8 --seq-len 2048 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
        --layers 8 --replicas 2 --batch 8 --seq-len 2048 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \\
        --layers 2 --replicas 2 --batch 2 --seq-len 2048 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 2 --batch 4 --seq-len 32 --replicas 2 --device cpu
    # checkpoint every 10 steps, then pick up where a killed run stopped:
    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --smoke --device cpu --steps 100 --ckpt-dir ck --ckpt-every 10 \\
        --resume
    # two ranks over gloo, the overlapped exchange with a top-k wire:
    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --faithful --smoke --device cpu --replicas 2 --batch 8 \\
        --engine mesh --exchange-delay 1 --exchange-compression topk

An LM arch trains at its published width in its config's dtype (bf16
params for the zoo, fp32 optimizer state) on ``markov_lm`` tokens;
``--smoke`` takes the reference's reduced config (fp32, ``--layers`` /
``--d-model`` size it), and without ``--smoke`` ``--layers`` cuts the
depth only.  It runs on ``cuda`` unless ``--device cpu`` is given, and
exits non-zero when CUDA is asked for and absent.  On the GPU fp32 runs
with TF32 off and deterministic cuDNN algorithms.  Weights are random
from ``--seed`` through ``torch.Generator``, so they differ from the JAX
CLI's for the same seed; the data streams are the same numpy streams.
``--numerics bf16`` trains under the reference's bf16 preset: bf16
params and compute (AlexNet's images are cast to bf16 at the loss, its
conv and LRN run their bf16 kernels), fp32 master weights in the
optimizer state, which the exchange averages, and dynamic loss scaling
that skips a non-finite step on every replica at once (docs/numerics.md
has the contract; the README says where the port differs); with
``--conv-backend im2col_ref`` the convs run on the bf16 GEMM kernel.  A
moe arch's loss is the cross-entropy plus its aux load-balance loss, and
its expert FFN is the library's batched product (the reference's CLI has
no flag for the ``matmul`` kernel opt-in, nor has this one).  The vlm
(queue A item 8, A8b) and encdec (A8c) families and model parallelism
(item 12) are not ported yet and raise; the mesh engine is one flat
group (the reference's two-axis ``('pod', 'data')`` layout is queue A
item 12).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable

import torch

from repro_torch import models
from repro_torch.configs import (ALEXNET, ALEXNET_FAITHFUL,
                                 ALEXNET_FAITHFUL_SMOKE, ALEXNET_SMOKE, ARCHS,
                                 reduced)
from repro_torch.core.param_avg import (ExchangeConfig, mesh_spread,
                                        replica_spread)
from repro_torch.core.steps import (init_param_avg_state, make_eval_step,
                                    make_mesh_param_avg_step,
                                    make_param_avg_step, reshape_for_replicas)
from repro_torch.data import synthetic
from repro_torch.data.preprocess import make_image_preprocess
from repro_torch.kernels.common import BACKENDS, KernelPolicy, device_of
from repro_torch.launch import mesh, not_ported
from repro_torch.models import alexnet, transformer
from repro_torch.numerics import (KV_CACHE_DTYPES, dtype_name,
                                  fp32_numerics, get_policy, param_dtype)
from repro_torch.optim import schedules
from repro_torch.optim.optimizers import for_numerics, get_optimizer
from repro_torch.train_loop import (EVAL_SEED_OFFSET, TrainSession,
                                    alexnet_metrics, lm_metrics)
from repro_torch.tree import tree_leaves, tree_map

CONV_BACKENDS = {"fused": None, "im2col_ref": "im2col_ref"}
LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")
# the LM families still to port, and their ROADMAP items
NOT_PORTED_ITEMS = {"vlm": "queue A item 8 (A8b, the vlm family)",
                    "encdec": "queue A item 8 (A8c, the encdec family)"}
ATTN_IMPLS = ["auto", "xla", "chunked", "qloop", "flash"]


@dataclasses.dataclass
class Build:
    """Everything arch-specific the session needs."""
    cfg: object
    init: Callable                    # generator -> one replica's params
    loss: Callable                    # loss(params, batch) -> scalar
    make_stream: Callable             # () -> fresh host-batch iterator
    make_eval_batches: Callable       # () -> fresh held-out iterator
    eval_metric_fn: Callable          # (params, batch) -> {name: scalar}
    plateau_metric: str               # the metric the LR controller tracks


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="alexnet",
                    help="alexnet or a dense, moe or recurrent LM of the "
                    "zoo ("
                    + ", ".join(sorted(a for a, c in ARCHS.items()
                                       if c.family in LM_FAMILIES)) + ")")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--seq-len", type=int, default=128,
                    help="LM sequence length")
    ap.add_argument("--layers", type=int, default=None,
                    help="LM depth (with --smoke the reduced config's; "
                    "without, a depth cut of the published width)")
    ap.add_argument("--d-model", type=int, default=None,
                    help="LM width of the reduced config (--smoke only)")
    ap.add_argument("--faithful", action="store_true",
                    help="paper-faithful AlexNet: 2-group conv2/4/5 + LRN "
                    "after pool1/pool2; without it the legacy net")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32,
                    help="global batch, split over the replicas")
    ap.add_argument("--image-size", type=int, default=None,
                    help="override the config's image size (errors if the "
                    "conv stack cannot consume it)")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "mesh", "reference"],
                    help="mesh: one process per replica, exchanging "
                    "through torch.distributed collectives; reference: a "
                    "leading replica axis in one process; auto: mesh when "
                    "--replicas equals the number of cards and is above 1")
    ap.add_argument("--strategy", default="all_reduce",
                    choices=["all_reduce", "ring", "pairwise", "none"])
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--exchange-delay", type=int, default=0, choices=[0, 1],
                    help="0: exchange after the update (the paper's path); "
                    "1: exchange the incoming state one step stale and "
                    "graft the update onto it")
    ap.add_argument("--exchange-compression", default="none",
                    choices=["none", "bf16", "topk"],
                    help="bf16 halves the wire; topk sends the largest "
                    "entries of the delta from the consensus with "
                    "error-feedback residuals (needs --exchange-delay 1)")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="kept fraction per leaf for --exchange-compression "
                    "topk (1.0 = identity, bit-equal to none)")
    ap.add_argument("--replica-exec", default="vmap",
                    choices=["vmap", "scan"],
                    help="the reference's batched (vmap) or sequential "
                    "(scan) replicas; the port runs its replicas one after "
                    "another under either")
    ap.add_argument("--staging", default="queue",
                    choices=["queue", "pinned"],
                    help="queue = prefetch handoff queue; pinned = "
                    "preallocated pinned buffers, side-stream copies and "
                    "event-fenced reuse (CUDA only)")
    ap.add_argument("--optimizer", default="sgd_momentum",
                    choices=["sgd_momentum", "adamw"])
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "wsd", "cosine", "plateau"],
                    help="plateau = the paper's rule: divide the LR by 10 "
                    "when the validation metric plateaus (needs "
                    "--eval-every)")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--plateau-factor", type=float, default=0.1)
    ap.add_argument("--plateau-patience", type=int, default=2)
    ap.add_argument("--plateau-threshold", type=float, default=1e-3)
    ap.add_argument("--kernel-backend", default="auto", choices=BACKENDS,
                    help="KernelPolicy backend: auto runs the CUDA kernels "
                    "on the GPU and their plain versions on the CPU")
    ap.add_argument("--attn-impl", default=None, choices=ATTN_IMPLS,
                    help="LM attention: flash/auto = the flash kernels on "
                    "the GPU and their plain version on the CPU; xla = the "
                    "plain version (chunked and qloop are not ported)")
    ap.add_argument("--conv-backend", default="fused",
                    choices=sorted(CONV_BACKENDS),
                    help="fused = implicit-GEMM conv kernel; im2col_ref = "
                    "unfold + the matmul_bias kernel (parity path)")
    ap.add_argument("--numerics", default="fp32", choices=["fp32", "bf16"],
                    help="NumericsPolicy preset: bf16 = bf16 params and "
                    "compute, fp32 master weights, dynamic loss scaling")
    ap.add_argument("--kv-cache-dtype", default="auto",
                    choices=KV_CACHE_DTYPES,
                    help="decode KV-cache storage dtype of the LM's numerics "
                    "policy (serving only: training does not read it)")
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest complete checkpoint in "
                    "--ckpt-dir and continue (fresh start if it has none)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="validation pass every N steps (0 = off)")
    ap.add_argument("--eval-batches", type=int, default=2)
    ap.add_argument("--metrics-out", default=None,
                    help="JSONL trace path (train/eval/summary records); "
                    "implies a host sync per step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def check_ported(args) -> None:
    if args.arch != "alexnet":
        if args.arch not in ARCHS:
            raise SystemExit(f"unknown --arch {args.arch!r}; known: "
                             f"alexnet, {', '.join(sorted(ARCHS))}")
        family = ARCHS[args.arch].family
        if family not in LM_FAMILIES:
            raise not_ported(f"--arch {args.arch} ({family})",
                             NOT_PORTED_ITEMS.get(
                                 family, "queue A item 8 (the remaining LM "
                                 "families)"))
    if args.model_parallel != 1:
        raise not_ported("--model-parallel", "queue A item 12 (the model "
                         "axis needs two or more GPUs)")


def numerics_policy(args):
    """The ``--numerics`` preset, with ``--kv-cache-dtype`` over its KV
    cache dtype when set."""
    npol = get_policy(args.numerics)
    if args.kv_cache_dtype != "auto":
        npol = dataclasses.replace(npol, kv_cache_dtype=args.kv_cache_dtype)
    return npol


def build_cfg(args, error):
    if args.arch != "alexnet":
        return build_lm_cfg(args, error)
    if args.faithful:
        cfg = ALEXNET_FAITHFUL_SMOKE if args.smoke else ALEXNET_FAITHFUL
    else:
        cfg = ALEXNET_SMOKE if args.smoke else ALEXNET
    cfg = dataclasses.replace(cfg, kernels=KernelPolicy(
        backend=args.kernel_backend, conv2d=CONV_BACKENDS[args.conv_backend]),
        numerics=numerics_policy(args))
    if args.image_size is not None:
        try:
            cfg.feature_hw(args.image_size)   # conv/pool windows must fit
        except ValueError as e:
            error(str(e))
        cfg = dataclasses.replace(cfg, image_size=args.image_size)
    return cfg


def build_lm_cfg(args, error):
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
    return dataclasses.replace(
        cfg, kernels=KernelPolicy(backend=args.kernel_backend,
                                  attention=args.attn_impl),
        numerics=numerics_policy(args))


def build_lm(args, cfg, dev) -> Build:
    def stream(sample_seed=None):
        return synthetic.markov_lm(cfg.vocab_size, args.batch, args.seq_len,
                                   seed=args.seed, sample_seed=sample_seed)

    return Build(
        cfg, lambda gen: transformer.init(cfg, gen, device=dev),
        lambda params, batch: models.loss_fn(params, cfg, batch), stream,
        # the same Markov chain (its table from --seed), held-out path
        lambda: stream(args.seed + EVAL_SEED_OFFSET), lm_metrics(cfg),
        "loss")


def build_alexnet(args, cfg, dev) -> Build:
    make_stream, make_eval_batches = make_streams(cfg, args)

    def init_fn(gen):
        model = alexnet.init(cfg, gen, device=dev)
        return tree_map(lambda p: p.detach(), model.params())

    def loss(params, batch):
        return alexnet.loss_fn(params, cfg, batch["images"],
                               batch["labels"])

    return Build(cfg, init_fn, loss, make_stream, make_eval_batches,
                 alexnet_metrics(cfg), "top1_err")


def make_streams(cfg, args):
    """(make_stream, make_eval_batches) of host batches: the reference
    CLI's seeded blob streams, mean-subtracted, cropped and flipped."""
    size = cfg.image_size + 8
    mean = synthetic.mean_image(synthetic.blob_images(
        cfg.n_classes, args.batch, size, seed=args.seed + 1), 2)

    def stream(seed):
        # a fresh preprocess per stream: its RNG advances once per batch,
        # so resume's fast-forward replays crops and flips exactly
        prep = make_image_preprocess(mean, cfg.image_size, seed=seed)
        return map(prep, synthetic.blob_images(cfg.n_classes, args.batch,
                                               size, seed=seed))

    return (lambda: stream(args.seed),
            lambda: stream(args.seed + EVAL_SEED_OFFSET))


def make_controller(args):
    if args.schedule == "constant":
        return schedules.StaticController(schedules.constant(args.lr))
    if args.schedule == "wsd":
        return schedules.StaticController(
            schedules.wsd(args.lr, args.steps // 10,
                          int(args.steps * 0.7), args.steps // 5))
    if args.schedule == "cosine":
        return schedules.StaticController(
            schedules.cosine(args.lr, args.steps // 10, args.steps))
    return schedules.plateau_decay(
        args.lr, factor=args.plateau_factor, patience=args.plateau_patience,
        threshold=args.plateau_threshold)


def pick_engine(args, dev, error) -> str:
    """``--engine``, with ``auto`` resolved as the reference's CLI does:
    the mesh when the replicas match the cards one to one, and there are
    more than one."""
    engine = args.engine
    if engine == "auto":
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        engine = "mesh" if (n_dev > 1 and args.replicas == n_dev
                            and args.replica_exec == "vmap") \
            else "reference"
    if engine == "mesh" and args.replica_exec == "scan":
        error("--replica-exec scan is a reference-engine execution mode "
              "(the mesh engine runs one replica per device); use "
              "--engine reference")
    return engine


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    check_ported(args)
    if args.schedule == "plateau" and args.eval_every <= 0:
        ap.error("--schedule plateau needs --eval-every > 0 (the plateau "
                 "rule is driven by validation metrics)")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    if args.replicas < 1 or args.batch % args.replicas:
        ap.error(f"--batch {args.batch} must split over --replicas "
                 f"{args.replicas}")
    try:
        exch = ExchangeConfig(strategy=args.strategy,
                              compression=args.exchange_compression,
                              topk_frac=args.topk_frac,
                              delay=args.exchange_delay,
                              sync_every=args.sync_every)
    except ValueError as e:
        ap.error(str(e))
    dev = device_of(args.device)
    cfg = dataclasses.replace(build_cfg(args, ap.error), exchange=exch)
    engine = pick_engine(args, dev, ap.error)
    n_rep = args.replicas
    group = None
    if engine == "mesh":
        ranked = mesh.rank_from_env()
        if ranked is None:
            # the launcher: start the R ranks of this command line
            mesh.spawn_ranks("repro_torch.launch.train",
                             list(sys.argv[1:] if argv is None else argv),
                             n_rep)
            return None
        rank, world, init = ranked
        if world != n_rep:
            ap.error(f"rank {rank} of {world} for --replicas {n_rep}")
        dev = mesh.rank_device(rank, dev)
        group = mesh.init_replica_group(rank, world, init, dev)
    try:
        return train(args, cfg, exch, dev, engine, group)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


def train(args, cfg, exch, dev, engine, group):
    """One process's run: the whole of the reference engine's, or one
    rank's of the mesh engine's (``group``)."""
    fp32_numerics(dev)
    build = (build_alexnet if args.arch == "alexnet" else build_lm)(
        args, cfg, dev)
    n_rep = args.replicas
    rank = 0 if group is None else group.rank

    npol = cfg.numerics
    opt = for_numerics(get_optimizer(args.optimizer), npol)
    # a rank holds one replica: every replica starts the same
    state = init_param_avg_state(torch.Generator().manual_seed(args.seed),
                                 build.init, opt,
                                 n_rep if group is None else 1,
                                 exchange=exch, numerics=npol)
    policy = cfg.kernels.describe()
    n_params = sum(x[0].numel() for x in tree_leaves(state.params))
    if group is None:
        def build_step(sched):
            return make_param_avg_step(build.loss, opt, sched,
                                       strategy=exch, numerics=npol)

        def rows(b):
            return reshape_for_replicas(b, n_rep)
        eval_step = make_eval_step(build.eval_metric_fn)
    else:
        def build_step(sched):
            return make_mesh_param_avg_step(build.loss, opt, sched,
                                            group=group, strategy=exch,
                                            numerics=npol)

        def rows(b):
            # every rank draws the same host batch and keeps its row
            return tree_map(lambda x: x[rank:rank + 1],
                            reshape_for_replicas(b, n_rep))
        inner = make_eval_step(build.eval_metric_fn)

        def eval_step(params, batch):
            # the averaged model: the ranks' fp32 mean, cast back
            return inner(tree_map(lambda x: group.mean(x.float()).to(
                x.dtype), params), batch)
    session = TrainSession(
        state=state, build_step=build_step,
        make_stream=lambda: map(rows, build.make_stream()),
        controller=make_controller(args), steps=args.steps, device=dev,
        eval_step=eval_step if args.eval_every else None,
        make_eval_batches=build.make_eval_batches,
        eval_every=args.eval_every, eval_batches=args.eval_batches,
        plateau_metric=build.plateau_metric, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume,
        prefetch=args.prefetch, staging=args.staging,
        log_every=args.log_every, images_per_step=args.batch,
        metrics_path=args.metrics_out, group=group,
        # no "engine": a checkpoint of either engine resumes on the other
        run_meta={"kernels": policy, "numerics": npol.describe(),
                  "strategy": args.strategy,
                  "exchange": exch.describe(), "staging": args.staging,
                  "device": dev.type})
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    wire = "" if group is None else \
        f" backend={torch.distributed.get_backend()}"
    if rank == 0:
        print(f"arch={cfg.name} replicas={n_rep} devices={n_dev} "
              + ("" if args.arch == "alexnet" else
                 f"layers={cfg.n_layers} d_model={cfg.d_model} "
                 f"seq_len={args.seq_len} optimizer={args.optimizer} "
                 f"params={n_params} "
                 f"dtype={dtype_name(param_dtype(cfg))} ")
              + f"model_parallel=1 engine={engine}{wire} "
              f"exchange={exch.describe()} "
              f"replica_exec={'sequential' if group is None else 'ranks'} "
              f"staging={args.staging} "
              f"kernels={policy} numerics={npol.describe()} "
              f"device={dev.type} ({name})"
              + (f" resume_from={args.ckpt_dir}" if args.resume else ""),
              flush=True)
    result = session.run()
    spread = replica_spread(result.state.params) if group is None else \
        mesh_spread(result.state.params, group)
    if rank:
        return result
    summ = result.summary
    unit = "images" if args.arch == "alexnet" else "sequences"
    through = (f"; {unit}/sec {summ['images_per_sec']} "
               + ("" if args.arch == "alexnet" else
                  f"tokens/sec {summ['images_per_sec'] * args.seq_len:.1f} ")
               + f"p50 {summ.get('step_ms_p50')}ms "
               f"p99 {summ.get('step_ms_p99')}ms"
               if "images_per_sec" in summ else "")
    print(f"done: steps {result.start_step} -> {result.final_step}; "
          f"final loss "
          f"{result.losses[-1][1] if result.losses else float('nan'):.4f}; "
          f"replica spread {spread:.2e}" + through
          + (f"; lr drops at {result.lr_drops}" if result.lr_drops else ""),
          flush=True)
    return result


if __name__ == "__main__":
    main()
