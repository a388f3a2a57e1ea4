"""Training CLI of the port: the paper's parameter-averaging data
parallelism for AlexNet on one GPU (or, when asked, on the CPU).

Builds the model, loss and data streams, the SGD-momentum optimizer, the
LR controller and the exchange, and hands the loop to
``repro_torch.train_loop.TrainSession`` (checkpoint/resume, eval +
plateau LR, Table-1 metrics).  The R replicas live on the one device
with a leading replica axis and run one after another; after every
update they exchange and average their weights and momentum.

    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --faithful --replicas 2 --batch 256 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --smoke --steps 2 --batch 8 --replicas 2 --device cpu
    # checkpoint every 10 steps, then pick up where a killed run stopped:
    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --smoke --device cpu --steps 100 --ckpt-dir ck --ckpt-every 10 \\
        --resume

It runs on ``cuda`` unless ``--device cpu`` is given, and exits non-zero
when CUDA is asked for and absent.  On the GPU it trains in fp32 with
TF32 off and deterministic cuDNN algorithms.  Weights are random from
``--seed`` through ``torch.Generator``, so they differ from the JAX
CLI's for the same seed; the data streams are the same numpy streams.
The LM archs, the mesh engine, model parallelism, bf16 numerics and the
overlapped / compressed exchange are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import (ALEXNET, ALEXNET_FAITHFUL,
                                 ALEXNET_FAITHFUL_SMOKE, ALEXNET_SMOKE)
from repro_torch.core.param_avg import ExchangeConfig, replica_spread
from repro_torch.core.steps import (init_param_avg_state, make_eval_step,
                                    make_param_avg_step, reshape_for_replicas)
from repro_torch.data import synthetic
from repro_torch.data.preprocess import make_image_preprocess
from repro_torch.kernels.common import BACKENDS, KernelPolicy, device_of
from repro_torch.models import alexnet
from repro_torch.optim import schedules
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.train_loop import (EVAL_SEED_OFFSET, TrainSession,
                                    alexnet_metrics)
from repro_torch.tree import tree_map

CONV_BACKENDS = {"fused": None, "im2col_ref": "im2col_ref"}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md "
                               f"{item}")


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="alexnet",
                    help="only alexnet is ported so far")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
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
                    help="reference: a leading replica axis on one device "
                    "(auto picks it); the mesh engine is not ported")
    ap.add_argument("--strategy", default="all_reduce",
                    choices=["all_reduce", "ring", "pairwise", "none"])
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--exchange-delay", type=int, default=0, choices=[0, 1])
    ap.add_argument("--exchange-compression", default="none",
                    choices=["none", "bf16", "topk"])
    ap.add_argument("--staging", default="queue",
                    choices=["queue", "pinned"],
                    help="queue = prefetch handoff queue; pinned = "
                    "preallocated pinned buffers, side-stream copies and "
                    "event-fenced reuse (CUDA only)")
    ap.add_argument("--optimizer", default="sgd_momentum",
                    choices=["sgd_momentum"])
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
    ap.add_argument("--conv-backend", default="fused",
                    choices=sorted(CONV_BACKENDS),
                    help="fused = implicit-GEMM conv kernel; im2col_ref = "
                    "unfold + the matmul_bias kernel (parity path)")
    ap.add_argument("--numerics", default="fp32", choices=["fp32", "bf16"])
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
        raise not_ported(f"--arch {args.arch}", "queue A items 7-8 (the "
                         "LM families come with the LM training slice)")
    if args.model_parallel != 1:
        raise not_ported("--model-parallel", "queue A item 12 (the model "
                         "axis needs two or more GPUs)")
    if args.engine == "mesh":
        raise not_ported("--engine mesh", "queue A item 4 (the "
                         "torch.distributed engine)")
    if args.numerics != "fp32":
        raise not_ported(f"--numerics {args.numerics}", "queue A item 6 "
                         "(the bf16 NumericsPolicy with fp32 master "
                         "weights)")


def build_cfg(args, error):
    if args.faithful:
        cfg = ALEXNET_FAITHFUL_SMOKE if args.smoke else ALEXNET_FAITHFUL
    else:
        cfg = ALEXNET_SMOKE if args.smoke else ALEXNET
    cfg = dataclasses.replace(cfg, kernels=KernelPolicy(
        backend=args.kernel_backend, conv2d=CONV_BACKENDS[args.conv_backend]))
    if args.image_size is not None:
        try:
            cfg.feature_hw(args.image_size)   # conv/pool windows must fit
        except ValueError as e:
            error(str(e))
        cfg = dataclasses.replace(cfg, image_size=args.image_size)
    return cfg


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


def fp32_numerics(device: torch.device) -> None:
    """fp32 end to end on the card, and deterministic library
    algorithms so a resumed run can repeat an uninterrupted one."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


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
    exch = ExchangeConfig(strategy=args.strategy,
                          compression=args.exchange_compression,
                          delay=args.exchange_delay,
                          sync_every=args.sync_every)
    dev = device_of(args.device)
    fp32_numerics(dev)
    cfg = build_cfg(args, ap.error)
    make_stream, make_eval_batches = make_streams(cfg, args)
    n_rep = args.replicas

    def init_fn(gen):
        model = alexnet.init(cfg, gen, device=dev)
        return tree_map(lambda p: p.detach(), model.params())

    def loss(params, batch):
        return alexnet.loss_fn(params, cfg, batch["images"],
                               batch["labels"])

    opt = get_optimizer(args.optimizer)
    state = init_param_avg_state(torch.Generator().manual_seed(args.seed),
                                 init_fn, opt, n_rep)
    policy = cfg.kernels.describe()
    session = TrainSession(
        state=state,
        build_step=lambda sched: make_param_avg_step(loss, opt, sched,
                                                     strategy=exch),
        make_stream=lambda: map(lambda b: reshape_for_replicas(b, n_rep),
                                make_stream()),
        controller=make_controller(args), steps=args.steps, device=dev,
        eval_step=make_eval_step(alexnet_metrics(cfg))
        if args.eval_every else None,
        make_eval_batches=make_eval_batches, eval_every=args.eval_every,
        eval_batches=args.eval_batches,
        plateau_metric="top1_err", ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume,
        prefetch=args.prefetch, staging=args.staging,
        log_every=args.log_every, images_per_step=args.batch,
        metrics_path=args.metrics_out,
        run_meta={"kernels": policy, "numerics": args.numerics,
                  "engine": "reference", "strategy": args.strategy,
                  "exchange": exch.describe(), "staging": args.staging,
                  "device": dev.type})
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"arch={cfg.name} replicas={n_rep} devices={n_dev} "
          f"model_parallel=1 engine=reference exchange={exch.describe()} "
          f"replica_exec=sequential staging={args.staging} "
          f"kernels={policy} numerics={args.numerics} device={dev.type} "
          f"({name})" + (f" resume_from={args.ckpt_dir}" if args.resume
                         else ""), flush=True)
    result = session.run()
    spread = replica_spread(result.state.params)
    summ = result.summary
    through = (f"; images/sec {summ['images_per_sec']} "
               f"p50 {summ.get('step_ms_p50')}ms "
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
