"""Resumable training sessions (the counterpart of
``repro/train_loop/session.py``).

A session owns the train loop:

    while step < total:
        batch   -> param-avg step (replicas one after another)
        every eval_every:  eval on a held-out stream
                           -> plateau controller (may divide the LR)
        every ckpt_every:  atomic checkpoint (arrays + session meta)

and makes it deterministic under kill/resume:

* **State**: the ``TrainState`` is checkpointed with its step counter and
  its loss-scale state (``numerics``, under loss scaling), and restored
  onto the session's device.
* **Data**: the streams are seeded iterators; the manifest records how
  many batches the train stream yielded, and resume rebuilds the stream
  and fast-forwards past exactly that many draws (which also replays the
  preprocess RNG).  Batches a killed run staged but never trained on are
  re-drawn identically.
* **Schedule**: the LR controller's decision state rides in the manifest
  meta, so a resumed session drops the LR at the same step.
* **Eval**: stateless by construction (``train_loop.eval``).
* **Mesh engine** (``group``, one replica per rank): every rank runs
  the session on its (1, ...) rows of the state and its row of each
  batch; rank 0 alone logs and writes metrics.  A checkpoint gathers the
  ranks' rows into the one-process engine's (R, ...) layout on rank 0,
  and a restore hands each rank its row, so ``--resume`` crosses
  engines both ways.

Bit-exact resume also needs the step itself to be deterministic: on the
CPU it is; on a GPU the library's conv-grad must run deterministic
algorithms (``torch.backends.cudnn.deterministic``, which the train CLI
sets), and what is left (the max-pool backward's atomics) is reported
by ``chip_smoke.py``, not assumed away.

Throughput is recorded per step and rolled up into the paper's Table 1
format (images/s and step-time percentiles) by ``train_loop.metrics``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import checkpoint
from repro_torch.core.steps import gather_state, local_state
from repro_torch.data.pipeline import make_loader, to_device
from repro_torch.optim import schedules
from repro_torch.train_loop.eval import run_eval, take
from repro_torch.train_loop.metrics import MetricsWriter
from repro_torch.tree import tree_map


@dataclasses.dataclass
class SessionResult:
    start_step: int              # 0 for fresh runs, N when resumed at N
    final_step: int
    state: Any
    losses: list                 # [(step, loss), ...] for the logged steps
    evals: list                  # [(step, {metric: float}), ...]
    lr_drops: list               # steps whose eval dropped the LR
    summary: dict                # Table-1 rollup (also last JSONL line)


class TrainSession:
    """See module docstring.  The model and engine stay with the caller:

    Args:
      state: freshly initialized ``TrainState`` (step 0); doubles as the
        restore template on resume.
      build_step: ``schedule -> step(state, batch)`` factory; called at
        start and again after every plateau LR drop.
      make_stream: zero-arg factory for the host-batch iterator from step
        0 (preprocess and replica reshape included, host arrays) — it must
        be re-creatable so resume can fast-forward a fresh copy.
      controller: LR controller (``schedules.as_controller`` accepts plain
        schedules too).
      device: where the state and the batches live.
      eval_step / make_eval_batches / eval_every: the validation loop; the
        controller is fed ``plateau_metric`` from each eval's averages.
      images_per_step: global batch items per step (Table 1's unit).
      run_meta: rides in the checkpoint manifest; resume warns when the
        resumed run's differs.
      group: the mesh engine's ``ReplicaGroup`` (None: one process).
    """

    def __init__(self, *, state, build_step: Callable, make_stream: Callable,
                 controller=None, steps: int, device, eval_step=None,
                 make_eval_batches=None, eval_every: int = 0,
                 eval_batches: int = 2, plateau_metric: str = "loss",
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 resume: bool = False, prefetch: int = 2,
                 staging: str = "queue", log_every: int = 10,
                 images_per_step: int = 0, metrics_path: Optional[str] = None,
                 run_meta: Optional[dict] = None, group=None):
        if resume and not ckpt_dir:
            raise ValueError("--resume needs a checkpoint directory")
        self.state = state
        self.build_step = build_step
        self.make_stream = make_stream
        self.controller = schedules.as_controller(
            controller if controller is not None
            else schedules.constant(0.01))
        self.steps = steps
        self.device = device
        self.device_put = to_device(device)
        self.eval_step = eval_step
        self.make_eval_batches = make_eval_batches
        self.eval_every = eval_every if eval_step is not None else 0
        self.eval_batches = eval_batches
        self.plateau_metric = plateau_metric
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.resume = resume
        self.prefetch = prefetch
        self.staging = staging
        self.log_every = log_every
        self.images_per_step = images_per_step
        self.metrics_path = metrics_path
        self.run_meta = run_meta or {}
        self.group = group
        self.lead = group is None or group.rank == 0   # logs and writes
        self._ff_batches = 0          # train batches to skip on resume
        self._eval_cache = None       # the eval batches never change

    def _try_restore(self) -> int:
        """Restore the latest complete checkpoint; returns the start step."""
        step = checkpoint.latest_step(self.ckpt_dir) if self.resume else None
        if step is None:
            return 0
        if self.group is None:
            self.state = checkpoint.restore(self.ckpt_dir, step, self.state,
                                            device=self.device)
        else:
            full = checkpoint.restore(self.ckpt_dir, step, self.state,
                                      device="cpu")
            self.state = tree_map(
                lambda x: x.to(self.device) if torch.is_tensor(x) else x,
                local_state(full, self.group.rank))
        meta = checkpoint.load_meta(self.ckpt_dir, step) or {}
        if "controller" in meta:
            self.controller.load_state_dict(meta["controller"])
        saved = meta.get("run_meta") or {}
        drift = {k: (saved.get(k), v) for k, v in self.run_meta.items()
                 if k in saved and saved.get(k) != v}
        if drift and self.lead:
            print("WARNING: resuming under a different configuration than "
                  "the checkpoint was written with — the continued loss "
                  "trace will NOT be bit-exact: "
                  + ", ".join(f"{k}: {a!r} -> {b!r}"
                              for k, (a, b) in sorted(drift.items())),
                  flush=True)
        self._ff_batches = meta.get("batches_consumed", step)
        return step

    def _save(self, step: int):
        state = self.state if self.group is None else \
            gather_state(self.state, self.group)
        if not self.lead:
            return
        checkpoint.save(
            self.ckpt_dir, step, state,
            meta={"controller": self.controller.state_dict(),
                  "batches_consumed": step,
                  "plateau_metric": self.plateau_metric,
                  "run_meta": self.run_meta})

    def _run_eval(self, step: int, writer, result: SessionResult) -> bool:
        """One validation pass; returns True iff the LR dropped."""
        if self._eval_cache is None:
            self._eval_cache = take(self.make_eval_batches(),
                                    self.eval_batches)
        avg = run_eval(self.eval_step, self.state.params, self._eval_cache,
                       self.device_put)
        dropped = self.controller.update(avg[self.plateau_metric])
        writer.eval(step, avg, dropped)
        result.evals.append((step, avg))
        if dropped:
            result.lr_drops.append(step)
        if dropped and self.lead:
            print(f"step {step:5d} eval "
                  f"{self.plateau_metric}={avg[self.plateau_metric]:.4f} "
                  f"plateaued -> lr {self.controller.lr:.2e}", flush=True)
        return dropped

    def run(self) -> SessionResult:
        start = self._try_restore() if self.ckpt_dir else 0
        result = SessionResult(start, start, self.state, [], [], [], {})
        if start >= self.steps:
            if self.lead:
                print(f"checkpoint at step {start} >= --steps "
                      f"{self.steps}; nothing to do", flush=True)
            return result

        writer = MetricsWriter(
            self.metrics_path if self.lead else None,
            images_per_step=self.images_per_step,
            resume_step=start if start else None)
        loader = None
        warming = True                    # the first step builds kernels
        t_session = time.perf_counter()
        try:
            stream = self.make_stream()
            for _ in range(self._ff_batches):   # deterministic fast-forward
                next(stream)
            loader = make_loader(stream, prefetch=self.prefetch,
                                 staging=self.staging,
                                 device_put=self.device_put,
                                 device=self.device)
            sched_fn = self.controller.schedule()
            step_fn = self.build_step(sched_fn)
            # a metrics trace needs the loss and honest wall time every
            # step, which costs a host sync per step; without it, sync
            # only at log boundaries
            per_step_sync = self.metrics_path is not None
            for i in range(start, self.steps):
                t0 = time.perf_counter()
                batch = next(loader)
                stage_wait_ms = loader.last_wait_ms
                self.state, loss = step_fn(self.state, batch)
                # pinned staging: the slot this batch occupies is reused
                # only after the work queued so far has finished
                loader.fence()
                at_log = (i + 1) % self.log_every == 0 or i == start
                if per_step_sync or at_log:
                    loss_f = float(loss)          # waits for the device
                    result.losses.append((i + 1, loss_f))
                if per_step_sync:
                    # the loss-scale state (bf16 preset) rides the
                    # TrainState as device scalars: trace it so a run's
                    # scale trajectory and skip count read from the JSONL
                    ns = getattr(self.state, "numerics", None)
                    writer.train(i + 1, loss_f, float(sched_fn(i)),
                                 time.perf_counter() - t0,
                                 timed=not warming,
                                 stage_wait_ms=stage_wait_ms,
                                 loss_scale=float(ns["scale"])
                                 if ns is not None else None,
                                 skipped_steps=int(ns["skipped"])
                                 if ns is not None else None)
                warming = False
                if at_log and self.lead:
                    print(f"step {i + 1:5d} loss {loss_f:.4f} "
                          f"({(time.perf_counter() - t_session) / (i + 1 - start):.3f}"
                          "s/step)", flush=True)
                if self.eval_every and (i + 1) % self.eval_every == 0:
                    if self._run_eval(i + 1, writer, result):
                        sched_fn = self.controller.schedule()
                        step_fn = self.build_step(sched_fn)
                if self.ckpt_dir and self.ckpt_every and \
                        (i + 1) % self.ckpt_every == 0:
                    self._save(i + 1)
                result.final_step = i + 1
        finally:
            if loader is not None:
                loader.close()            # never leak the worker thread
            result.state = self.state
            result.summary = writer.summary(result.final_step)
            writer.close()
        return result
