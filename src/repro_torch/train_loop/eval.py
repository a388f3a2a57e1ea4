"""Validation metrics and held-out streams for the session's eval loop
(the counterpart of ``repro/train_loop/eval.py``).

Eval streams are stateless across the session: each pass rebuilds a
freshly seeded stream and takes its first ``n`` batches, so validation
is a pure function of the parameters and adds no resume state.  The eval
seed is offset from the train seed so the two streams never share draws.
"""
from __future__ import annotations

from typing import Callable

import torch

EVAL_SEED_OFFSET = 100_003        # train seed + this = eval stream seed


def alexnet_metrics(cfg) -> Callable:
    """(params, batch{images,labels}) -> {loss, top1_err} (0-d tensors)."""
    from repro_torch.models import alexnet
    from repro_torch.models.layers import softmax_xent

    def metric_fn(params, batch):
        logits = alexnet.forward(params, cfg, batch["images"])
        labels = batch["labels"].long()
        loss = softmax_xent(logits[:, None, :], labels[:, None])
        top1 = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss, "top1_err": 1.0 - top1}

    return metric_fn


def lm_metrics(cfg) -> Callable:
    """(params, batch{tokens,labels}) -> {loss, perplexity} (0-d
    tensors) for the LMs, on the kernels ``cfg.kernels`` selects."""
    from repro_torch import models

    def metric_fn(params, batch):
        loss = models.loss_fn(params, cfg, batch)
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return metric_fn


def take(stream, n: int) -> list:
    """The first ``n`` host batches of an iterator."""
    it = iter(stream)
    return [next(it) for _ in range(n)]


def run_eval(eval_step, params, batches, device_put) -> dict:
    """``eval_step``'s metrics averaged over host ``batches``, as floats
    (the host-side plateau controller consumes these)."""
    acc: dict = {}
    with torch.no_grad():
        for b in batches:
            for k, v in eval_step(params, device_put(b)).items():
                acc[k] = acc.get(k, 0.0) + float(v)
    return {k: v / len(batches) for k, v in acc.items()}
