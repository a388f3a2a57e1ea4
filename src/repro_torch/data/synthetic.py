"""Synthetic data with learnable structure, a numpy copy of
``repro/data/synthetic.py`` (``markov_lm``, ``blob_images``,
``mean_image``): the same seed gives the same arrays bit for bit.  The
port keeps its own copy because ``repro.data`` imports JAX.

``markov_lm``: tokens drawn from a sharp random Markov chain; a model
that learns the transition table reaches low loss.  ``blob_images``:
class-conditional Gaussian blobs at class-dependent locations over
Gaussian noise; AlexNet learns it in a few hundred steps.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

MAX_DENSE_STATES = 4096


def markov_lm(vocab: int, batch: int, seq_len: int, seed: int = 0,
              sharpness: float = 8.0,
              sample_seed: int = None) -> Iterator[dict]:
    """For vocab > MAX_DENSE_STATES the chain runs over K superstates and
    each token is drawn uniformly inside its superstate's block (a dense
    V x V table at LM vocabs would need tens of GB).  ``sample_seed``
    draws another sample path over the same table (which comes from
    ``seed`` alone): the held-out stream of the same language."""
    rng = np.random.default_rng(seed)
    k = min(vocab, MAX_DENSE_STATES)
    block = vocab // k
    logits = rng.normal(size=(k, k)) * sharpness / np.sqrt(k)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    cum = np.cumsum(probs, axis=-1)
    if sample_seed is not None:       # same table, independent sample path
        rng = np.random.default_rng(sample_seed)
    while True:
        states = np.empty((batch, seq_len), np.int32)
        states[:, 0] = rng.integers(0, k, size=batch)
        u = rng.random((batch, seq_len))
        for t in range(1, seq_len):
            states[:, t] = np.minimum(
                (cum[states[:, t - 1]] < u[:, t:t + 1]).sum(-1), k - 1)
        if block > 1:
            toks = (states * block
                    + rng.integers(0, block, size=states.shape)).astype(
                        np.int32)
        else:
            toks = states
        yield {"tokens": toks, "labels": toks.copy()}


def blob_images(n_classes: int, batch: int, size: int, channels: int = 3,
                seed: int = 0, noise: float = 0.35,
                task_seed: int = 12345) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    # the TASK (class centers/colors) is fixed by task_seed so differently
    # seeded streams (train/eval/mean) describe the same classes
    task_rng = np.random.default_rng(task_seed)
    centers = task_rng.uniform(0.2, 0.8, size=(n_classes, 2))
    colors = task_rng.uniform(0.3, 1.0, size=(n_classes, channels))
    yy, xx = np.mgrid[0:size, 0:size] / size
    while True:
        labels = rng.integers(0, n_classes, size=batch).astype(np.int32)
        imgs = rng.normal(scale=noise, size=(batch, size, size, channels))
        for i, lab in enumerate(labels):
            cy, cx = centers[lab]
            blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 0.02))
            imgs[i] += blob[..., None] * colors[lab]
        yield {"images": imgs.astype(np.float32), "labels": labels}


def mean_image(it: Iterator[dict], n_batches: int = 4) -> np.ndarray:
    acc, n = 0.0, 0
    for _ in range(n_batches):
        b = next(it)["images"]
        acc = acc + b.sum(0)
        n += b.shape[0]
    return (acc / n).astype(np.float32)
