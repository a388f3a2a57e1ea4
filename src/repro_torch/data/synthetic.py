"""Synthetic image data with learnable structure, a numpy copy of
``repro/data/synthetic.py`` (``blob_images``, ``mean_image``): the same
seed gives the same arrays bit for bit.  The port keeps its own copy
because ``repro.data`` imports JAX.

``blob_images``: class-conditional Gaussian blobs at class-dependent
locations over Gaussian noise; AlexNet learns it in a few hundred steps.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


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
