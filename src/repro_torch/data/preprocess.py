"""Image preprocessing, the paper's loader-side transforms (footnote 2):
subtract the mean image, random crop, random horizontal flip.  A numpy
copy of ``repro/data/preprocess.py``, bit-identical for a seed; it runs
on the host in the loader thread.
"""
from __future__ import annotations

import numpy as np


def random_crop_flip(images: np.ndarray, crop: int, rng: np.random.Generator,
                     flip: bool = True) -> np.ndarray:
    """images (B, H, W, C) -> (B, crop, crop, C).  All random draws happen
    before the copies, in the reference's order; each image is one
    strided block copy (the reference's ``loop`` kernel)."""
    b, h, w, c = images.shape
    if h < crop or w < crop:
        raise ValueError(f"crop {crop} exceeds the {h}x{w} images")
    ys = rng.integers(0, h - crop + 1, size=b)
    xs = rng.integers(0, w - crop + 1, size=b)
    do_flip = rng.random(b) < 0.5 if flip else np.zeros(b, bool)
    out = np.empty((b, crop, crop, c), images.dtype)
    for i in range(b):
        patch = images[i, ys[i]:ys[i] + crop, xs[i]:xs[i] + crop]
        out[i] = patch[:, ::-1] if do_flip[i] else patch
    return out


def subtract_mean(images: np.ndarray, mean_image: np.ndarray) -> np.ndarray:
    return images.astype(np.float32) - mean_image.astype(np.float32)


def make_image_preprocess(mean_image: np.ndarray, crop: int, seed: int = 0):
    """A batch transform for the loaders; its RNG advances once per
    batch."""
    rng = np.random.default_rng(seed)

    def f(batch):
        imgs = subtract_mean(batch["images"], mean_image)
        return {**batch, "images": random_crop_flip(imgs, crop, rng)}

    return f
