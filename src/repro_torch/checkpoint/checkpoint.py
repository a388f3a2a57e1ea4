"""Tree checkpointing in the reference's on-disk format (the counterpart
of ``repro/checkpoint/checkpoint.py``): raw bytes in an npz plus a JSON
manifest, so a checkpoint written by either package restores in the
other.

    <dir>/step_<N>/manifest.json  {"step", "arrays": {key: {dtype, shape}},
                                   "meta"}
    <dir>/step_<N>/arrays.npz     key = flattened tree path, value = the
                                   leaf's bytes as uint8

Keys are ``repro_torch.tree.flatten_with_paths`` paths, which are the
reference's (``.params/convs/0/w`` for a ``TrainState``, tuple entries
by index, an empty ``{}`` contributing no key).  bfloat16 leaves are
stored as their 16-bit patterns under the dtype name ``bfloat16``, as the
reference stores them.  A Python int leaf (the port's
``TrainState.step``) is stored as an int32 scalar, as the reference
stores its step.  Writes are atomic: into
``step_<N>.tmp``, then renamed; ``latest_step`` skips incomplete
directories.  ``meta`` carries host-side session state (stream position,
LR-controller state).  ``pack_tree`` waits for the serving tier.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten_like


_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int64)


def _host(leaf):
    """(the leaf's bytes as a numpy array, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _DTYPES:
            raise ValueError(f"cannot checkpoint a {leaf.dtype} leaf")
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:   # numpy has no bfloat16 of its own
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, bool) or not isinstance(leaf, int):
        raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")
    return np.asarray(leaf, np.int32), "int32"


def _tensor(buf: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.frombuffer(buf, np.int16).reshape(
            shape).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(dtype)).reshape(
        shape).copy())


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree: Any, meta: dict = None) -> str:
    """Write ``tree`` (+ optional JSON-serializable ``meta``) atomically."""
    final = step_dir(directory, step)
    d = final + ".tmp"
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    manifest, buffers = {}, {}
    for key, leaf in flatten_with_paths(tree).items():
        arr, dtype = _host(leaf)
        manifest[key] = {"dtype": dtype, "shape": list(arr.shape)}
        buffers[key] = np.frombuffer(arr.tobytes(), np.uint8)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"step": step, "arrays": manifest, "meta": meta}, f)
    np.savez(os.path.join(d, "arrays.npz"), **buffers)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(d, final)
    return final


def restore(directory: str, step: int, like: Any, *, device=None) -> Any:
    """The tree saved at ``step``, shaped like ``like`` (its values are
    ignored).  Tensor leaves land on ``device`` (default: the device of
    ``like``'s leaf); int leaves come back as ints."""
    d = step_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)["arrays"]
    flat = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, leaf in flatten_with_paths(like).items():
            if key not in manifest:
                raise KeyError(f"checkpoint {d} has no array {key!r}")
            m = manifest[key]
            t = _tensor(data[key].tobytes(), m["dtype"], m["shape"])
            if isinstance(leaf, torch.Tensor):
                flat[key] = t.to(leaf.device if device is None else device)
            else:
                flat[key] = int(t.item())
    return unflatten_like(like, flat)


def load_meta(directory: str, step: int) -> dict | None:
    """The ``meta`` dict stored with ``save`` (None when absent)."""
    with open(os.path.join(step_dir(directory, step), "manifest.json")) as f:
        return json.load(f).get("meta")


def _complete(d: str) -> bool:
    """A checkpoint directory is resumable iff its manifest parses and
    its arrays exist."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            json.load(f)
    except (OSError, ValueError):
        return False
    return os.path.isfile(os.path.join(d, "arrays.npz"))


def latest_step(directory: str) -> int | None:
    """The largest step with a complete checkpoint (``.tmp`` directories
    of interrupted saves and corrupt ones are skipped)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", name))
             and _complete(os.path.join(directory, name))]
    return max(steps) if steps else None
