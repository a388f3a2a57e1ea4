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
LR-controller state).

``pack_tree`` is the same container in one bytes buffer, the serving
tier's wire form of a slot snapshot:

    <8-byte little-endian manifest length><JSON {"arrays", "meta"}>
    <npz of the leaves' uint8 bytes>

so a buffer packed by either package unpacks in the other, every leaf
bit for bit; ``peek_meta`` reads the JSON header alone.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten_like


_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int32,
           torch.int64)


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


def _tensor(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """The leaf stored as ``raw`` (a uint8 array fresh from the npz, which
    the tensor takes over without a copy)."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).reshape(shape)).view(
            torch.bfloat16)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape))


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _leaves(tree) -> tuple:
    """(the manifest's ``arrays``, {key: the leaf's bytes as uint8})."""
    manifest, buffers = {}, {}
    for key, leaf in flatten_with_paths(tree).items():
        arr, dtype = _host(leaf)
        manifest[key] = {"dtype": dtype, "shape": list(arr.shape)}
        buffers[key] = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return manifest, buffers


def save(directory: str, step: int, tree: Any, meta: dict = None) -> str:
    """Write ``tree`` (+ optional JSON-serializable ``meta``) atomically."""
    final = step_dir(directory, step)
    d = final + ".tmp"
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    manifest, buffers = _leaves(tree)
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
            t = _tensor(data[key], m["dtype"], m["shape"])
            if isinstance(leaf, torch.Tensor):
                flat[key] = t.to(leaf.device if device is None else device)
            else:
                flat[key] = int(t.item())
    return unflatten_like(like, flat)


def pack_tree(tree: Any, meta: dict = None) -> bytes:
    """``tree`` (+ optional JSON-serializable ``meta``) as one buffer:
    ``save``'s manifest and leaf bytes with no filesystem."""
    manifest, buffers = _leaves(tree)
    head = json.dumps({"arrays": manifest, "meta": meta}).encode()
    bio = io.BytesIO()
    bio.write(len(head).to_bytes(8, "little"))
    bio.write(head)
    np.savez(bio, **buffers)
    return bio.getvalue()


def _header(buf: bytes) -> tuple:
    n = int.from_bytes(buf[:8], "little")
    return json.loads(buf[8:8 + n].decode()), 8 + n


def peek_meta(buf: bytes) -> dict | None:
    """The ``meta`` of a ``pack_tree`` buffer, from its JSON header alone
    (no arrays decoded, no ``like`` needed)."""
    return _header(buf)[0].get("meta")


def unpack_tree(buf: bytes, like: Any, *, device=None) -> tuple:
    """Inverse of ``pack_tree``: (the tree shaped like ``like``, meta).
    ``like`` gives the structure only: every leaf comes back as a tensor
    of the buffer's dtype and shape, on ``device`` (default the CPU)."""
    head, off = _header(buf)
    manifest = head["arrays"]
    flat = {}
    bio = io.BytesIO(buf)
    bio.seek(off)           # zipfile finds an archive behind a prefix
    with np.load(bio) as data:
        for key in flatten_with_paths(like):
            if key not in manifest:
                raise KeyError(f"packed tree has no array {key!r}")
            m = manifest[key]
            t = _tensor(data[key], m["dtype"], m["shape"])
            flat[key] = t if device is None else t.to(device)
    return unflatten_like(like, flat), head.get("meta")


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
