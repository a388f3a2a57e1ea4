"""The weight bridge between the reference's params and the port's.

AlexNet:

The reference keeps params as a pytree (``repro/models/alexnet.py``
``init``): ``{"convs": [{"w": (K,K,Cin/G,Cout), "b": (Cout,)}, ...],
"fcs": [{"w": (in,out), "b": (out,)}, ...]}``.  The port's ``AlexNet``
holds the same arrays in the same layouts, so the bridge copies them
bit for bit in both directions.  Arrays cross as numpy (convert JAX
arrays with ``np.asarray``).

The LMs (dense, moe, ssm, hybrid): ``lm_from_reference`` / ``lm_to_reference`` copy the
reference's params tree (``repro.models.init``) as it is, tuples and the
empty ``{}`` of a non-parametric norm included; leaves keep their dtype
(bf16 crosses bit for bit as its 16-bit pattern; numpy names the type
only once ``ml_dtypes`` is imported, as JAX does).

``state_from_reference`` / ``state_to_reference`` do the same for a
parameter-averaging ``TrainState`` of either: params (in the config's
``param_dtype``, bf16 under the bf16 numerics preset) and the optimizer
state (``{"velocity"}`` for SGD, ``{"mu", "nu", "count"}`` for AdamW,
fp32, under ``{"master": fp32 masters, "inner": ...}`` with master
weights) with a leading replica axis R, the step, the delayed
exchange's state (``exchange``: ``base`` and fp32 ``residual``) and the
loss-scale state (``numerics``: scale, good_steps, skipped) when there
are.

``decode_state_from_reference`` / ``decode_state_to_reference`` carry a
serving ``DecodeState`` (the stacked ring KV cache, or the block pool,
and ``pos``) across, checked against ``init_decode_cache``'s shapes and
dtypes, so both packages can decode from the same cache.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import models
from repro_torch.core.steps import TrainState
from repro_torch.kernels.common import device_of
from repro_torch.models import alexnet, transformer
from repro_torch.numerics import dtype_name, param_dtype
from repro_torch.tree import flatten_with_paths, tree_map


def to_torch(arr, device=None) -> torch.Tensor:
    """A numpy (or JAX) array as a tensor on ``device``, bit for bit;
    bfloat16 arrays cross as their 16-bit patterns."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array, bit for bit (bf16 as numpy's
    ``bfloat16``, which exists once ``ml_dtypes`` is imported)."""
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise RuntimeError("numpy names bfloat16 only once ml_dtypes is "
                           "imported (JAX imports it)") from None
    return t.view(torch.int16).numpy().view(bf16).copy()


def _is_shape(t) -> bool:
    """A leaf of a shapes tree: a non-empty tuple of ints (``()`` is an
    empty subtree, as ``rem_blocks``)."""
    return bool(t) and all(isinstance(i, int) for i in t)


def _convert(src, shapes, dtype, device, path="params"):
    """``src`` (a tree of arrays) as tensors, checked against ``shapes``
    (dicts and tuples of subtrees, tuples of ints at the leaves)."""
    if isinstance(shapes, dict):
        if not isinstance(src, dict) or set(src) != set(shapes):
            got = sorted(src) if isinstance(src, dict) else type(src)
            raise ValueError(f"{path}: keys {got}, expected "
                             f"{sorted(shapes)}")
        return {k: _convert(src[k], shapes[k], dtype, device, f"{path}/{k}")
                for k in shapes}
    if not _is_shape(shapes):
        if not isinstance(src, (tuple, list)) or len(src) != len(shapes):
            raise ValueError(f"{path}: expected a tuple of {len(shapes)}")
        return tuple(_convert(a, b, dtype, device, f"{path}/{i}")
                     for i, (a, b) in enumerate(zip(src, shapes)))
    arr = np.asarray(src)
    want = dtype_name(dtype)
    if tuple(arr.shape) != tuple(shapes) or arr.dtype.name != want:
        raise ValueError(f"{path}: got {arr.dtype.name}{arr.shape}, "
                         f"expected {want}{tuple(shapes)}")
    return to_torch(arr, device)


def _prefixed(shapes, n: int):
    """``shapes`` with a leading axis of ``n`` on every leaf."""
    if isinstance(shapes, dict):
        return {k: _prefixed(v, n) for k, v in shapes.items()}
    if _is_shape(shapes):
        return (n,) + tuple(shapes)
    return tuple(_prefixed(v, n) for v in shapes)


@torch.no_grad()
def lm_from_reference(params, cfg, *, device=None) -> dict:
    """The reference's LM params tree as the port's, on ``device``
    (checked against ``cfg``'s shapes and param dtype)."""
    return _convert(params, transformer.param_shapes(cfg), param_dtype(cfg),
                    device_of(device))


def lm_to_reference(params) -> dict:
    """The port's params tree as numpy arrays in the reference's tree."""
    return tree_map(to_numpy, params)


@torch.no_grad()
def from_reference(params, cfg, *, device=None) -> alexnet.AlexNet:
    """An ``AlexNet`` for ``cfg`` on ``device`` holding ``params`` (in
    the config's param dtype, bit for bit)."""
    model = alexnet.AlexNet(cfg, device=device)
    want = dtype_name(param_dtype(cfg))
    for group, ws, bs in (("convs", model.conv_w, model.conv_b),
                          ("fcs", model.fc_w, model.fc_b)):
        layers = params[group]
        if len(layers) != len(ws):
            raise ValueError(f"{group}: {len(layers)} layers, {cfg.name} "
                             f"has {len(ws)}")
        for i, (layer, w, b) in enumerate(zip(layers, ws, bs)):
            for key, dst in (("w", w), ("b", b)):
                src = np.asarray(layer[key])
                if src.shape != tuple(dst.shape) or src.dtype.name != want:
                    raise ValueError(
                        f"{group}[{i}].{key}: got {src.dtype}{src.shape}, "
                        f"expected {want}{tuple(dst.shape)}")
                dst.copy_(to_torch(src))
    return model


def to_reference(model: alexnet.AlexNet) -> dict:
    """The model's params as the reference's pytree of numpy arrays."""
    return {
        "convs": [{"w": to_numpy(w), "b": to_numpy(b)}
                  for w, b in zip(model.conv_w, model.conv_b)],
        "fcs": [{"w": to_numpy(w), "b": to_numpy(b)}
                for w, b in zip(model.fc_w, model.fc_b)],
    }


def _stacked_shapes(cfg, n_rep: int) -> dict:
    shapes = alexnet.param_shapes(cfg)
    return {group: [{"w": (n_rep,) + w, "b": (n_rep,) + b}
                    for w, b in shapes[group]]
            for group in ("convs", "fcs")}


def _opt_from_reference(src, params_tree, n_rep, dev, path="opt_state"):
    """The reference's optimizer state: ``count`` (AdamW's step count, one
    per replica) int32, ``inner`` (the wrapped optimizer's state under
    master weights) recursively, every other entry (velocity, mu, nu,
    master) an fp32 tree shaped like the params, via ``params_tree(src,
    dtype, path)``."""
    out = {}
    for key, sub in src.items():
        at = f"{path}/{key}"
        if key == "count":
            out[key] = _convert(sub, (n_rep,), torch.int32, dev, at)
        elif key == "inner":
            out[key] = _opt_from_reference(sub, params_tree, n_rep, dev, at)
        else:
            out[key] = params_tree(sub, torch.float32, at)
    return out


def _exchange_from_reference(aux, params, opt_state, dev):
    """The delayed exchange's state (None, or ``base`` shaped and typed
    like (params, opt_state) and ``residual`` fp32 of the same shapes),
    each leaf checked against the converted state."""
    if aux is None:
        return None

    def like(src, tmpl, dtype, path):
        if isinstance(tmpl, dict):
            return {k: like(src[k], v, dtype, f"{path}/{k}")
                    for k, v in tmpl.items()}
        if isinstance(tmpl, (list, tuple)):
            if len(src) != len(tmpl):
                raise ValueError(f"{path}: {len(src)} entries, expected "
                                 f"{len(tmpl)}")
            return type(tmpl)(like(a, b, dtype, f"{path}/{i}")
                              for i, (a, b) in enumerate(zip(src, tmpl)))
        arr = np.asarray(src)
        want = dtype_name(dtype or tmpl.dtype)
        if tuple(arr.shape) != tuple(tmpl.shape) or arr.dtype.name != want:
            raise ValueError(f"{path}: got {arr.dtype.name}{arr.shape}, "
                             f"expected {want}{tuple(tmpl.shape)}")
        return to_torch(arr, dev)

    tree = (params, opt_state)
    return {"base": like(aux["base"], tree, None, "exchange/base"),
            "residual": like(aux["residual"], tree, torch.float32,
                             "exchange/residual")}


def _numerics_from_reference(ns, dev):
    """The loss-scale state (None, or fp32 scale and int32 counters)."""
    if ns is None:
        return None
    kinds = {"scale": torch.float32, "good_steps": torch.int32,
             "skipped": torch.int32}
    out = {}
    for k, dt in kinds.items():
        arr = np.asarray(ns[k])
        if arr.shape != () or arr.dtype.name != dtype_name(dt):
            raise ValueError(f"numerics/{k}: got {arr.dtype.name}"
                             f"{arr.shape}, expected {dtype_name(dt)}()")
        out[k] = to_torch(arr, dev)
    return out


@torch.no_grad()
def state_from_reference(state, cfg, *, device=None) -> TrainState:
    """The port's ``TrainState`` on ``device`` for the reference's (any
    object with ``params``, ``opt_state`` and ``step``, and optionally
    ``exchange`` and ``numerics``): R replicas' params, optimizer state
    (masters included), the delayed exchange's base and residual and the
    loss-scale state, copied bit for bit."""
    if cfg.family != "conv":
        return _lm_state_from_reference(state, cfg, device)
    dev = device_of(device)
    n_rep = np.asarray(state.params["convs"][0]["w"]).shape[0]
    shapes = _stacked_shapes(cfg, n_rep)

    def leaf(src, shape, dtype, path):
        arr = np.asarray(src)
        want = dtype_name(dtype)
        if arr.shape != shape or arr.dtype.name != want:
            raise ValueError(f"{path}: got {arr.dtype}{arr.shape}, expected "
                             f"{want}{shape}")
        return to_torch(arr, dev)

    def tree(src, dtype, path="params"):
        return {g: [{k: leaf(layer[k], sh[k], dtype, f"{path}/{g}/{i}/{k}")
                     for k in ("w", "b")}
                    for i, (layer, sh) in enumerate(
                        zip(src[g], shapes[g], strict=True))]
                for g in ("convs", "fcs")}

    params = tree(state.params, param_dtype(cfg))
    opt = _opt_from_reference(state.opt_state, tree, n_rep, dev)
    return TrainState(params, opt, int(np.asarray(state.step)),
                      _exchange_from_reference(
                          getattr(state, "exchange", None), params, opt,
                          dev),
                      _numerics_from_reference(
                          getattr(state, "numerics", None), dev))


def _lm_state_from_reference(state, cfg, device) -> TrainState:
    dev = device_of(device)
    leaves = []
    tree_map(leaves.append, state.params["embed"])
    n_rep = np.asarray(leaves[0]).shape[0]
    shapes = _prefixed(transformer.param_shapes(cfg), n_rep)
    params = _convert(state.params, shapes, param_dtype(cfg), dev)
    opt = _opt_from_reference(
        state.opt_state,
        lambda src, dt, path: _convert(src, shapes, dt, dev, path), n_rep,
        dev)
    return TrainState(params, opt, int(np.asarray(state.step)),
                      _exchange_from_reference(
                          getattr(state, "exchange", None), params, opt,
                          dev),
                      _numerics_from_reference(
                          getattr(state, "numerics", None), dev))


def state_to_reference(state: TrainState) -> dict:
    """The state as the reference's ``TrainState`` fields, numpy arrays:
    ``repro.core.TrainState(**state_to_reference(s))`` rebuilds it."""
    return {"params": tree_map(to_numpy, state.params),
            "opt_state": tree_map(to_numpy, state.opt_state),
            "step": np.asarray(state.step, np.int32),
            "exchange": tree_map(to_numpy, state.exchange),
            "numerics": tree_map(to_numpy, state.numerics)}


@torch.no_grad()
def decode_state_from_reference(state, cfg, *, device=None):
    """The port's ``DecodeState`` on ``device`` for the reference's (any
    object with ``cache`` and ``pos``): each leaf checked against
    ``init_decode_cache`` at the reference's batch and capacity (a block
    pool is a cache whose batch is the block count) and copied bit for
    bit; ``pos`` int32."""
    dev = device_of(device)
    cache = state.cache
    k = np.asarray(cache["blocks"][0]["k"])
    like = models.init_decode_cache(cfg, k.shape[1], k.shape[2],
                                    device="meta")
    got, want = (sorted(flatten_with_paths(t)) for t in (cache, like))
    if got != want:
        raise ValueError(f"decode cache leaves {got}, expected {want}")

    def one(src, want, axis):
        arr = np.asarray(src)
        dt = dtype_name(want.dtype)
        if tuple(arr.shape) != tuple(want.shape) or arr.dtype.name != dt:
            raise ValueError(f"decode cache leaf: got {arr.dtype.name}"
                             f"{arr.shape}, expected {dt}"
                             f"{tuple(want.shape)}")
        return to_torch(arr, dev)

    pos = np.asarray(state.pos)
    if pos.ndim != 1 or pos.dtype != np.int32:
        raise ValueError(f"pos: got {pos.dtype}{pos.shape}, expected "
                         "int32 (B,)")
    return models.DecodeState(cache=models.map_cache(one, cache, like),
                              pos=to_torch(pos, dev))


def decode_state_to_reference(state) -> dict:
    """The state as the reference's ``DecodeState`` fields, numpy arrays:
    ``repro.models.DecodeState(**decode_state_to_reference(s))``."""
    return {"cache": tree_map(to_numpy, state.cache),
            "pos": to_numpy(state.pos)}
