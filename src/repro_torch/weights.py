"""The weight bridge between the reference's AlexNet params and the port.

The reference keeps params as a pytree (``repro/models/alexnet.py``
``init``): ``{"convs": [{"w": (K,K,Cin/G,Cout), "b": (Cout,)}, ...],
"fcs": [{"w": (in,out), "b": (out,)}, ...]}``.  The port's ``AlexNet``
holds the same arrays in the same layouts, so the bridge copies them
bit for bit in both directions.  Arrays cross as numpy (convert JAX
arrays with ``np.asarray``).

``state_from_reference`` / ``state_to_reference`` do the same for a
parameter-averaging ``TrainState``: params and ``{"velocity": ...}``
with a leading replica axis R, and the step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.steps import TrainState
from repro_torch.kernels.common import device_of
from repro_torch.models import alexnet
from repro_torch.tree import tree_map


@torch.no_grad()
def from_reference(params, cfg, *, device=None) -> alexnet.AlexNet:
    """An ``AlexNet`` for ``cfg`` on ``device`` holding ``params``."""
    model = alexnet.AlexNet(cfg, device=device)
    for group, ws, bs in (("convs", model.conv_w, model.conv_b),
                          ("fcs", model.fc_w, model.fc_b)):
        layers = params[group]
        if len(layers) != len(ws):
            raise ValueError(f"{group}: {len(layers)} layers, {cfg.name} "
                             f"has {len(ws)}")
        for i, (layer, w, b) in enumerate(zip(layers, ws, bs)):
            for key, dst in (("w", w), ("b", b)):
                src = np.asarray(layer[key])
                if src.shape != tuple(dst.shape) or src.dtype != np.float32:
                    raise ValueError(
                        f"{group}[{i}].{key}: got {src.dtype}{src.shape}, "
                        f"expected float32{tuple(dst.shape)}")
                dst.copy_(torch.tensor(src))
    return model


def to_reference(model: alexnet.AlexNet) -> dict:
    """The model's params as the reference's pytree of numpy arrays."""
    def host(t):
        return t.detach().cpu().numpy().copy()

    return {
        "convs": [{"w": host(w), "b": host(b)}
                  for w, b in zip(model.conv_w, model.conv_b)],
        "fcs": [{"w": host(w), "b": host(b)}
                for w, b in zip(model.fc_w, model.fc_b)],
    }


def _stacked_shapes(cfg, n_rep: int) -> dict:
    shapes = alexnet.param_shapes(cfg)
    return {group: [{"w": (n_rep,) + w, "b": (n_rep,) + b}
                    for w, b in shapes[group]]
            for group in ("convs", "fcs")}


@torch.no_grad()
def state_from_reference(state, cfg, *, device=None) -> TrainState:
    """The port's ``TrainState`` on ``device`` for the reference's (any
    object with ``params``, ``opt_state`` and ``step``): the SGD-momentum
    state of R replicas, copied bit for bit."""
    dev = device_of(device)
    n_rep = np.asarray(state.params["convs"][0]["w"]).shape[0]
    shapes = _stacked_shapes(cfg, n_rep)

    def leaf(src, shape):
        arr = np.asarray(src)
        if arr.shape != shape or arr.dtype != np.float32:
            raise ValueError(f"got {arr.dtype}{arr.shape}, expected "
                             f"float32{shape}")
        return torch.tensor(arr, device=dev)

    def tree(src):
        return {g: [{k: leaf(layer[k], sh[k]) for k in ("w", "b")}
                    for layer, sh in zip(src[g], shapes[g], strict=True)]
                for g in ("convs", "fcs")}

    return TrainState(tree(state.params),
                      {"velocity": tree(state.opt_state["velocity"])},
                      int(np.asarray(state.step)))


def state_to_reference(state: TrainState) -> dict:
    """The state as the reference's ``TrainState`` fields, numpy arrays:
    ``repro.core.TrainState(**state_to_reference(s))`` rebuilds it."""
    def host(t):
        return t.detach().cpu().numpy().copy()

    return {"params": tree_map(host, state.params),
            "opt_state": tree_map(host, state.opt_state),
            "step": np.asarray(state.step, np.int32)}
