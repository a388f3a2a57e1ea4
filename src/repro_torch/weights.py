"""The weight bridge between the reference's AlexNet params and the port.

The reference keeps params as a pytree (``repro/models/alexnet.py``
``init``): ``{"convs": [{"w": (K,K,Cin/G,Cout), "b": (Cout,)}, ...],
"fcs": [{"w": (in,out), "b": (out,)}, ...]}``.  The port's ``AlexNet``
holds the same arrays in the same layouts, so the bridge copies them
bit for bit in both directions.  Arrays cross as numpy (convert JAX
arrays with ``np.asarray``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import alexnet


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
