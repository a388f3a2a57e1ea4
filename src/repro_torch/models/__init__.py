"""Model API of the port: init and the decode-state surface by family.

Only the conv family (AlexNet) is ported.  Image classification is one
forward pass, so its ``DecodeState`` carries an empty cache and ``pos``,
and the serving engine keeps none for it.  The LM families and
their DecodeState contract (``prefill`` / ``decode_step``) come with the
LM slices (ROADMAP queue A); asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.common import device_of
from repro_torch.models import alexnet

_NOT_PORTED = ("family {family!r} ({name}) is not ported to PyTorch yet: "
               "see ROADMAP.md queue A (the LM families and their "
               "DecodeState contract come with the LM slices)")


def _check_family(cfg) -> None:
    if cfg.family != "conv":
        raise NotImplementedError(
            _NOT_PORTED.format(family=cfg.family, name=cfg.name))


def init(cfg, generator: torch.Generator, *, device=None):
    """A randomly initialized model for ``cfg`` on ``device``."""
    _check_family(cfg)
    return alexnet.init(cfg, generator, device=device)


@dataclasses.dataclass
class DecodeState:
    """``cache`` is the family's state (empty for conv); ``pos`` (B,)
    int32 counts the tokens each row has consumed."""
    cache: Any
    pos: torch.Tensor


def init_decode_state(cfg, batch: int, capacity: int, *,
                      device=None) -> DecodeState:
    _check_family(cfg)
    # classification is one forward: there is no state to carry
    return DecodeState(cache={}, pos=torch.zeros(
        (batch,), dtype=torch.int32, device=device_of(device)))


def write_slots(state: DecodeState, sub: DecodeState, slots) -> DecodeState:
    """Scatter ``sub`` (batch = len(slots)) into ``state`` at ``slots``."""
    if state.cache or sub.cache:
        raise NotImplementedError("write_slots of a non-empty cache comes "
                                  "with the LM slices (ROADMAP queue A)")
    idx = torch.as_tensor(list(slots), dtype=torch.long,
                          device=state.pos.device)
    pos = state.pos.clone()
    pos[idx] = sub.pos.to(device=pos.device, dtype=pos.dtype)
    return DecodeState(cache={}, pos=pos)
