"""Model API of the port: init, logits, loss and the decode-state surface
by family (the counterpart of ``repro/models/__init__.py``).

Ported: the conv family (AlexNet) and the ``dense`` LM family
(``transformer``).  ``init`` returns an ``AlexNet`` module for conv and a
params tree in the reference's structure for dense; ``logits_fn`` /
``loss_fn`` take a params tree and a batch dict for both.  The LM loss is
next-token cross-entropy: ``logits[:, :-1]`` against ``labels[:, 1:]``.

Image classification is one forward pass, so its ``DecodeState`` carries
an empty cache and ``pos``.  The other LM families (moe, ssm, hybrid,
vlm, encdec) and the LM DecodeState contract (``prefill`` /
``decode_step``) come with later slices (ROADMAP queue A); asking for
them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.common import device_of
from repro_torch.models import alexnet, transformer
from repro_torch.models.layers import softmax_xent

_NOT_PORTED = ("family {family!r} ({name}) is not ported to PyTorch yet: "
               "see ROADMAP.md queue A ({what})")
FAMILIES = ("conv", "dense")
_DECODE = "items 9-11, the LM decode surface"


def _check_family(cfg, families=FAMILIES, what="item 8, the remaining "
                  "LM families") -> None:
    if cfg.family not in families:
        raise NotImplementedError(_NOT_PORTED.format(
            family=cfg.family, name=cfg.name, what=what))


def init(cfg, generator: torch.Generator, *, device=None):
    """A randomly initialized model for ``cfg`` on ``device``: an
    ``AlexNet`` for conv, a params tree for dense."""
    _check_family(cfg)
    if cfg.family == "conv":
        return alexnet.init(cfg, generator, device=device)
    return transformer.init(cfg, generator, device=device)


def logits_fn(params, cfg, batch):
    """Logits of a params tree on a batch dict (``images`` for conv,
    ``tokens`` for dense); fp32."""
    _check_family(cfg)
    if cfg.family == "conv":
        return alexnet.forward(params, cfg, batch["images"])
    return transformer.forward(params, cfg, batch["tokens"])


def loss_fn(params, cfg, batch):
    """Classification cross-entropy for conv; next-token cross-entropy
    for the LMs."""
    logits = logits_fn(params, cfg, batch)
    labels = batch["labels"]
    if cfg.family == "conv":
        return softmax_xent(logits[:, None, :], labels[:, None])
    return softmax_xent(logits[:, :-1], labels[:, 1:])



@dataclasses.dataclass
class DecodeState:
    """``cache`` is the family's state (empty for conv); ``pos`` (B,)
    int32 counts the tokens each row has consumed."""
    cache: Any
    pos: torch.Tensor


def init_decode_state(cfg, batch: int, capacity: int, *,
                      device=None) -> DecodeState:
    _check_family(cfg, ("conv",), _DECODE)
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
