"""Layers shared by the port's models (the counterpart of
``repro/models/layers.py``; only the loss is needed so far)."""
from __future__ import annotations

import torch


def softmax_xent(logits, labels):
    """Mean cross-entropy; logits float32 (B, S, V), labels int (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
