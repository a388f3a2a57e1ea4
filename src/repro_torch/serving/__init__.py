"""Serving subsystem of the port: the slot engine for image
classification and the LMs, speculative decoding (``spec_decode``), the
shared-prefix block pool, and token sampling."""
from repro_torch.serving.blocks import BlockManager
from repro_torch.serving.engine import Request, Result, ServingEngine
from repro_torch.serving.sampling import sample, sample_slots

__all__ = ["ServingEngine", "Request", "Result", "BlockManager", "sample",
           "sample_slots"]
