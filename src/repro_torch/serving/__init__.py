"""Serving subsystem of the port: the slot engine for image
classification and the LMs, speculative decoding (``spec_decode``), the
shared-prefix block pool, token sampling, and the multi-process tier on
top: engine instances as worker processes (``tier``) behind a
least-loaded ``Router`` (``router``), with disaggregated prefill and the
drain and handoff of live rows."""
from repro_torch.serving.blocks import BlockManager
from repro_torch.serving.engine import (DEFAULT_BUCKETS, DrainingError,
                                        Request, Result, ServingEngine)
from repro_torch.serving.router import DeadInstanceError, Router
from repro_torch.serving.sampling import sample, sample_slots
from repro_torch.serving.tier import InstanceHandle, PrefillWorker, TierError

__all__ = ["ServingEngine", "Request", "Result", "DEFAULT_BUCKETS",
           "BlockManager", "sample", "sample_slots", "DrainingError",
           "Router", "DeadInstanceError", "InstanceHandle", "PrefillWorker",
           "TierError"]
