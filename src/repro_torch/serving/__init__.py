"""Serving subsystem of the port: the slot engine for image
classification and token sampling."""
from repro_torch.serving.engine import Request, Result, ServingEngine
from repro_torch.serving.sampling import sample

__all__ = ["ServingEngine", "Request", "Result", "sample"]
