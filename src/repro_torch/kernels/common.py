"""Kernel selection shared by every op of the port.

``KernelPolicy`` is carried on the model config, as in the reference.
Each op resolves to one of two implementations:

  ``cuda``   the hand-written kernel (``kernels/*/csrc/*.cu``); it needs
             CUDA tensors and raises on anything else
  ``plain``  the plain PyTorch version beside the kernel, on any device

``auto`` (the default) picks the kernel for a CUDA tensor and the plain
version for a CPU tensor.  ``plain`` on a CUDA tensor is an explicit
request (parity checks on the card); nothing falls back to it.

``matmul="kernel"`` is an explicit opt-in, the counterpart of the
reference's ``matmul="pallas"``: it routes the MoE expert FFN's GEMMs
through ``kernels.conv2d.ops.matmul_bias`` (one call per expert weight),
under ``backend`` as every other op.  ``backend`` never turns it on (the
reference's ``wants_pallas``): the default (None) keeps the library's
batched product.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

BACKENDS = ("auto", "plain", "cuda")
# ``conv2d``: None is the fused implicit-GEMM kernel; ``im2col_ref`` is the
# two-stage parity path (``F.unfold`` + the ``matmul_bias`` kernel), the
# reference's ``conv2d="pallas_im2col_ref"``
CONV2D = (None, "im2col_ref")
# ``attention``: None, ``auto`` and ``flash`` are the flash-attention
# kernels under ``backend`` (the kernels on CUDA tensors, the plain
# version on CPU tensors); ``xla`` is the plain masked-softmax version on
# any device.  The reference's ``chunked`` and ``qloop`` are not ported.
ATTENTION = (None, "auto", "flash", "xla")
ATTENTION_NOT_PORTED = ("chunked", "qloop")
# ``decode_attention``: None and ``auto`` are the flash-decode kernels under
# ``backend``; ``xla`` is the plain version on any device (the reference's
# ``resolve_decode_impl``)
DECODE_ATTENTION = (None, "auto", "xla")
# ``rwkv6`` / ``rglru``: None and ``auto`` are the recurrence kernels under
# ``backend``; ``chunked`` (the reference's XLA form of the WKV) and
# ``xla`` (its associative scan of the RG-LRU) are the plain versions on
# any device
RWKV6 = (None, "auto", "chunked")
RGLRU = (None, "auto", "xla")
# ``matmul``: None is the library's batched product (the reference's XLA
# einsum); ``kernel`` the explicit opt-in to the matmul_bias kernel
MATMUL = (None, "kernel")


def _check_backend(name: str, value) -> None:
    if value not in BACKENDS:
        raise ValueError(f"{name} must be one of {BACKENDS}, got {value!r}")


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Per-run kernel selection: ``backend`` applies to every op;
    ``conv2d`` picks the conv formulation (``CONV2D``), ``attention`` the
    attention implementation (``ATTENTION``), ``decode_attention`` the
    single-token decode attention (``DECODE_ATTENTION``), ``rwkv6`` and
    ``rglru`` the two recurrences (``RWKV6``, ``RGLRU``), ``matmul`` the
    MoE expert FFN's GEMMs (``MATMUL``; opt-in only)."""
    backend: str = "auto"
    conv2d: Optional[str] = None
    attention: Optional[str] = None
    decode_attention: Optional[str] = None
    rwkv6: Optional[str] = None
    rglru: Optional[str] = None
    matmul: Optional[str] = None

    def __post_init__(self):
        _check_backend("backend", self.backend)
        if self.conv2d not in CONV2D:
            raise ValueError(f"conv2d must be one of {CONV2D}, "
                             f"got {self.conv2d!r}")
        if self.attention in ATTENTION_NOT_PORTED:
            raise NotImplementedError(
                f"attention impl {self.attention!r} is not ported yet: see "
                "ROADMAP.md queue A (the reference's chunked / qloop "
                "attention)")
        if self.attention not in ATTENTION:
            raise ValueError(f"attention must be one of {ATTENTION}, got "
                             f"{self.attention!r}")
        if self.decode_attention not in DECODE_ATTENTION:
            raise ValueError(f"decode_attention must be one of "
                             f"{DECODE_ATTENTION}, got "
                             f"{self.decode_attention!r}")
        for name, known in (("rwkv6", RWKV6), ("rglru", RGLRU),
                            ("matmul", MATMUL)):
            if getattr(self, name) not in known:
                raise ValueError(f"{name} must be one of {known}, got "
                                 f"{getattr(self, name)!r}")

    def attention_backend(self) -> str:
        """The backend the flash-attention ops run under: the global one
        for the flash kernels, ``plain`` for ``xla``."""
        return "plain" if self.attention == "xla" else self.backend

    def decode_backend(self) -> str:
        """The backend the decode-attention op runs under: the global one
        for the flash-decode kernels, ``plain`` for ``xla``."""
        return "plain" if self.decode_attention == "xla" else self.backend

    def rwkv6_backend(self) -> str:
        """The backend the WKV op runs under: the global one for the
        kernel, ``plain`` for ``chunked``."""
        return "plain" if self.rwkv6 == "chunked" else self.backend

    def rglru_backend(self) -> str:
        """The backend the RG-LRU scan runs under: the global one for the
        kernel, ``plain`` for ``xla``."""
        return "plain" if self.rglru == "xla" else self.backend

    def describe(self) -> dict:
        """Stable summary for logging: the fields that are set."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


def policy_of(cfg) -> KernelPolicy:
    """The config's policy, defaulting for configs without the field."""
    pol = getattr(cfg, "kernels", None)
    return pol if pol is not None else KernelPolicy()


def route(backend: str, x: torch.Tensor) -> str:
    """``"cuda"`` or ``"plain"`` for an op called with ``backend`` on
    ``x``.  A forced ``cuda`` backend on a CPU tensor raises."""
    _check_backend("backend", backend)
    if backend == "auto":
        return "cuda" if x.is_cuda else "plain"
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got a tensor "
                         f"on {x.device}")
    return backend


def device_of(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and
    absent — nothing continues quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' "
            "(--device cpu) to run the plain versions on the CPU")
    return dev


def check_operand(name: str, t: torch.Tensor, ndim: int,
                  dtypes=(torch.float32,)) -> None:
    """What every CUDA kernel of the port takes: a contiguous CUDA tensor
    of one of ``dtypes`` (fp32 unless the kernel says otherwise) and rank
    ``ndim`` that 32-bit offsets can index, on the current device."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} lies on {t.device}, not on the current "
                         f"device cuda:{torch.cuda.current_device()}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernel "
                         "indexes with 32-bit offsets")
