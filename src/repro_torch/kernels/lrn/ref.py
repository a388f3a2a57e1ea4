"""Plain PyTorch version of local response normalization (AlexNet §3.3).

``y_c = x_c / (k + alpha * sum_{c' in window(c)} x_{c'}^2) ** beta`` with
a size-``n`` channel window centred on ``c`` (zero-padded at the edges),
the arithmetic of ``repro/kernels/lrn/ref.py``.  Note that
``torch.nn.functional.local_response_norm`` divides ``alpha`` by ``n``;
this formula does not.
"""
from __future__ import annotations

import torch.nn.functional as F


def window_sum(v, n: int):
    """Size-``n`` zero-padded sliding-window sum over the channel axis."""
    c = v.shape[-1]
    pad = n // 2
    vp = F.pad(v, (pad, pad))
    return sum(vp[..., i:i + c] for i in range(n))


def lrn_ref(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
            k: float = 2.0):
    """x (..., C) -> (..., C), same dtype; fp32 internal math."""
    xf = x.float()
    den = (k + alpha * window_sum(xf * xf, n)) ** beta
    return (xf / den).to(x.dtype)


def lrn_grad(x, dy, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
             k: float = 2.0):
    """The vector-Jacobian product of ``lrn_ref`` in closed form, the
    reference's ``_lrn_bwd``::

        dx = dy * d**-b - 2*a*b * x * W(dy * x * d**-(b+1)),  d = k + a*W(x^2)

    (W, the window sum, is symmetric: channel i is in window(j) iff j is
    in window(i) for odd n)."""
    xf = x.float()
    dyf = dy.float()
    d = k + alpha * window_sum(xf * xf, n)
    dx = (dyf * d.pow(-beta)
          - 2.0 * alpha * beta * xf
          * window_sum(dyf * xf * d.pow(-(beta + 1.0)), n))
    return dx.to(x.dtype)
