"""AlexNet in PyTorch — the paper's own architecture.

The counterpart of ``repro/models/alexnet.py``: 5 conv layers (LRN after
conv1/2, 3x3 stride-2 max-pool after conv1/2/5), two 4096-d
fully-connected layers, logits over 1000 classes.  With ``cfg.faithful``
conv2/4/5 are 2-group convolutions and LRN runs *after* pool1/pool2;
otherwise LRN runs before the pool and the convs are ungrouped.

Layouts are the reference's: images and activations NHWC, conv weights
HWIO, FC weights (in, out), and the flatten before FC1 is in NHWC order,
so FC1's rows line up with the reference's.  Conv and LRN go through
``kernels.conv2d.ops`` and ``kernels.lrn.ops.lrn`` (the CUDA kernels on
the card, their plain versions on the CPU, per ``cfg.kernels``); every
one is differentiable.  ``cfg.kernels.conv2d`` picks the conv
formulation: the fused implicit-GEMM kernel (``None``) or the two-stage
``im2col_ref`` path through the ``matmul_bias`` kernel.  Max-pool and the
FC products are library calls, as the reference leaves them to XLA.

``forward(params, cfg, images)`` and ``loss_fn`` are functions of a
params tree in the reference's structure (``{"convs": [{"w", "b"}],
"fcs": [...]}``) so the trainer can run them on one replica's slice of
stacked parameters; ``AlexNet.forward`` runs them on the module's own.
Dropout (``train=True``) draws its masks from an explicit
``torch.Generator``.

Params are stored in ``numerics.param_dtype(cfg)``: bf16 under the bf16
numerics preset, whose trainer casts the images to bf16 too.  Conv and
LRN then run their bf16 kernels; the FC products run ``torch.matmul`` in
bf16 with fp32 reduction (``numerics.fp32_numerics`` turns the reduced-
precision reduction off on the card), rounded once to bf16, and the bias
is added in bf16, as the reference's ``preferred_element_type`` form;
the logits come out fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.common import device_of, policy_of
from repro_torch.kernels.conv2d.ops import conv2d_fused, conv2d_im2col
from repro_torch.kernels.lrn.ops import lrn
from repro_torch.models.layers import softmax_xent
from repro_torch.numerics import param_dtype


def maxpool(x, size: int = 3, stride: int = 2):
    """NHWC max-pool, VALID windows.  The NCHW view of a contiguous NHWC
    tensor is channels-last, which ``max_pool2d`` keeps, so the result is
    contiguous NHWC again without a copy."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), size, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def param_shapes(cfg) -> dict:
    """Shapes of every parameter, in the reference's layouts."""
    convs, c_in, hw = [], cfg.in_channels, cfg.image_size
    for cs in cfg.convs:
        convs.append(((cs.kernel, cs.kernel, c_in // cs.groups,
                       cs.out_channels), (cs.out_channels,)))
        hw = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
        if cs.pool:
            hw = (hw - 3) // 2 + 1
        c_in = cs.out_channels
    dims = [(hw * hw * c_in, cfg.fc_dim), (cfg.fc_dim, cfg.fc_dim),
            (cfg.fc_dim, cfg.n_classes)]
    return {"convs": convs, "fcs": [(d, (d[1],)) for d in dims]}


def dropout(h, rate: float, generator):
    """Keep each activation with probability 1 - ``rate`` and scale the
    kept ones by 1 / (1 - rate), as the reference's ``train`` forward;
    the mask comes from ``generator`` (on ``h``'s device)."""
    if generator is None:
        raise ValueError("dropout needs a torch.Generator for its masks")
    keep = torch.rand(h.shape, generator=generator, device=h.device) >= rate
    return torch.where(keep, h / (1 - rate), torch.zeros((), device=h.device))


def forward(params, cfg, images, *, train: bool = False, generator=None):
    """images (B,H,W,C) -> logits (B, n_classes) float32.  ``params`` is a
    tree in the reference's structure; conv and LRN run the
    implementations ``cfg.kernels`` selects.  ``train=True`` applies the
    FC dropout with masks drawn from ``generator`` (on the images'
    device)."""
    pol = policy_of(cfg)
    backend = pol.backend
    conv = conv2d_im2col if pol.conv2d == "im2col_ref" else conv2d_fused

    def _lrn(h):
        return lrn(h, n=cfg.lrn_n, alpha=cfg.lrn_alpha, beta=cfg.lrn_beta,
                   k=cfg.lrn_k, backend=backend)

    h = images
    for cp, cs in zip(params["convs"], cfg.convs):
        h = conv(h, cp["w"], stride=cs.stride, padding=cs.padding,
                 bias=cp["b"], relu=True, groups=cs.groups, backend=backend)
        # faithful: pool, then normalize the pooled map (Caffe order)
        if not cfg.faithful and cs.lrn:
            h = _lrn(h)
        if cs.pool:
            h = maxpool(h)
        if cfg.faithful and cs.lrn:
            h = _lrn(h)
    h = h.reshape(h.shape[0], -1)
    for i, fp in enumerate(params["fcs"]):
        if i > 0:
            h = torch.relu(h)
            if train and cfg.dropout > 0:
                h = dropout(h, cfg.dropout, generator)
        h = torch.matmul(h, fp["w"]) + fp["b"]
    return h.float()


def loss_fn(params, cfg, images, labels, *, train: bool = False,
            generator=None):
    """Mean softmax cross-entropy of the logits against int ``labels``."""
    logits = forward(params, cfg, images, train=train, generator=generator)
    return softmax_xent(logits[:, None, :], labels[:, None])


class AlexNet(nn.Module):
    """Parameters: ``conv_w[i]`` (K,K,Cin/G,Cout), ``conv_b[i]``,
    ``fc_w[i]`` (in,out), ``fc_b[i]``.  Built uninitialized; ``init``
    fills them from a generator, ``weights.from_reference`` from the
    reference's params."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        dev = device_of(device)
        dt = param_dtype(cfg)
        shapes = param_shapes(cfg)

        def plist(shs):
            return nn.ParameterList(
                nn.Parameter(torch.empty(s, device=dev, dtype=dt))
                for s in shs)

        self.conv_w = plist([w for w, _ in shapes["convs"]])
        self.conv_b = plist([b for _, b in shapes["convs"]])
        self.fc_w = plist([w for w, _ in shapes["fcs"]])
        self.fc_b = plist([b for _, b in shapes["fcs"]])

    def params(self) -> dict:
        """The module's parameters as the reference's tree."""
        return {"convs": [{"w": w, "b": b}
                          for w, b in zip(self.conv_w, self.conv_b)],
                "fcs": [{"w": w, "b": b}
                        for w, b in zip(self.fc_w, self.fc_b)]}

    def forward(self, images, *, train: bool = False, generator=None):
        """images (B,H,W,C) -> logits (B, n_classes) float32."""
        return forward(self.params(), self.cfg, images, train=train,
                       generator=generator)


@torch.no_grad()
def init(cfg, generator: torch.Generator, *, device=None) -> AlexNet:
    """He-initialized weights (the reference's scheme: conv std
    sqrt(2/fan_in) with fan_in over the group's channels, FC std
    in**-0.5, zero biases), drawn in fp32 on the CPU from ``generator``
    so the same seed gives the same weights on every device, and cast to
    the params' dtype."""
    model = AlexNet(cfg, device=device)
    for w in model.conv_w:
        fan_in = w.shape[0] * w.shape[1] * w.shape[2]
        w.copy_(torch.randn(w.shape, generator=generator)
                * (2.0 / fan_in) ** 0.5)
    for w in model.fc_w:
        w.copy_(torch.randn(w.shape, generator=generator) * w.shape[0] ** -0.5)
    for b in list(model.conv_b) + list(model.fc_b):
        b.zero_()
    return model
