"""PyTorch + CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package (``src/repro``) is the reference this port is held
against; the port imports neither it nor ``jax``.  Layouts at the public
functions are the reference's own (images NHWC, conv weights HWIO, FC
weights (in, out)), so both packages take the same numpy arrays.

Ported so far — serving and training the paper's AlexNet, and training
the dense LMs of the zoo:

  configs/         AlexNet configs (``ALEXNET``, ``ALEXNET_FAITHFUL``, ...)
                   and the LM zoo's published ``ModelConfig``s (``ARCHS``)
  kernels/         hand-written CUDA kernels for sm_90a (grouped
                   implicit-GEMM conv, cross-channel LRN, blocked GEMM,
                   flash-attention forward, dq and dk/dv), each beside its
                   plain PyTorch version, selected by ``KernelPolicy``,
                   each differentiable
  models/          ``AlexNet`` (``nn.Module``) and its functional forward
                   and loss, the dense transformer (``transformer``,
                   ``attention``, ``layers``), ``init`` / ``logits_fn`` /
                   ``loss_fn``, the conv-family ``DecodeState``
  numerics         the ``NumericsPolicy`` carried on model configs
  weights          the bridge to and from the reference's params and
                   ``TrainState``
  tree             nested dict / list / tuple trees of tensors
  optim/           SGD with momentum, AdamW, LR schedules, the plateau
                   controller
  core/            the replica exchange and the parameter-averaging step
  data/            synthetic streams, preprocessing, the prefetching and
                   pinned-staging loaders
  checkpoint/      checkpoints in the reference's on-disk format
  train_loop/      resumable sessions, eval, JSONL metrics
  serving/         ``ServingEngine`` for image classification, sampling
  launch/          the serving and training CLIs

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); on the CPU every kernel runs its
plain version.  Importing this package imports nothing heavy.
"""
