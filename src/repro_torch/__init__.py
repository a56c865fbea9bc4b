"""PyTorch/CUDA port of the approximate signed multiplier system.

The counterpart of :mod:`repro` (the JAX package, which stays the
reference): the same module names under ``core/``, ``kernels/``, ``nn/``,
``data/``, ``obs/`` and ``serving/``, with plain PyTorch code on tensors and
hand-written CUDA kernels (``csrc/``) where :mod:`repro` has Pallas kernels.

Device rule: a tensor's device decides. CPU tensors run the plain PyTorch
version of every kernel; CUDA tensors launch the kernel or raise. Entry
points that create tensors themselves (``serving.EdgeDetectService``)
default to ``"cuda"``.
"""
