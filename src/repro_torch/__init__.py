"""PyTorch / CUDA port of the graph-regularized semi-supervised learner.

A second package beside the JAX reference (``repro``): same layout, same
configs, hand-written Hopper kernels (``csrc/``) where the reference has
Pallas kernels.  It imports torch, numpy and scipy, never JAX and never the
reference package.  Entry points run on the GPU unless given
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""
__version__ = "0.1.0"
