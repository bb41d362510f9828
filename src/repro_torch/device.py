"""Device selection and the float32 precision contract, in one place.

Every entry point (``Experiment``, ``train_dnn_ssl``, the CLI) resolves its
``device=`` argument here.  ``"cuda"`` is the default; without a usable
GPU it raises — an entry point never drops to the CPU on its own.  The CPU
runs only when the caller asks for ``device="cpu"``.

The reference multiplies float32 inputs in full float32.  PyTorch would
use TF32 for cuDNN convolutions (and, if a user flipped it, for matmuls);
resolving a CUDA device pins both off.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        # Full float32 products: no TF32 in matmuls or cuDNN.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
