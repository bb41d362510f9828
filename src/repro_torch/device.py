"""Device selection and the float32 precision contract, in one place.

Every entry point (``Experiment``, ``train_dnn_ssl``, the CLI) resolves its
``device=`` argument here.  ``"cuda"`` is the default; without a usable
GPU it raises — an entry point never drops to the CPU on its own.  The CPU
runs only when the caller asks for ``device="cpu"``.

The reference multiplies float32 inputs in full float32.  PyTorch would
use TF32 for cuDNN convolutions (and, if a user flipped it, for matmuls);
resolving a CUDA device pins both off.  It also pins off cuBLAS's reduced
precision reduction in bfloat16 GEMMs, so they sum in float32 like the
reference's float32-accumulating bf16 einsums.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "card_label"]


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
        # bf16 GEMMs reduce in float32.
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def card_label(device: str | torch.device = "cuda") -> str:
    """What a measurement on ``device`` is labelled with: the name and
    power limit of the card at its index (the current device's when it
    has none) as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, the torch name where
    ``nvidia-smi`` cannot be run; ``"cpu"`` on the CPU."""
    import subprocess
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{torch.cuda.get_device_name(index)}, power limit not read"
