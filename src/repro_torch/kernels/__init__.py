"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers, and the
plain PyTorch versions the CPU path runs.  Nothing is built at import.

:func:`boundary` marks where a kernel wrapper's work begins and ends (see
:mod:`.boundary`)."""
from .boundary import boundary

__all__ = ["boundary"]
