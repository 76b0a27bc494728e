"""Where the port's entry points put their tensors.

Every public function that builds tensors takes ``device`` and defaults to
the card (``"cuda"``).  Without a CUDA device that default raises: the port
never moves to the CPU on its own.  The CPU runs only where the caller asks
for it with ``device="cpu"``, as the tests do; the kernels' wrappers then
take their plain PyTorch versions.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raise for a CUDA device when there
    is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but no CUDA device is available; "
            "pass device='cpu' to run the port on the CPU")
    return dev
