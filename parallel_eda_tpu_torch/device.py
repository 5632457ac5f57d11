"""Device resolution for the port's entry points.

The default is the CUDA card, and asking for it without one raises:
the port never falls back to the CPU on its own.  The CPU is used only
when the caller passes ``device="cpu"`` (the tests do), and then every
kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
