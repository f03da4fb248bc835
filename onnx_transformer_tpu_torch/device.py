"""Device selection shared by the port's entry points.

``device=None`` means the CUDA card.  Without a card that is an error: the
port never drops to the CPU on its own.  Tests and other CPU callers pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
