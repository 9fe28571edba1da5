"""Device and dtype policy of the port.

Everything computes in float64 (the card has native FP64). Entry points
take an explicit `device`, "cuda" by default; asking for a card where
there is none raises, and nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

DTYPE = torch.float64


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
