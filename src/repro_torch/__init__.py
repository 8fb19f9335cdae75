"""PyTorch/CUDA port of the CodeCRDT serving stack (``repro`` is the JAX
reference it is held against).

Entry points take an explicit ``device``.  They run on the CUDA card unless
the caller passes ``device="cpu"``, and they raise when no card is present
and the CPU was not asked for: nothing carries on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.index is None:                    # "cuda" -> "cuda:<current>"
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
