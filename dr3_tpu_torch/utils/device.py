"""Where the port's entry points run: on the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve(device, owner: str) -> torch.device:
    """``device`` as a torch.device; None means ``"cuda"``. A CUDA device
    without a card raises instead of falling back to the CPU: the CPU runs
    the kernels' plain versions and is asked for with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{owner}: runs on the card by default, but "
                           f"torch.cuda.is_available() is False; pass "
                           f'device="cpu" to run the plain versions on the CPU')
    return dev
