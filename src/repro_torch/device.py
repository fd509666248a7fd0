"""Device resolution for the port's entry points.

Every entry point runs on the CUDA card unless the caller names another
device. A missing card raises: the port never carries on on the CPU when
the caller did not ask for it (the CPU runs the kernels' plain versions,
which is what the tests ask for with ``device="cpu"``).
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given.
    Raises RuntimeError when CUDA is asked for (or implied) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "kernels' plain PyTorch versions on the CPU")
    return dev
