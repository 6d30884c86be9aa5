"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``. ``cuda`` is the default;
asking for it on a machine without a GPU raises — nothing drops to the CPU
behind the caller's back. ``device="cpu"`` runs the kernels' plain PyTorch
versions and exists for tests.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device [cuda] was requested but no CUDA device is "
                "available; pass device=\"cpu\" to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device [{device}]")
    return dev
