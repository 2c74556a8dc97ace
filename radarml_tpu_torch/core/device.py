"""Where the port's entry points compute by default: on the card.

Every entry point that makes tensors (model loaders, featurizers, the
SVC fit) takes `device=None` and resolves it here. None means the CUDA
card; without one this raises instead of carrying on quietly on the
CPU, and a caller that wants the CPU says so with `device="cpu"`.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[torch.device, str, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None is the current CUDA card.

    Raises RuntimeError when `device` is None and no CUDA device is
    present: pass device="cpu" to run on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
