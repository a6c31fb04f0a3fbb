"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device (the
CPU tests pass ``device="cpu"``).  Without CUDA and without an explicit
device they raise: they never carry on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sequoia_tpu_torch runs on CUDA by default and no "
                               "CUDA device is available; pass device='cpu' to "
                               "run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors) with every tensor on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)
