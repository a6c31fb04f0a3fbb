"""Parameter initializers with torch-default distributions, drawn from an
explicit ``torch.Generator``.

Counterpart of ``sequoia_tpu/utils/torch_init.py``: the same distributions
(``nn.Linear``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias;
``nn.Parameter(torch.randn(...))``: N(0, 1)), weights in math layout
``(fan_in, fan_out)``.  The random streams differ from JAX's by nature.
"""

from __future__ import annotations

import math

import torch


def linear_params(gen: torch.Generator, fan_in: int, fan_out: int,
                  dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Weight (fan_in, fan_out) + bias (fan_out,) with torch Linear
    defaults, on the generator's device."""
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty((fan_in, fan_out), dtype=dtype, device=gen.device)
    w.uniform_(-bound, bound, generator=gen)
    b = torch.empty((fan_out,), dtype=dtype, device=gen.device)
    b.uniform_(-bound, bound, generator=gen)
    return w, b


def randn(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=dtype, device=gen.device)
