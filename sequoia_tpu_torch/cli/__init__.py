"""Command-line entry points of the port (``python -m sequoia_tpu_torch.cli.<name>``)."""

from __future__ import annotations

import argparse

from sequoia_tpu_torch.parallel.multihost import add_fleet_args  # noqa: F401


def add_compile_cache_arg(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' ``--compilation_cache DIR`` (a persistent XLA cache),
    taken so their command lines parse; eager PyTorch compiles nothing."""
    p.add_argument("--compilation_cache", type=str, default=None, metavar="DIR",
                   help="(accepted for compatibility; unused)")
