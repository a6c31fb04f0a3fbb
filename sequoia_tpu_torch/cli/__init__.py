"""Command-line entry points of the port (``python -m sequoia_tpu_torch.cli.<name>``)."""

from __future__ import annotations

import argparse


class NotPorted(argparse.Action):
    """Stops at parse time on a flag, or on some of its values, that the port
    does not run yet, naming its ROADMAP.md item.  ``refused``: the refused
    values, or None to refuse any use; ``item``: e.g. "queue 1 item 8"."""

    def __init__(self, option_strings, dest, refused=None, item="", **kw):
        super().__init__(option_strings, dest, **kw)
        self.refused, self.item = refused, item

    def __call__(self, parser, namespace, values, option_string=None):
        if self.refused is None or values in self.refused:
            shown = option_string if self.refused is None else f"{option_string} {values}"
            parser.error(f"{shown} is not ported yet (ROADMAP.md {self.item})")
        setattr(namespace, self.dest, values)


#: the ROADMAP.md item that multi-GPU and multi-host work waits for
MULTI_GPU = "queue 1 item 8"


def add_fleet_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' multi-host fleet flags, each stopping at parse time."""
    g = p.add_argument_group("multi-host fleet (not ported)")
    g.add_argument("--multihost", nargs=0, action=NotPorted, item=MULTI_GPU)
    for flag in ("--coordinator", "--num_processes", "--process_id"):
        g.add_argument(flag, default=None, action=NotPorted, item=MULTI_GPU)
