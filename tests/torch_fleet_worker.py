"""One rank of a port CLI fleet, for tests/test_torch_fleet_cli.py and
tests/test_torch_mesh_cli.py: runs ``sequoia_tpu_torch.cli.<name>.main(argv)``
for the JSON ``[name, argv]`` in ``sys.argv[1]`` with one torch thread, then
prints ``DONE``.  A fleet launches each CLI in fresh processes."""

import importlib
import json
import sys

import torch

if __name__ == "__main__":
    torch.set_num_threads(1)
    name, argv = json.loads(sys.argv[1])
    importlib.import_module(f"sequoia_tpu_torch.cli.{name}").main(argv)
    print("DONE", flush=True)
