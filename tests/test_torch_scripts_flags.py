"""Lint of the port's shell scripts (``scripts/torch/*.sh`` and
``tools/run_example_pipeline_torch.sh``): each invokes a
``sequoia_tpu_torch.cli`` module and only that package's, every ``--flag``
it passes exists on the CLI it invokes, and each ``scripts/torch`` script
is its ``scripts/*.sh`` counterpart's command lines with the module
renamed."""

import glob
import importlib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(glob.glob(os.path.join(REPO, "scripts", "torch", "*.sh"))) + [
    os.path.join(REPO, "tools", "run_example_pipeline_torch.sh")]
MOD_RE = re.compile(r"python3? -m (sequoia_tpu(?:_torch)?\.cli\.\w+)")
FLAG_RE = re.compile(r"(--[\w-]+)")


def _code(path: str) -> str:
    """The script without its comment lines."""
    with open(path) as f:
        return "\n".join(ln for ln in f.read().splitlines() if not ln.lstrip().startswith("#"))


@pytest.mark.parametrize("script", SCRIPTS, ids=[os.path.relpath(s, REPO) for s in SCRIPTS])
def test_script_flags_exist_on_the_port_cli(script):
    text = _code(script)
    mods = MOD_RE.findall(text)
    assert mods, f"{script} invokes no sequoia_tpu_torch.cli module"
    assert all(m.startswith("sequoia_tpu_torch.") for m in mods), mods
    # one command at a time: a flag must exist on the CLI that receives it
    for cmd in re.split(r"\n(?=[^\n]*python3? -m )", text.replace("\\\n", " ")):
        found = MOD_RE.search(cmd)
        if not found:
            continue
        parser = importlib.import_module(found.group(1)).build_parser()
        known = {o for a in parser._actions for o in a.option_strings}
        used = set(FLAG_RE.findall(cmd[found.end():].split("\n")[0]))
        assert not used - known, (f"{os.path.basename(script)}: {found.group(1)} lacks "
                                  f"{sorted(used - known)}")


def test_every_jax_script_has_its_counterpart():
    jax_scripts = sorted(glob.glob(os.path.join(REPO, "scripts", "*.sh")))
    assert len(jax_scripts) == 11
    for path in jax_scripts:
        twin = os.path.join(REPO, "scripts", "torch", os.path.basename(path))
        assert os.path.exists(twin), twin
        assert _code(twin) == _code(path).replace("sequoia_tpu.cli.", "sequoia_tpu_torch.cli.")
