"""Every JAX command line parses with the port's CLIs: each option string of
each JAX CLI's parser exists on the port's parser of the same name, and every
``python3 -m sequoia_tpu.cli.<name>`` command of ``scripts/*.sh`` parses
with ``sequoia_tpu_torch.cli.<name>`` (shell variables given placeholder
values).  ``--compilation_cache`` is taken and unused, and ``kmean_features
--backend tpu`` is the port's ``device``."""

import glob
import importlib
import os
import re
import shlex

import pytest

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(glob.glob(os.path.join(REPO, "scripts", "*.sh")))
PORT_CLIS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(REPO, "sequoia_tpu_torch", "cli", "*.py")) if not p.endswith("__init__.py"))
CMD_RE = re.compile(r"python3? -m sequoia_tpu\.cli\.(\w+)(.*)")


def _options(parser) -> set[str]:
    return {o for a in parser._actions for o in a.option_strings}


@pytest.mark.parametrize("name", PORT_CLIS)
def test_every_jax_option_exists_on_the_port(name):
    jparser = importlib.import_module(f"sequoia_tpu.cli.{name}").build_parser()
    tparser = importlib.import_module(f"sequoia_tpu_torch.cli.{name}").build_parser()
    missing = _options(jparser) - _options(tparser)
    assert not missing, f"cli.{name}: the port lacks {sorted(missing)}"


def _commands(script: str):
    """(cli name, argv) of each ``python3 -m sequoia_tpu.cli.<name>`` command,
    continuation lines joined, comments dropped, variables substituted."""
    with open(script) as f:
        text = "\n".join(ln for ln in f.read().splitlines() if not ln.lstrip().startswith("#"))
    text = text.replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        m = CMD_RE.search(line)
        if not m:
            continue
        rest = m.group(2).replace('"${EXTRA[@]}"', "").replace('"$@"', "slide.svs")
        rest = re.sub(r'"?\$\{(\w+):-([^}]*)\}"?', r"\2", rest)
        rest = re.sub(r'"?\$\{?(\w+)\}?"?', lambda v: {"HTTP_PORT": "8000",
                                                      "NUM_HOSTS": "2",
                                                      "PROC_ID": "0"}.get(v.group(1), "x"),
                      rest)
        out.append((m.group(1), shlex.split(rest)))
    return out


@pytest.mark.parametrize("script", SCRIPTS, ids=[os.path.basename(s) for s in SCRIPTS])
def test_script_command_lines_parse_with_the_port(script):
    commands = _commands(script)
    assert commands, f"{script} runs no sequoia_tpu.cli module"
    for name, argv in commands:
        tcli = importlib.import_module(f"sequoia_tpu_torch.cli.{name}")
        jcli = importlib.import_module(f"sequoia_tpu.cli.{name}")
        jparser = jcli.build_parser()
        args, jargs = tcli.build_parser().parse_args(argv), jparser.parse_args(argv)
        given = {a.dest for a in jparser._actions if set(a.option_strings) & set(argv)}
        for dest in given:  # the values the command line sets
            assert getattr(args, dest) == getattr(jargs, dest), (name, dest)


def test_compat_flags():
    from sequoia_tpu_torch.cli import compute_features, he2rna, kmean_features, main
    from sequoia_tpu_torch.cli import pretrain_gtex, serve

    for mod, base in ((compute_features, ["--ref_file", "r", "--patch_data_path", "p",
                                          "--weights", "random"]),
                      (he2rna, ["--path_csv", "r"]), (main, ["--ref_file", "r"]),
                      (pretrain_gtex, ["--path_csv", "r"]),
                      (serve, ["--checkpoints", "c", "--weights", "random"])):
        args = mod.build_parser().parse_args([*base, "--compilation_cache", "/cache"])
        assert args.compilation_cache == "/cache"
        assert "unused" in next(a.help for a in mod.build_parser()._actions
                                if "--compilation_cache" in a.option_strings)
    assert kmean_features.build_parser().parse_args(
        ["--ref_file", "r", "--backend", "tpu"]).backend == "tpu"
    fleet = ["--coordinator", "h:1", "--num_processes", "2", "--process_id", "1",
             "--multihost"]
    args = serve.build_parser().parse_args(["--checkpoints", "c", "--weights", "random",
                                            *fleet])
    assert (args.coordinator, args.num_processes, args.process_id, args.multihost) == \
        ("h:1", 2, 1, True)
