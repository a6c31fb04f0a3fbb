"""Experiment logging: wandb where it is asked for and installed, else none.

Counterpart of ``sequoia_tpu/utils/logging.py``; wandb is imported only when
a project is given.
"""

from __future__ import annotations


def make_log_fn(project: str | None, config=None, name: str | None = None):
    """(log_fn(epoch, phase, metrics) or None, finish_fn)."""
    if not project:
        return None, lambda: None
    try:
        import wandb
    except ImportError:
        print("wandb not installed; logging to stdout only")
        return None, lambda: None

    run = wandb.init(project=project, config=config, name=name)

    def log_fn(epoch, phase, metrics):
        run.log({"epoch": epoch, **{f"{phase} {k}": v for k, v in metrics.items()}})

    return log_fn, run.finish
