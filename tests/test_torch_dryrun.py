"""``sequoia_tpu_torch.dryrun.dryrun_multichip`` wiring on the CPU
(``production=False``): the training leg over n spawned gloo ranks, the
inference and spatial legs over an in-process mesh of n CPU "devices", at
n = 2, 4 and an odd n, each leg asserting that every rank or device holds
1/n_model of each fold's head (and of its AdamW moments in training); and
``SEQUOIA_DRYRUN_MODEL``/``SEQUOIA_DRYRUN_FULL`` read as in
``__graft_entry__.dryrun_multichip``."""

import pytest

from sequoia_tpu_torch import dryrun


@pytest.mark.parametrize("n,shape", [(2, (1, 2)), (4, (2, 2)), (3, (3, 1))])
def test_dryrun_multichip_legs(n, shape, capsys):
    lines = dryrun.dryrun_multichip(n, production=False, device="cpu")
    assert lines[0].startswith(f"dryrun_multichip({n}): mesh data={shape[0]} "
                               f"model={shape[1]} [tiny shapes")
    assert [ln.split()[-2:] for ln in lines] == [["leg", "OK"]] * 3
    assert "train leg OK" in lines[0] and "infer leg OK" in lines[1] \
        and "spatial leg OK" in lines[2]
    assert capsys.readouterr().out.splitlines()[-3:] == lines


def test_model_degree_and_shapes_from_the_environment(monkeypatch):
    monkeypatch.delenv("SEQUOIA_DRYRUN_MODEL", raising=False)
    assert dryrun._factor(8) == (4, 2) and dryrun._factor(5) == (5, 1)
    monkeypatch.setenv("SEQUOIA_DRYRUN_MODEL", "4")
    assert dryrun._factor(8) == (2, 4)
    with pytest.raises(ValueError, match="must divide"):
        dryrun._factor(6)
    assert dryrun._vis_cfg(True, 2).num_outputs == 20820
    assert dryrun._vis_cfg(False, 2).num_outputs == 64
    monkeypatch.setattr(dryrun.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(2, production=False)
