"""The port's training launcher: ``python -m repro_torch.launch.train``."""

import pytest

from repro_torch.launch import train


def test_fl_cli_runs_rounds_on_the_cpu(capsys):
    train.main(["--fl", "--device", "cpu", "--num-clients", "8",
                "--clients-per-round", "3", "--rounds", "2",
                "--policy", "dqre_sc", "--target-accuracy", "0.99"])
    out = capsys.readouterr().out
    assert "device=cpu" in out
    assert out.count("round ") == 2
    assert "final metrics:" in out and "'auc'" in out


def test_lm_mode_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="§A5"):
        train.main(["--arch", "gemma-2b", "--device", "cpu"])
