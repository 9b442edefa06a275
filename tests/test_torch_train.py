"""The port's training launcher: ``python -m repro_torch.launch.train``."""

import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.launch import train


def test_fl_cli_runs_rounds_on_the_cpu(capsys):
    train.main(["--fl", "--device", "cpu", "--num-clients", "8",
                "--clients-per-round", "3", "--rounds", "2",
                "--policy", "dqre_sc", "--target-accuracy", "0.99"])
    out = capsys.readouterr().out
    assert "device=cpu" in out
    assert out.count("round ") == 2
    assert "final metrics:" in out and "'auc'" in out


def test_lm_cli_trains_and_checkpoints_on_the_cpu(capsys, tmp_path):
    train.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                "--steps", "3", "--global-batch", "2", "--seq-len", "16",
                "--log-every", "1", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "arch=gemma-2b" in out and "device=cpu" in out
    assert [line.split()[:2] for line in out.splitlines()
            if line.startswith("step ")] == [["step", str(i)]
                                             for i in range(3)]
    assert "done in" in out and "final loss" in out
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "ckpt_00000002.npz", "ckpt_00000003.npz"]
    assert (tmp_path / "ckpt_00000002.npz.json").exists()
    ck = Checkpointer(str(tmp_path))
    tree, step, _ = ck.restore()
    assert step == 3 and set(tree) == {"params", "opt_state"}
    assert set(tree["opt_state"]) == {"m", "v"}


def test_lm_cli_without_a_device_needs_the_card():
    """No ``--device``: the card, so without one the launcher raises (and
    no longer refuses LM mode)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "gemma-2b", "--reduced", "--steps", "1"])
