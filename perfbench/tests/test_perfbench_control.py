"""On the card: each cell's control comes out not correct.

The control is the plain reference computed one precision below the
configuration's float32 (float32 storage, TF32 products; the action
values with TF32-rounded operands) in the program's place, at the cell's
own size, over a short window at the cell's own load.  Three seeds a
cell; the program's own run must come out correct beside it.

    python -m pytest -q -s -m cuda perfbench/tests/test_perfbench_control.py

(``-s`` shows each seed's readings, the program's and the control's.)
"""

import json
import subprocess
import sys

import pytest

from perfbench.harness import registry

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
WINDOW_S = 8


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size on the card")


def _cells():
    return [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", _cells())
def test_the_control_is_not_correct(card, workload, seed):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(WINDOW_S), "--trace", "0",
         "--control"], cwd=registry.ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps({"workload": workload, "seed": seed,
                      "program": result["checks"],
                      "control": result["control"]["checks"]}))
    assert result["correct"], result["checks"]
    assert not result["control"]["correct"], result["control"]
