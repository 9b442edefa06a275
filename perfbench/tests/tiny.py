"""A cell of a size a CPU test run holds: the StackOverflow deployment's
file with its population cut, run on the CPU through the same harness
(the kernels' plain versions stand in for the CUDA ones there)."""

import copy

from perfbench.harness import registry


def tiny_cell():
    cfg = copy.deepcopy(registry.load_json(
        registry.PERFBENCH / "configs" / "cohort-stackoverflow-342k.json"))
    cfg.update(num_clients=4096, cohort_size=16, num_landmarks=256,
               check={"solves": 2})
    mix = copy.deepcopy(registry.load_json(
        registry.PERFBENCH / "traffic" / "rounds-closed.json"))
    mix["warmup_rounds"] = 2
    return {"cell": {"name": "tiny", "chips": 1}, "config": cfg,
            "traffic": mix,
            "end_to_end": [{"name": "select_p95_ms", "unit": "ms"},
                           {"name": "selects_per_s", "unit": "selects/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "observe_ms", "unit": "ms"},
                          {"name": "solve_ms", "unit": "ms"},
                          {"name": "warm_share", "unit": "share"}]}
