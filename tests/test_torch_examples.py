"""The port's examples (``examples/torch_*.py``) and the API they reach,
held against the JAX package on the CPU.

* ``eigengap_k`` (``core/spectral.py``) equals the JAX function exactly.
* A ``dqre_sc`` round with ``auto_k`` gives the JAX engine's k̂ and its
  partition, on the twin runners of ``test_torch_rounds.py`` (the JAX
  runner's weights, projection, Q-networks, pooling keys and k-means
  draws handed to the port).
* The quickstart's step 1 partitions its three blobs as JAX's
  ``spectral_cluster`` does, with the same eigengap k.
* ``run(stop_at_target=True)``, ``rounds_to_accuracy`` and
  ``final_metrics`` under fedavg: the same rounds run, accuracies and
  metrics within ±0.01.
* Each example's ``main`` on the CPU at a tiny size.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cohort.engine as jax_engine
import repro_torch.cohort.engine as port_engine
from repro.core.kmeans import kmeans_plus_plus_init as jax_kpp_init
from repro.core.spectral import eigengap_k as jax_eigengap_k
from repro.core.spectral import spectral_cluster as jax_spectral_cluster
from repro.fed import FederatedRunner as JaxRunner
from repro.fed import RunnerConfig as JaxConfig
from repro.fed.metrics import classification_metrics as jax_metrics
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import (cnn_params_from_jax, dqn_params_from_jax,
                                 embedder_from_jax)
from repro_torch.core.kmeans import _lloyd
from repro_torch.core.spectral import eigengap_k
from repro_torch.fed.rounds import FederatedRunner, RunnerConfig
from repro_torch.tree import leaves
from test_torch_rounds import CONFIG, decisive_pooling  # noqa: F401
from test_torch_rounds import jax_noise, same_partition
from test_torch_train_mesh import one_thread  # noqa: F401

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
# the round tests' configuration: test_torch_rounds.py's at 2 local steps
TWIN = dict(CONFIG, local_steps=2)
# accuracies and final metrics, port against JAX: the round's FedAvg is
# the same, its convolutions rounded differently (the eval set is 256
# images, so one image is 0.0039)
METRIC_ABS = 0.01


def example(name):
    """``examples/torch_<name>.py`` as a module."""
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- eigengap_k -------------------------------------------------------------

EVALS = {
    # a clear gap after the third eigenvalue
    "separated": [0.0, 0.01, 0.02, 0.9, 0.95, 1.0, 1.02, 1.05, 1.1, 1.2,
                  1.3, 1.4],
    # the first two gaps tie exactly (0.25 each): the first one wins
    "tie": [0.0, 0.25, 0.5, 0.625, 0.75, 0.8125, 0.875, 0.9375, 1.0,
            1.0625, 1.125, 1.1875],
    # fewer values than max_k + 1
    "short": [0.0, 0.1, 0.7, 0.8],
    # the largest gap lies past max_k = 4 but before 10
    "late": [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 1.6, 1.7, 1.8, 1.9, 2.0],
}


@pytest.mark.parametrize("max_k", [4, 10])
@pytest.mark.parametrize("case", sorted(EVALS))
def test_eigengap_k_equals_jax(case, max_k):
    evals = np.asarray(EVALS[case], np.float32)
    want = int(jax_eigengap_k(jnp.asarray(evals), max_k))
    assert eigengap_k(torch.from_numpy(evals), max_k) == want
    assert eigengap_k(evals, max_k) == want


# -- auto_k in a dqre_sc round ---------------------------------------------

def test_auto_k_round_gives_jax_k_hat_and_partition(decisive_pooling,
                                                    monkeypatch):
    kw = dict(TWIN, policy="dqre_sc", sigma=0.8,
              policy_kwargs={"num_clusters": 8, "auto_k": True})
    ref = JaxRunner(JaxConfig(**kw))
    port = FederatedRunner(RunnerConfig(**kw), device="cpu")
    port.global_params = cnn_params_from_jax(ref.global_params)
    port.embedder = embedder_from_jax(np.asarray(ref.embedder.proj),
                                      device="cpu")
    port._pool_noise = jax_noise(port)
    keys = []

    def jax_kmeans(key, y, k):
        keys.append(key)
        return jax_kmeans_fn(key, y, k)

    def port_kmeans(generator, y, k):
        init = jax.jit(jax_kpp_init, static_argnums=2)(keys.pop(0),
                                                       y.numpy(), k)
        return _lloyd(y, torch.from_numpy(np.asarray(init)), 25)

    jax_kmeans_fn = jax_engine.kmeans
    monkeypatch.setattr(jax_engine, "kmeans", jax_kmeans)
    monkeypatch.setattr(port_engine, "kmeans", port_kmeans)
    jax_agent = ref.policy.cluster_policy.agent
    port_agent = port.policy.cluster_policy.agent
    port_agent.net.load_state_dict(dqn_params_from_jax(jax_agent.params))
    port_agent.target.load_state_dict(
        dqn_params_from_jax(jax_agent.target_params))

    want = ref.run_round()
    got = port.run_round()
    want_k = ref.policy.engine.state.result.k
    got_k = port.policy.engine.state.result.k
    assert port.policy.engine.config.auto_k
    assert 2 <= got_k <= 8
    assert got_k == want_k
    assert same_partition(port.policy._last_assign, ref.policy._last_assign)
    assert len(set(port.policy._last_assign.tolist())) == got_k
    np.testing.assert_array_equal(got.selected, want.selected)
    assert not keys


# -- the quickstart's step 1 ------------------------------------------------

def test_quickstart_step1_partitions_like_jax():
    quickstart = example("quickstart")
    x = quickstart.three_blobs()
    want, _, evals = jax_spectral_cluster(jax.random.PRNGKey(0),
                                          jnp.asarray(x), 3)
    assign, k_hat = quickstart.demo_spectral_clustering(torch.device("cpu"))
    assert same_partition(assign, np.asarray(want))
    assert sorted(np.bincount(assign).tolist()) == [20, 20, 20]
    assert k_hat == int(jax_eigengap_k(evals))


# -- stop_at_target, rounds_to_accuracy, final_metrics ----------------------

# between round 0's and round 1's accuracy of the twin runners below
# (0.1250 and 0.1836 in both packages), so a run of at most 3 rounds
# stops after its second
STOP_TARGET = 0.15
STOP_CAP = 3


def test_stop_at_target_matches_jax(decisive_pooling):
    kw = dict(TWIN, policy="fedavg", sigma=0.5,
              target_accuracy=STOP_TARGET)
    ref = JaxRunner(JaxConfig(**kw))
    port = FederatedRunner(RunnerConfig(**kw), device="cpu")
    port.global_params = cnn_params_from_jax(ref.global_params)
    port.embedder = embedder_from_jax(np.asarray(ref.embedder.proj),
                                      device="cpu")
    port._pool_noise = jax_noise(port)

    want = ref.run(STOP_CAP, stop_at_target=True)
    got = port.run(STOP_CAP, stop_at_target=True)
    assert len(want) < STOP_CAP, "the target no longer stops the run early"
    assert len(got) == len(want)
    assert port.rounds_to_accuracy() == ref.rounds_to_accuracy() == len(want)
    for g, w in zip(got, want):
        assert abs(g.accuracy - w.accuracy) <= METRIC_ABS
    assert port.rounds_to_accuracy(1.0) is ref.rounds_to_accuracy(1.0) is None
    got_m, want_m = port.final_metrics(), ref.final_metrics()
    assert set(got_m) == set(want_m)
    for key, value in want_m.items():
        assert abs(got_m[key] - value) <= METRIC_ABS, key


# -- each example's main on the CPU -----------------------------------------

@pytest.fixture
def tiny_runs(monkeypatch):
    """Every ``RunnerConfig`` an example builds at 2 local steps and 128
    evaluation images: its flags do not reach them."""
    import repro_torch.fed.rounds as rounds

    real = rounds.RunnerConfig
    monkeypatch.setattr(rounds, "RunnerConfig", lambda **kw: real(
        **dict(kw, local_steps=2, eval_size=128)))

def test_fl_mnist_writes_the_jax_examples_json(tmp_path, tiny_runs):
    out = example("fl_mnist").main([
        "--device", "cpu", "--clients", "6", "--cohort", "3", "--rounds",
        "2", "--train-size", "300", "--out", str(tmp_path)])
    path = tmp_path / "mnist_sigma0.8_seed0.json"
    assert out["path"] == str(path)
    results = json.loads(path.read_text())
    assert list(results) == ["fedavg", "kcenter", "favor", "dqre_sc"]
    metric_keys = set(jax_metrics(np.array([0, 1]),
                                  np.eye(2, dtype=np.float32)))
    for policy, res in results.items():
        assert set(res) == {"rounds_to_target", "final_accuracy", "curve",
                            "metrics"}, policy
        assert 1 <= len(res["curve"]) <= 2
        assert res["final_accuracy"] == res["curve"][-1]
        assert set(res["metrics"]) == metric_keys
        assert out["runs"][policy]["seconds"] > 0
    assert out["runs"]["dqre_sc"]["solves"] > 0


def test_quickstart_main_ends_ok(capsys, tiny_runs):
    out = example("quickstart").main(["--device", "cpu", "--use-pallas"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "quickstart OK"
    assert len(out["rounds"]) == 3
    assert out["affinity"].shape == (64, 64)
    assert out["affinity_err"] == 0.0


def test_ablation_main_reports_k_hat(capsys, tiny_runs, monkeypatch):
    import repro_torch.fed.rounds as rounds

    tiny = rounds.RunnerConfig
    monkeypatch.setattr(rounds, "RunnerConfig", lambda **kw: tiny(
        **dict(kw, num_clients=10, clients_per_round=3, train_size=500)))
    out = example("ablation_clusters").main(["--device", "cpu", "--rounds",
                                             "1"])
    assert list(out) == ["k=2", "k=4", "k=8", "eigengap(<=8)"]
    assert [out[k]["k_hat"] for k in ("k=2", "k=4", "k=8")] == [2, 4, 8]
    assert 2 <= out["eigengap(<=8)"]["k_hat"] <= 8
    assert "k_hat" in capsys.readouterr().out


@pytest.mark.parametrize("arch,multiple", [("qwen2-7b", 1),
                                           ("mamba2-2.7b", 8)])
def test_serve_lm_retires_every_request(arch, multiple):
    out = example("serve_lm").main([
        "--device", "cpu", "--arch", arch, "--requests", "6",
        "--prompt-multiple", str(multiple), "--use-pallas"])
    done, cfg = out["done"], out["cfg"]
    assert [r.uid for r in done] == list(range(6))
    for r in done:
        assert len(r.generated) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
        assert len(r.prompt) % multiple == 0
    assert out["stats"]["retired"] == 6
    assert out["stats"]["truncated"] == 0


def test_serve_lm_draws_the_jax_examples_requests():
    """The same seed gives the JAX example's prompt lengths and token
    budgets (the draws are numpy in both)."""
    vocab = get_config("qwen2-7b").reduced().vocab_size
    rng = np.random.default_rng(0)
    want = []
    for _ in range(5):
        plen = len(rng.integers(0, vocab, rng.integers(4, 24)))
        want.append((plen, int(rng.integers(1, 17))))
    out = example("serve_lm").main(["--device", "cpu", "--requests", "5",
                                    "--gen-len", "16"])
    assert [(len(r.prompt), r.max_new_tokens) for r in out["done"]] == want


def test_train_lm_tiny_checkpoint_restores(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    out = example("train_lm").main([
        "--device", "cpu", "--preset", "tiny", "--steps", "101",
        "--global-batch", "2", "--seq-len", "16", "--log-every", "50",
        "--ckpt-dir", str(ckpt_dir)])
    assert len(out["losses"]) == 101
    assert np.isfinite(out["losses"]).all()
    assert out["peak_bytes"] is None
    tree, step, _ = Checkpointer(str(ckpt_dir)).restore()
    assert step == 100
    got = leaves(tree["params"])
    want = leaves(out["params"])
    assert len(got) == len(want) == len(leaves(out["params"]))
    for g, w in zip(got, want):
        g = torch.as_tensor(np.asarray(g))
        assert g.shape == w.shape
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("name", ["quickstart", "fl_mnist",
                                  "ablation_clusters", "serve_lm",
                                  "train_lm"])
def test_examples_refuse_to_run_without_a_card(name, tmp_path):
    """Without ``--device cpu`` an example needs a GPU: on a host without
    one it raises before it runs anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main(["--out", str(tmp_path)] if name == "fl_mnist"
                           else [])
