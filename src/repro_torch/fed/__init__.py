"""The federated loop: data, partitions, local training, FedAvg, the round
loop (``repro_torch.fed.rounds.FederatedRunner``), client realism
(``fed/realism.py``) and the serving-state metrics.

The package exports the realism names, as the JAX package's ``repro.fed``
does; import the rest from the submodules.  Nothing else is imported
eagerly, so ``core.selection`` and ``fed.metrics`` can depend on each
other's packages without an import cycle.
"""

from repro_torch.fed.realism import (ClientTrace, RoundOutcome, RoundSpec,
                                     SimClock, TraceSpec, blended_reward,
                                     filter_survivors)

__all__ = ["ClientTrace", "RoundOutcome", "RoundSpec", "SimClock",
           "TraceSpec", "blended_reward", "filter_survivors"]
