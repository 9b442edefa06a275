"""The federated loop: data, partitions, local training, FedAvg and the
round loop (``repro_torch.fed.rounds.FederatedRunner``), plus the
serving-state metrics.  Import from the submodules; this package imports
nothing eagerly, so ``core.selection`` and ``fed.metrics`` can depend on
each other's packages without an import cycle."""
