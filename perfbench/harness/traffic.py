"""The one traffic generator: a traffic mix is a file of parameters.

A configuration gives the population (``num_clients`` rows of width
``embed_dim`` in ``num_clusters`` blobs, ``tenants``, ``cohort_size``);
a traffic mix gives how the rounds come:

* ``loop``: ``"closed"``: each tenant sends its next select when its
  last round is done (the only loop this harness drives);
* ``update_sigma``: after a select the cohort's rows move by
  N(0, sigma^2), the clients that trained reporting back, as the serve
  CLI's demo moves them;
* ``accuracy``: the round's accuracy is ``base + gain * share of the
  cohort outside blob ``stale_blob``, as the serve CLI's demo scores it;
* ``warmup_rounds``: rounds a tenant runs in set-up.

Everything is drawn from ``seed``: the same seed gives the same tables
and the same noise.
"""

from __future__ import annotations

import numpy as np

def tenant_rng(seed: int, tenant: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), tenant, stream]))


class TenantTraffic:
    """One tenant's table, its blobs and its rounds."""

    def __init__(self, config: dict, traffic: dict, seed: int, tenant: int):
        self.config, self.traffic = config, traffic
        self.tenant = tenant
        n, d, k = (config["num_clients"], config["embed_dim"],
                   config["num_clusters"])
        blobs = config["blobs"]
        rng = tenant_rng(seed, tenant, 0)
        centers = (rng.normal(size=(k, d)).astype(np.float32)
                   * np.float32(blobs["center_scale"]))
        self.labels = rng.integers(0, k, n)
        self.initial = (centers[self.labels]
                        + np.float32(blobs["noise"])
                        * rng.normal(size=(n, d)).astype(np.float32))
        self.initial.setflags(write=False)
        self.table = self.initial.copy()
        self.noise = tenant_rng(seed, tenant, 1)
        self.rounds = 0

    def updates(self, ids: np.ndarray) -> list:
        """The ``update_embeddings`` calls that close a round whose
        cohort was ``ids``: [(ids, rows)], the cohort's reports.  Applies
        them to the mirror table."""
        ids = np.asarray(ids, np.int64)
        rows = self.table[ids] + np.float32(self.traffic["update_sigma"]) \
            * self.noise.normal(size=(len(ids), self.table.shape[1])) \
            .astype(np.float32)
        self.table[ids] = rows
        self.rounds += 1
        return [(ids, rows)]

    def accuracy(self, ids: np.ndarray) -> float:
        a = self.traffic["accuracy"]
        if not len(ids):
            return float(a["base"])
        useful = float(np.mean(self.labels[np.asarray(ids)]
                               != a["stale_blob"]))
        return float(a["base"] + a["gain"] * useful)


class TableLog:
    """The tables a tenant's server held, version by version: the
    initial table as version 1 and one ``update_embeddings`` a version
    after it.  ``table(v)`` replays the log; asking for versions in
    ascending order costs one pass."""

    def __init__(self, initial: np.ndarray):
        self.initial = initial
        self.updates: list = []          # version v + 1 <- updates[v - 1]
        self._at = 1
        self._table = initial.copy()

    def append(self, ids, rows) -> None:
        self.updates.append((ids, rows))

    @property
    def versions(self) -> int:
        return 1 + len(self.updates)

    def table(self, version: int) -> np.ndarray:
        if version < self._at:
            self._at, self._table = 1, self.initial.copy()
        while self._at < version:
            ids, rows = self.updates[self._at - 1]
            self._table[ids] = rows
            self._at += 1
        return self._table
