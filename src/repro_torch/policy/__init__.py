"""Algorithm II: the cluster-level Deep-Q cohort policy."""

from repro_torch.policy.cluster_policy import ClusterPolicy

__all__ = ["ClusterPolicy"]
