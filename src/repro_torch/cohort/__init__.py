"""Cohort-selection subsystem: engine, landmarks, Nyström core (single
device and mesh-sharded), solvers."""

from repro_torch.cohort.engine import (CohortConfig, CohortEngine,
                                       CohortResult, CohortState,
                                       PreparedSolve)
from repro_torch.cohort.landmarks import (LANDMARK_STRATEGIES,
                                          select_landmarks,
                                          uniform_landmarks)
from repro_torch.cohort.nystrom import nystrom_from_landmarks
from repro_torch.cohort.sharded import sharded_nystrom_from_landmarks

__all__ = ["CohortConfig", "CohortEngine", "CohortResult", "CohortState",
           "PreparedSolve", "LANDMARK_STRATEGIES", "select_landmarks",
           "uniform_landmarks", "nystrom_from_landmarks",
           "sharded_nystrom_from_landmarks"]
