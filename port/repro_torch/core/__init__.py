"""Bourbon core on PyTorch: learned-index LSM tree (the paper's contribution)."""

from .clock import CostModel, VirtualClock
from .plr import PLRModel, greedy_plr_np, greedy_plr_torch, plr_predict_np
from .lsm import LSMConfig, LSMTree
from .engine import EngineConfig, LookupEngine
from .cba import (CBAConfig, CostBenefitAnalyzer, LearningExecutor,
                  MaintenanceConfig, MaintenanceScheduler)
from .store import StoreConfig, BourbonStore
from .datasets import make_dataset, DATASETS
from .workloads import WorkloadSpec, iter_workload, request_indices

__all__ = [
    "CostModel", "VirtualClock", "PLRModel", "greedy_plr_np",
    "greedy_plr_torch", "plr_predict_np", "LSMConfig", "LSMTree", "EngineConfig", "LookupEngine",
    "CBAConfig", "CostBenefitAnalyzer", "LearningExecutor",
    "MaintenanceConfig", "MaintenanceScheduler", "StoreConfig",
    "BourbonStore", "make_dataset", "DATASETS", "WorkloadSpec",
    "iter_workload", "request_indices",
]
