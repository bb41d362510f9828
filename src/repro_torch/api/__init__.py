"""Public experiment layer of the port: config-driven, registry-backed.

    from repro_torch.api import Experiment, ExperimentConfig

    result = Experiment(ExperimentConfig(), device="cuda").run()
    print(result.best("eval/acc"))
"""
from .config import (BatchConfig, DataConfig, ExecutionConfig,
                     ExperimentConfig, GraphConfig, ObjectiveConfig,
                     OnlineConfig, PartitionConfig, RepartitionConfig,
                     ResilienceConfig, TrainConfig)
from .experiment import Experiment, ExperimentResult
from .registry import (AFFINITY, OPTIMIZER, PAIRWISE, PARTITIONER, PIPELINE,
                       STRATEGY, Registry, resolve_pairwise)

__all__ = [
    "ExperimentConfig", "DataConfig", "GraphConfig", "PartitionConfig",
    "BatchConfig", "RepartitionConfig", "ObjectiveConfig", "TrainConfig",
    "ExecutionConfig", "ResilienceConfig", "OnlineConfig",
    "Experiment", "ExperimentResult",
    "Registry", "AFFINITY", "PARTITIONER", "PIPELINE", "PAIRWISE",
    "STRATEGY", "OPTIMIZER", "resolve_pairwise",
]
