"""Core implementation of the paper's contribution.

Stochastic graph regularization over affinity graphs for distributed SSL:
affinity-graph construction, balanced min-cut partitioning, meta-batch
synthesis, stochastic neighbour regularization, and the decomposed
graph-regularized objective (PyTorch port; the host modules are copies
of the reference package's numpy/scipy code).
"""
from .affinity import AffinityGraph, build_affinity_graph
from .metabatch import (MetaBatchPlan, NeighborSampler, concat_batch_indices,
                        epoch_plan_seed, plan_meta_batches, resynthesize_plan)
from .partition import (PartitionResult, edge_cut, partition_graph,
                        partition_graph_loop, partition_permutation)
from .ssl_loss import (SSLHyper, entropy, graph_regularizer,
                       pairwise_cross_entropy_term, ssl_objective,
                       ssl_objective_kl_form)
from .stats import (batch_label_entropy, connectivity_distribution,
                    entropy_distribution, random_batches,
                    within_batch_connectivity)

__all__ = [
    "AffinityGraph", "build_affinity_graph",
    "PartitionResult", "partition_graph", "partition_graph_loop",
    "partition_permutation", "edge_cut",
    "MetaBatchPlan", "plan_meta_batches", "resynthesize_plan",
    "epoch_plan_seed", "NeighborSampler", "concat_batch_indices",
    "SSLHyper", "ssl_objective", "ssl_objective_kl_form",
    "graph_regularizer", "pairwise_cross_entropy_term", "entropy",
    "within_batch_connectivity", "batch_label_entropy",
    "connectivity_distribution", "entropy_distribution", "random_batches",
]
