"""Online graph construction from the live model + dynamic corpus ingestion
(the reference's ``repro.online``): embedding-space graph refresh from
activations captured during training, and incremental node insert/evict
patched through the partitioner's delta-repair path."""
from .refresh import (OnlineManager, edge_churn, edge_set,
                      embedding_knn_graph, embedding_topk_device,
                      scatter_epoch_embeddings)

__all__ = ["OnlineManager", "edge_set", "edge_churn", "embedding_knn_graph",
           "embedding_topk_device", "scatter_epoch_embeddings"]
