"""Embedding-space affinity refresh (the graph half of online refresh)."""
from .refresh import (edge_churn, edge_set, embedding_knn_graph,
                      embedding_topk_device)

__all__ = ["embedding_topk_device", "embedding_knn_graph", "edge_set",
           "edge_churn"]
