"""Host-side data: the synthetic TIMIT-like corpus and the batch pipelines
(copies of the reference package's numpy code)."""
from .pipeline import (MetaBatchPipeline, MetaBatchStream, SSLBatch,
                       random_batch_pipeline)
from .synthetic_timit import SyntheticCorpus, drop_labels, make_corpus

__all__ = ["MetaBatchPipeline", "MetaBatchStream", "SSLBatch",
           "random_batch_pipeline", "SyntheticCorpus", "drop_labels",
           "make_corpus"]
