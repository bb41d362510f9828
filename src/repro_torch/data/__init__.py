"""Host-side data: the synthetic TIMIT-like corpus, the batch pipelines and
the synthetic LM token corpus (copies of the reference package's numpy
code)."""
from .pipeline import (MetaBatchPipeline, MetaBatchStream, SSLBatch,
                       random_batch_pipeline)
from .synthetic_timit import SyntheticCorpus, drop_labels, make_corpus
from .tokens import lm_batches, make_token_corpus, sequence_features

__all__ = ["MetaBatchPipeline", "MetaBatchStream", "SSLBatch",
           "random_batch_pipeline", "SyntheticCorpus", "drop_labels",
           "make_corpus", "make_token_corpus", "sequence_features",
           "lm_batches"]
