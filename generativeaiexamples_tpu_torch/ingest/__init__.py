"""Streaming ingest: continuous sources -> chunks -> embeddings -> store
(a port of the reference package's ``ingest`` package).

The shape of a VDB-upload pipeline (RSS, filesystem or Kafka sources,
content extraction, tokenize, embed, write to the vector store, with
throughput counters between stages) as an asyncio pipeline: stages
connected by bounded queues (natural backpressure), the embed stage
batching documents into the encoder, per-stage counters in the metrics
registry.

  sources.py   FilesystemSource (glob + poll watch), RSSSource
               (stdlib XML parsing, urllib fetch), KafkaSource (gated on
               a client library)
  pipeline.py  stage runner + batching + stats
  __main__.py  CLI: python -m generativeaiexamples_tpu_torch.ingest ...
"""

from .pipeline import IngestPipeline, PipelineStats
from .sources import FilesystemSource, KafkaSource, RSSSource, SourceItem

__all__ = ["IngestPipeline", "PipelineStats", "FilesystemSource",
           "RSSSource", "KafkaSource", "SourceItem"]
