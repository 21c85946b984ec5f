"""The ingest pipeline: source -> extract -> chunk -> embed+store (a copy
of the reference package's ``ingest/pipeline.py``).

Mirrors the reference's VDB-upload pipeline shape (reference:
experimental/streaming_ingest_rag/pipeline.py:60-102 — source pipes into
content extraction into tokenize/embed into WriteToVectorDBStage, with a
MonitorStage reporting throughput between every pair of stages). Here:

- stages are coroutines connected by bounded asyncio queues, so a slow
  embedder backpressures extraction instead of buffering unbounded;
- the store stage batches chunks (count or linger timeout) into the
  batch encoder — one encoder call per batch, the role
  Triton inference plays in the reference;
- per-stage counters live in the shared metrics registry and in a
  ``PipelineStats`` snapshot (the MonitorStage equivalent).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Optional

from ..chains.readers import read_document
from ..chains.splitter import TokenTextSplitter
from ..obs import metrics as obs_metrics
from ..utils.logging import get_logger
from .sources import SourceItem

logger = get_logger(__name__)

_STOP = object()


@dataclass
class PipelineStats:
    """Per-stage throughput counters (MonitorStage equivalent)."""
    items_in: int = 0
    documents_extracted: int = 0
    chunks: int = 0
    chunks_stored: int = 0
    batches: int = 0
    errors: int = 0
    started: float = field(default_factory=time.monotonic)

    def snapshot(self) -> dict:
        dt = max(time.monotonic() - self.started, 1e-9)
        return {"items_in": self.items_in,
                "documents_extracted": self.documents_extracted,
                "chunks": self.chunks,
                "chunks_stored": self.chunks_stored,
                "batches": self.batches,
                "errors": self.errors,
                "chunks_per_sec": round(self.chunks_stored / dt, 2),
                "elapsed_sec": round(dt, 2)}


class IngestPipeline:
    """source -> extract/chunk -> batch embed+store."""

    def __init__(self, source, index, chunk_size: int = 510,
                 chunk_overlap: int = 200, batch_size: int = 32,
                 linger_sec: float = 1.0, queue_size: int = 64,
                 max_items: Optional[int] = None):
        self.source = source
        self.index = index
        self.splitter = TokenTextSplitter(chunk_size=chunk_size,
                                          chunk_overlap=chunk_overlap)
        self.batch_size = batch_size
        self.linger_sec = linger_sec
        self.queue_size = queue_size
        self.max_items = max_items
        self.stats = PipelineStats()

    # ------------------------------------------------------------- stages

    async def _extract(self, in_q: asyncio.Queue,
                       out_q: asyncio.Queue) -> None:
        loop = asyncio.get_running_loop()
        while True:
            item = await in_q.get()
            if item is _STOP:
                await out_q.put(_STOP)
                return
            try:
                if item.path:
                    text = await loop.run_in_executor(
                        None, read_document, item.path)
                else:
                    text = item.content
                chunks = self.splitter.split_text(text or "")
                self.stats.documents_extracted += 1
                obs_metrics.REGISTRY.counter(
                    "ingest_documents_total",
                    "documents extracted by the ingest pipeline").inc()
                for i, chunk in enumerate(chunks):
                    self.stats.chunks += 1
                    await out_q.put((chunk, {**item.metadata,
                                             "chunk": i,
                                             "source_id": item.source_id}))
            except Exception as exc:  # noqa: BLE001 — skip bad documents
                self.stats.errors += 1
                obs_metrics.REGISTRY.counter(
                    "ingest_errors_total",
                    "documents the ingest pipeline failed on").inc()
                logger.warning("extract failed for %s: %s",
                               item.source_id or item.path, exc)

    async def _store(self, in_q: asyncio.Queue) -> None:
        loop = asyncio.get_running_loop()
        batch: list[tuple[str, dict]] = []

        async def flush() -> None:
            if not batch:
                return
            texts = [t for t, _ in batch]
            metas = [m for _, m in batch]
            await loop.run_in_executor(
                None, lambda: self.index.add_texts(texts, metas))
            self.stats.chunks_stored += len(batch)
            self.stats.batches += 1
            obs_metrics.REGISTRY.counter(
                "ingest_chunks_total",
                "chunks stored by the ingest pipeline").inc(len(batch))
            batch.clear()

        while True:
            try:
                item = await asyncio.wait_for(in_q.get(),
                                              timeout=self.linger_sec)
            except asyncio.TimeoutError:
                await flush()     # linger expired: don't sit on a batch
                continue
            if item is _STOP:
                await flush()
                return
            batch.append(item)
            if len(batch) >= self.batch_size:
                await flush()

    # ---------------------------------------------------------------- run

    async def run(self) -> PipelineStats:
        raw_q: asyncio.Queue = asyncio.Queue(maxsize=self.queue_size)
        chunk_q: asyncio.Queue = asyncio.Queue(maxsize=self.queue_size)

        async def pump() -> None:
            n = 0
            async for item in self.source:
                await raw_q.put(item)
                self.stats.items_in += 1
                obs_metrics.REGISTRY.counter(
                    "ingest_items_total",
                    "source items entering the ingest pipeline").inc()
                n += 1
                if self.max_items is not None and n >= self.max_items:
                    break
            await raw_q.put(_STOP)

        await asyncio.gather(pump(),
                             self._extract(raw_q, chunk_q),
                             self._store(chunk_q))
        logger.info("ingest finished: %s", self.stats.snapshot())
        return self.stats

    def run_sync(self) -> PipelineStats:
        return asyncio.run(self.run())
