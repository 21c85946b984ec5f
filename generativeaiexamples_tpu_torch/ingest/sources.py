"""Ingest sources: filesystem watch, RSS feeds, Kafka (a port of the
reference package's ``ingest/sources.py``; feeds are fetched over
``urllib.request``, and the Kafka client is imported only when a
``KafkaSource`` builds its own consumer).

Parity with the reference's source pipes (reference:
experimental/streaming_ingest_rag/module/{file_source_pipe,
rss_source_pipe}.py and the Kafka source in vdb_utils.py:28-120). Each
source is an async iterator of ``SourceItem``s; continuous modes poll
(filesystem mtimes, feed refetch) the way the reference's watchers do.
"""

from __future__ import annotations

import asyncio
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from glob import glob
from html.parser import HTMLParser
from typing import AsyncIterator, Optional

from ..utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class SourceItem:
    """One unit of raw content entering the pipeline."""
    content: str = ""                 # inline text (RSS/Kafka payloads)
    path: str = ""                    # file path (filesystem source)
    source_id: str = ""               # stable id for dedup/metadata
    metadata: dict = field(default_factory=dict)


class FilesystemSource:
    """Glob-matching file source; ``watch=True`` keeps polling for new or
    modified files (reference: file_source_pipe.py watch_dir +
    MonitorStage semantics)."""

    def __init__(self, patterns: list[str] | str, watch: bool = False,
                 poll_interval: float = 2.0):
        self.patterns = [patterns] if isinstance(patterns, str) else patterns
        self.watch = watch
        self.poll_interval = poll_interval
        self._seen: dict[str, float] = {}

    def _scan(self) -> list[str]:
        fresh = []
        for pattern in self.patterns:
            for path in sorted(glob(pattern, recursive=True)):
                if not os.path.isfile(path):
                    continue
                mtime = os.path.getmtime(path)
                if self._seen.get(path) != mtime:
                    self._seen[path] = mtime
                    fresh.append(path)
        return fresh

    async def __aiter__(self) -> AsyncIterator[SourceItem]:
        while True:
            for path in self._scan():
                yield SourceItem(path=path, source_id=path,
                                 metadata={"source": os.path.basename(path),
                                           "kind": "file"})
            if not self.watch:
                return
            await asyncio.sleep(self.poll_interval)


class _TextExtractor(HTMLParser):
    def __init__(self):
        super().__init__()
        self.chunks: list[str] = []

    def handle_data(self, data):
        if data.strip():
            self.chunks.append(data.strip())


def _strip_html(text: str) -> str:
    p = _TextExtractor()
    p.feed(text)
    return " ".join(p.chunks)


class RSSSource:
    """RSS/Atom feed source using stdlib XML parsing (the reference pulls
    feedparser through Morpheus's RSSController; rss_source_pipe.py).
    ``watch=True`` refetches on an interval, emitting only new entries."""

    def __init__(self, urls: list[str] | str, watch: bool = False,
                 poll_interval: float = 60.0, fetch=None):
        self.urls = [urls] if isinstance(urls, str) else urls
        self.watch = watch
        self.poll_interval = poll_interval
        self._fetch = fetch or self._http_fetch
        self._seen: set[str] = set()

    @staticmethod
    def _http_fetch(url: str) -> str:
        """The feed's text (``HTTPError`` on a status of 400 or more)."""
        import urllib.request
        with urllib.request.urlopen(url, timeout=30) as resp:
            charset = resp.headers.get_content_charset() or "utf-8"
            return resp.read().decode(charset, "replace")

    def _parse(self, xml_text: str, url: str) -> list[SourceItem]:
        root = ET.fromstring(xml_text)
        ns = {"atom": "http://www.w3.org/2005/Atom",
              "content": "http://purl.org/rss/1.0/modules/content/"}
        items = []
        # RSS 2.0 <item> or Atom <entry>
        entries = root.findall(".//item") or root.findall(".//atom:entry",
                                                         ns)
        for entry in entries:
            def text_of(*tags: str) -> str:
                for tag in tags:
                    try:
                        node = entry.find(tag, ns)
                    except SyntaxError:  # unmapped prefix: skip the tag
                        continue
                    if node is not None and (node.text or "").strip():
                        return node.text.strip()
                return ""
            guid = text_of("guid", "link", "atom:id", "title")
            title = text_of("title", "atom:title")
            body = text_of("description", "content:encoded",
                           "atom:summary", "atom:content")
            items.append(SourceItem(
                content=_strip_html(f"{title}. {body}") if body else title,
                source_id=f"{url}#{guid}",
                metadata={"source": url, "title": title, "kind": "rss"}))
        return items

    async def __aiter__(self) -> AsyncIterator[SourceItem]:
        while True:
            for url in self.urls:
                try:
                    text = await asyncio.get_running_loop().run_in_executor(
                        None, self._fetch, url)
                except Exception as exc:  # noqa: BLE001 — feed down: skip
                    logger.warning("rss fetch failed for %s: %s", url, exc)
                    continue
                for item in self._parse(text, url):
                    if item.source_id in self._seen:
                        continue
                    self._seen.add(item.source_id)
                    yield item
            if not self.watch:
                return
            await asyncio.sleep(self.poll_interval)


class KafkaSource:
    """Kafka topic source (reference: vdb_utils.py kafka source config +
    producer/src tooling). Requires a kafka client library at runtime —
    an external-boundary dependency like the reference's; constructing
    without one raises with instructions rather than pretending."""

    def __init__(self, bootstrap_servers: str, topic: str,
                 group_id: str = "tpu-rag-ingest", consumer=None):
        self._consumer = consumer
        if consumer is None:
            try:
                from kafka import KafkaConsumer  # type: ignore
            except ImportError as exc:
                raise ImportError(
                    "KafkaSource needs the kafka-python package (or pass "
                    "a pre-built consumer=); not installed in this "
                    "image") from exc
            self._consumer = KafkaConsumer(
                topic, bootstrap_servers=bootstrap_servers,
                group_id=group_id, value_deserializer=lambda b: b)
        self.topic = topic

    async def __aiter__(self) -> AsyncIterator[SourceItem]:
        import json
        loop = asyncio.get_running_loop()
        while True:
            batch = await loop.run_in_executor(
                None, lambda: self._consumer.poll(timeout_ms=1000))
            if batch is None:
                return
            empty = True
            for records in dict(batch).values():
                for rec in records:
                    empty = False
                    raw = rec.value
                    text = raw.decode("utf-8", "replace") \
                        if isinstance(raw, bytes) else str(raw)
                    try:  # payloads are usually JSON documents
                        doc = json.loads(text)
                    except ValueError:
                        doc = None
                    if isinstance(doc, dict):  # else: the raw text
                        text = doc.get("content") or doc.get("text") or text
                    yield SourceItem(
                        content=text,
                        source_id=f"{self.topic}@{rec.offset}",
                        metadata={"source": self.topic, "kind": "kafka"})
            if empty and getattr(self._consumer, "_drain_once", False):
                return
