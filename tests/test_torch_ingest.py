"""The port's streaming ingest against the reference package's: the
filesystem source (one-shot and watch), RSS parsing, dedup and the urllib
fetch, a Kafka source over a scripted consumer, the pipeline over the
hash embedder and an exact store (chunk texts, ids, metadata and stats,
``max_items``, a bad document skipped) and the CLI.

Tolerances: items, texts, ids and counts exact; embeddings within 1e-6
(the hash embedder is the same arithmetic in numpy on both sides)."""

import asyncio
import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
from aiohttp import web

from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
from generativeaiexamples_tpu_torch.ingest import (FilesystemSource,
                                                   IngestPipeline,
                                                   KafkaSource, RSSSource)
from generativeaiexamples_tpu_torch.ingest.__main__ import main
from generativeaiexamples_tpu_torch.retrieval.docstore import DocumentIndex

from generativeaiexamples_tpu import ingest as jingest
from generativeaiexamples_tpu.ingest.__main__ import main as jmain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = ("frontend.md", "evaluation.md", "README.md", "router.md")


def _collect(source, limit=None):
    """The items of an async source as dicts (at most ``limit``)."""
    async def run():
        out = []
        async for item in source:
            out.append(dataclasses.asdict(item))
            if limit is not None and len(out) >= limit:
                break
        return out
    return asyncio.run(run())


def _corpus(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    for n in DOCS:
        shutil.copy(os.path.join(ROOT, "docs", n), d / n)
    return d


# ----------------------------------------------------------------- sources

def test_filesystem_source_one_shot_matches_the_reference(tmp_path):
    d = _corpus(tmp_path)
    (d / "sub").mkdir()
    (d / "sub" / "nested.md").write_text("nested text")
    patterns = [str(d / "*.md"), str(d / "**" / "*.md")]
    ours = _collect(FilesystemSource(patterns))
    assert ours == _collect(jingest.FilesystemSource(patterns))
    assert sorted(os.path.basename(i["path"]) for i in ours) == sorted(
        DOCS + ("nested.md",))
    assert all(i["metadata"]["kind"] == "file" for i in ours)


def test_filesystem_source_watch_matches_the_reference(tmp_path):
    """``watch=True`` re-scans: a new file and a modified file come again;
    an unchanged one does not."""
    out = {}
    for side, cls in (("port", FilesystemSource),
                      ("ref", jingest.FilesystemSource)):
        d = tmp_path / side
        d.mkdir()
        (d / "a.txt").write_text("alpha")
        (d / "b.txt").write_text("beta")

        def later(d=d):
            time.sleep(0.15)
            (d / "c.txt").write_text("gamma")
            a = d / "a.txt"
            a.write_text("alpha two")
            os.utime(a, (time.time() + 5, time.time() + 5))
        t = threading.Thread(target=later)
        t.start()
        items = _collect(cls(str(d / "*.txt"), watch=True,
                             poll_interval=0.05), limit=4)
        t.join()
        out[side] = [os.path.relpath(i["path"], d) for i in items]
    assert out["port"] == out["ref"]
    assert out["port"][:2] == ["a.txt", "b.txt"]
    assert sorted(out["port"][2:]) == ["a.txt", "c.txt"]


RSS = """<?xml version="1.0" encoding="UTF-8"?>
<rss version="2.0" xmlns:content="http://purl.org/rss/1.0/modules/content/">
<channel><title>feed</title>
<item><title>Paged attention</title><guid>g1</guid>
<description>&lt;p&gt;Pages of &lt;b&gt;128&lt;/b&gt; tokens.&lt;/p&gt;
</description></item>
<item><title>Only a title</title><link>http://x/2</link></item>
<item><title>Encoded</title><guid>g3</guid>
<content:encoded>&lt;div&gt;Split-K halves&lt;/div&gt;</content:encoded></item>
</channel></rss>"""
ATOM = """<feed xmlns="http://www.w3.org/2005/Atom"><title>a</title>
<entry><id>urn:1</id><title>Atom one</title><summary>First entry.</summary>
</entry>
<entry><id>urn:2</id><title>Atom two</title><content>Second.</content>
</entry></feed>"""


def test_rss_parsing_and_dedup_match_the_reference():
    """RSS 2.0 and Atom entries; a watch refetch yields only new entries;
    a feed that fails to fetch is skipped."""
    def fetcher():
        calls = {"n": 0}

        def fetch(url):
            if url == "http://down":
                raise OSError("feed down")
            calls["n"] += 1
            if url == "http://atom":
                return ATOM
            return RSS if calls["n"] < 3 else RSS.replace(
                "</channel>", "<item><title>New</title><guid>g9</guid>"
                              "<description>fresh</description></item>"
                              "</channel>")
        return fetch
    urls = ["http://down", "http://rss", "http://atom"]
    ours = _collect(RSSSource(urls, watch=True, poll_interval=0.01,
                              fetch=fetcher()), limit=6)
    ref = _collect(jingest.RSSSource(urls, watch=True, poll_interval=0.01,
                                     fetch=fetcher()), limit=6)
    assert ours == ref
    assert [i["source_id"] for i in ours] == [
        "http://rss#g1", "http://rss#http://x/2", "http://rss#g3",
        "http://atom#urn:1", "http://atom#urn:2", "http://rss#g9"]
    assert ours[0]["content"] == "Paged attention. Pages of 128 tokens."
    assert ours[1]["content"] == "Only a title"


@contextlib.contextmanager
def _feed_server():
    loop = asyncio.new_event_loop()
    box, started = {}, threading.Event()

    async def feed(request):
        return web.Response(text=RSS, content_type="application/rss+xml")

    async def missing(request):
        raise web.HTTPNotFound()

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            app = web.Application()
            app.router.add_get("/feed.xml", feed)
            app.router.add_get("/missing.xml", missing)
            box["runner"] = web.AppRunner(app)
            await box["runner"].setup()
            site = web.TCPSite(box["runner"], "127.0.0.1", 0)
            await site.start()
            box["port"] = box["runner"].addresses[0][1]
        loop.run_until_complete(boot())
        started.set()
        loop.run_forever()
        loop.run_until_complete(box["runner"].cleanup())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(30)
    try:
        yield f"http://127.0.0.1:{box['port']}"
    finally:
        loop.call_soon_threadsafe(loop.stop)
        t.join(30)


def test_rss_fetch_over_http_matches_the_reference():
    """The default fetch (urllib here) reads a served feed as the
    reference's does; a feed answering 404 is skipped."""
    with _feed_server() as base:
        urls = [base + "/missing.xml", base + "/feed.xml"]
        ours = _collect(RSSSource(urls))
        assert ours == _collect(jingest.RSSSource(urls))
    assert len(ours) == 3


class FakeRecord:
    def __init__(self, value, offset):
        self.value, self.offset = value, offset


class FakeConsumer:
    """``poll`` hands out the scripted batches, then empty ones; the
    source stops at the first empty batch (``_drain_once``)."""
    _drain_once = True

    def __init__(self, batches):
        self.batches = list(batches)

    def poll(self, timeout_ms=1000):
        return self.batches.pop(0) if self.batches else {}


def _kafka_batches():
    return [{"p0": [FakeRecord(b'{"content": "json content"}', 0),
                    FakeRecord(b"plain bytes", 1)]},
            {"p0": [FakeRecord('{"text": "text field"}', 2)],
             "p1": [FakeRecord(b"\xff\xfe bad utf8", 3),
                    FakeRecord(b'{"other": 1}', 4)]}]


def test_kafka_source_matches_the_reference():
    ours = _collect(KafkaSource("b:9092", "topic",
                                consumer=FakeConsumer(_kafka_batches())))
    ref = _collect(jingest.KafkaSource(
        "b:9092", "topic", consumer=FakeConsumer(_kafka_batches())))
    assert ours == ref
    assert [i["content"] for i in ours] == [
        "json content", "plain bytes", "text field", "\ufffd\ufffd bad utf8",
        '{"other": 1}']
    assert [i["source_id"] for i in ours] == [f"topic@{i}" for i in range(5)]


def test_kafka_json_payload_that_is_not_an_object_is_text():
    """A JSON payload that is not an object (the reference's source
    raises on it) is taken as the item's text."""
    batches = [{"p0": [FakeRecord(b"[1, 2]", 0), FakeRecord(b"7", 1)]}]
    ours = _collect(KafkaSource("b:9092", "t",
                                consumer=FakeConsumer(batches)))
    assert [i["content"] for i in ours] == ["[1, 2]", "7"]


def test_kafka_source_needs_a_client_or_a_consumer(monkeypatch):
    monkeypatch.setitem(sys.modules, "kafka", None)
    with pytest.raises(ImportError, match="kafka-python"):
        KafkaSource("b:9092", "topic")


# ---------------------------------------------------------------- pipeline

def _indexes():
    from generativeaiexamples_tpu.embed.encoder import \
        HashEmbedder as JHash
    from generativeaiexamples_tpu.retrieval.docstore import \
        DocumentIndex as JIndex
    return (DocumentIndex(HashEmbedder(dim=64), store_name="exact"),
            JIndex(JHash(dim=64), store_name="exact"))


def _snapshot(stats):
    snap = stats.snapshot()
    return {k: v for k, v in snap.items()
            if k not in ("chunks_per_sec", "elapsed_sec")}


@pytest.mark.parametrize("max_items", [None, 3])
def test_pipeline_matches_the_reference(tmp_path, max_items):
    d = _corpus(tmp_path)
    (d / "broken.pptx").write_bytes(b"not a zip archive")
    (d / "empty.txt").write_text("")
    patterns = [str(d / "*")]
    ours, ref = _indexes()
    # A long linger: every batch is full but the last, whatever the pace.
    kw = dict(chunk_size=120, chunk_overlap=20, batch_size=7,
              linger_sec=60, max_items=max_items)
    stats = IngestPipeline(FilesystemSource(patterns), ours, **kw).run_sync()
    jstats = jingest.IngestPipeline(jingest.FilesystemSource(patterns), ref,
                                    **kw).run_sync()
    assert _snapshot(stats) == _snapshot(jstats)
    n_files = len(DOCS) + 2
    assert stats.items_in == (max_items or n_files)
    if max_items is None:
        assert stats.errors == 1 and stats.documents_extracted == n_files - 1
    assert stats.chunks == stats.chunks_stored == len(ours) > 0
    assert stats.batches == -(-stats.chunks // 7)
    ids = sorted(ours._docs)
    assert ids == sorted(ref._docs) == list(range(len(ours)))
    for i in ids:
        a, b = ours.get(i), ref.get(i)
        assert (a.text, a.metadata) == (b.text, b.metadata)
    for q in ("How does the router pick a replica?", "evaluation metrics"):
        hits = ours.similarity_search(q, k=4)
        jhits = ref.similarity_search(q, k=4)
        assert [h.id for h in hits] == [h.id for h in jhits]
        np.testing.assert_allclose([h.score for h in hits],
                                   [h.score for h in jhits], atol=1e-6)


def test_cli_matches_the_reference(tmp_path, capsys):
    d = _corpus(tmp_path)
    out = {}
    for side, fn in (("port", main), ("ref", jmain)):
        save = tmp_path / f"index_{side}"
        assert fn(["--files", str(d / "*.md"), "--embedder", "hash",
                   "--store", "exact", "--chunk-size", "200",
                   "--chunk-overlap", "50", "--batch-size", "16",
                   "--embedding-dim", "32", "--save-dir", str(save)]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out[side] = ({k: v for k, v in stats.items()
                      if k not in ("chunks_per_sec", "elapsed_sec")},
                     (save / "docs.jsonl").read_text())
    assert out["port"] == out["ref"]
    assert out["port"][0]["chunks_stored"] > len(DOCS)
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            main([])
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            main(["--files", "x", "--embedder", "tpu-jax"])
