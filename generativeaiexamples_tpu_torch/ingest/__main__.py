"""CLI: ``python -m generativeaiexamples_tpu_torch.ingest`` — streaming
ingest (a port of the reference package's ``ingest/__main__.py``).

Sources: --files GLOB (optionally --watch), --rss URL, --kafka TOPIC.
By default the chunks are embedded and stored on the card: the embedder
is ``torch-cuda`` (the e5-large-v2 encoder on ``--device``, default
``cuda``: the checkpoint in ``--embedder-path``, else random weights from
seed 0) and the store ``exact-cuda``. ``--embedder hash`` (the n-gram
test double, numpy) and ``--store exact`` (numpy) run on the host and
are asked for by name. The destination index persists with --save-dir
so a chain server can load it; the run's ``PipelineStats`` snapshot is
printed as one JSON line.

    python -m generativeaiexamples_tpu_torch.ingest --files 'docs/*.md' \
        --embedder-path /models/e5-large-v2 --save-dir DIR
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m generativeaiexamples_tpu_torch.ingest")
    parser.add_argument("--files", action="append", default=[],
                        help="glob pattern (repeatable)")
    parser.add_argument("--rss", action="append", default=[],
                        help="feed URL (repeatable)")
    parser.add_argument("--kafka", default="",
                        help="topic (requires --kafka-servers)")
    parser.add_argument("--kafka-servers", default="localhost:9092")
    parser.add_argument("--watch", action="store_true",
                        help="keep polling sources for new content")
    parser.add_argument("--poll-interval", type=float, default=5.0)
    parser.add_argument("--embedder", default="torch-cuda",
                        choices=["torch-cuda", "hash"],
                        help="torch-cuda: e5-large-v2 on --device; hash: "
                             "the host-side test double")
    parser.add_argument("--embedding-dim", type=int, default=256,
                        help="the hash embedder's width")
    parser.add_argument("--embedder-path", default="",
                        help="e5-large-v2 checkpoint directory (HF BERT "
                             "safetensors and its tokenizer) for "
                             "--embedder torch-cuda; none: random weights")
    parser.add_argument("--device", default="cuda",
                        help="the torch-cuda encoder's device")
    parser.add_argument("--store", default="exact-cuda",
                        help="vector store; exact-cuda keeps the index on "
                             "the card, exact is the numpy store")
    parser.add_argument("--chunk-size", type=int, default=510)
    parser.add_argument("--chunk-overlap", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--max-items", type=int, default=None)
    parser.add_argument("--save-dir", default="")
    args = parser.parse_args(argv)

    from ..embed.encoder import get_embedder
    from ..retrieval.docstore import DocumentIndex
    from .pipeline import IngestPipeline
    from .sources import FilesystemSource, KafkaSource, RSSSource

    sources = []
    if args.files:
        sources.append(FilesystemSource(args.files, watch=args.watch,
                                        poll_interval=args.poll_interval))
    if args.rss:
        sources.append(RSSSource(args.rss, watch=args.watch,
                                 poll_interval=args.poll_interval))
    if args.kafka:
        sources.append(KafkaSource(args.kafka_servers, args.kafka))
    if not sources:
        parser.error("at least one of --files/--rss/--kafka is required")

    async def merged():
        # Pump sources concurrently: sequential chaining would let a
        # --watch source's infinite poll loop starve every later source.
        import asyncio
        q: asyncio.Queue = asyncio.Queue(maxsize=64)
        stop = object()

        async def pump(src):
            try:
                async for item in src:
                    await q.put(item)
            finally:
                await q.put(stop)

        tasks = [asyncio.ensure_future(pump(s)) for s in sources]
        done_sources = 0
        try:
            while done_sources < len(sources):
                item = await q.get()
                if item is stop:
                    done_sources += 1
                    continue
                yield item
        finally:
            for t in tasks:
                t.cancel()

    embedder = get_embedder(args.embedder, "e5-large-v2",
                            checkpoint_path=args.embedder_path or None,
                            dim=args.embedding_dim, device=args.device)
    index = DocumentIndex(embedder, store_name=args.store)
    pipe = IngestPipeline(merged(), index, chunk_size=args.chunk_size,
                          chunk_overlap=args.chunk_overlap,
                          batch_size=args.batch_size,
                          max_items=args.max_items)
    stats = pipe.run_sync()
    if args.save_dir:
        index.save(args.save_dir)
    json.dump(stats.snapshot(), sys.stdout)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
