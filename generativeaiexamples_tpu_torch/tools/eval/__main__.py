"""CLI: ``python -m generativeaiexamples_tpu_torch.tools.eval``.

Runs the full evaluation pipeline over the port's RAG chatbot against a
corpus directory (or a small built-in corpus) and prints the metrics
JSON. Defaults to the dev stack, echo LLM + hash embedder, so it runs
headless with no card; ``--llm-engine openai-compat --server-url ...``
points the chain and the judge at a live model server, and ``--embedder
torch-cuda`` embeds on the card. Writes the report only where
``--output`` says.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

_BUILTIN_CORPUS = {
    "mxu.txt": (
        "The MXU is a 128x128 systolic array that performs matrix "
        "multiplies in bfloat16 with float32 accumulation. Large, batched "
        "matmuls keep the MXU busy; scalar loops and dynamic shapes "
        "prevent XLA from tiling work onto it."),
    "ici.txt": (
        "TPU chips in a slice communicate over ICI links. XLA compiles "
        "collectives such as all-reduce, all-gather, and reduce-scatter "
        "directly into the program, so no separate communication library "
        "is needed at runtime."),
    "paging.txt": (
        "Paged KV caching shares a pool of fixed-size pages between "
        "decode slots. Each slot holds a block table mapping logical to "
        "physical pages, so cache capacity is sized to HBM instead of "
        "batch size times maximum length."),
    "batching.txt": (
        "Continuous batching admits new requests into the decode batch "
        "between steps without recompiling the program. Prefill uses "
        "bucketed static shapes; decode masks inactive slots."),
}


def build_example(args):
    from ...chains.examples.developer_rag import QAChatbot
    from ...utils.app_config import AppConfig
    from ...utils.configuration import from_dict

    cfg = from_dict(AppConfig, {
        "llm": {"model_engine": args.llm_engine,
                "server_url": args.server_url or ""},
        "embeddings": {"model_engine": args.embedder,
                       "dimensions": args.embedding_dim},
        "vector_store": {"name": "exact"},
        "text_splitter": {"chunk_size": args.chunk_size,
                          "chunk_overlap": args.chunk_overlap},
    })
    return QAChatbot(config=cfg)


def ingest_builtin(example) -> None:
    """The built-in corpus, through the chatbot's own ingest."""
    with tempfile.TemporaryDirectory() as td:
        for name, text in _BUILTIN_CORPUS.items():
            path = os.path.join(td, name)
            with open(path, "w") as f:
                f.write(text)
            example.ingest_docs(path, name)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m generativeaiexamples_tpu_torch.tools.eval",
        description="RAG evaluation: synthetic QA + RAGAS-style metrics + "
                    "retrieval nDCG + LLM judge")
    parser.add_argument("--corpus", default=None,
                        help="directory of text/PDF files (default: "
                             "built-in corpus)")
    parser.add_argument("--llm-engine", default="echo",
                        choices=["echo", "openai-compat"],
                        help="LLM for the chain AND the judge")
    parser.add_argument("--server-url", default=os.environ.get(
        "APP_LLM_SERVERURL", ""))
    parser.add_argument("--embedder", default="hash",
                        choices=["hash", "torch-cuda"])
    parser.add_argument("--embedding-dim", type=int, default=256)
    parser.add_argument("--chunk-size", type=int, default=120)
    parser.add_argument("--chunk-overlap", type=int, default=20)
    parser.add_argument("--top-k", type=int, default=4)
    parser.add_argument("--max-questions", type=int, default=16)
    parser.add_argument("--max-chunks", type=int, default=8)
    parser.add_argument("--pairs-per-chunk", type=int, default=2)
    parser.add_argument("--num-tokens", type=int, default=150)
    parser.add_argument("--no-judge", action="store_true")
    parser.add_argument("--no-ragas", action="store_true")
    parser.add_argument("--output", default=None,
                        help="where to write the report (default: none)")
    args = parser.parse_args(argv)

    example = build_example(args)
    if args.corpus:
        for name in sorted(os.listdir(args.corpus)):
            path = os.path.join(args.corpus, name)
            if os.path.isfile(path):
                example.ingest_docs(path, name)
    else:
        ingest_builtin(example)

    from .runner import EvalConfig, run_eval
    cfg = EvalConfig(top_k=args.top_k, num_tokens=args.num_tokens,
                     pairs_per_chunk=args.pairs_per_chunk,
                     max_questions=args.max_questions,
                     max_chunks=args.max_chunks,
                     judge=not args.no_judge, ragas=not args.no_ragas,
                     output_path=args.output)
    report = run_eval(example, example.llm, cfg)
    json.dump(report.metrics, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
