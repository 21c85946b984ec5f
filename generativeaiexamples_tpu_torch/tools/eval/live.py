"""Live RAG evaluation through the port's chain server — port of the
reference's root ``eval.py``.

Runs the ``tools/eval`` pipeline with answers streamed THROUGH the chain
server (``POST /generate`` over HTTP, read with urllib) on the port's
engine, then scores retrieval (nDCG/hit/MRR against each question's
source chunk), the RAGAS-style metrics and the Likert judge (the
engine's LLM as judge). Retrieval contexts and gold ids come from the
server's own index object, shared in-process, as the reference's runner
labels them.

Honesty model, as the reference's: retrieval metrics are meaningful on
any weights (the hash embedder and the store rank them, no LLM); the
LLM-graded ones only with trained weights, and the report carries how
many verdicts parsed. The judge's prompts are longer than a small
model's context: the judge sees the last ``max_input_length`` tokens of
each (``FittedLLM``), where the reference's engine refused longer ones.

Usage::

    python -m generativeaiexamples_tpu_torch.tools.eval.live \\
        --corpus docs --model-path DIR [--device cuda] --output report.json

The report is written only to ``--output`` (never an ``EVAL_r*.json`` at
the repository root: that name is the reference's artifact).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import threading
import time
import urllib.request
from typing import Iterator

from ...chains.llm import LLM

class LiveChainExample:
    """The runner's example interface, answering THROUGH the live chain
    server: ``rag_chain`` posts to ``/generate`` and reads the streamed
    text; ``index`` is the served example's own."""

    def __init__(self, example, base_url: str):
        self._example = example
        self._base = base_url

    @property
    def index(self):
        return self._example.index

    def rag_chain(self, question: str, num_tokens: int) -> Iterator[str]:
        req = urllib.request.Request(
            f"{self._base}/generate",
            data=json.dumps({"question": question,
                             "use_knowledge_base": True,
                             "num_tokens": num_tokens}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            text = resp.read().decode()
        if "[error]" in text:
            # The server degrades failures into the stream; scoring the
            # error banner would be fiction.
            raise RuntimeError(f"in-stream failure: {text[:200]!r}")
        yield text


class FittedLLM(LLM):
    """An engine LLM whose prompts keep their last ``max_input`` tokens,
    so a judge prompt longer than the model's context still runs."""

    def __init__(self, llm, tokenizer, max_input: int):
        self.llm = llm
        self.tokenizer = tokenizer
        self.max_input = max_input
        self.clipped = 0

    def stream(self, prompt: str, max_tokens: int = 256, stop=None,
               temperature: float = 1.0, top_k: int = 1,
               top_p: float = 0.0) -> Iterator[str]:
        ids = self.tokenizer.encode(prompt)
        if len(ids) > self.max_input:
            self.clipped += 1
            prompt = self.tokenizer.decode(ids[-(self.max_input - 8):])
        yield from self.llm.stream(prompt, max_tokens, stop, temperature,
                                   top_k, top_p)


def serve_http(example, config=None):
    """The chain server on a free local port in a thread; returns
    (base url, stop). ``stop`` cleans the server up and joins the
    thread."""
    from aiohttp import web

    from ...chains.server import create_app

    app = create_app(example, config=config)
    loop = asyncio.new_event_loop()
    box: dict = {}
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            box["runner"] = runner
            box["port"] = runner.addresses[0][1]
        loop.run_until_complete(boot())
        started.set()
        loop.run_forever()
        loop.run_until_complete(box["runner"].cleanup())
        loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    if not started.wait(timeout=60):
        raise RuntimeError("chain server failed to start")

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)

    return f"http://127.0.0.1:{box['port']}", stop


def chatbot_config(args):
    """The chatbot's config: the deterministic hash embedder into the
    ``args.store`` store, the splitter and retriever settings of
    ``args``."""
    from ...utils.app_config import AppConfig
    from ...utils.configuration import from_dict

    return from_dict(AppConfig, {
        "embeddings": {"model_engine": "hash",
                       "dimensions": args.embedding_dim},
        "vector_store": {"name": args.store},
        "text_splitter": {"chunk_size": args.chunk_size,
                          "chunk_overlap": args.chunk_overlap},
        "retriever": {"top_k": args.top_k,
                      "max_context_tokens": args.max_context_tokens},
    })


def build_stack(args, engine=None):
    """(example, engine, model name, weights): the QA chatbot over the
    port's engine (``build_services``; or ``engine`` as given) and the
    ``chatbot_config`` retriever."""
    from ...chains.examples.developer_rag import QAChatbot
    from ...chains.llm import EngineLLM

    name = args.model_name
    if engine is None:
        from ...engine import EngineConfig
        from ...serving.model_server import build_services
        engine, name = build_services(
            name, model_path=args.model_path, device=args.device,
            quantization=args.quantization, engine_cfg=EngineConfig(
                max_slots=4, max_input_length=args.max_input_length,
                max_output_length=args.max_output_length, dtype=args.dtype,
                kv_quant=args.kv_quant))
    example = QAChatbot(llm=EngineLLM(engine), config=chatbot_config(args),
                        fused_rag=False)
    return example, engine, name, args.model_path or "random-init"


def ingest_corpus(example, corpus_dir: str) -> dict:
    exts = (".md", ".txt", ".pdf")
    files = sorted(f for f in os.listdir(corpus_dir)
                   if f.endswith(exts)
                   and os.path.isfile(os.path.join(corpus_dir, f)))
    for name in files:
        example.ingest_docs(os.path.join(corpus_dir, name), name)
    return {"dir": corpus_dir, "files": len(files),
            "chunks": len(example.index._docs)}


def generation_sanity(questions) -> dict:
    """Answer-stream health at any weight quality: did every question
    produce a non-empty, non-error answer through the live server?"""
    answers = [q.answer for q in questions]
    non_empty = [a for a in answers if a.strip()]
    return {
        "answers": len(answers),
        "non_empty": len(non_empty),
        "mean_answer_chars": (round(sum(map(len, non_empty))
                                    / len(non_empty), 1)
                              if non_empty else 0),
    }


def run_live(args, engine=None, judge=None) -> dict:
    """Build (or take) the stack, ingest ``args.corpus``, serve it, run
    the eval through the server and return the report (written to
    ``args.output`` when given). ``judge`` (default: the engine's LLM,
    fitted to its context) synthesizes the questions and grades. The
    engine is stopped at the end unless the caller passed it."""
    from .runner import EvalConfig, run_eval

    example, engine_used, name, weights = build_stack(args, engine)
    if judge is None:
        judge = FittedLLM(example.llm, engine_used.tokenizer,
                          engine_used.cfg.max_input_length)
    try:
        corpus = ingest_corpus(example, args.corpus)
        base_url, stop = serve_http(example, example.config)
        try:
            live = LiveChainExample(example, base_url)
            cfg = EvalConfig(top_k=args.top_k, num_tokens=args.num_tokens,
                             pairs_per_chunk=2,
                             max_questions=args.max_questions,
                             max_chunks=args.max_chunks, judge=True,
                             ragas=not args.no_ragas)
            report = run_eval(live, judge, cfg)
        finally:
            stop()
    finally:
        if engine is None:
            engine_used.stop()
    artifact = {
        "generated_unix": int(time.time()),
        "stack": {
            "llm": name, "weights": weights,
            "dtype": engine_used.cfg.dtype,
            "quantization": args.quantization or None,
            "kv_quant": engine_used.cfg.kv_quant or None,
            "device": str(engine_used.device),
            "embedder": f"hash-{args.embedding_dim} (deterministic)",
            "vector_store": args.store,
            "transport": "live chain-server HTTP (streamed /generate)",
        },
        "corpus": corpus,
        "metrics": report.metrics,
        "generation": generation_sanity(report.questions),
        "judge_prompts_clipped": getattr(judge, "clipped", 0),
        "questions": [q.to_dict() for q in report.questions],
    }
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(artifact, f, indent=2)
            f.write("\n")
    return artifact


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m generativeaiexamples_tpu_torch.tools.eval.live",
        description="RAG quality eval through the port's live chain server")
    p.add_argument("--output", default=None,
                   help="report path (default: print the summary only)")
    p.add_argument("--corpus", required=True,
                   help="directory of documents to ingest and question")
    p.add_argument("--model-path", default=os.environ.get(
        "EVAL_MODEL_PATH", ""))
    p.add_argument("--model-name", default="llama-2-7b-chat",
                   help="registry geometry (a checkpoint's config.json "
                        "overrides it)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--quantization", default="")
    p.add_argument("--kv-quant", default="")
    p.add_argument("--store", default="exact",
                   choices=["exact", "exact-cuda"])
    p.add_argument("--max-input-length", type=int, default=3000)
    p.add_argument("--max-output-length", type=int, default=256)
    p.add_argument("--max-context-tokens", type=int, default=1500)
    p.add_argument("--embedding-dim", type=int, default=256)
    p.add_argument("--chunk-size", type=int, default=150)
    p.add_argument("--chunk-overlap", type=int, default=30)
    p.add_argument("--top-k", type=int, default=4)
    p.add_argument("--num-tokens", type=int, default=100)
    p.add_argument("--max-questions", type=int, default=24)
    p.add_argument("--max-chunks", type=int, default=24)
    p.add_argument("--no-ragas", action="store_true")
    return p


def main(argv=None) -> int:
    artifact = run_live(parser().parse_args(argv))
    summary = {k: artifact["metrics"].get(k) for k in
               ("num_questions", "retrieval", "faithfulness",
                "context_precision", "judge")}
    summary["weights"] = artifact["stack"]["weights"]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
