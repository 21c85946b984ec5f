"""The port's RAG evaluation suite (``tools/eval``) against the JAX
package's, on the CPU: the same functions give the same values on the
same inputs, ``run_eval`` over the port's dev stack (echo LLM, hash
embedder, exact store) gives the reference's report over its own, the
CLI runs headless, and the live eval answers through the port's chain
server on golden-tiny."""

import json
import os
import subprocess
import sys

import pytest

from generativeaiexamples_tpu.tools import eval as jeval
from generativeaiexamples_tpu.tools.eval import judge as jjudge
from generativeaiexamples_tpu.tools.eval import metrics as jmetrics
from generativeaiexamples_tpu.tools.eval import synthesize as jsynth
from generativeaiexamples_tpu_torch.tools import eval as teval
from generativeaiexamples_tpu_torch.tools.eval import judge as tjudge
from generativeaiexamples_tpu_torch.tools.eval import metrics as tmetrics
from generativeaiexamples_tpu_torch.tools.eval import synthesize as tsynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ScriptedLLM:
    """Canned responses in order, the last one repeated."""

    def __init__(self, responses):
        self.responses = list(responses)
        self.prompts = []

    def complete(self, prompt, max_tokens=256, stop=None, temperature=1.0,
                 top_k=1, top_p=0.0):
        self.prompts.append(prompt)
        return self.responses[min(len(self.prompts) - 1,
                                  len(self.responses) - 1)]


QA_TEXTS = [
    '[{"question": "What is the MXU size?", "answer": "It is 128x128."}]',
    'Here:\n```json\n{"question": "What links chips together?", '
    '"answer": "ICI links."}\n```\nDone.',
    json.dumps({"question1": "How big is the page size here?",
                "answer1": "128 tokens.", "question2": "What is stored in "
                "pages?", "answer2": "KV cache."}),
    '[{"question": "...", "answer": "..."}]',
    "no json here at all",
    'prose {"Q": "Which unit multiplies matrices fast?", "A": "The MXU."} '
    'and {"query": "What carries the collective ops?", "response": "ICI"}',
    '{"pair1": {"Question": "What does the pool share?", '
    '"Answer": "Fixed-size pages."}}',
]


@pytest.mark.parametrize("text", QA_TEXTS)
def test_extract_qa_json_matches(text):
    assert tsynth.extract_qa_json(text) == jsynth.extract_qa_json(text)


CHUNKS = ["The MXU is a systolic array. More text follows here.",
          "Paged KV shares a pool. Second sentence here.",
          "tiny", "Continuous batching admits requests between decode "
          "steps without recompiling; prefill uses bucketed shapes."]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_fallback_pairs_match(chunk):
    assert tsynth.extractive_pair(chunk) == jsynth.extractive_pair(chunk)
    assert tsynth.keyword_pair(chunk) == jsynth.keyword_pair(chunk)


@pytest.mark.parametrize("responses", [
    ["garbage", "still garbage"],
    ['[{"question": "What does the pool share?", '
     '"answer": "Fixed-size pages."}]'],
])
def test_generate_qa_pairs_matches(responses):
    chunks = [(c, {"doc_id": i, "source": f"{i}.txt"})
              for i, c in enumerate(CHUNKS)]
    got = tsynth.generate_qa_pairs(ScriptedLLM(responses), chunks)
    want = jsynth.generate_qa_pairs(ScriptedLLM(responses), chunks)
    assert [p.to_dict() for p in got] == [p.to_dict() for p in want]


@pytest.mark.parametrize("text", ["Yes, clearly.", "No.", "Yes and no",
                                  "maybe?", "FALSE", "true story"])
def test_parse_verdict_matches(text):
    assert tmetrics.parse_verdict(text) == jmetrics.parse_verdict(text)


@pytest.mark.parametrize("responses,contexts", [
    (["The MXU is 128x128.\nThe MXU runs bfloat16.", "Yes", "No"], ["c"]),
    (["Statement one is here.", "shrug"], ["c"]),
    (["Yes", "No", "Yes"], ["c1", "c2", "c3"]),
    (["No"], ["c1", "c2"]),
])
def test_ragas_metrics_match(responses, contexts):
    args = ("q", "answer text here", contexts)
    assert tmetrics.faithfulness(ScriptedLLM(responses), *args) == \
        jmetrics.faithfulness(ScriptedLLM(responses), *args)
    assert tmetrics.context_precision(ScriptedLLM(responses), "q", "gt",
                                      contexts) == \
        jmetrics.context_precision(ScriptedLLM(responses), "q", "gt",
                                   contexts)


@pytest.mark.parametrize("ranked,gold,k", [([5, 3, 9], 5, 4),
                                           ([3, 5, 9], 5, 4), ([3, 9], 5, 4),
                                           ([3, 5], 5, 2), ([1], None, 4),
                                           ([1, 2, 3, 4, 5], 5, 4)])
def test_retrieval_metrics_match(ranked, gold, k):
    assert tmetrics.retrieval_metrics(ranked, gold, k) == \
        jmetrics.retrieval_metrics(ranked, gold, k)
    if gold is not None:
        assert tmetrics.ndcg_at_k(ranked, gold, k) == \
            jmetrics.ndcg_at_k(ranked, gold, k)


@pytest.mark.parametrize("text", ['"Rating": 4, "Explanation": "Good."',
                                  "Rating: 5 Explanation: perfect",
                                  "Rating: 0", "Rating: 9",
                                  "no rating at all"])
def test_parse_rating_matches(text):
    assert tjudge.parse_rating(text) == jjudge.parse_rating(text)


def test_judge_and_summary_match():
    r = ["unparsable", '"Rating": 3, "Explanation": "ok"']
    assert tjudge.judge_answer(ScriptedLLM(r), "q", "c", "gt", "a") == \
        jjudge.judge_answer(ScriptedLLM(r), "q", "c", "gt", "a")
    for ratings in ([5, 5, 3, None], [], [None]):
        assert tjudge.summarize_ratings(ratings) == \
            jjudge.summarize_ratings(ratings)


# ----------------------------------------------------------- run_eval

CORPUS = {
    "a.txt": "The MXU is a 128x128 systolic array for matrix multiplies.",
    "b.txt": "Paged KV caching shares a pool of fixed-size pages.",
    "c.txt": "Continuous batching admits requests between decode steps.",
}


def _dev_example(pkg, corpus_dir):
    import importlib
    QAChatbot = importlib.import_module(
        f"{pkg}.chains.examples.developer_rag").QAChatbot
    AppConfig = importlib.import_module(f"{pkg}.utils.app_config").AppConfig
    from_dict = importlib.import_module(
        f"{pkg}.utils.configuration").from_dict
    cfg = from_dict(AppConfig, {
        "llm": {"model_engine": "echo"},
        "embeddings": {"model_engine": "hash", "dimensions": 128},
        "vector_store": {"name": "exact"},
        "text_splitter": {"chunk_size": 60, "chunk_overlap": 10}})
    example = QAChatbot(config=cfg)
    for name in sorted(os.listdir(corpus_dir)):
        example.ingest_docs(os.path.join(corpus_dir, name), name)
    return example


@pytest.fixture
def corpus_dir(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    for name, text in CORPUS.items():
        (d / name).write_text(text)
    return str(d)


def _metrics(report):
    return {k: v for k, v in report.metrics.items() if k != "eval_seconds"}


def test_run_eval_dev_stack_matches_the_reference(corpus_dir, tmp_path):
    """The whole pipeline over the two packages' dev stacks: equal
    questions, answers, contexts and ids, and equal metrics."""
    out = tmp_path / "report.json"
    got = teval.run_eval(*(lambda e: (e, e.llm))(
        _dev_example("generativeaiexamples_tpu_torch", corpus_dir)),
        teval.EvalConfig(output_path=str(out), max_questions=6))
    want = jeval.run_eval(*(lambda e: (e, e.llm))(
        _dev_example("generativeaiexamples_tpu", corpus_dir)),
        jeval.EvalConfig(max_questions=6))
    assert _metrics(got) == _metrics(want)
    assert [q.to_dict() for q in got.questions] == \
        [q.to_dict() for q in want.questions]
    m = got.metrics
    assert m["retrieval"]["ndcg"] > 0.8 and m["faithfulness"] is None
    assert json.loads(out.read_text())["metrics"]["retrieval"] == \
        m["retrieval"]


def test_run_eval_scripted_judge_matches(corpus_dir):
    responses = [
        '[{"question": "What carries the collectives?", '
        '"answer": "The interconnect."}]',
        "The interconnect carries them.", "Yes", "Yes", "No",
        '"Rating": 4, "Explanation": "Close to reference."']
    got = teval.run_eval(
        _dev_example("generativeaiexamples_tpu_torch", corpus_dir),
        ScriptedLLM(responses), teval.EvalConfig(max_questions=2,
                                                 top_k=2))
    want = jeval.run_eval(
        _dev_example("generativeaiexamples_tpu", corpus_dir),
        ScriptedLLM(responses), jeval.EvalConfig(max_questions=2, top_k=2))
    assert _metrics(got) == _metrics(want)
    assert got.metrics["judge"]["rated"] == 2


def test_eval_cli_runs_headless_and_matches(tmp_path, capsys):
    """The port's CLI in a subprocess on the built-in corpus prints the
    reference CLI's metrics, and writes no file unless asked."""
    proc = subprocess.run(
        [sys.executable, "-m", "generativeaiexamples_tpu_torch.tools.eval",
         "--max-questions", "4"], capture_output=True, text=True,
        timeout=240, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert os.listdir(tmp_path) == []
    got = json.loads(proc.stdout)
    from generativeaiexamples_tpu.tools.eval.__main__ import main
    assert main(["--max-questions", "4",
                 "--output", str(tmp_path / "ref.json")]) == 0
    want = json.loads(capsys.readouterr().out)
    got.pop("eval_seconds")
    want.pop("eval_seconds")
    assert got == want and got["retrieval"]["ndcg"] >= 0.8


# ------------------------------------------------------------ live eval

def test_live_eval_through_the_chain_server(corpus_dir, tmp_path):
    """``tools/eval/live.py`` on the CPU: golden-tiny (float32) behind the
    port's chain server, the hash embedder and the exact store, with the
    echo LLM as judge (the engine judges on the card; on the CPU its
    300-token syntheses take minutes). Every question is answered over
    HTTP; the retrieval ids equal an in-process search's on the same
    index and questions; the report lands only at ``--output``."""
    from generativeaiexamples_tpu_torch.chains.llm import EchoLLM
    from generativeaiexamples_tpu_torch.engine import EngineConfig
    from generativeaiexamples_tpu_torch.serving.model_server import \
        build_services
    from generativeaiexamples_tpu_torch.tools.eval import live
    engine, name = build_services(
        "golden-tiny", model_path=os.path.join(REPO, "tests", "fixtures",
                                               "golden_tiny"),
        device="cpu", engine_cfg=EngineConfig(
            dtype="float32", max_slots=4, max_input_length=384,
            max_output_length=128, prefill_buckets=(64, 128, 384)))
    out = tmp_path / "out" / "live.json"
    args = live.parser().parse_args([
        "--corpus", corpus_dir, "--output", str(out), "--chunk-size", "60",
        "--chunk-overlap", "10", "--max-questions", "3", "--num-tokens", "8",
        "--max-context-tokens", "200", "--model-name", name])
    try:
        art = live.run_live(args, engine=engine, judge=EchoLLM())
        # Retrieval only, in process, over the same example and questions.
        example, _, _, _ = live.build_stack(args, engine)
        live.ingest_corpus(example, corpus_dir)
        ids = [[h.id for h in example.index.similarity_search(
            q["question"], k=args.top_k)] for q in art["questions"]]
    finally:
        engine.stop()
        engine.close()
    m = art["metrics"]
    assert m["num_questions"] == 3
    assert art["generation"]["answers"] == 3
    assert art["generation"]["non_empty"] == 3
    assert [q["context_ids"] for q in art["questions"]] == ids
    assert "live chain-server" in art["stack"]["transport"]
    assert m["judge"]["unparsed"] == 3 and m["retrieval"]["scored"] == 3
    assert json.loads(out.read_text())["metrics"] == m
    assert os.listdir(tmp_path / "out") == ["live.json"]
