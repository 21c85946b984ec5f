"""RAG evaluation suite (script form of the reference's eval notebooks) —
the port's own copy of the JAX package's ``tools/eval/``, which is pure
Python: the same prompts, parsers and metrics, so a report from either
package scores alike. ``__main__`` runs it over the port's chatbot and
``live.py`` over the port's chain server and engine.

Pipeline stages, mirroring reference tools/evaluation/*.ipynb:
  1. ``synthesize``   — LLM-generated QA pairs from KB chunks
                        (ref: 01_synthetic_data_generation.ipynb).
  2. ``runner.fill``  — run the RAG chain to produce answers + contexts
                        (ref: 02_filling_RAG_outputs_for_Evaluation.ipynb).
  3. ``metrics``      — RAGAS-style faithfulness / context precision with
                        an LLM verdict model, plus deterministic retrieval
                        nDCG / hit-rate / MRR against the gold chunk
                        (ref: 03_eval_ragas.ipynb; BASELINE.md north star
                        "retrieval nDCG parity").
  4. ``judge``        — LLM-as-judge Likert 1-5 scoring with parse/retry
                        (ref: 04_Human_Like_RAG_Evaluation-AIP.ipynb).
"""

from .judge import judge_answer, summarize_ratings
from .metrics import (context_precision, faithfulness, ndcg_at_k,
                      retrieval_metrics)
from .runner import EvalConfig, run_eval
from .synthesize import QAPair, generate_qa_pairs

__all__ = [
    "QAPair", "generate_qa_pairs", "faithfulness", "context_precision",
    "ndcg_at_k", "retrieval_metrics", "judge_answer", "summarize_ratings",
    "EvalConfig", "run_eval",
]
