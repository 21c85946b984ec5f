"""The port's remaining chain modules against the JAX package's, on the
CPU: ``chains/hier_splitter.py`` under the reference's
``tests/test_hier_splitter.py`` scenarios (and node for node against the
reference's trees and merges), and the ``foundation_endpoints`` and
``query_decomposition`` examples, each behind both chain servers fed the
same upload (``/uploadDocument``, ``/generate`` with and without the
knowledge base, ``/documentSearch``). Texts, ids and statuses are exact;
scores within 1e-6 (both hash embedders are numpy)."""

import json
import os
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

from generativeaiexamples_tpu_torch.chains import hier_splitter as hier
from generativeaiexamples_tpu_torch.chains.examples import (
    foundation_endpoints, query_decomposition)
from generativeaiexamples_tpu_torch.chains.hier_splitter import (
    AutoMergingIndex, HierarchicalSplitter)
from generativeaiexamples_tpu_torch.chains.llm import LLM, EchoLLM
from generativeaiexamples_tpu_torch.chains.server import (create_app,
                                                          discover_example)
from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
from generativeaiexamples_tpu_torch.retrieval.docstore import DocumentIndex
from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
from generativeaiexamples_tpu_torch.utils.configuration import from_dict

from generativeaiexamples_tpu.chains import hier_splitter as jhier
from generativeaiexamples_tpu.chains import llm as jllm
from generativeaiexamples_tpu.chains.examples import \
    foundation_endpoints as jfound
from generativeaiexamples_tpu.chains.examples import \
    query_decomposition as jquery
from generativeaiexamples_tpu.embed.encoder import HashEmbedder as JHash
from generativeaiexamples_tpu.retrieval.docstore import \
    DocumentIndex as JIndex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text(n_sentences=120):
    return " ".join(
        f"Sentence {i} about topic {'alpha' if i < 60 else 'beta'}."
        for i in range(n_sentences))


# ----------------------------------------------------------- hier_splitter

def _nodes(nodes):
    return [(n.id, n.text, n.level, n.parent, list(n.children))
            for n in nodes]


def test_split_builds_the_references_strict_tree():
    sp = HierarchicalSplitter(chunk_sizes=(256, 64, 16))
    nodes = sp.split(_text())
    by_id = {n.id: n for n in nodes}
    roots = [n for n in nodes if n.parent is None]
    leaves = sp.leaves(nodes)
    assert roots and leaves
    assert all(n.level == 0 for n in roots)
    for n in nodes:
        for c in n.children:
            assert by_id[c].parent == n.id
            assert by_id[c].level == n.level + 1
            assert by_id[c].text in n.text or by_id[c].text.strip() in n.text
    assert {n.level for n in leaves} == {2}
    ref = jhier.HierarchicalSplitter(chunk_sizes=(256, 64, 16))
    assert _nodes(nodes) == _nodes(ref.split(_text()))
    assert _nodes(leaves) == _nodes(ref.leaves(ref.split(_text())))


@pytest.mark.parametrize("sizes", [(128, 128), (64, 256)])
def test_chunk_sizes_must_decrease(sizes):
    with pytest.raises(ValueError, match="strictly decrease"):
        HierarchicalSplitter(chunk_sizes=sizes)
    with pytest.raises(ValueError, match="strictly decrease"):
        jhier.HierarchicalSplitter(chunk_sizes=sizes)


def _merging(mod_hier, index_cls, embed_cls, **kw):
    return mod_hier.AutoMergingIndex(
        index_cls(embed_cls(dim=64)),
        mod_hier.HierarchicalSplitter(chunk_sizes=(256, 64, 16)), **kw)


def _docs(docs):
    return [(d.text, round(float(d.score), 6), dict(d.metadata))
            for d in docs]


def test_automerge_replaces_children_with_parent():
    ami = _merging(hier, DocumentIndex, HashEmbedder, merge_ratio=0.5)
    ref = _merging(jhier, JIndex, JHash, merge_ratio=0.5)
    n_leaves = ami.add_document(_text(), source="doc")
    assert n_leaves == ref.add_document(_text(), source="doc") >= 8
    docs = ami.retrieve("topic alpha", k=min(n_leaves, 12))
    assert docs
    assert any(d.metadata.get("merged_depth", 0) >= 1 for d in docs), \
        [d.metadata for d in docs]
    merged = next(d for d in docs
                  if d.metadata.get("merged_depth", 0) >= 1)
    assert merged.metadata["level"] < 2
    assert merged.metadata["merged_children"] > 1
    keys = [(d.metadata["tree"], d.metadata["node_id"]) for d in docs]
    assert len(keys) == len(set(keys))
    scores = [d.score for d in docs]
    assert scores == sorted(scores, reverse=True)
    assert _docs(docs) == _docs(ref.retrieve("topic alpha",
                                             k=min(n_leaves, 12)))


def test_two_documents_with_same_source_keep_separate_trees():
    ami = AutoMergingIndex(DocumentIndex(HashEmbedder(dim=64)),
                           HierarchicalSplitter(chunk_sizes=(256, 64, 16)))
    ref = _merging(jhier, JIndex, JHash)
    for idx in (ami, ref):
        idx.add_document(_text(), source="same.txt")
        idx.add_document("Entirely different subject: cooking pasta. " * 30,
                         source="same.txt")
    docs = ami.retrieve("topic alpha", k=12)
    assert docs
    for d in docs:
        node = ami._trees[d.metadata["tree"]][d.metadata["node_id"]]
        assert d.text == node.text
    assert _docs(docs) == _docs(ref.retrieve("topic alpha", k=12))


def test_single_hit_is_not_merged():
    ami = AutoMergingIndex(DocumentIndex(HashEmbedder(dim=64)),
                           HierarchicalSplitter(chunk_sizes=(256, 64, 16)))
    ami.add_document(_text(), source="doc")
    docs = ami.retrieve("topic alpha", k=1)
    assert len(docs) == 1
    assert docs[0].metadata.get("merged_depth", 0) == 0
    assert docs[0].metadata["level"] == 2
    with pytest.raises(ValueError, match="merge_ratio"):
        AutoMergingIndex(DocumentIndex(HashEmbedder(dim=64)),
                         merge_ratio=0.0)


# ------------------------------------------------------- the two examples

CHAIN_CFG = {"llm": {"model_engine": "echo"},
             "embeddings": {"model_engine": "hash", "dimensions": 64},
             "text_splitter": {"chunk_size": 100, "chunk_overlap": 20}}
DOC = "deployment.md"


def _configs():
    from generativeaiexamples_tpu.utils.app_config import \
        AppConfig as JAppConfig
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom_dict
    return from_dict(AppConfig, CHAIN_CFG), jfrom_dict(JAppConfig, CHAIN_CFG)


def _scripted(base):
    """A deterministic LLM double over ``base`` (each package's ``LLM``)
    for the decomposition agent: a Search step, then a Math step, then
    Done; answers extracted from the first context line; the final
    answer echoes the ledger."""

    class Scripted(base):
        def __init__(self):
            self.calls = []

        def stream(self, prompt, max_tokens=256, stop=None,
                   temperature=1.0, top_k=1, top_p=0.0):
            self.calls.append(prompt)
            if prompt.startswith("You are an assistant that decomposes"):
                steps = prompt.count("- Q: ")
                tool = ("Search" if steps == 0 else
                        "Math" if steps == 1 else "Done")
                text = json.dumps({"Tool_Request": tool,
                                   "Generated Sub Questions": [
                                       f"sub question {steps}"]})
            elif prompt.startswith("Context: "):
                text = prompt.split("\n")[0][len("Context: "):][:60]
            elif prompt.startswith("Compute the result"):
                text = "42"
            else:
                text = "FINAL: " + prompt[-300:]
            text = text[:max_tokens * 4]
            for i in range(0, len(text), 9):
                yield text[i:i + 9]

    return Scripted()


def _examples(kind):
    """(port example, reference example) of ``kind`` on hash embedders."""
    ours_cfg, ref_cfg = _configs()
    if kind == "foundation_endpoints":
        return (foundation_endpoints.RemoteEndpointsChatbot(
                    llm=EchoLLM(prefix="", tail_chars=4000),
                    embedder=HashEmbedder(dim=64), config=ours_cfg),
                jfound.RemoteEndpointsChatbot(
                    llm=jllm.EchoLLM(prefix="", tail_chars=4000),
                    embedder=JHash(dim=64), config=ref_cfg))
    return (query_decomposition.QueryDecompositionChatbot(
                llm=_scripted(LLM), embedder=HashEmbedder(dim=64),
                config=ours_cfg),
            jquery.QueryDecompositionChatbot(
                llm=_scripted(jllm.LLM), embedder=JHash(dim=64),
                config=ref_cfg))


def _call(url, body=None, data=None, headers=None):
    if body is not None:
        data = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _upload(base, name, payload):
    boundary = uuid.uuid4().hex
    data = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f" filename=\"{name}\"\r\nContent-Type: text/markdown\r\n\r\n"
            ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return _call(base + "/uploadDocument", data=data, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})


@pytest.mark.parametrize("kind", ["foundation_endpoints",
                                  "query_decomposition"])
def test_example_serves_as_the_reference(kind, tmp_path, monkeypatch):
    """Both chain servers resolve the example by its short name and, fed
    the same upload, answer ``/generate`` (with and without the knowledge
    base) and ``/documentSearch`` alike; an upload with no text is
    refused alike."""
    from conftest import serve_app

    from generativeaiexamples_tpu.chains.server import create_app as jcreate
    from generativeaiexamples_tpu.chains.server import \
        discover_example as jdiscover
    ours, ref = _examples(kind)
    assert discover_example(kind) is type(ours)
    assert jdiscover(kind) is type(ref)
    monkeypatch.setenv("GAIE_RUN_DIR", str(tmp_path))
    with open(os.path.join(ROOT, "docs", DOC), "rb") as f:
        payload = f.read()
    apps = (create_app(ours, str(tmp_path / "port")),
            jcreate(ref, str(tmp_path / "ref")))
    with serve_app(apps[0], timeout=60) as port, \
            serve_app(apps[1], timeout=60) as jref:
        sides = (port, jref)
        got = [_upload(base, DOC, payload) for base in sides]
        assert got[0][0] == got[1][0] == 200
        assert len(ours.index) == len(ref.index) > 3
        for body in ({"question": "How is the operator deployed?",
                      "use_knowledge_base": True, "num_tokens": 200},
                     {"question": "Hello?", "use_knowledge_base": False,
                      "num_tokens": 64}):
            got = [_call(base + "/generate", body) for base in sides]
            assert got[0] == got[1]
            assert got[0][0] == 200 and got[0][1]
        got = [_call(base + "/documentSearch",
                     {"content": "helm chart values", "num_docs": 3})
               for base in sides]
        assert got[0][0] == got[1][0] == 200
        hits = [json.loads(t) for _, t in got]
        assert [(h["source"], h["content"]) for h in hits[0]] == [
            (h["source"], h["content"]) for h in hits[1]]
        assert len(hits[0]) == 3 and hits[0][0]["source"] == DOC
        np.testing.assert_allclose([h["score"] for h in hits[0]],
                                   [h["score"] for h in hits[1]], atol=1e-6)
        if kind == "foundation_endpoints":
            got = [_upload(base, "empty.txt", b"   ") for base in sides]
            assert got[0][0] == got[1][0] != 200
    if kind == "query_decomposition":
        # Search, then Math, then Done, then the final answer: one
        # extraction per search sub-question.
        assert len(ours.llm.calls) == len(ref.llm.calls)
        assert ours.llm.calls == ref.llm.calls


@pytest.mark.parametrize("text", [
    'Sure! {"Tool_Request": "Search", "Generated Sub Questions": '
    '["a", "b"]} hope that helps',
    '{"Tool_Request": "Math", "sub_questions": "2+2"}',
    '{"Tool_Request": "Done"}', "no json here", '{"broken": ',
    '{"Tool_Request": " Search ", "Generated Sub Questions": ["", "x"]}'])
def test_tool_requests_parse_as_the_reference(text):
    assert query_decomposition.parse_tool_request(text) == \
        jquery.parse_tool_request(text)


def test_agent_ledger_and_search_cap_match_the_reference():
    """The agent's ledger after a run, and the search-round cap (an LLM
    that always asks for a search stops after ``MAX_SEARCH_ROUNDS``)."""
    ours, ref = _examples("query_decomposition")
    for bot in (ours, ref):
        bot.index.add_texts(["The operator deploys a helm chart.",
                             "Replicas drain before an upgrade."])
    a, b = ours.run_agent("How is it deployed?"), ref.run_agent(
        "How is it deployed?")
    assert (a.question_trace, a.answer_trace, a.done, a.search_calls) == (
        b.question_trace, b.answer_trace, b.done, b.search_calls)
    assert a.render() == b.render() and a.done and a.search_calls == 1

    class Searcher(LLM):
        def stream(self, prompt, max_tokens=256, stop=None,
                   temperature=1.0, top_k=1, top_p=0.0):
            yield '{"Tool_Request": "Search"}'

    ours.llm = Searcher()
    ledger = ours.run_agent("q")
    assert ledger.search_calls == query_decomposition.MAX_SEARCH_ROUNDS
    assert not ledger.done
