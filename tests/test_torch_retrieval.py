"""The port's retrieval layer against the JAX package's on the same
vectors: the exact store (numpy and native backends, ip and l2, delete
and grow, persistence), the IVF store (recall, persistence, equal
results), the factory and the gated connectors, ``DocumentIndex`` end to
end, and the CUDA backend's CPU path against the reference's
``_TpuBackend`` on the CPU.

Tolerances: ids exact everywhere; float32 backends' scores within 1e-6
relative (1e-5 native against a float64 product); the device backend's
scores within the bfloat16 rounding of a score (2^-8 of its magnitude,
plus 1e-6): both multiply bfloat16 operands into float32 sums, in
different orders."""

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu import retrieval as jret
from generativeaiexamples_tpu.embed.encoder import \
    HashEmbedder as JHashEmbedder
from generativeaiexamples_tpu.retrieval.tpu_search import _TpuBackend
from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
from generativeaiexamples_tpu_torch.retrieval import (
    DocumentIndex, ExactStore, IVFFlatStore, get_vector_store, native)
from generativeaiexamples_tpu_torch.retrieval.cuda_search import (
    _CudaBackend, topk_lowest_id_first)
from generativeaiexamples_tpu_torch.retrieval.store import (score_matrix,
                                                            store_from_config)
from generativeaiexamples_tpu_torch.utils.errors import ConfigError


def _corpus(n=400, d=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _brute_ref(base, q, k, metric):
    scores = score_matrix(base, q[None, :], metric)[0]
    return np.argsort(-scores)[:k]


def _ids(hits):
    return [h.id for h in hits]


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("backend", ["numpy", "auto"])
def test_exact_matches_reference_store(metric, backend):
    base = _corpus()
    ours = ExactStore(dim=32, metric=metric, backend=backend)
    ref = jret.ExactStore(dim=32, metric=metric, backend=backend)
    assert ours.add(base) == ref.add(base) == list(range(len(base)))
    for row in _corpus(3, 32, seed=7):
        got, want = ours.search(row, k=5)[0], ref.search(row, k=5)[0]
        assert _ids(got) == _ids(want) == list(_brute_ref(base, row, 5,
                                                          metric))
        np.testing.assert_allclose([h.score for h in got],
                                   [h.score for h in want], rtol=1e-6)
        scores = [h.score for h in got]
        assert scores == sorted(scores, reverse=True)


def test_exact_delete_and_grow():
    base = _corpus(50, 16)
    ours, ref = ExactStore(dim=16, capacity=8), jret.ExactStore(dim=16,
                                                                 capacity=8)
    ours.add(base)
    ref.add(base)
    assert len(ours) == 50 and ours.search(base[10], k=1)[0][0].id == 10
    ours.delete([10])
    ref.delete([10])
    assert len(ours) == 49
    hits = ours.search(base[10], k=3)[0]
    assert 10 not in _ids(hits)
    assert _ids(hits) == _ids(ref.search(base[10], k=3)[0])


def test_exact_persistence_roundtrip_both_ways(tmp_path):
    """A store the port saves loads in the reference and the port with the
    same answers, and the reverse."""
    base = _corpus(30, 16)
    ours = ExactStore(dim=16)
    ours.add(base)
    ours.delete([3])
    ours.save(str(tmp_path / "port"))
    ref = jret.ExactStore(dim=16)
    ref.add(base)
    ref.delete([3])
    ref.save(str(tmp_path / "ref"))
    q = base[5]
    want = _ids(ours.search(q, k=4)[0])
    for loaded in (ExactStore.load(str(tmp_path / "port")),
                   ExactStore.load(str(tmp_path / "ref")),
                   jret.ExactStore.load(str(tmp_path / "port"))):
        assert len(loaded) == 29
        assert _ids(loaded.search(q, k=4)[0]) == want


def test_ivf_recall_and_equal_results():
    base = _corpus(600, 32, seed=1)
    ivf = IVFFlatStore(dim=32, nlist=16, nprobe=8)
    ivf.add(base)
    jivf = jret.IVFFlatStore(dim=32, nlist=16, nprobe=8)
    jivf.add(base)
    exact = ExactStore(dim=32, backend="numpy")
    exact.add(base)
    hits_at_4 = 0
    for row in _corpus(10, 32, seed=9):
        got = ivf.search(row, k=4)[0]
        assert _ids(got) == _ids(jivf.search(row, k=4)[0])
        hits_at_4 += len(set(_ids(got)) & set(_ids(exact.search(row,
                                                                k=4)[0])))
    assert hits_at_4 / 40 >= 0.7


def test_ivf_small_corpus_is_exact_and_persists(tmp_path):
    base = _corpus(40, 16)
    ivf = IVFFlatStore(dim=16, nlist=64, nprobe=16)
    ivf.add(base)
    assert ivf.search(base[7], k=1)[0][0].id == 7
    big = _corpus(300, 16)
    ivf = IVFFlatStore(dim=16, nlist=8, nprobe=8)
    ivf.add(big)
    ivf.delete([0])
    ivf.save(str(tmp_path))
    for loaded in (IVFFlatStore.load(str(tmp_path)),
                   jret.IVFFlatStore.load(str(tmp_path))):
        assert len(loaded) == 299
        assert loaded.search(big[1], k=1)[0][0].id == 1


def test_native_kernel_matches_the_reference_and_builds_in_the_build_dir():
    if native.load() is None:
        pytest.skip("no native toolchain")
    from generativeaiexamples_tpu.retrieval import native as jnative
    path = native.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent.name == "generativeaiexamples_tpu_torch"
    base = _corpus(500, 48)
    q = _corpus(6, 48, seed=2)
    idx, score = native.brute_topk(base, q, 10, 0)
    for qi in range(q.shape[0]):
        expect = _brute_ref(base, q[qi], 10, "ip")
        assert list(idx[qi]) == list(expect)
        np.testing.assert_allclose(score[qi], (base @ q[qi])[expect],
                                   rtol=1e-5)
    if jnative.load() is not None:
        jidx, jscore = jnative.brute_topk(base, q, 10, 0)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(score, jscore)


def test_factory_names_and_refusals():
    store = get_vector_store("exact-cuda", dim=8, device="cpu")
    assert isinstance(store, ExactStore) and store.backend == "cuda"
    assert isinstance(get_vector_store("exact", dim=8), ExactStore)
    assert isinstance(get_vector_store("ivfflat", dim=8), IVFFlatStore)
    with pytest.raises(ConfigError, match="exact-cuda"):
        get_vector_store("exact-tpu", dim=8)
    with pytest.raises(ValueError):
        get_vector_store("bogus")
    with pytest.raises(ValueError, match="cuda"):
        ExactStore(dim=8, backend="tpu")
    from generativeaiexamples_tpu_torch.utils.app_config import \
        VectorStoreConfig
    with pytest.raises(ConfigError, match="exact-cuda"):
        VectorStoreConfig(name="exact-tpu")
    ivf = store_from_config(VectorStoreConfig(name="ivfflat", nlist=4,
                                              nprobe=2), 8)
    assert (ivf.nlist, ivf.nprobe) == (4, 2)


def test_connectors_gated():
    for pkg, name in (("pymilvus", "milvus"), ("psycopg2", "pgvector")):
        try:
            __import__(pkg)
            continue
        except ImportError:
            pass
        with pytest.raises(ConfigError, match=pkg):
            get_vector_store(name, dim=8)


def test_document_index_end_to_end_matches_the_reference(tmp_path):
    texts = ["TPUs use a systolic array called the MXU for matmuls.",
             "The Eiffel Tower is in Paris, France.",
             "JAX compiles programs with XLA for TPU execution.",
             "Milvus is a vector database."]
    metas = [{"source": "tpu.txt"}, {"source": "travel.txt"},
             {"source": "tpu.txt"}, {"source": "db.txt"}]
    index = DocumentIndex(HashEmbedder(dim=64))
    index.add_texts(texts, metadatas=metas)
    jindex = jret.DocumentIndex(JHashEmbedder(dim=64))
    jindex.add_texts(texts, metadatas=metas)
    docs = index.similarity_search("systolic array MXU matmul", k=2)
    jdocs = jindex.similarity_search("systolic array MXU matmul", k=2)
    assert [(d.id, d.text, d.metadata) for d in docs] == [
        (d.id, d.text, d.metadata) for d in jdocs]
    assert [d.score for d in docs] == pytest.approx(
        [d.score for d in jdocs], abs=1e-6)
    assert any("MXU" in d.text for d in docs)
    assert index.sources() == ["db.txt", "tpu.txt", "travel.txt"]
    ids, emb, got = index.export_corpus()
    assert ids == [0, 1, 2, 3] and emb.shape == (4, 64) and got == texts

    index.save(str(tmp_path))
    index2 = DocumentIndex(HashEmbedder(dim=64),
                           store=ExactStore.load(str(tmp_path / "store")))
    index2.load_docs(str(tmp_path))
    assert [d.text for d in index2.similarity_search(
        "systolic array MXU matmul", k=2)] == [d.text for d in docs]
    assert DocumentIndex(HashEmbedder(dim=8)).similarity_search("x") == []
    # An empty store passed in is kept (it is falsy: it has a length).
    empty = ExactStore(dim=8, backend="cuda", device="cpu")
    assert DocumentIndex(HashEmbedder(dim=8), store=empty).store is empty


# ------------------------------------------------------ the device backend

def _with_duplicates(n, d, seed):
    """Random unit rows where rows 5..9 copy row 3 and rows 20..22 copy
    row 17: exact ties, as overlapping chunks and repeated boilerplate
    make."""
    x = _corpus(n, d, seed)
    x[5:10] = x[3]
    x[20:23] = x[17]
    return x


def _bf16_close(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    tol = np.abs(theirs) * 2.0 ** -8 + 1e-6
    assert np.all(np.abs(ours - theirs) <= tol), (ours, theirs)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dead", [False, True], ids=["live", "deleted"])
def test_cuda_backend_cpu_path_matches_the_tpu_backend(metric, dead):
    """The CUDA backend's CPU path gives the reference ``_TpuBackend``'s
    ids on the CPU, ties (duplicate rows) included, and -1 past the live
    rows."""
    base = _with_duplicates(300, 64, seed=4)
    live = None
    if dead:
        live = np.ones(300, np.uint8)
        live[[3, 6, 17, 100]] = 0
    queries = np.concatenate([base[[3, 17, 40]], _corpus(5, 64, seed=11)])
    ours = _CudaBackend(base, live, metric, device="cpu")
    ref = _TpuBackend(base, live, metric)
    assert ours.base.dtype == torch.bfloat16 and ours.base.shape[0] == 384
    for k in (1, 4, 10):
        idx, sc = ours.search(queries, k)
        jidx, jsc = ref.search(queries, k)
        np.testing.assert_array_equal(idx, jidx)
        _bf16_close(sc, jsc)
    # The ties of row 3's copies come out lowest id first.
    idx, _ = ours.search(base[3:4], 6)
    if dead:
        assert list(idx[0][:4]) == [5, 7, 8, 9]
    else:
        assert list(idx[0]) == [3, 5, 6, 7, 8, 9]
    small = _CudaBackend(base[:6], None, metric, device="cpu")
    idx, sc = small.search(base[:1], 8)
    jidx, _ = _TpuBackend(base[:6], None, metric).search(base[:1], 8)
    np.testing.assert_array_equal(idx, jidx)
    assert list(idx[0][6:]) == [-1, -1]


def test_topk_orders_ties_lowest_id_first():
    s = torch.tensor([[0.5, -1.0, 0.5, float("-inf"), 2.0, -1.0, 0.25]])
    vals, idx = topk_lowest_id_first(s, 7)
    assert idx.tolist() == [[4, 0, 2, 6, 1, 5, 3]]
    assert vals.tolist() == [[2.0, 0.5, 0.5, 0.25, -1.0, -1.0,
                              float("-inf")]]
    rows = torch.from_numpy(np.random.default_rng(0).integers(
        -3, 3, (4, 1000)).astype(np.float32))
    vals, idx = topk_lowest_id_first(rows, 50)
    order = np.lexsort((np.arange(1000)[None].repeat(4, 0),
                        -rows.numpy()), axis=-1)[:, :50]
    np.testing.assert_array_equal(idx.numpy(), order)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_exact_cuda_store_matches_exact_tpu_store(metric):
    """The store with the device backend (CPU path) against the
    reference's with its TPU backend, through add, search and delete."""
    base = _with_duplicates(200, 64, seed=3)
    ours = ExactStore(dim=64, metric=metric, backend="cuda", device="cpu")
    ref = jret.ExactStore(dim=64, metric=metric, backend="tpu")
    ours.add(base)
    ref.add(base)
    q = np.concatenate([base[[3, 17]], _corpus(4, 64, seed=3)])
    for row in q:
        assert _ids(ours.search(row, k=8)[0]) == _ids(ref.search(row,
                                                                 k=8)[0])
    ours.delete([3, 5])
    ref.delete([3, 5])
    for row in q:
        got, want = ours.search(row, k=8)[0], ref.search(row, k=8)[0]
        assert _ids(got) == _ids(want)
        _bf16_close([h.score for h in got], [h.score for h in want])
