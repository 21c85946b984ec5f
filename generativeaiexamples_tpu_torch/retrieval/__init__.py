"""Vector retrieval: first-party stores + external-engine connectors (a
port of the reference package's ``retrieval/``). Components:

- ``store``      VectorStore interface + factory.
- ``exact``      Exact top-k store (numpy / native C++ / CUDA backends).
- ``ivf``        IVF-Flat ANN store (nlist/nprobe parity with the reference's
                 Milvus GPU_IVF_FLAT defaults, nlist=64 nprobe=16).
- ``cuda_search`` Exact top-k on the device: one matmul + ``torch.topk``.
- ``native``     C++ kernels (OpenMP) behind ctypes, compiled on demand.
- ``connectors`` Gated Milvus / pgvector client stores.
- ``docstore``   DocumentIndex: embedder + store + text/metadata persistence.
"""

from .store import SearchHit, VectorStore, get_vector_store
from .exact import ExactStore
from .ivf import IVFFlatStore
from .docstore import Document, DocumentIndex

__all__ = [
    "SearchHit", "VectorStore", "get_vector_store", "ExactStore",
    "IVFFlatStore", "Document", "DocumentIndex",
]
