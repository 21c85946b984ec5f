"""Hierarchical chunking and auto-merging retrieval — port of the
reference package's ``chains/hier_splitter.py``.

A document is split into a tree of progressively smaller token windows;
only the leaves are embedded and searched (small chunks retrieve
precisely), and when enough of one parent's leaves answer the same query
they are merged back into the parent's larger window (large chunks give
generation context).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..retrieval.docstore import Document, DocumentIndex
from .splitter import TokenTextSplitter


@dataclass
class Node:
    """One window in the hierarchy. ``level`` 0 is the coarsest."""
    id: int
    text: str
    level: int
    parent: Optional[int] = None
    children: list[int] = field(default_factory=list)


class HierarchicalSplitter:
    """Split text into a tree of token windows, one level per chunk size.

    ``chunk_sizes`` must be strictly decreasing (coarse → fine); each
    level re-splits its parent's text, so every leaf is contained in the
    text of its whole ancestor chain. Overlap is 0 on purpose: an
    auto-merged parent must equal the concatenation of its children, and
    overlapping children would duplicate tokens at the seams.
    """

    def __init__(self, chunk_sizes: Sequence[int] = (2048, 512, 128)):
        sizes = list(chunk_sizes)
        if sizes != sorted(sizes, reverse=True) or len(set(sizes)) != len(sizes):
            raise ValueError(
                f"chunk_sizes must strictly decrease, got {sizes}")
        self.chunk_sizes = sizes
        self._splitters = [TokenTextSplitter(chunk_size=s, chunk_overlap=0)
                           for s in sizes]

    def split(self, text: str) -> list[Node]:
        """All nodes of the tree, ids dense in creation order."""
        counter = itertools.count()
        nodes: list[Node] = []

        def build(text: str, level: int, parent: Optional[int]) -> int:
            node = Node(id=next(counter), text=text, level=level,
                        parent=parent)
            nodes.append(node)
            if level + 1 < len(self.chunk_sizes):
                for piece in self._splitters[level + 1].split_text(text):
                    node.children.append(build(piece, level + 1, node.id))
            return node.id

        for piece in self._splitters[0].split_text(text):
            build(piece, 0, None)
        return nodes

    @staticmethod
    def leaves(nodes: Sequence[Node]) -> list[Node]:
        return [n for n in nodes if not n.children]


class AutoMergingIndex:
    """DocumentIndex wrapper that indexes leaves and merges retrievals.

    ``retrieve`` replaces leaf hits by their parent node whenever at
    least ``merge_ratio`` of the parent's children were retrieved (the
    LlamaIndex ``AutoMergingRetriever`` default of a simple majority),
    recursively — a merged parent can in turn merge into ITS parent. The
    merged Document keeps the best child's score and records the merge
    depth in metadata.
    """

    def __init__(self, index: DocumentIndex,
                 splitter: Optional[HierarchicalSplitter] = None,
                 merge_ratio: float = 0.5):
        if not 0.0 < merge_ratio <= 1.0:
            raise ValueError("merge_ratio must be in (0, 1]")
        self.index = index
        self.splitter = splitter or HierarchicalSplitter()
        self.merge_ratio = merge_ratio
        # Trees keyed by an add_document sequence number, NOT by source:
        # node ids restart at 0 per split, and two documents may share a
        # source string — a source-keyed map would cross their trees.
        self._trees: dict[int, dict[int, Node]] = {}
        self._tree_source: dict[int, str] = {}
        self._seq = itertools.count()

    def add_document(self, text: str, source: str = "") -> int:
        """Split, keep the tree, embed + index the leaves. Returns the
        number of leaves indexed."""
        tree_id = next(self._seq)
        nodes = self.splitter.split(text)
        self._trees[tree_id] = {n.id: n for n in nodes}
        self._tree_source[tree_id] = source
        leaves = self.splitter.leaves(nodes)
        self.index.add_documents([
            Document(text=n.text,
                     metadata={"source": source, "tree": tree_id,
                               "node_id": n.id, "level": n.level})
            for n in leaves])
        return len(leaves)

    def retrieve(self, query: str, k: int = 6) -> list[Document]:
        hits = self.index.similarity_search(query, k=k)
        best: dict[tuple[int, int], Document] = {}
        for d in hits:
            best[(d.metadata["tree"], d.metadata["node_id"])] = d
        merged = self._merge(best)
        return sorted(merged, key=lambda d: -(d.score or 0.0))

    def _merge(self, best: dict[tuple[int, int], Document]
               ) -> list[Document]:
        while True:
            # group current hits by parent; one merge pass per iteration
            # so a fully-hit grandparent merges on the next loop
            by_parent: dict[tuple[int, int], list] = {}
            for (tree, nid), doc in best.items():
                node = self._trees[tree][nid]
                if node.parent is not None:
                    by_parent.setdefault((tree, node.parent), []).append(
                        (node, doc))
            changed = False
            for (tree, pid), members in by_parent.items():
                parent = self._trees[tree][pid]
                if len(members) / len(parent.children) >= self.merge_ratio \
                        and len(members) > 1:
                    score = max(d.score or 0.0 for _, d in members)
                    depth = 1 + max(d.metadata.get("merged_depth", 0)
                                    for _, d in members)
                    for node, _ in members:
                        del best[(tree, node.id)]
                    best[(tree, pid)] = Document(
                        text=parent.text, score=score,
                        metadata={"source": self._tree_source[tree],
                                  "tree": tree, "node_id": pid,
                                  "level": parent.level,
                                  "merged_depth": depth,
                                  "merged_children": len(members)})
                    changed = True
            if not changed:
                return list(best.values())
