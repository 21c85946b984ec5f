"""Fused RAG admission: retrieval, prompt assembly and prefill as one
device program — port of the reference package's ``engine/rag_fusion.py``.

The chatbot's host path crosses the host three times before the first
token: it embeds the question, searches the store and tokenizes the
assembled prompt. The fused path keeps the corpus on the device and runs
the chain inside the engine's admission program:

  question tokens --> e5 encoder --> dot-product top-k over the corpus
      --> token-space prompt assembly (template + retrieved chunks)
      --> prefill + sample + KV insert (the engine's admission)

One host-to-device copy in (the question in both vocabularies), one
device-to-host copy out (the first token, the assembled length and the
retrieved rows). On the card the engine captures the whole program as one
CUDA graph per (spec, greedy).

Token-space assembly: chunk token ids are joined at chunk boundaries
instead of tokenizing the joined string, so a merge that would span a
boundary stays split. The ids differ from the host path's only at those
joins; the rendered text is the same.

The reference left this program to XLA, not Pallas, so plain PyTorch
calls are the port (no hand-written kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..models import encoder as enc
from ..retrieval.cuda_search import topk_lowest_id_first


@dataclass(frozen=True)
class FusedRagSpec:
    """Static geometry and template tokens of the fused program.

    Prompt layout: ``prefix ⧺ [sep? doc_i]* ⧺ mid ⧺ question ⧺ suffix``
    (sep before every doc but the first: the token-space "\\n\\n".join).
    Every length is fixed when the program is captured.
    """
    prefix_ids: tuple          # template up to {context_str} (with BOS)
    sep_ids: tuple             # joiner between retrieved chunks
    mid_ids: tuple             # between {context_str} and {query_str}
    suffix_ids: tuple          # template tail after {query_str}
    top_k: int = 4             # chunks retrieved
    ctx_budget: int = 1500     # context token cap
    bucket: int = 1024         # assembled prompt's static length
    chunk_tokens: int = 256    # per-chunk token capacity (C)
    q_bucket: int = 64         # question token capacity (LLM vocab)
    enc_bucket: int = 128      # question token capacity (encoder vocab)


def build_prompt_parts(rag_template: str, tokenizer) -> dict:
    """Split the RAG template at its placeholders and tokenize each part
    (the prefix gets the BOS). Sentinel-based, so any template text
    works."""
    probe = rag_template.format(context_str="\x00", query_str="\x01")
    prefix, rest = probe.split("\x00", 1)
    mid, suffix = rest.split("\x01", 1)
    return {
        "prefix_ids": tuple(tokenizer.encode(prefix, add_bos=True)),
        "sep_ids": tuple(tokenizer.encode("\n\n", add_bos=False)),
        "mid_ids": tuple(tokenizer.encode(mid, add_bos=False)),
        "suffix_ids": tuple(tokenizer.encode(suffix, add_bos=False)),
    }


def corpus_capacity(n: int, top_k: int = 0) -> int:
    """Rows the device corpus holds for ``n`` chunks: the next power of
    two from 8 (so incremental ingest reuses the captured programs), and
    at least ``top_k``, which the top-k needs."""
    cap = 8
    while cap < max(n, top_k):
        cap *= 2
    return cap


class FusedRag:
    """The encoder parameters, the device-resident corpus and the assembly
    function the engine runs inside its fused admission.

    The corpus lives in static device buffers: ``emb`` (cap, D) float32,
    ``toks`` (cap, C) and ``lens`` (cap,) int32, and ``n``, a one-element
    int32 tensor. ``set_corpus`` copies into them in place while the
    capacity holds, so a captured program keeps reading the right
    addresses; only a larger capacity reallocates them."""

    def __init__(self, enc_params, enc_cfg, spec: FusedRagSpec,
                 device: torch.device):
        self.enc_params = enc_params
        self.enc_cfg = enc_cfg
        self.spec = spec
        self.device = device
        self.corpus = self._alloc(corpus_capacity(0, spec.top_k))
        # The template parts as device constants, made once: a captured
        # program may copy nothing from the host.
        self.parts = {name: torch.tensor(getattr(spec, name),
                                         dtype=torch.int32, device=device)
                      for name in ("prefix_ids", "sep_ids", "mid_ids",
                                   "suffix_ids")}

    def _alloc(self, cap: int) -> dict:
        D, C, dev = self.enc_cfg.hidden_size, self.spec.chunk_tokens, \
            self.device
        return {"emb": torch.zeros((cap, D), dtype=torch.float32, device=dev),
                "toks": torch.zeros((cap, C), dtype=torch.int32, device=dev),
                "lens": torch.zeros((cap,), dtype=torch.int32, device=dev),
                "n": torch.zeros((1,), dtype=torch.int32, device=dev)}

    @property
    def capacity(self) -> int:
        return self.corpus["emb"].shape[0]

    def set_corpus(self, emb: np.ndarray, toks: np.ndarray,
                   lens: np.ndarray, copy=None) -> bool:
        """Upload the retrieval corpus: (n, D) rows, (n, >= C) chunk
        tokens cut to C and their lengths capped at C, padded to the
        capacity (the next power of two from 8). While the capacity holds,
        the arrays are copied into the buffers in place by ``copy(dst,
        array)`` (the engine passes its pinned, asynchronous copy); a
        larger capacity allocates new buffers. Returns True when it did:
        programs captured over the old buffers must be captured again."""
        emb = np.asarray(emb, np.float32)
        n, d = emb.shape
        cap = corpus_capacity(n, self.spec.top_k)
        C = self.spec.chunk_tokens
        host = {"emb": np.zeros((cap, d), np.float32),
                "toks": np.zeros((cap, C), np.int32),
                "lens": np.zeros((cap,), np.int32),
                "n": np.array([n], np.int32)}
        host["emb"][:n] = emb
        host["toks"][:n] = np.asarray(toks)[:, :C]
        host["lens"][:n] = np.minimum(lens, C)
        grew = cap != self.capacity
        if grew:
            self.corpus = self._alloc(cap)
        copy = copy or (lambda dst, arr: dst.copy_(torch.from_numpy(arr)))
        for name, arr in host.items():
            copy(self.corpus[name], arr)
        return grew

    def assemble(self, q_enc: torch.Tensor, q_llm: torch.Tensor,
                 q_len: torch.Tensor, share=None):
        """On the device: embed the question, take the top-k chunks under
        the token budget and scatter template, chunks and question into
        one (bucket,) token row. ``q_enc`` (2, enc_bucket) int32 holds
        the encoder tokens and mask, ``q_llm`` (q_bucket,) the question
        in the LLM vocabulary and ``q_len`` (1,) its length. Returns
        (tokens (bucket,) int32, length (1,) int32, top_ids (K,) int32).
        ``share``: applied in place to the chosen rows before assembly
        (under tensor parallelism the leader's rows broadcast, so every
        rank assembles the same prompt whatever its own search's ties).
        Nothing here reads a device value on the host, so the engine can
        capture it."""
        spec, corpus, dev = self.spec, self.corpus, self.device
        S, K, C = spec.bucket, spec.top_k, spec.chunk_tokens
        hidden = enc.apply(self.enc_params, self.enc_cfg, q_enc[0][None],
                           q_enc[1][None])
        qvec = enc.mean_pool(hidden, q_enc[1][None], normalize=True)[0]

        emb = corpus["emb"]
        scores = emb @ qvec.to(emb.dtype)                          # (cap,)
        rows = torch.arange(emb.shape[0], device=dev)
        scores = scores.masked_fill(rows >= corpus["n"], float("-inf"))
        # Ties lowest id first, as lax.top_k orders them.
        _, top_ids = topk_lowest_id_first(scores, K)
        if share is not None:
            top_ids = share(top_ids.to(torch.int32))
        kk = torch.arange(K, device=dev)
        # Past a corpus shorter than K the top-k returns dead rows.
        dlens = torch.where(kk < corpus["n"], corpus["lens"][top_ids],
                            torch.zeros((K,), dtype=torch.int32, device=dev))
        dtoks = corpus["toks"][top_ids]                            # (K, C)

        sep_len, pre_len = len(spec.sep_ids), len(spec.prefix_ids)
        # The context budget keeps the leading run of docs that fits.
        costs = torch.where(dlens > 0, dlens + (kk > 0).int() * sep_len,
                            torch.zeros_like(dlens))
        keep = (torch.cumsum(costs, 0) <= spec.ctx_budget) & (dlens > 0)
        costs = torch.where(keep, costs, torch.zeros_like(costs))
        ends = torch.cumsum(costs, 0)
        doc_off = pre_len + ends - costs                          # (K,)
        mid_off = pre_len + ends[-1:]                             # (1,)

        # Every (position, token) pair of the prompt, scattered at once
        # into a row with a trash slot S: a position that is invalid or
        # past the bucket goes there (the reference scatters with
        # mode="drop"; an out-of-range index is an error on the card).
        parts = self.parts
        idx, vals = [], []

        def place(ids, offset, valid):
            """``ids`` (..., m) at ``offset`` (...,) + 0..m-1 where
            ``valid`` (..., m) holds."""
            pos = offset[..., None] + torch.arange(ids.shape[-1],
                                                   device=dev)
            idx.append(torch.where(valid & (pos < S), pos,
                                   torch.full_like(pos, S)).reshape(-1))
            vals.append(ids.reshape(-1))

        def const(name, offset):
            ids = parts[name]
            if ids.numel():
                place(ids, offset, torch.ones_like(ids, dtype=torch.bool))

        const("prefix_ids", torch.zeros((), dtype=torch.int64, device=dev))
        if sep_len and K > 1:
            place(parts["sep_ids"].expand(K - 1, sep_len), doc_off[1:],
                  keep[1:, None].expand(K - 1, sep_len))
        tok_off = doc_off + (kk > 0).long() * sep_len
        place(dtoks, tok_off,
              keep[:, None] & (torch.arange(C, device=dev) < dlens[:, None]))
        const("mid_ids", mid_off[0])
        q_off = mid_off + len(spec.mid_ids)
        place(q_llm, q_off[0],
              torch.arange(q_llm.shape[0], device=dev) < q_len)
        suf_off = q_off + q_len
        const("suffix_ids", suf_off[0])
        out = torch.zeros((S + 1,), dtype=torch.int32, device=dev)
        out.scatter_(0, torch.cat(idx).long(),
                     torch.cat([v.to(torch.int32) for v in vals]))
        length = torch.clamp(suf_off + len(spec.suffix_ids), max=S)
        return out[:S], length.to(torch.int32), top_ids.to(torch.int32)


def corpus_rows(texts: Sequence[str], tokenizer, chunk_tokens: int):
    """On the host: tokenize chunk texts (no BOS) into padded (N, C) rows
    for ``FusedRag.set_corpus``."""
    n = len(texts)
    toks = np.zeros((n, chunk_tokens), np.int32)
    lens = np.zeros((n,), np.int32)
    for i, t in enumerate(texts):
        ids = tokenizer.encode(t, add_bos=False)[:chunk_tokens]
        toks[i, :len(ids)] = ids
        lens[i] = len(ids)
    return toks, lens
