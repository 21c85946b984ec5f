"""Vocab-tiled fused unembed + sampling for the decode round — port of the
reference's ``ops/fused_sampler.py``.

The materialized tail builds, every step, a ``(B, V)`` float32 logit
tensor, a penalized copy, two ``(B, V)`` bool masks, and sorts the whole
vocabulary. This module streams the ``lm_head`` in vocab tiles instead and
folds penalize -> mask -> sample into each tile, carrying only
O(B * cand_k) state across tiles:

- the repetition penalty and the bad-words masks are applied per tile,
  from the packed 32-token words (``ops/sampling.py``), sliced per tile:
  no ``(B, V)`` bool exists;
- greedy is a running argmax;
- sampling is Gumbel-max (``argmax(scaled + gumbel)`` is a categorical
  draw) with per-tile noise, plus a running top-``cand_k`` of the raw
  scaled values (the Gumbel-top-k carry), so top-k / top-p truncation is
  resolved after the stream from the candidates alone, with an exact
  running logsumexp for the top-p mass.

Noise: the reference keys each tile's Gumbel field on ``fold_in(key, t)``.
The port cannot reproduce that stream, so its public functions take the
noise instead: a ``torch.Generator`` from which tile ``t`` draws
``(rows, tile)`` uniforms in tile order (``ops.sampling.gumbel_noise``),
or a callable ``noise_tile(t) -> (rows, tile)`` float32 Gumbel values
(the tests hand over the reference's own field, tile by tile).
``tiled_gumbel`` materializes the field a noise source gives, for the
oracles.

Exactness: greedy, pure temperature sampling and any top-k/top-p whose
kept prefix fits in ``cand_k`` candidates give the tokens of
``sample_reference_tiled`` (the materialized oracle) on the same noise. A
top-p set wider than ``cand_k`` tokens is cut at ``cand_k``, as in the
reference. The candidate merge keeps the reference's order among equal
values (the carry first, then ascending id): a stable descending sort of
the concatenation, not ``torch.topk``, whose order among ties is
unspecified.

Tensor parallelism (``fused_unembed_sample_tp``, ``fused_verify_sample_tp``):
each rank streams the tiles of its own vocab shard and its carries merge
across ranks once at the end (``merge_running_max``, ``merge_candidates``,
``merge_lse``: pure functions of the carries gathered rank-major, the
gather kept apart in ``parallel/comm.py``), so no rank materializes
``(B, V)`` and every rank ends with the same tokens. Ties go to the lowest
shard, which holds the lowest vocab ids: the one-card stream's rule. The
noise is keyed by global tile: a callable gets the global tile index, and
a generator is drawn for every tile of the vocab in order, each rank
keeping its own, so a sharded tail and a one-card tail of the same tile
width draw the same tokens from the same generator state.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..parallel.comm import all_gather, all_reduce_
from ..parallel.mesh import Mesh
from ..utils.errors import ConfigError
from .sampling import MASK_BITS, NEG_INF, gumbel_noise, unpack_mask

DEFAULT_TILE = 4096
DEFAULT_CAND_K = 64

Noise = Union[torch.Generator, Callable[[int], torch.Tensor]]
TileFn = Callable[[int, int], torch.Tensor]


def choose_tile(vocab_size: int, target: Optional[int] = None) -> int:
    """Largest divisor of ``vocab_size`` that is <= ``target`` and a
    multiple of 32, so each tile covers whole mask words and its words are
    one contiguous slice. A vocab that 32 does not divide streams as one
    whole-vocab tile (the reference's fallback); on one that 32 divides a
    target below one word is refused instead."""
    target = max(1, min(target or DEFAULT_TILE, vocab_size))
    if vocab_size % MASK_BITS:
        return vocab_size
    for t in range(target - target % MASK_BITS, 0, -MASK_BITS):
        if vocab_size % t == 0:
            return t
    raise ConfigError(f"sampler tile {target} is below one {MASK_BITS}-token "
                      f"mask word")


def tp_shardable(vocab_size: int, n_shards: int) -> bool:
    """Whether the vocab stream can shard over ``n_shards`` ranks: each
    shard an equal slice whose tiles still cover whole mask words (the
    reference's rule). Failing geometries keep the materialized tail (the
    engine records a downgrade)."""
    return (n_shards > 1 and vocab_size % n_shards == 0
            and (vocab_size // n_shards) % MASK_BITS == 0)


def _slice_tile_mask(words: torch.Tensor, t0: int, tile: int,
                     batch: int) -> torch.Tensor:
    """Bool mask (batch, tile) for tokens [t0, t0 + tile) of a (B, Wn) or
    (Wn,) bitfield: the tile's ``tile // 32`` words, a contiguous slice
    (or, for a single tile over a vocab 32 does not divide, every
    word)."""
    if words.dim() == 1:
        words = words[None, :]
    if tile % MASK_BITS == 0:
        w0 = t0 // MASK_BITS
        words = words[:, w0:w0 + tile // MASK_BITS]
    return unpack_mask(words, tile).expand(batch, tile)


def _penalize_tile(logits: torch.Tensor, t0: int, tile: int, *,
                   seen_words: torch.Tensor, banned_words: torch.Tensor,
                   rep_pen: torch.Tensor,
                   ban_tok: Optional[torch.Tensor] = None,
                   ban_hit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold the repetition penalty and the bad-words masks into one vocab
    tile. ``logits``: (B, tile) for tokens [t0, t0 + tile). ``ban_tok`` /
    ``ban_hit``: optional (B, S) sequence-ban tails (token ban_tok[b, s]
    is masked wherever ban_hit[b, s]), resolved by comparing ids."""
    B = logits.shape[0]
    lf = logits.float()
    seen = _slice_tile_mask(seen_words, t0, tile, B)
    pen = rep_pen.float()[:, None]
    lf = torch.where(seen, torch.where(lf > 0, lf / pen, lf * pen), lf)
    lf = lf.masked_fill(_slice_tile_mask(banned_words, t0, tile, B), NEG_INF)
    if ban_tok is not None:
        ids = t0 + torch.arange(tile, dtype=torch.int32, device=lf.device)
        hit = ((ids[None, :, None] == ban_tok[:, None, :])
               & ban_hit[:, None, :]).any(dim=-1)
        lf = lf.masked_fill(hit, NEG_INF)
    return lf


def _noise_fn(noise: Noise, rows: int, tile: int,
              device) -> Callable[[int], torch.Tensor]:
    """``noise_tile(t)``: a generator's next (rows, tile) Gumbel draw, or
    the caller's function."""
    if isinstance(noise, torch.Generator):
        return lambda t: gumbel_noise((rows, tile), noise, device)
    return noise


def _argmax_ids(values: torch.Tensor, ids: torch.Tensor) -> tuple:
    """Per row: the max value and the id at its first position."""
    at = values.argmax(dim=-1, keepdim=True)
    return values.gather(1, at)[:, 0], ids.gather(1, at)[:, 0]


def _update(best: torch.Tensor, best_id: torch.Tensor, val: torch.Tensor,
            vid: torch.Tensor) -> tuple:
    """A running argmax step: strictly greater wins, so the earlier tile
    (the lower id) keeps a tie."""
    up = val > best
    return torch.where(up, val, best), torch.where(up, vid, best_id)


def _merge(cv, ci, cp, scaled, idb, pert, cand_k: int) -> tuple:
    """Keep the top-``cand_k`` raw scaled values seen so far, with their
    ids and perturbations. The carry goes first and the sort is stable,
    so equal values keep ascending ids: the oracle's tie order."""
    top = torch.sort(torch.cat([cv, scaled], dim=-1), dim=-1,
                     descending=True, stable=True)
    sel = top.indices[:, :cand_k]
    return (top.values[:, :cand_k],
            torch.cat([ci, idb], dim=-1).gather(1, sel),
            torch.cat([cp, pert], dim=-1).gather(1, sel))


def _tile_ids(t0: int, tile: int, shape, device) -> torch.Tensor:
    return (t0 + torch.arange(tile, dtype=torch.int32, device=device)
            ).expand(shape)


def _greedy_stream(masked_tile, n_tiles: int, tile: int, B: int,
                   device) -> tuple:
    """Running argmax over the tile stream: (best value, best id), ties
    keeping the lowest id."""
    best = torch.full((B,), float("-inf"), device=device)
    best_id = torch.zeros((B,), dtype=torch.int32, device=device)
    for t in range(n_tiles):
        t0, lf = masked_tile(t)
        val, vid = _argmax_ids(lf, _tile_ids(t0, tile, lf.shape, lf.device))
        best, best_id = _update(best, best_id, val, vid)
    return best, best_id


def _carry(rows: int, cand_k: int, device) -> tuple:
    """The candidate carry's start: (values, ids, perturbations)."""
    return (torch.full((rows, cand_k), float("-inf"), device=device),
            torch.zeros((rows, cand_k), dtype=torch.int32, device=device),
            torch.full((rows, cand_k), float("-inf"), device=device))


def _sample_stream(masked_tile, noise_tile, tf: torch.Tensor, n_tiles: int,
                   tile: int, B: int, cand_k: int, device) -> tuple:
    """Sampling carry over the tile stream. Returns
    ``(cv, ci, cp, lse, bpert, bpid, braw, brid)``: the top-``cand_k`` raw
    scaled values with ids and Gumbel perturbations, the running
    logsumexp, the untruncated Gumbel-max winner, and the running greedy
    argmax (for the temp <= 0 / top_k == 1 rows)."""
    cv, ci, cp = _carry(B, cand_k, device)
    ninf = torch.full((B,), float("-inf"), device=device)
    zero = torch.zeros((B,), dtype=torch.int32, device=device)
    lse, bpert, bpid, braw, brid = ninf, ninf, zero, ninf, zero
    for t in range(n_tiles):
        t0, lf = masked_tile(t)
        idb = _tile_ids(t0, tile, lf.shape, lf.device)
        scaled = lf / tf
        pert = scaled + noise_tile(t)
        # the running logsumexp of the scaled logits (the top-p mass)
        lse = torch.logaddexp(lse, torch.logsumexp(scaled, dim=-1))
        # the running untruncated Gumbel-max (the pure-categorical case)
        bpert, bpid = _update(bpert, bpid, *_argmax_ids(pert, idb))
        # the running greedy argmax
        braw, brid = _update(braw, brid, *_argmax_ids(lf, idb))
        cv, ci, cp = _merge(cv, ci, cp, scaled, idb, pert, cand_k)
    return cv, ci, cp, lse, bpert, bpid, braw, brid


def _verify_stream(masked_tile, noise_tile, tf: torch.Tensor,
                   draft_ids: torch.Tensor, n_tiles: int, tile: int, R: int,
                   cand_k: int, device) -> tuple:
    """Verification carry over the tile stream. Returns
    ``(cv, ci, cp, lse, braw, brid, sd, sfound, npert, npid)``: the
    sampling carry, the draft token's scaled logit (``sd``; it lives in
    one tile, so a masked sum is a gather) and whether it was seen, and
    the running Gumbel-max with the draft masked (the untruncated
    residual sample)."""
    cv, ci, cp = _carry(R, cand_k, device)
    ninf = torch.full((R,), float("-inf"), device=device)
    zero = torch.zeros((R,), dtype=torch.int32, device=device)
    lse, braw, brid, npert, npid = ninf, ninf, zero, ninf, zero
    sd = torch.zeros((R,), device=device)
    sfound = torch.zeros((R,), dtype=torch.bool, device=device)
    for t in range(n_tiles):
        t0, lf = masked_tile(t)
        idb = _tile_ids(t0, tile, lf.shape, lf.device)
        scaled = lf / tf
        pert = scaled + noise_tile(t)
        lse = torch.logaddexp(lse, torch.logsumexp(scaled, dim=-1))
        braw, brid = _update(braw, brid, *_argmax_ids(lf, idb))
        dm = idb == draft_ids[:, None]
        sd = sd + torch.where(dm, scaled, torch.zeros_like(scaled)).sum(-1)
        sfound = sfound | dm.any(dim=-1)
        # draft -1 matches nothing: a plain sample
        pert_nod = pert.masked_fill(dm, float("-inf"))
        npert, npid = _update(npert, npid, *_argmax_ids(pert_nod, idb))
        cv, ci, cp = _merge(cv, ci, cp, scaled, idb, pert, cand_k)
    return cv, ci, cp, lse, braw, brid, sd, sfound, npert, npid


def _kept(cv, lse, top_k, top_p, vocab_size: int, cand_k: int) -> tuple:
    """The kept prefix of the candidates (top-k and top-p both keep
    prefixes of the value order: position j survives if j < k and the
    mass before it is < p, ``ops.sampling.sample``'s rule), and whether a
    row is untruncated."""
    kk = torch.where(top_k <= 0, torch.full_like(top_k, vocab_size), top_k)
    p = torch.where((top_p <= 0) | (top_p >= 1.0), torch.ones_like(top_p),
                    top_p).float()
    probs = torch.exp(cv - lse[:, None])
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep = ((torch.arange(cand_k, device=cv.device)[None, :] < kk[:, None])
            & (cum_before < p[:, None]))
    return keep, (kk >= vocab_size) & (p >= 1.0)


def _finalize_sample(cv, ci, cp, lse, bpid, brid, *, temp, top_k, top_p,
                     vocab_size: int, cand_k: int) -> torch.Tensor:
    """Resolve top-k/top-p from the candidate carry alone and pick the
    sampled (or greedy) token per row."""
    keep, untruncated = _kept(cv, lse, top_k, top_p, vocab_size, cand_k)
    kept_pert = cp.masked_fill(~keep, float("-inf"))
    trunc_tok = ci.gather(1, kept_pert.argmax(dim=-1, keepdim=True))[:, 0]
    sampled = torch.where(untruncated, bpid, trunc_tok)
    is_greedy = (temp <= 0) | (top_k == 1)
    return torch.where(is_greedy, brid, sampled).to(torch.int32)


def _finalize_verify(cv, ci, cp, lse, brid, sd, sfound, npid, *, u, temp,
                     top_k, top_p, draft_ids, vocab_size: int,
                     cand_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Resolve the per-row accept/resample verdicts from the carry."""
    sd = sd.masked_fill(~sfound, float("-inf"))
    keep, untruncated = _kept(cv, lse, top_k, top_p, vocab_size, cand_k)
    # The truncated target: the normalizer over the kept candidates; the
    # draft's probability is exp(sd - z_kept) when it is kept, else 0.
    z_kept = torch.logsumexp(cv.masked_fill(~keep, float("-inf")), dim=-1)
    is_draft = ci == draft_ids[:, None]
    draft_kept = (is_draft & keep).any(dim=-1)
    p_trunc = torch.where(draft_kept, torch.exp(sd - z_kept),
                          torch.zeros_like(sd))
    # The truncated residual: Gumbel-argmax over the kept candidates but
    # the draft; an empty residual (kept == {draft}, so p(draft) == 1)
    # falls back to the draft, so a rounded reject cannot emit ci[0].
    kept_res = keep & ~is_draft
    res_pert = cp.masked_fill(~kept_res, float("-inf"))
    trunc_res = ci.gather(1, res_pert.argmax(dim=-1, keepdim=True))[:, 0]
    trunc_res = torch.where(kept_res.any(dim=-1), trunc_res,
                            draft_ids.to(trunc_res.dtype))
    p_acc = torch.where(untruncated, torch.exp(sd - lse), p_trunc)
    resample = torch.where(untruncated, npid, trunc_res)
    is_greedy = (temp <= 0) | (top_k == 1)
    accept = torch.where(is_greedy, draft_ids == brid, u < p_acc)
    out_tok = torch.where(is_greedy, brid, resample).to(torch.int32)
    return accept, out_tok


def _masked_tiles(tile_logits_fn: TileFn, tile: int, **penalties):
    def masked_tile(t: int):
        t0 = t * tile
        return t0, _penalize_tile(tile_logits_fn(t0, tile), t0, tile,
                                  **penalties)
    return masked_tile


def fused_unembed_sample(tile_logits_fn: TileFn, vocab_size: int, *,
                         noise: Optional[Noise], temp, top_k, top_p, rep_pen,
                         seen_words, banned_words, ban_tok=None, ban_hit=None,
                         greedy: bool = False, tile: Optional[int] = None,
                         cand_k: Optional[int] = None) -> torch.Tensor:
    """Stream the vocab in tiles and sample without materializing it.

    ``tile_logits_fn(t0, tile) -> (B, tile)`` raw logits for tokens
    [t0, t0 + tile), typically a slice of the lm_head projection
    (``models/llama.py`` ``lm_head_tile``). Returns (B,) int32 tokens with
    the semantics of ``ops.sampling.sample`` on the penalized logits.
    ``greedy`` (the engine's all-greedy round): a running argmax only, no
    noise, no candidates. ``noise``: a generator or ``noise_tile(t)``
    (module docstring); unused when ``greedy``."""
    tile = choose_tile(vocab_size, tile)
    cand_k = cand_k or DEFAULT_CAND_K
    n_tiles = vocab_size // tile
    B, device = temp.shape[0], temp.device
    masked_tile = _masked_tiles(
        tile_logits_fn, tile, seen_words=seen_words,
        banned_words=banned_words, rep_pen=rep_pen, ban_tok=ban_tok,
        ban_hit=ban_hit)
    if greedy:
        return _greedy_stream(masked_tile, n_tiles, tile, B, device)[1]
    tf = torch.clamp(temp.float(), min=1e-6)[:, None]
    cv, ci, cp, lse, _, bpid, _, brid = _sample_stream(
        masked_tile, _noise_fn(noise, B, tile, device), tf, n_tiles, tile, B,
        cand_k, device)
    return _finalize_sample(cv, ci, cp, lse, bpid, brid, temp=temp,
                            top_k=top_k, top_p=top_p, vocab_size=vocab_size,
                            cand_k=cand_k)


def fused_verify_sample(tile_logits_fn: TileFn, vocab_size: int, *,
                        noise: Noise, u, temp, top_k, top_p, rep_pen,
                        seen_words, banned_words, draft_ids, ban_tok=None,
                        ban_hit=None, tile: Optional[int] = None,
                        cand_k: Optional[int] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative-decoding verification on the vocab-tiled stream: per
    row, the rejection-sampling verdict for one draft token, without
    materializing (R, V) logits.

    ``draft_ids[r]``: the draft token scored at row r (-1: none, a bonus
    or padding row that always rejects and samples the full target).
    ``u``: (R,) uniforms in [0, 1) drawn by the caller. Returns
    ``(accept, out_tok)``: keep the draft (``u < p(draft)`` under the
    penalized, truncated target; a greedy row accepts iff the draft is
    the argmax), and the token to emit at the first rejected or the bonus
    position (a sample of the residual with the draft removed; greedy
    rows: the argmax). Exact against ``verify_reference_tiled`` whenever
    the kept prefix fits ``cand_k`` candidates."""
    tile = choose_tile(vocab_size, tile)
    cand_k = cand_k or DEFAULT_CAND_K
    n_tiles = vocab_size // tile
    R, device = temp.shape[0], temp.device
    masked_tile = _masked_tiles(
        tile_logits_fn, tile, seen_words=seen_words,
        banned_words=banned_words, rep_pen=rep_pen, ban_tok=ban_tok,
        ban_hit=ban_hit)
    tf = torch.clamp(temp.float(), min=1e-6)[:, None]
    cv, ci, cp, lse, _, brid, sd, sfound, _, npid = _verify_stream(
        masked_tile, _noise_fn(noise, R, tile, device), tf, draft_ids,
        n_tiles, tile, R, cand_k, device)
    return _finalize_verify(cv, ci, cp, lse, brid, sd, sfound, npid, u=u,
                            temp=temp, top_k=top_k, top_p=top_p,
                            draft_ids=draft_ids, vocab_size=vocab_size,
                            cand_k=cand_k)


# ----------------------------------------------------- cross-rank merges


def merge_running_max(vals: torch.Tensor, ids: torch.Tensor) -> tuple:
    """Per-shard running-argmax carries, gathered ``(n_shards, B)``, into
    one: the largest value wins, ties the lowest shard (the lowest vocab
    ids: the one-card stream's tie rule)."""
    win = vals.argmax(dim=0, keepdim=True)           # first max
    return vals.gather(0, win)[0], ids.gather(0, win)[0]


def merge_candidates(cv: torch.Tensor, ci: torch.Tensor, cp: torch.Tensor,
                     cand_k: int) -> tuple:
    """Per-shard candidate carries, gathered ``(n_shards, B, cand_k)``,
    into the global top ``cand_k``: shard-major rows and a stable
    descending sort, so equal values keep ascending ids. Every global
    top-``cand_k`` element is in its own shard's, so the merge is
    exact."""
    def flat(a):
        return a.movedim(0, 1).reshape(a.shape[1], -1)
    av, ai, ap = flat(cv), flat(ci), flat(cp)
    top = torch.sort(av, dim=-1, descending=True, stable=True)
    sel = top.indices[:, :cand_k]
    return top.values[:, :cand_k], ai.gather(1, sel), ap.gather(1, sel)


def merge_lse(lse: torch.Tensor) -> torch.Tensor:
    """Per-shard logsumexps, gathered ``(n_shards, B)``, into one."""
    return torch.logsumexp(lse, dim=0)


def _gather_rows(mesh: Mesh, *rows: torch.Tensor) -> list[torch.Tensor]:
    """Each (B, ...) tensor gathered ``(n_shards, B, ...)``, tensors of a
    dtype packed into one collective."""
    out: list = [None] * len(rows)
    for dtype in dict.fromkeys(r.dtype for r in rows):
        idx = [i for i, r in enumerate(rows) if r.dtype == dtype]
        B = rows[idx[0]].shape[0]
        flat = [rows[i].reshape(B, -1) for i in idx]
        g = all_gather(torch.cat(flat, dim=1), mesh)        # (n, B, sum)
        at = 0
        for i, f in zip(idx, flat):
            out[i] = g[:, :, at:at + f.shape[1]].reshape(
                g.shape[0], *rows[i].shape)
            at += f.shape[1]
    return out


def shard_geometry(mesh: Mesh, vocab_size: int,
                   tile: Optional[int]) -> tuple[int, int, int]:
    """(n_shards, V per shard, tile) of a vocab stream sharded over
    ``mesh``'s tp axis; ``ValueError`` where ``tp_shardable`` says no."""
    n_shards = int(mesh.shape["tp"])
    if not tp_shardable(vocab_size, n_shards):
        raise ValueError(
            f"vocab_size={vocab_size} cannot shard over tp={n_shards} in "
            f"whole {MASK_BITS}-token mask words")
    v_local = vocab_size // n_shards
    return n_shards, v_local, choose_tile(v_local, tile)


def _shard_noise(noise: Noise, rows: int, tile: int, first: int,
                 n_tiles: int, total: int, device) -> Callable:
    """``noise_tile(t)`` for the ``n_tiles`` tiles from global tile
    ``first``: a callable is asked for the global tile; a generator
    draws all ``total`` tiles in order and this rank keeps its own, so
    the generator ends where a one-card stream leaves it."""
    if not isinstance(noise, torch.Generator):
        return lambda t: noise(first + t)
    drawn = [gumbel_noise((rows, tile), noise, device) for _ in range(total)]
    mine = drawn[first:first + n_tiles]
    return lambda t: mine[t]


def _local_tiles(local_tile_fn: TileFn, tile: int, base: int, **penalties):
    """``masked_tile(t)`` over a shard: the projection at the local
    offset, the penalties and masks at the global one."""
    def masked_tile(t: int):
        t0 = base + t * tile
        return t0, _penalize_tile(local_tile_fn(t * tile, tile), t0, tile,
                                  **penalties)
    return masked_tile


def fused_unembed_sample_tp(mesh: Mesh, local_tile_fn: TileFn,
                            vocab_size: int, *, noise: Optional[Noise],
                            temp, top_k, top_p, rep_pen, seen_words,
                            banned_words, ban_tok=None, ban_hit=None,
                            greedy: bool = False, tile: Optional[int] = None,
                            cand_k: Optional[int] = None) -> torch.Tensor:
    """``fused_unembed_sample`` with the vocab stream sharded over the
    mesh's tp ranks (the reference's ``fused_unembed_sample_tp``):
    ``local_tile_fn(t0, tile)`` projects onto this rank's shard at local
    offset ``t0`` (``models/llama.py`` ``lm_head_tile`` on the rank's
    head). The carries merge in one gather per dtype; the returned (B,)
    tokens are the same on every rank."""
    n_shards, v_local, tile = shard_geometry(mesh, vocab_size, tile)
    cand_k = cand_k or DEFAULT_CAND_K
    n_tiles = v_local // tile
    B, device = temp.shape[0], temp.device
    masked_tile = _local_tiles(
        local_tile_fn, tile, mesh.tp_rank * v_local, seen_words=seen_words,
        banned_words=banned_words, rep_pen=rep_pen, ban_tok=ban_tok,
        ban_hit=ban_hit)
    if greedy:
        best, best_id = _greedy_stream(masked_tile, n_tiles, tile, B, device)
        return merge_running_max(*_gather_rows(mesh, best, best_id))[1]
    tf = torch.clamp(temp.float(), min=1e-6)[:, None]
    noise_tile = _shard_noise(noise, B, tile, mesh.tp_rank * n_tiles,
                              n_tiles, n_shards * n_tiles, device)
    cv, ci, cp, lse, bpert, bpid, braw, brid = _sample_stream(
        masked_tile, noise_tile, tf, n_tiles, tile, B, cand_k, device)
    gv, gi, gp, glse, gbpert, gbpid, gbraw, gbrid = _gather_rows(
        mesh, cv, ci, cp, lse, bpert, bpid, braw, brid)
    cv, ci, cp = merge_candidates(gv, gi, gp, cand_k)
    bpid = merge_running_max(gbpert, gbpid)[1]
    brid = merge_running_max(gbraw, gbrid)[1]
    return _finalize_sample(cv, ci, cp, merge_lse(glse), bpid, brid,
                            temp=temp, top_k=top_k, top_p=top_p,
                            vocab_size=vocab_size, cand_k=cand_k)


def fused_verify_sample_tp(mesh: Mesh, local_tile_fn: TileFn,
                           vocab_size: int, *, noise: Noise, u, temp, top_k,
                           top_p, rep_pen, seen_words, banned_words,
                           draft_ids, ban_tok=None, ban_hit=None,
                           tile: Optional[int] = None,
                           cand_k: Optional[int] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_verify_sample`` with the vocab stream sharded over the
    mesh's tp ranks (the reference's ``fused_verify_sample_tp``). The
    draft's scaled logit lives on one shard, so its value and whether it
    was seen are sums over ranks (the reference's ``psum``). The verdicts
    are the same on every rank."""
    n_shards, v_local, tile = shard_geometry(mesh, vocab_size, tile)
    cand_k = cand_k or DEFAULT_CAND_K
    n_tiles = v_local // tile
    R, device = temp.shape[0], temp.device
    masked_tile = _local_tiles(
        local_tile_fn, tile, mesh.tp_rank * v_local, seen_words=seen_words,
        banned_words=banned_words, rep_pen=rep_pen, ban_tok=ban_tok,
        ban_hit=ban_hit)
    tf = torch.clamp(temp.float(), min=1e-6)[:, None]
    noise_tile = _shard_noise(noise, R, tile, mesh.tp_rank * n_tiles,
                              n_tiles, n_shards * n_tiles, device)
    cv, ci, cp, lse, braw, brid, sd, sfound, npert, npid = _verify_stream(
        masked_tile, noise_tile, tf, draft_ids, n_tiles, tile, R, cand_k,
        device)
    gv, gi, gp, glse, gbraw, gbrid, gnpert, gnpid = _gather_rows(
        mesh, cv, ci, cp, lse, braw, brid, npert, npid)
    cv, ci, cp = merge_candidates(gv, gi, gp, cand_k)
    brid = merge_running_max(gbraw, gbrid)[1]
    npid = merge_running_max(gnpert, gnpid)[1]
    sd = all_reduce_(sd.clone(), mesh)
    sfound = all_reduce_(sfound.to(torch.int32), mesh) > 0
    return _finalize_verify(cv, ci, cp, merge_lse(glse), brid, sd, sfound,
                            npid, u=u, temp=temp, top_k=top_k, top_p=top_p,
                            draft_ids=draft_ids, vocab_size=vocab_size,
                            cand_k=cand_k)


def tiled_gumbel(noise: Noise, batch: int, vocab_size: int, tile: int,
                 device=None) -> torch.Tensor:
    """The full (batch, V) Gumbel field a noise source gives the fused
    stream tile by tile, for the oracles (it materializes what the fused
    path exists to avoid)."""
    n_tiles = -(-vocab_size // tile)
    fn = _noise_fn(noise, batch, tile, device)
    return torch.cat([fn(t) for t in range(n_tiles)], dim=-1)[:, :vocab_size]


def _reference_keep(scaled, top_k, top_p) -> torch.Tensor:
    """The materialized top-k/top-p keep mask over (B, V) scaled logits:
    a stable descending sort (ascending id among ties), ranks below k,
    and the smallest prefix whose mass reaches p."""
    B, V = scaled.shape
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    ranks = torch.empty_like(sort_idx).scatter_(
        1, sort_idx, torch.arange(V, device=scaled.device).expand(B, V)
        .contiguous())
    k = torch.where(top_k[:, None] <= 0, torch.full_like(top_k[:, None], V),
                    top_k[:, None])
    sorted_probs = torch.softmax(torch.gather(scaled, 1, sort_idx), dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    tp = top_p.float()[:, None]
    p = torch.where((tp <= 0) | (tp >= 1.0), torch.ones_like(tp), tp)
    keep_p = torch.zeros_like(sort_idx, dtype=torch.bool).scatter_(
        1, sort_idx, (cum - sorted_probs) < p)
    return (ranks < k) & keep_p


def _field(noise, B: int, V: int, tile: int, device) -> torch.Tensor:
    if isinstance(noise, torch.Tensor):
        return noise
    return tiled_gumbel(noise, B, V, tile, device)


def sample_reference_tiled(logits: torch.Tensor, noise, temp, top_k, top_p,
                           tile: int) -> torch.Tensor:
    """Materialized penalize-then-sample oracle with the fused sampler's
    noise layout: full (B, V) (already penalized) logits, the stable
    top-k / top-p prefix keep, argmax over the kept Gumbel-perturbed
    values. ``noise``: a (B, V) Gumbel field or a noise source, read in
    ``tile``-wide tiles (``tiled_gumbel``). The fused path gives the same
    tokens whenever the kept prefix fits its candidate carry."""
    B, V = logits.shape
    lf = logits.float()
    greedy_ids = lf.argmax(dim=-1).to(torch.int32)
    scaled = lf / torch.clamp(temp.float(), min=1e-6)[:, None]
    pert = scaled + _field(noise, B, V, tile, lf.device)
    masked = pert.masked_fill(~_reference_keep(scaled, top_k, top_p),
                              float("-inf"))
    sampled = masked.argmax(dim=-1).to(torch.int32)
    is_greedy = (temp <= 0) | (top_k == 1)
    return torch.where(is_greedy, greedy_ids, sampled)


def verify_reference_tiled(logits: torch.Tensor, noise, u, temp, top_k,
                           top_p, draft_ids, tile: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialized oracle for ``fused_verify_sample``: full (R, V)
    penalized logits in, the same accept/resample verdicts out, on the
    fused path's noise layout and the same uniforms."""
    R, V = logits.shape
    lf = logits.float()
    greedy_ids = lf.argmax(dim=-1).to(torch.int32)
    scaled = lf / torch.clamp(temp.float(), min=1e-6)[:, None]
    kept = _reference_keep(scaled, top_k, top_p)
    is_draft = (torch.arange(V, device=lf.device)[None, :]
                == draft_ids[:, None])
    sd = torch.where(is_draft.any(dim=-1),
                     torch.where(is_draft, scaled,
                                 torch.zeros_like(scaled)).sum(-1),
                     torch.full((R,), float("-inf"), device=lf.device))
    kk = torch.where(top_k <= 0, torch.full_like(top_k, V), top_k)
    tp = top_p.float()
    p = torch.where((tp <= 0) | (tp >= 1.0), torch.ones_like(tp), tp)
    untruncated = (kk >= V) & (p >= 1.0)
    z_kept = torch.logsumexp(scaled.masked_fill(~kept, float("-inf")), -1)
    lse = torch.logsumexp(scaled, dim=-1)
    draft_kept = (is_draft & kept).any(dim=-1)
    p_trunc = torch.where(draft_kept, torch.exp(sd - z_kept),
                          torch.zeros_like(sd))
    p_acc = torch.where(untruncated, torch.exp(sd - lse), p_trunc)
    pert = scaled + _field(noise, R, V, tile, lf.device)
    kept_res = kept & ~is_draft
    resample = pert.masked_fill(~kept_res, float("-inf")).argmax(
        dim=-1).to(torch.int32)
    resample = torch.where(kept_res.any(dim=-1), resample,
                           draft_ids.to(torch.int32))
    is_greedy = (temp <= 0) | (top_k == 1)
    accept = torch.where(is_greedy, draft_ids == greedy_ids, u < p_acc)
    out_tok = torch.where(is_greedy, greedy_ids, resample)
    return accept, out_tok.to(torch.int32)
