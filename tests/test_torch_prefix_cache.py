"""The port's prefix cache (``engine/prefix_cache.py``) against the JAX
package's on the CPU: identical block hashes, and identical results and
stats over a scripted sequence of match, acquire, insert, release and
evict; then the port's engine under pool pressure."""

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.engine.prefix_cache import (
    PrefixCache, hash_blocks, usable_prefix_tokens)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

PAGE = 16


@pytest.mark.parametrize("n,page", [(0, 16), (15, 16), (16, 16), (47, 16),
                                    (300, 128), (1000, 7)])
def test_hash_blocks_bytes_match_jax(n, page):
    from generativeaiexamples_tpu.engine.prefix_cache import \
        hash_blocks as jhash
    toks = np.random.default_rng(n).integers(0, 32000, n).tolist()
    got = hash_blocks(toks, page)
    assert got == jhash(toks, page)
    assert len(got) == n // page
    assert all(isinstance(h, bytes) and len(h) == 16 for h in got)


def test_usable_prefix_tokens_matches_jax():
    from generativeaiexamples_tpu.engine.prefix_cache import \
        usable_prefix_tokens as jusable
    for matched in range(6):
        for n in range(1, 90):
            assert usable_prefix_tokens(matched, n, PAGE) == \
                jusable(matched, n, PAGE)
    assert usable_prefix_tokens(2, 32, PAGE) == 16     # COW demotion


def _script(seed: int, steps: int = 400):
    """A random sequence of cache operations over a few chains sharing
    prefixes, as (op, args) with every argument fixed in advance."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 500, 6 * PAGE).tolist()
    prompts = [base[:rng.integers(1, 7) * PAGE] + rng.integers(
        0, 500, rng.integers(0, 4) * PAGE).tolist() for _ in range(12)]
    ops = []
    for _ in range(steps):
        kind = rng.choice(["admit", "retire", "evict"], p=[0.5, 0.3, 0.2])
        ops.append((str(kind), int(rng.integers(0, len(prompts))),
                    int(rng.integers(1, 6))))
    return prompts, ops


def _run(cache, hash_fn, prompts, ops):
    """Drive one cache through the script as the engine does (match, take
    refs on the usable prefix, insert the rest on fresh pages; release at
    retire; evict under pressure). Returns every observable result."""
    live, out, next_page = [], [], [100]
    for kind, i, n in ops:
        if kind == "admit":
            hashes = hash_fn(prompts[i], PAGE)
            m = cache.match(hashes)
            k = usable_prefix_tokens(m, len(prompts[i]), PAGE) // PAGE
            pages = cache.acquire(hashes[:k])
            refs = list(hashes[:k])
            for j in range(k, len(hashes)):
                next_page[0] += 1
                if cache.insert(hashes[j], hashes[j - 1] if j else None,
                                next_page[0]):
                    refs.append(hashes[j])
            live.append(refs)
            out.append(("admit", m, k, pages))
        elif kind == "retire" and live:
            refs = live.pop(i % len(live))
            cache.release(refs)
            out.append(("retire", len(refs)))
        elif kind == "evict":
            out.append(("evict", cache.evict(n)))
        out.append((len(cache), cache.cached_pages))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_sequence_matches_jax(seed):
    """The same scripted admissions, retirements and evictions give the
    same matches, pages, evictions and stats on both caches, and the
    port's idle-page counter ends equal to its refcount-0 entries."""
    from generativeaiexamples_tpu.engine.prefix_cache import \
        PrefixCache as JCache
    from generativeaiexamples_tpu.engine.prefix_cache import \
        hash_blocks as jhash
    prompts, ops = _script(seed)
    ours, theirs = PrefixCache(PAGE), JCache(PAGE)
    assert _run(ours, hash_blocks, prompts, ops) == _run(
        theirs, jhash, prompts, ops)
    assert vars(ours.stats) == vars(theirs.stats)
    assert ours.stats.snapshot() == theirs.stats.snapshot()
    assert ours.idle_pages == sum(1 for e in ours._entries.values()
                                  if e.refcount == 0)
    assert ours.stats.evicted_pages > 0 and ours.stats.inserted_pages > 0


def test_idle_pages_follow_refcounts():
    cache = PrefixCache(PAGE)
    hashes = hash_blocks(list(range(48)), PAGE)
    for i, h in enumerate(hashes):
        assert cache.insert(h, hashes[i - 1] if i else None, i + 1)
    assert cache.idle_pages == 0
    cache.release(hashes)
    assert cache.idle_pages == 3
    cache.acquire(hashes[:2])
    assert cache.idle_pages == 1
    assert cache.evict(5) == [3]          # only the leaf is idle
    assert cache.idle_pages == 0
    cache.release(hashes[:2])
    assert cache.evict(5) == [2, 1] and cache.idle_pages == 0


def test_pool_pressure_evicts_cached_pages_before_backpressure():
    """A pool of 8 pages: each 48-token request needs 4 (3 of them full
    prompt blocks the cache keeps). Retired requests' cached pages are
    evicted for the next distinct prompt instead of stalling it, no page
    is lost, and a prompt still cached is hit (fully: its last block is
    recomputed, so 32 of its 48 tokens count as hit)."""
    params = llama.init_params(LLAMA_TINY, seed=2, dtype=torch.float32)
    engine = Engine(params, LLAMA_TINY, ByteTokenizer(), EngineConfig(
        max_slots=2, max_input_length=48, max_output_length=16,
        prefill_buckets=(16, 48), page_size=PAGE, dtype="float32",
        kv_pool_tokens=8 * PAGE), device="cpu")
    sp = SamplingParams(max_tokens=4, top_k=1, ignore_eos=True)
    prompts = [[1] + [3 + (5 * i + j) % 250 for i in range(47)]
               for j in range(4)]
    outs = []
    for p in prompts + prompts[-1:]:
        s = engine.submit(p, sp)
        for _ in range(50):
            if s.finish_reason:
                break
            engine._step()
        outs.append(s.token_ids)
        engine._step()
        st = engine.stats
        assert st["free_pages"] == st["pool_pages"] == 8
        assert len(engine._free_pages) + st["prefix_cache_pages"] == 8
    assert all(len(t) == 4 for t in outs) and outs[-1] == outs[-2]
    assert st["prefix_cache_evicted_pages"] >= 6
    assert st["prefix_cache_hits"] == 1
    assert st["prefix_cache_hit_tokens"] == 32


def test_clear_prefix_cache_returns_idle_pages():
    """``Engine.clear_prefix_cache`` hands every idle cached page back to
    the free list (the next request prefills cold) and leaves a running
    serve loop's cache alone."""
    params = llama.init_params(LLAMA_TINY, seed=2, dtype=torch.float32)
    engine = Engine(params, LLAMA_TINY, ByteTokenizer(), EngineConfig(
        max_slots=2, max_input_length=48, max_output_length=16,
        prefill_buckets=(16, 48), page_size=PAGE, dtype="float32",
        kv_pool_tokens=8 * PAGE), device="cpu")
    sp = SamplingParams(max_tokens=2, top_k=1, ignore_eos=True)
    prompt = [1] + [9] * 40
    for _ in range(2):
        s = engine.submit(prompt, sp)
        for _ in range(5):
            engine._step()
        assert s.finish_reason == "length"
    st = engine.stats
    assert st["prefix_cache_pages"] == 2 and st["prefix_cache_hits"] == 1
    assert engine.clear_prefix_cache() == 2
    assert engine.stats["prefix_cache_pages"] == 0
    assert sorted(engine._free_pages) == list(range(1, 9))
    s = engine.submit(prompt, sp)
    for _ in range(5):
        engine._step()
    assert engine.stats["prefix_cache_hits"] == 1       # cold again
    with engine:
        assert engine.clear_prefix_cache() == 0
