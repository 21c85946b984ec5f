#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``generativeaiexamples_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each fails loudly: a failure exits non-zero and the final
``{"ok": true, ...}`` line is never printed):

1. Card, power limit, torch/CUDA versions; builds every kernel from the
   sources in the checkout (one ``nvcc`` per source, started together).
2. Each kernel against its plain PyTorch version at the shapes the
   llama-2-7b paths give it, plus its time beside its plain version, its
   bound and a one-call PyTorch yardstick where one exists:
   #1 paged decode attention (bf16/f32 pools) and #2 its int8-pool path
   (each call a split pass and a merge pass), in float32 (atol 1e-4) and
   bfloat16 (atol 1e-3, rtol 1e-2), timed L2-cold (the calls cycle the
   layer over a pool deep enough that > 100 MB of live rows pass between
   two reads of one row) at the check's lengths and at 8 slots of 2048
   rows, and L2-warm (one pool) as earlier runs timed it; #3 the
   packed-int4 matmul at every projection shape, M = 1, 3, 8, 9, 128,
   200 and 1024 (each call checked to take the path ``_path`` names:
   for bf16 x the tensor-core paths, ``tc`` at M <= 8 and ``wg`` above;
   for float32 x the fp32 GEMV at M <= 8 and the tiled path above),
   float32 out atol 1e-4 * max|ref|, rtol 1e-4, bf16 out rtol 1e-2. At
   M = 128 and 1024 on the layer shapes the old tiled kernel is timed on
   the same bf16 x beside ``wg``; and ``tc`` on the fused tail's lm_head
   tiles (M = 8 and 1, K 4096, N 4000 and 16000: column slices of the
   32000-wide head read in place at its row stride).
   The fused sampling tail (``check_fused_tail``): at llama-2-7b's head
   width over bf16 and int4_awq heads, in 8 tiles of 4000 and in the
   card's default 2 of 16000, 8 rows of mixed sampling settings give the
   materialized oracle's tokens on one shared noise field.
3. The engines on a small input: llama-2-7b's width cut to 2 layers,
   float32 (TF32 off). bf16 path: greedy tokens through the engine (#1 in
   every layer) against argmax of a full-sequence forward. Quantized
   path (int4_awq weights, int8 KV pool): greedy tokens through the
   engine on the card (#2 and #3 on every call) against the same engine
   on the CPU with the same parameters (the plain versions). On the card
   each engine replays the decode rounds and admissions it captured as
   CUDA graphs at construction; an eager engine (``cuda_graphs=False``,
   planning under the captured engine's budget) must give the same
   tokens. Admission path (float32): a 700-token prompt admitted in six
   chunks (buckets capped at 128), then again as a prefix hit (640 cached
   tokens, one final chunk), gives the one-shot engine's greedy tokens,
   equal to the full-forward reference.
4. Checkpoints: the trained golden-tiny checkpoint
   (``tests/fixtures/golden_tiny``, its real 32k sentencepiece
   vocabulary) through ``build_services(model_path=...)`` and the HTTP
   app, in bf16 and with int4 weights (per channel) over an int8 KV
   pool: one streamed /v1/completions (launch counts: #1, or #2 and #3,
   on every decode layer and projection; text = decode() of the greedy
   tokens), /v1/score of a corpus sentence (NLL under 6.0 nats; both
   modes' NLL printed), and greedy tokens equal to the same engine's on
   the CPU. Then llama-2-7b-chat's geometry cut to 4 layers, written from
   seed 0 as an HF-named fp16 checkpoint in two shards with an index
   into a temporary directory, loaded to bf16 on the card bit-equal to
   the cast in memory (load seconds and GB/s), and one greedy request
   through the loaded engine.
5. The main paths: serves llama-2-7b-chat (full width and depth, random
   weights from seed 0) through the port's aiohttp ``/v1/completions``
   (4 concurrent requests, one streamed) plus one ``ignore_eos`` engine
   request, once in bf16 and once with int4_awq weights over an int8 KV
   pool, and checks through the launch counts (set to 0 just before each
   path, read just after; a replayed program adds the counts its capture
   recorded) that every layer of every decode step, and every
   projection, went through the path's kernels (#3 by path: every
   decode projection and every prefill's lm_head row on ``tc``, the
   prefill projections on ``wg``, none on ``tile`` or ``gemv``). Then
   the same prompts through the served engine and an eager engine on the
   same weights must give equal greedy tokens, and the served engine's
   decode round (host-clock step at dispatch depth 2, the harvest worker,
   and 1, in line; device time and busy share of a traced round) and
   bucket-128 admission are measured as ``tools/profile_decode.py`` does.
   Every serve path runs at the engine's default dispatch depth, 2, and
   with the fused sampling tail (the engine's default): the lm_head in
   the card's 2 vocab tiles of 16000 on ``tc`` per decode step, over the
   active-row ladder's rungs (1 row for one stream, all 8 otherwise; both
   must run, shown by ``sampler_rows_*``). The served engine's greedy tokens must also equal
   an eager engine's with the materialized tail (``fused_tail=False``);
   the 8-slot step of a graph engine with the materialized tail, one
   stream's step with and without the ladder, and the tail alone (fused
   at 8 and 1 rows and at tiles of 4000, 8000 and 16000; materialized)
   are timed untraced, and traced last beside a traced lm_head tile
   product, which must run no copy kernel.
   Then each mode's admission path at full depth on the same weights
   (``serve_admission``): an engine for 3000-token prompts serves a
   shared-system-prompt pair (the second a prefix hit: hit tokens, warm
   against cold TTFT) and a 2900-token prompt arriving while 4 streams
   decode, under its measured token budget (chunks beside the decode
   rounds) and with the budget pinned high (one admission), printing the
   chunks, the interleaved rounds and the largest gap between two token
   deliveries to a decoding stream during the admission. Its launch
   counts are set to 0 before and read after, checked the same way, and
   added to the serve run's in the ``kernels`` line (chunk programs
   included: each chunk's projections on ``wg``, a final chunk's lm_head
   row on ``tc``).
   Each served engine first runs ``Engine.prewarm()`` (a worst-case
   request and the ladder pair through the loop). Inside each mode's
   counted window, after the completions, the chat phase
   (``serve_chat``): a greedy ``/v1/chat/completions`` with a system and
   a user message and a client ``X-Request-ID`` (echoed; its
   ``/debug/requests`` timeline holds the queue wait and the first
   readback), a streamed sampled chat with the route's default body and
   seed 7 (the engine's sampling state put back to its construction
   state first), and a request with ``X-Deadline-Ms: 1`` (finish
   ``deadline_queue`` or ``deadline``, its counter moved); ``/metrics``
   parses and its ``engine_rounds_total`` moves by the engine's records
   that ``/debug/rounds`` shows completed; those hold decode records with device
   time whose median ``bw_util`` lies in (0, 1.05] (spread printed).
   After the window the greedy chat's text must equal the engine's
   greedy text for the rendered messages, and the sampled chat's text an
   eager engine's (``cuda_graphs=False``) for the same body and seed.
6. The RAG chatbot (``serve_rag``): the e5-large-v2 embedder (float32,
   random weights from seed 0 on the card, byte tokenizer) first cut to
   2 layers against the same numbers on the CPU (8 passages in the 512
   bucket, a query in the 128 bucket; atol 1e-4, TF32 off), then at 24
   layers behind the port's chain server with an ``exact-cuda`` store
   and the reference's defaults (510/200 splitter, top-4, 1500-token
   context cap), over a 3000-token engine on each served mode's weights.
   Every ``docs/*.md`` (18 files) goes through ``/uploadDocument``; the
   search's ids equal the numpy backend's on the stored vectors (near-
   ties within the bf16 rounding bound are named and allowed); greedy
   ``/generate`` questions with the knowledge base (launch counts set to
   0 before and read after, checked as the serve phases' and added to
   the kernels line) stream the engine's greedy text for the prompt the
   chain assembled, with ``degraded_total`` unmoved; in bf16 one
   ``/generate`` through ``OpenAICompatLLM`` against the model server
   gives the same text, and ``/v1/embeddings`` the service's vector.
   Prints the ingest rate, the query embed, ``/documentSearch`` and the
   store's search (also over a seeded 1,000,000 x 1024 corpus) and the
   ``/generate`` TTFT by the timeline's stages. That is the host path
   (``fused_rag=False``); beside it, per mode, the chatbot's default
   path, fused RAG (``serve_rag_fused``): a chatbot with the default
   ``fused_rag`` over the same index and engine mirrors the corpus onto
   the engine (the spec the reference's defaults give: bucket 1664, C
   542, top-4, over a 1024-row corpus; one captured program per greedy
   flag, a silent fallback to the host path fails); greedy ``/generate``
   questions each take a fused admission (``rag_admissions``; launch
   counts by the same formula, added to the kernels line;
   ``last_sources`` name ingested files); each question through
   ``submit_rag`` gives the same tokens, rows and assembled length on
   the captured programs and on an eager engine; the rows equal a numpy
   float32 top-4 over the exported vectors (near-ties within float32
   rounding named), the length a numpy assembly's, and the plain
   engine's greedy tokens for those assembled ids (cold, one-shot, in
   the fused bucket) equal the fused ones. Prints the fused TTFT beside
   the host path's and the fused admission's replay time.
7. Per mode, after the serve phases: speculative decoding
   (``serve_spec``): an engine with ``spec_decode`` on the served weights
   (its verify rounds captured per page window, greedy flag and rung)
   serves draftable and serve prompts; launch counts by formula (each
   verify round's 224 projections on #3 "wg" at M = 64, its lm_head
   tiles on "wg" at the 8-row rung and "tc" at the 1-row one, #1/#2 only
   in the classic rounds); greedy tokens equal to the plain served
   engine's up to the first position whose top-2 logit gap is under
   ``SPEC_TIE`` (where they part is printed); drafts accepted; a sampled
   request's length; the calibrator's budget moves and costs; the verify
   round's device time beside an 8-step decode round's and the gathered
   attention's share. The host KV tier (``kv_tier_phase``): a
   1000-token prompt's 7 cached pages evicted and offloaded, then
   restored bit-equal with the prefix hit's tokens; ``suspend_session``
   to a blob and ``resume_session`` on a second engine with the same
   continuation; D2H and H2D ms per page. #3 is also checked and timed
   at the verify shape (M = 64: 4096², w_gate, w_down, a 16000-column
   head tile; ``time_verify_shapes``), rows on the kernels line.
8. The fleet tier (``serve_fleet``) on the int4 weights: three replicas
   of llama-2-7b-chat at full width and depth sharing one set of weight
   tensors (r0 and r1 unified, r2 prefill; int8 pools and host tiers of
   explicit size), each behind the port's chain server, the port's
   router in front, over loopback HTTP: a ~2100-token ``/generate``
   through the two-leg handoff (its text equal to a unified replica's
   holding the prefix, the pages it lands bit-equal to r2's), the pull
   leg by ``X-KV-Transfer-From`` and by the router
   (``ROUTER_KV_TRANSFER=1``), a two-turn conversation's affinity, a
   drain with a stream in flight, and a mid-stream failover replayed on
   the sibling, in one counted window (the serve formula over the three
   engines; added to the kernels line), with lone windows showing #3
   "wg" on the prefill replica and #2 and #3 "tc" on a decode replica.
   The engines read and write text with a tokenizer whose every id is
   one character, so generated text round-trips (the failover replays
   text). Prints each handoff leg's time, the blob's size, the TTFT
   after a handoff against unified, the handoff price's answer and
   inputs against the measured legs, and the router's overhead.
9. After the traced profiles, the model server's ``/profiler/start`` and
   ``/stop`` around one request on the int4 engine write a Chrome trace
   that must name ``paged_decode_split_kernel`` and an int4 kernel.

Exits 2 without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
from typing import Optional

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM float32 peak outside tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def time_cuda(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of device time: after warm-up, ``iters``
    calls are captured in one CUDA graph and the replay is timed with CUDA
    events, so the host's time to issue each call (tens of microseconds in
    a Python wrapper, more than a small kernel's own time) is not counted.
    ``fn`` may be a list of calls, taken in turn (on copies of the inputs,
    so that a weight smaller than the 50 MB L2 cache is read cold, as the
    decode step reads it)."""
    fns = fn if isinstance(fn, list) else [fn]
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ kernel phase

def check_paged_attention(torch, dev, dtype, quant: bool = False):
    """The paged decode kernel against its plain version at llama-2-7b
    decode shapes: B=8, H=KV=32, hd=128, page=128, layer 1 of an L=2
    pool, lengths covering 0, page-1, page, page+1 and long contexts. q
    and cur_k/cur_v are in ``dtype``; the pools too (#1), or, under
    ``quant`` (#2), int8 pools with bf16 scale pools made by
    ``quantize_rows`` from random rows.

    Tolerances, from the kernel's measured error: float32 atol 1e-4 (fp32
    accumulation in another order than the plain einsum; a dropped or
    extra row shifts a 3000-token slot's output by ~1e-3), bfloat16
    atol 1e-3 with rtol 1e-2 (both sides accumulate in fp32; the rtol
    covers one bf16 ulp on the large outputs of the length-0/1 slots).
    The appended rows must be bit copies of cur_k/cur_v (#2: equal
    ``quantize_rows(cur)``, rows and scales), and no other pool or scale
    byte may change apart from the trash page 0. Returns the kernel's row
    of the result line for bfloat16 (timed L2-cold by ``time_attention``
    against its plain version and bound; also timed L2-warm, and L2-cold
    at 8 slots of 2048 rows), None for float32."""
    from generativeaiexamples_tpu_torch.ops.kv_quant import quantize_rows
    from generativeaiexamples_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_decode_plain,
        paged_attention_decode_quant_plain)

    B, H, KV, hd, page, L = 8, 32, 32, 128, 128, 2
    lengths = [0, 1, 127, 128, 129, 1000, 2047, 3000]
    W = max(-(-(n + 1) // page) for n in lengths)
    N = 1 + B * W
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1 if quant else 0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    q = randn(B, H, hd).to(dtype)
    if quant:
        (pk, ks), (pv, vs) = (quantize_rows(randn(L, N, KV, page, hd))
                              for _ in range(2))
        pools = (pk, pv, ks, vs)
    else:
        pools = (randn(L, N, KV, page, hd).to(dtype),
                 randn(L, N, KV, page, hd).to(dtype))
    ck, cv = randn(B, KV, hd).to(dtype), randn(B, KV, hd).to(dtype)
    table = (1 + torch.arange(B * W, device=dev, dtype=torch.int32)
             ).reshape(B, W)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = lens > 0
    wp = torch.where(live, table.gather(1, (lens // page)[:, None].long())
                     [:, 0], torch.zeros_like(lens)).to(torch.int32)
    off = torch.where(live, lens % page, torch.zeros_like(lens)).to(
        torch.int32)
    layer = 1
    name = "paged_attention_decode" + ("_int8" if quant else "")

    def kernel(p):
        scales = {"pool_ks": p[2], "pool_vs": p[3]} if quant else {}
        return paged_attention_decode(q, p[0], p[1], table, lens, ck, cv, wp,
                                      off, layer, **scales)

    def plain(p):
        if quant:
            return paged_attention_decode_quant_plain(
                q, p[0], p[1], table, lens, ck, cv, wp, off, layer,
                pool_ks=p[2], pool_vs=p[3])
        return paged_attention_decode_plain(q, p[0], p[1], table, lens, ck,
                                            cv, wp, off, layer)

    new = [t.clone() for t in pools]
    out = kernel(new)
    ref_pools = [t.clone() for t in pools]
    ref = plain(ref_pools)
    torch.cuda.synchronize()
    if out.shape != (B, H, hd) or out.dtype != dtype:
        fail(f"{name} output {tuple(out.shape)} {out.dtype}")
    if not torch.isfinite(out.float()).all():
        fail(f"{name} output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (1e-3, 1e-2)
    if not torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol):
        fail(f"{name} ({dtype}) disagrees with its plain version: max abs "
             f"err {err} (atol {atol}, rtol {rtol})")

    def bits(t):
        if t.dtype in (torch.bfloat16, torch.float32):
            return t.view(torch.int16 if t.dtype == torch.bfloat16
                          else torch.int32)
        return t

    # The appended rows (and scales), and no other byte outside page 0.
    idx = live.nonzero()[:, 0]
    at = (layer, wp[idx].long(), slice(None), off[idx].long())
    if quant:
        (wk, wks), (wv, wvs) = quantize_rows(ck[idx]), quantize_rows(cv[idx])
        wants = (wk, wv, wks, wvs)
    else:
        wants = (ck[idx], cv[idx])
    touched = torch.zeros((L, N, KV, page), dtype=torch.bool, device=dev)
    touched[at] = True
    touched[layer, 0] = True
    for what, got, old, want in zip(("K rows", "V rows", "K scales",
                                     "V scales"), new, pools, wants):
        if not torch.equal(bits(got[at]), bits(want)):
            fail(f"{name}: appended {what} are not "
                 f"{'quantize_rows(cur)' if quant else 'bit copies of cur'}")
        keep = ~touched
        if got.dim() == 5:
            keep = keep[..., None].expand_as(got)
        if not torch.equal(bits(got)[keep], bits(old)[keep]):
            fail(f"{name} changed {what} bytes outside the append")

    # The kernel reads no row (or scale) at or past a slot's length:
    # poisoning those and the trash page (NaN rows; under int8, 127-rows
    # and NaN scales) leaves the output bit-identical.
    poison = [t.clone() for t in pools]
    fills = (127, 127, float("nan"), float("nan")) if quant else (
        float("nan"), float("nan"))
    rows = torch.arange(W * page, device=dev)
    for b, n in enumerate(lengths):
        dead = (rows >= n).reshape(W, page)
        for t, fill in zip(poison, fills):
            view = t[layer, table[b].long()]
            view[dead[:, None, :].expand(W, KV, page)] = fill
            t[layer, table[b].long()] = view
            t[layer, 0] = fill
    out_p = kernel(poison)
    torch.cuda.synchronize()
    if not torch.equal(bits(out_p), bits(out)):
        fail(f"{name} read rows at or past a slot's length")
    del poison
    if dtype == torch.float32:
        say(f"kernel {name} float32: max_abs_err={err} (atol {atol}); "
            f"appends bit-exact, no row past a length read")
        return None

    warm_ms = time_cuda(torch, lambda: kernel(new), iters=50)
    plain_ms = time_cuda(torch, lambda: plain(ref_pools), iters=5, warmup=1)
    del new, ref_pools, pools
    torch.cuda.empty_cache()
    ms, bound, by, layers = time_attention(torch, dev, dtype, quant, lengths)
    say(f"kernel {name}: max_abs_err={err} ms={ms} (L2-cold: {layers} "
        f"pool layers cycled) warm_l2_ms={warm_ms} (one pool, every call "
        f"on the same rows) plain_ms={plain_ms} bound_ms={bound} ({by}; "
        f"{bound / ms:.1%} of it) library_ms=null (no single PyTorch call "
        f"computes paged attention{' over int8 pages' if quant else ''} "
        f"with the in-place append)")
    uni_ms, uni_bound, uni_by, uni_layers = time_attention(
        torch, dev, dtype, quant, [2048] * B)
    say(f"kernel {name} uniform {B} x 2048 rows: ms={uni_ms} (L2-cold: "
        f"{uni_layers} pool layers cycled) bound_ms={uni_bound} ({uni_by}; "
        f"{uni_bound / uni_ms:.1%} of it)")
    return {
        "name": name,
        "route": "cuda",
        "source": "generativeaiexamples_tpu_torch/csrc/paged_attention.cu",
        "replaces": ("generativeaiexamples_tpu/ops/paged_attention.py:"
                     + ("338" if quant else "82")),
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


def attention_bound(B, H, KV, hd, W, lengths, quant, e=2):
    """Least time of one paged attention call at these shapes on the card
    (ms), what bounds it, and the live K/V bytes it reads: each live row
    (and, under int8 pools, its two scales) read once, q, cur_k/cur_v,
    the table and the slot vectors read once, out and the appended rows
    written once; QK^T and PV over the live rows plus the current one."""
    live_rows = sum(lengths)
    if quant:
        kv_bytes = (2 * live_rows * KV * hd        # int8 K and V rows
                    + 2 * live_rows * KV * 2)      # their bf16 scales
        nbytes = (kv_bytes
                  + 2 * B * KV * hd * e            # cur_k/cur_v in
                  + 2 * B * KV * (hd + 2))         # appended rows, scales
    else:
        kv_bytes = 2 * live_rows * KV * hd * e     # K and V rows read once
        nbytes = kv_bytes + 4 * B * KV * hd * e    # cur_k/v in, append out
    nbytes += (2 * B * H * hd * e                  # q in, out
               + B * W * 4 + 3 * B * 4)            # table, lengths, wp, off
    flops = 2 * 2 * (live_rows + B) * H * hd       # QK^T and PV
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOPS * 1e3
    if bytes_ms >= flops_ms:
        return bytes_ms, "bytes", kv_bytes
    return flops_ms, "operations", kv_bytes


def time_attention(torch, dev, dtype, quant, lengths):
    """L2-cold device time of one paged attention call (bf16 or float32
    q; bf16/f32 pools, or int8 pools under ``quant``) at llama-2-7b decode
    shapes (H = KV = 32, hd = page = 128) over ``lengths``: the timed
    calls cycle the ``layer`` argument over a pool with enough layers that
    more than 100 MB of live rows are read between two reads of one row
    (the L2 cache holds 50 MB). Returns (ms, bound ms, what bounds it,
    layers cycled)."""
    from generativeaiexamples_tpu_torch.ops.kv_quant import quantize_rows
    from generativeaiexamples_tpu_torch.ops.paged_attention import \
        paged_attention_decode

    B, H, KV, hd, page = len(lengths), 32, 32, 128, 128
    W = max(-(-(n + 1) // page) for n in lengths)
    N = 1 + B * W
    e = torch.empty((), dtype=dtype).element_size()
    bound, by, kv_bytes = attention_bound(B, H, KV, hd, W, lengths, quant, e)
    layers = 2 + int(100e6 // kv_bytes)
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    q = randn(B, H, hd).to(dtype)
    ck, cv = randn(B, KV, hd).to(dtype), randn(B, KV, hd).to(dtype)
    scales = {}
    if quant:
        (pk, ks), (pv, vs) = (quantize_rows(randn(layers, N, KV, page, hd))
                              for _ in range(2))
        scales = {"pool_ks": ks, "pool_vs": vs}
    else:
        pk = randn(layers, N, KV, page, hd).to(dtype)
        pv = randn(layers, N, KV, page, hd).to(dtype)
    table = (1 + torch.arange(B * W, device=dev, dtype=torch.int32)
             ).reshape(B, W)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = lens > 0
    wp = torch.where(live, table.gather(1, (lens // page)[:, None].long())
                     [:, 0], torch.zeros_like(lens)).to(torch.int32)
    off = torch.where(live, lens % page, torch.zeros_like(lens)).to(
        torch.int32)
    calls = [(lambda layer=layer: paged_attention_decode(
        q, pk, pv, table, lens, ck, cv, wp, off, layer, **scales))
        for layer in range(layers)]
    ms = time_cuda(torch, calls, iters=20 * layers, warmup=layers)
    del pk, pv, scales, calls
    torch.cuda.empty_cache()
    return ms, bound, by, layers


def int4_library_ms(torch, dev, M, K, N, group, iters):
    """One PyTorch call computing a group-quantized int4 product of the
    same shape: ``aten._weight_int4pack_mm`` after
    ``_convert_weight_to_int4pack`` (bf16 x; asymmetric uint4 with
    (scale, zero) pairs, so a different weight format on random data).
    Timed as a yardstick only; the port never calls it. Returns (ms or
    None, reason)."""
    try:
        packed_in = torch.randint(0, 256, (N, K // 2), dtype=torch.uint8,
                                  device=dev)
        packed = torch.ops.aten._convert_weight_to_int4pack(packed_in, 8)
        sz = torch.rand((K // group, N, 2), device=dev).to(torch.bfloat16)
        x = torch.randn((M, K), device=dev).to(torch.bfloat16)
        ms = time_cuda(torch, lambda: torch.ops.aten._weight_int4pack_mm(
            x, packed, group, sz), iters=iters)
        return ms, "aten._weight_int4pack_mm"
    except (AttributeError, RuntimeError, NotImplementedError) as exc:
        return None, f"aten._weight_int4pack_mm unavailable: {exc}"[:200]


def old_tile_call(torch, x, q4, scale, out_dtype):
    """A call of the C entry point on the "tile" path (code 2) for bf16 x,
    which the wrapper now sends to "wg": the before side of a same-call
    before/after factor. A measurement only; the port never does this."""
    from generativeaiexamples_tpu_torch.ops.int4_matmul import (
        _KERNEL_DTYPES, _PATHS, _kernel)
    M, K = x.shape
    N, G = q4.shape[1], scale.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)

    def call():
        err = _kernel()(
            _PATHS["tile"], _KERNEL_DTYPES[x.dtype],
            _KERNEL_DTYPES[out_dtype], x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None, 0, None, 0, M, K, N, K // G, N, N,
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"int4_matmul tile path (code 2) failed with CUDA error "
                 f"{err}")
        return out
    return call


def check_int4_matmul(torch, dev):
    """The packed-int4 kernel against its plain version at every
    projection shape of llama-2-7b, (K, N) in {(4096, 4096), (4096, 11008),
    (11008, 4096), (4096, 32000)}, M in {1, 3, 8, 9, 128, 200, 1024} (the
    logits row, a partly filled decode batch, a full one, the smallest
    prefill, the commonest prefill bucket, a partial token tile, the
    largest bucket here), per channel and group 128, x bf16 and float32,
    out x's dtype and float32. Every call must launch the path ``_path``
    names, which at these shapes is "tc" for bf16 x at M <= 8 and "wg"
    above, "gemv" for float32 x at M <= 8 and "tile" above.

    Tolerances (both sides sum in fp32 from identical inputs, in another
    order): float32 out atol 1e-4 * max|ref|, rtol 1e-4; bf16 out rtol 1e-2
    (one bf16 ulp is 2^-8 relative) with the same atol for outputs near
    zero. Then times the kernel (bf16 x, group 128, the served format) at
    each shape and M in {1, 8, 128, 1024} beside its plain version, its
    bound, the library yardstick and a dense bf16 ``torch.mm`` of the
    dequantized weight; at M = 128 and 1024 on the layer shapes also the
    old "tile" kernel on the same x; and the GEMV (float32 x) at M = 8 on
    w_gate. Returns the kernel's rows of the result line: "tc" at the
    decode step's w_gate shape (M = 8) and "wg" at a 1024-row prefill's
    (M = 1024)."""
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.ops.int4_matmul import (
        _path, int4_matmul, int4_matmul_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = {}
    row_err = {}
    prefill = {}   # (K, N) -> ms by kernel at M = 1024
    for K, N in shapes:
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        leaves = {0: quant.quantize_tensor(w, 4),
                  128: quant.quantize_tensor_grouped(w, 128)}
        del w
        for M in (1, 3, 8, 9, 128, 200, 1024):
            x32 = torch.randn((M, K), generator=gen, device=dev)
            for group, leaf in leaves.items():
                scale = leaf["gscale"] if group else leaf["scale"]
                for x in (x32, x32.to(torch.bfloat16)):
                    bf16 = x.dtype == torch.bfloat16
                    path = (("tc" if bf16 else "gemv") if M <= 8 else
                            ("wg" if bf16 else "tile"))
                    if _path(M, K, N, group or K, x.dtype) != path:
                        fail(f"int4_matmul M={M} K={K} N={N} x={x.dtype} "
                             f"would not take the {path!r} path")
                    for out_dtype in {x.dtype, torch.float32}:
                        before = int4_matmul.launches_by_path[path]
                        got = int4_matmul(x, leaf["q4"], scale,
                                          out_dtype=out_dtype)
                        if int4_matmul.launches_by_path[path] != before + 1:
                            fail(f"int4_matmul M={M} K={K} N={N} "
                                 f"x={x.dtype} did not launch the "
                                 f"{path!r} path")
                        ref = int4_matmul_plain(x, leaf["q4"], scale,
                                                out_dtype=out_dtype)
                        torch.cuda.synchronize()
                        if got.shape != (M, N) or got.dtype != out_dtype:
                            fail(f"int4_matmul output {tuple(got.shape)} "
                                 f"{got.dtype}")
                        peak = ref.float().abs().max().item()
                        err = (got.float() - ref.float()).abs().max().item()
                        rtol = 1e-4 if out_dtype == torch.float32 else 1e-2
                        if not (torch.isfinite(got.float()).all()
                                and torch.allclose(got.float(), ref.float(),
                                                   atol=1e-4 * peak,
                                                   rtol=rtol)):
                            fail(f"int4_matmul [{path}] M={M} K={K} N={N} "
                                 f"group={group} x={x.dtype} "
                                 f"out={out_dtype} disagrees with its plain "
                                 f"version: max abs err {err} (max|ref| "
                                 f"{peak})")
                        worst[out_dtype] = max(worst[out_dtype],
                                               err / max(peak, 1e-30))
                        if (M in (8, 1024) and (K, N) == (4096, 11008)
                                and group == 128 and bf16
                                and out_dtype == torch.bfloat16):
                            row_err[path] = err
        say(f"kernel int4_matmul K={K} N={N}: M=1, 3, 8 (tc for bf16 x, "
            f"gemv for f32 x), 9, 128, 200, 1024 (wg for bf16 x, tile for "
            f"f32 x) x per-channel, group 128 x bf16/f32 in and out agree "
            f"with the plain version")

        # Timing: the served format (bf16 x, group 128), out bf16 (f32 for
        # the lm_head, as the logits path calls it); and the GEMV, which
        # float32 x takes, at M = 8 on w_gate.
        leaf = leaves[128]
        out_dtype = torch.float32 if N == 32000 else torch.bfloat16
        wbytes = leaf["q4"].numel() + 4 * leaf["gscale"].numel()
        copies = 1 + (120 << 20) // wbytes      # > L2 over the cycle
        q4s = [leaf["q4"].clone() for _ in range(copies)]
        dense = quant.dequantize(leaf, torch.bfloat16)
        runs = [(1, torch.bfloat16), (8, torch.bfloat16),
                (128, torch.bfloat16), (1024, torch.bfloat16)]
        if (K, N) == (4096, 11008):
            runs.append((8, torch.float32))
        for M, x_dtype in runs:
            x = torch.randn((M, K), generator=gen, device=dev).to(x_dtype)
            path = _path(M, K, N, 128, x_dtype)
            iters = 20 if M == 1024 else 200
            ms = time_cuda(torch, [
                (lambda q4=q4: int4_matmul(x, q4, leaf["gscale"],
                                           out_dtype=out_dtype))
                for q4 in q4s], iters=iters)
            plain_ms = time_cuda(torch, lambda: int4_matmul_plain(
                x, leaf["q4"], leaf["gscale"], out_dtype=out_dtype),
                iters=3, warmup=1)
            xb = x.to(torch.bfloat16)
            lib_ms, lib_note = int4_library_ms(torch, dev, M, K, N, 128,
                                               iters)
            dense_ms = time_cuda(torch, lambda: torch.mm(xb, dense),
                                 iters=iters)
            tile = ""
            if path == "wg" and N != 32000:
                # The old kernel on the same x, checked once, then timed.
                calls = [old_tile_call(torch, x, q4, leaf["gscale"],
                                       out_dtype) for q4 in q4s]
                got = calls[0]().float()
                ref = int4_matmul_plain(x, leaf["q4"], leaf["gscale"],
                                        out_dtype=out_dtype).float()
                if not torch.allclose(got, ref, rtol=1e-2,
                                      atol=1e-4 * ref.abs().max().item()):
                    fail(f"old tile kernel M={M} K={K} N={N} disagrees with "
                         f"the plain version")
                tile_ms = time_cuda(torch, calls,
                                    iters=5 if M == 1024 else 50)
                tile = (f" tile_ms={tile_ms} (old kernel, same x; wg is "
                        f"{tile_ms / ms:.2f}x faster)")
                if M == 1024:
                    prefill[(K, N)] = {"wg": ms, "tile": tile_ms,
                                       "library": lib_ms, "dense": dense_ms}
            nbytes = (K // 2 * N + 4 * (K // 128) * N
                      + M * K * x.element_size()
                      + M * N * (4 if out_dtype == torch.float32 else 2))
            flops = 2 * M * K * N
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            flops_ms = flops / (BF16_FLOPS if x_dtype == torch.bfloat16
                                else F32_FLOPS) * 1e3
            bound = max(bytes_ms, flops_ms)
            by = "bytes" if bytes_ms >= flops_ms else "operations"
            lib_x = "" if x_dtype == torch.bfloat16 else " (bf16 x)"
            lib_factor = (f" ({ms / lib_ms:.2f}x the library)"
                          if lib_ms else "")
            say(f"kernel int4_matmul [{path}] M={M} K={K} N={N} group=128 "
                f"x={str(x_dtype)[6:]}: ms={ms} plain_ms={plain_ms} "
                f"bound_ms={bound} ({by}; {nbytes} bytes, {flops} flops; "
                f"{bound / ms:.1%} of it) library_ms={lib_ms}{lib_x} "
                f"({lib_note}){lib_factor} dense_bf16_mm_ms={dense_ms}"
                f"{tile}")
            if (M, K, N) in ((8, 4096, 11008), (1024, 4096, 11008)) and (
                    path in ("tc", "wg")):
                rows[path] = {
                    "name": "int4_matmul",
                    "route": "cuda",
                    "source":
                        "generativeaiexamples_tpu_torch/csrc/int4_matmul.cu",
                    "replaces":
                        "generativeaiexamples_tpu/ops/int4_matmul.py:83",
                    "path": path,
                    "launches": 0,
                    "max_abs_err": row_err[path],
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound,
                    "bound_by": by,
                    "library_ms": lib_ms,
                }
        del q4s, dense, leaves
        torch.cuda.empty_cache()
    rows.update(time_head_tiles(torch, dev, gen))
    rows.update(time_verify_shapes(torch, dev, gen))
    # #3's device time per 1024-row prefill: 32 layers of 4 projections
    # of 4096 x 4096, 2 of w_gate/w_up and 1 of w_down.
    mix = {(4096, 4096): 4, (4096, 11008): 2, (11008, 4096): 1}
    per_prefill = {
        k: (32 * sum(n * prefill[s][k] for s, n in mix.items())
            if all(prefill[s][k] for s in mix) else None)
        for k in ("wg", "tile", "library", "dense")}
    say(f"kernel int4_matmul: device time of the 224 prefill projections "
        f"of a 1024-row llama-2-7b prefill, from the M=1024 rows: wg "
        f"{per_prefill['wg']} ms, old tile {per_prefill['tile']} ms, "
        f"library {per_prefill['library']} ms, dense bf16 mm "
        f"{per_prefill['dense']} ms")
    say(f"kernel int4_matmul: worst error over all cases relative to "
        f"max|ref|: float32 out {worst[torch.float32]}, bf16 out "
        f"{worst[torch.bfloat16]}; max abs err at the rows' cases (K=4096, "
        f"N=11008, group 128, bf16 out): tc M=8 {row_err['tc']}, wg M=1024 "
        f"{row_err['wg']}")
    return [rows["tc"], rows["wg"]] + [rows[k] for k in sorted(rows)
                                       if k.startswith(("head", "verify"))]


def time_verify_shapes(torch, dev, gen) -> dict:
    """#3 at the speculative verify round's shape: M = 64 (8 slots x S =
    8 scored positions), bf16 x, group 128, on the "wg" path: q/k/v/o's
    4096 x 4096, w_gate's 4096 x 11008, w_down's 11008 x 4096 (bf16 out)
    and a 16000-column lm_head tile read in place at the head's row
    stride (float32 out), each checked against the plain version (bf16
    out rtol 1e-2, float32 out rtol 1e-4, atol 1e-4 * max|ref|), timed
    L2-cold beside its plain version, its bound and the library
    yardstick. Returns the kernels line's rows "verify-<shape>"."""
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.ops.int4_matmul import (
        _path, int4_matmul, int4_matmul_plain)

    M, out = 64, {}
    for name, K, N, width in (("qkvo", 4096, 4096, 4096),
                              ("w_gate", 4096, 11008, 11008),
                              ("w_down", 11008, 4096, 4096),
                              ("head16000", 4096, 16000, 32000)):
        w = torch.randn((K, width), generator=gen, device=dev) * K ** -0.5
        leaf = quant.quantize_tensor_grouped(w, 128)
        del w
        head = width != N
        out_dtype = torch.float32 if head else torch.bfloat16
        wbytes = leaf["q4"].numel() + 4 * leaf["gscale"].numel()
        copies = 1 + (120 << 20) // wbytes
        leaves = [leaf] + [{k: v.clone() for k, v in leaf.items()}
                           for _ in range(copies - 1)]
        views = [(lf["q4"][:, :N], lf["gscale"][:, :N]) for lf in leaves]
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        if _path(M, K, N, 128, x.dtype) != "wg":
            fail(f"verify shape {name} M={M} would not take the 'wg' path")
        before = int4_matmul.launches_by_path["wg"]
        got = int4_matmul(x, *views[0], out_dtype=out_dtype)
        if int4_matmul.launches_by_path["wg"] != before + 1:
            fail(f"verify shape {name} did not launch the 'wg' path")
        ref = int4_matmul_plain(x, views[0][0].contiguous(),
                                views[0][1].contiguous(), out_dtype=out_dtype)
        peak = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        rtol = 1e-4 if head else 1e-2
        if not (torch.isfinite(got.float()).all() and torch.allclose(
                got.float(), ref.float(), atol=1e-4 * peak, rtol=rtol)):
            fail(f"int4_matmul [wg] verify shape {name} disagrees with its "
                 f"plain version: max abs err {err}")
        ms = time_cuda(torch, [
            (lambda q4=q4, sc=sc: int4_matmul(x, q4, sc, out_dtype=out_dtype))
            for q4, sc in views], iters=100)
        plain_ms = time_cuda(torch, lambda: int4_matmul_plain(
            x, views[0][0], views[0][1], out_dtype=out_dtype), iters=3,
            warmup=1)
        lib_ms, lib_note = int4_library_ms(torch, dev, M, K, N, 128, 100)
        nbytes = (K // 2 * N + 4 * (K // 128) * N + M * K * 2
                  + M * N * (4 if head else 2))
        flops = 2 * M * K * N
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOPS * 1e3
        bound = max(bytes_ms, flops_ms)
        by = "bytes" if bytes_ms >= flops_ms else "operations"
        say(f"kernel int4_matmul [wg] verify shape {name} M={M} K={K} N={N}"
            f"{' (strided, in place)' if head else ''} group=128 "
            f"x=bfloat16: ms={ms} plain_ms={plain_ms} bound_ms={bound} "
            f"({by}; {nbytes} bytes, {flops} flops; {bound / ms:.1%} of it) "
            f"library_ms={lib_ms} ({lib_note}); max abs err {err}")
        out[f"verify-{name}"] = {
            "name": "int4_matmul", "route": "cuda",
            "source": "generativeaiexamples_tpu_torch/csrc/int4_matmul.cu",
            "replaces": "generativeaiexamples_tpu/ops/int4_matmul.py:83",
            "path": "wg", "shape": f"verify M={M} K={K} N={N}"
                                   f"{' strided' if head else ''}",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}
        del leaves, views
        torch.cuda.empty_cache()
    return out


def time_head_tiles(torch, dev, gen) -> dict:
    """#3 on the fused tail's lm_head tiles: column slices of llama-2-7b's
    (4096, 32000) head quantized to group 128, 4000 columns each (the
    reference's tile) and 16000 (the card's default), read in place at
    the head's row stride ("tc", float32 out as the logits path calls
    it), at M = 8 and 1 (the active-row ladder's rungs). Each tile is
    checked against the plain version on a contiguous copy (atol 1e-4 *
    max|ref|, rtol 1e-4); the kernel is timed cycling through the tiles
    (the whole head, 65 MB, read cold as a decode step reads it) beside
    its plain version, its bound and the library yardstick at the same
    shape. Returns the kernels line's rows "head<tile>-<M>"."""
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.ops.int4_matmul import (
        _path, int4_matmul, int4_matmul_plain)

    K, V = 4096, 32000
    w = torch.randn((K, V), generator=gen, device=dev) * K ** -0.5
    head = quant.quantize_tensor_grouped(w, 128)
    del w
    out = {}
    for tile, M in itertools.product((4000, 16000), (8, 1)):
        tiles = [(head["q4"][:, t0:t0 + tile],
                  head["gscale"][:, t0:t0 + tile])
                 for t0 in range(0, V, tile)]
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        if _path(M, K, tile, 128, x.dtype) != "tc":
            fail(f"head tile M={M} would not take the 'tc' path")
        before = int4_matmul.launches_by_path["tc"]
        err = 0.0
        for q4, sc in tiles:
            got = int4_matmul(x, q4, sc, out_dtype=torch.float32)
            ref = int4_matmul_plain(x, q4.contiguous(), sc.contiguous(),
                                    out_dtype=torch.float32)
            peak = ref.abs().max().item()
            err = max(err, (got - ref).abs().max().item())
            if not torch.allclose(got, ref, atol=1e-4 * peak, rtol=1e-4):
                fail(f"int4_matmul head tile M={M} disagrees with its "
                     f"plain version: max abs err {err}")
        if int4_matmul.launches_by_path["tc"] != before + len(tiles):
            fail("a head tile did not launch the 'tc' path once")
        ms = time_cuda(torch, [
            (lambda q4=q4, sc=sc: int4_matmul(x, q4, sc,
                                              out_dtype=torch.float32))
            for q4, sc in tiles], iters=200)
        plain_ms = time_cuda(torch, lambda: int4_matmul_plain(
            x, tiles[0][0], tiles[0][1], out_dtype=torch.float32),
            iters=3, warmup=1)
        lib_ms, lib_note = int4_library_ms(torch, dev, M, K, tile, 128, 200)
        nbytes = K // 2 * tile + 4 * (K // 128) * tile + M * K * 2 + \
            M * tile * 4
        flops = 2 * M * K * tile
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOPS * 1e3
        bound = max(bytes_ms, flops_ms)
        by = "bytes" if bytes_ms >= flops_ms else "operations"
        say(f"kernel int4_matmul [tc] head tile M={M} K={K} N={tile} of "
            f"{V} (strided, in place) group=128 x=bfloat16 out=float32: "
            f"ms={ms} plain_ms={plain_ms} bound_ms={bound} ({by}; {nbytes} "
            f"bytes; {bound / ms:.1%} of it) library_ms={lib_ms} "
            f"({lib_note}); max abs err {err}")
        out[f"head{tile:05d}-{M}"] = {
            "name": "int4_matmul", "route": "cuda",
            "source": "generativeaiexamples_tpu_torch/csrc/int4_matmul.cu",
            "replaces": "generativeaiexamples_tpu/ops/int4_matmul.py:83",
            "path": "tc", "shape": f"lm_head tile M={M} K={K} N={tile} "
                                   f"strided",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}
    del head
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ fused sampling tail

def check_fused_tail(torch, dev, card: str) -> None:
    """The fused sampling tail (``ops/fused_sampler.py``) at llama-2-7b's
    head width (D 4096, V 32000) on the card, in the reference's 8 tiles
    of 4000 and the card's default 2 of 16000, over a bf16 head and an
    int4_awq one: 8 rows of mixed settings (greedy,
    top-k, top-p at a low temperature, pure temperature) with repetition
    penalties, banned tokens and sequence-ban tails, against the
    materialized oracle ``sample_reference_tiled`` on the same logits
    (the same tile products, concatenated) and one shared Gumbel field:
    exact tokens with the engine's candidate carry (64) and with a carry
    of the whole vocab (rows whose top-p set is wider than 64), and the
    greedy stream equal to the argmax of the penalized logits. Under
    int4 each stream launches "tc" once per tile."""
    from generativeaiexamples_tpu_torch.engine.engine import CARD_TILE
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    from generativeaiexamples_tpu_torch.ops import fused_sampler as fs
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul
    from generativeaiexamples_tpu_torch.ops.sampling import (
        NEG_INF, apply_repetition_penalty, pack_mask)

    t0 = time.monotonic()
    D, V, B = LLAMA2_7B.hidden_size, LLAMA2_7B.vocab_size, 8
    g = torch.Generator(dev).manual_seed(5)
    w = torch.randn((D, V), generator=g, device=dev).mul_(D ** -0.5)
    heads = {"bf16": w.to(torch.bfloat16),
             "int4_awq": quant.quantize_tensor_grouped(w, 128)}
    del w
    hn = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    seen = torch.rand((B, V), generator=g, device=dev) < 0.002
    banned = torch.rand((B, V), generator=g, device=dev) < 0.0005
    ban_tok = torch.randint(0, V, (B, 2), generator=g, device=dev,
                            dtype=torch.int32)
    ban_hit = torch.rand((B, 2), generator=g, device=dev) < 0.5
    rep_pen = torch.tensor([1.0, 1.2, 1.0, 1.1, 1.3, 1.0, 1.0, 1.2],
                           device=dev)
    # (temperature, top_k, top_p): every kept set fits 64 candidates
    # (top-p at temperature 0.05 keeps a few tokens).
    narrow = [(0.0, 0, 0.0), (0.7, 40, 0.0), (1.0, 0, 0.0), (1.3, 5, 0.0),
              (0.05, 0, 0.9), (1.0, 64, 0.0), (0.8, 1, 0.0), (2.0, 0, 0.0)]
    # wide top-p sets: exact only with the whole vocab as the carry
    wide = [(1.0, 0, 0.9), (0.7, 0, 0.95), (1.0, 200, 0.0),
            (1.2, 0, 0.5), (0.0, 0, 0.0), (1.0, 0, 0.0), (0.9, 500, 0.9),
            (1.5, 0, 0.99)]
    for (name, head), tile in itertools.product(
            heads.items(), (fs.choose_tile(V), fs.choose_tile(V, CARD_TILE))):
        n_tiles = V // tile
        field = fs.tiled_gumbel(torch.Generator(dev).manual_seed(6), B, V,
                                tile, dev)
        params = {"lm_head": head}
        logits = torch.cat([llama.lm_head_tile(params, LLAMA2_7B, hn, t, tile)
                            for t in range(0, V, tile)], dim=1)
        pen = apply_repetition_penalty(logits, seen, rep_pen).masked_fill(
            banned, NEG_INF)
        rows = torch.arange(B, device=dev)[:, None]
        pen[rows.expand(B, 2)[ban_hit], ban_tok.long()[ban_hit]] = NEG_INF
        for settings, cand_k in ((narrow, 64), (wide, V)):
            temp, top_k, top_p = (torch.tensor(c, device=dev)
                                  for c in zip(*settings))
            top_k = top_k.to(torch.int32)
            kw = dict(temp=temp, top_k=top_k, top_p=top_p, rep_pen=rep_pen,
                      seen_words=pack_mask(seen),
                      banned_words=pack_mask(banned), ban_tok=ban_tok,
                      ban_hit=ban_hit, tile=tile, cand_k=cand_k)
            fn = (lambda t, n: llama.lm_head_tile(  # noqa: E731
                params, LLAMA2_7B, hn, t, n))
            before = int4_matmul.launches_by_path["tc"]
            got = fs.fused_unembed_sample(
                fn, V, noise=lambda t: field[:, t * tile:(t + 1) * tile],
                **kw)
            greedy = fs.fused_unembed_sample(fn, V, noise=None, greedy=True,
                                             **kw)
            launched = int4_matmul.launches_by_path["tc"] - before
            want = fs.sample_reference_tiled(pen, field, temp, top_k, top_p,
                                             tile)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"fused tail [{name} head, cand_k {cand_k}]: tokens "
                     f"{got.tolist()}, the oracle's {want.tolist()}")
            if not torch.equal(greedy, pen.argmax(dim=-1).to(torch.int32)):
                fail(f"fused tail [{name} head]: the greedy stream is not "
                     f"the argmax of the penalized logits")
            if launched != (2 * n_tiles if name == "int4_awq" else 0):
                fail(f"fused tail [{name} head]: {launched} 'tc' launches "
                     f"for two streams of {n_tiles} tiles")
        say(f"fused tail [{name} head]: V={V} in {n_tiles} tiles of {tile}, "
            f"8 mixed rows: tokens equal the oracle's with cand_k 64 and "
            f"with cand_k {V}; greedy stream = argmax; tc launches per "
            f"stream {n_tiles if name == 'int4_awq' else 0}")
    del heads
    torch.cuda.empty_cache()
    say(f"fused tail check: {time.monotonic() - t0:.1f} s [{card}]")


# ------------------------------------------------------------- model check

def check_model(torch, dev) -> None:
    """The port's engine against a plain greedy reference on a small
    input: llama-2-7b's full width cut to 2 layers, float32 weights from
    seed 0 (TF32 off), three concurrent greedy requests through the engine
    (its captured programs; the paged kernel in every layer) and through
    an eager engine (``cuda_graphs=False``, planning under the captured
    engine's measured budget, so both make one schedule), both against
    argmax of a full-sequence ``llama.apply`` recomputed per token (no
    cache, no kernel). Then ``check_chunked``."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(LLAMA2_7B, num_layers=2)
    params = llama.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    n_new = 8
    prompts = [[1] + [3 + (7 * i + j) % 256 for i in range(n)]
               for j, n in ((0, 40), (1, 125), (2, 300))]
    t0 = time.monotonic()
    runs = {}
    budget = None
    for graphs_on in (True, False):
        engine = Engine(params, cfg, ByteTokenizer(), EngineConfig(
            max_slots=4, max_input_length=512, max_output_length=16,
            prefill_buckets=(128, 512), dtype="float32", kv_pool_tokens=None,
            cuda_graphs=graphs_on, sched_round_budget_tokens=budget),
            device=dev)
        budget = engine.stats["sched_round_budget_tokens"]
        # Submitted before the serve thread starts: one schedule for both.
        streams = [engine.submit(p, SamplingParams(
            max_tokens=n_new, top_k=1, ignore_eos=True)) for p in prompts]
        with engine:
            for s in streams:
                s.text()
        runs[graphs_on] = [s.token_ids for s in streams]
        del engine
    got = runs[True]
    if runs[False] != got:
        fail(f"float32 engine: captured programs gave greedy tokens {got}, "
             f"the eager engine {runs[False]}")
    for p, toks in zip(prompts, got):
        want = reference_tokens(torch, params, cfg, p, n_new)
        if want != toks:
            fail(f"engine greedy tokens {toks} differ from the plain "
                 f"reference {want} (prompt of {len(p)})")
    say(f"model check: 2-layer llama-2-7b width, float32: engine greedy "
        f"tokens (captured programs, and the eager engine alike) equal the "
        f"plain full-forward reference for prompts of "
        f"{[len(p) for p in prompts]} tokens ({time.monotonic() - t0:.1f} s)")
    check_chunked(torch, dev, params, cfg)
    del params
    torch.cuda.empty_cache()


def reference_tokens(torch, params, cfg, prompt, n_new: int) -> list:
    """Greedy tokens by argmax of a full-sequence ``llama.apply``
    recomputed per token (no cache, no kernel)."""
    from generativeaiexamples_tpu_torch.models import llama
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            t = torch.tensor([ids], dtype=torch.int32, device=params[
                "embed"].device)
            pos = torch.arange(len(ids), dtype=torch.int32,
                               device=t.device)[None, :]
            logits, _ = llama.apply(params, cfg, t, pos)
            if not torch.isfinite(logits).all():
                fail("reference logits are not finite")
            ids.append(int(logits[0, -1].argmax()))
    return ids[len(prompt):]


def check_chunked(torch, dev, params, cfg) -> None:
    """The admission path on the float32 model: a 700-token prompt through
    an engine whose buckets are capped at 128 (six chunk programs, the
    last arming the slot; the budget measured at construction), then the
    same prompt again (a prefix hit: five cached pages, one seeded final
    chunk). Both must give the greedy tokens of an engine that admits the
    prompt in one bucket, and those equal the full-forward reference."""
    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

    t0 = time.monotonic()
    n_new = 8
    prompt = [1] + [3 + (11 * i) % 256 for i in range(699)]
    base = dict(max_slots=2, max_input_length=768, max_output_length=16,
                prefill_buckets=(128, 768), dtype="float32",
                kv_pool_tokens=None)
    sp = SamplingParams(max_tokens=n_new, top_k=1, ignore_eos=True)
    chunked = Engine(params, cfg, ByteTokenizer(), EngineConfig(
        **base, max_prefill_bucket=128), device=dev)
    with chunked:
        cold = chunked.submit(prompt, sp)
        cold.text()
        warm = chunked.submit(prompt, sp)
        warm.text()
    st = chunked.stats
    source = chunked._sched.cost.source
    del chunked
    oneshot = Engine(params, cfg, ByteTokenizer(), EngineConfig(
        **base, prefix_cache=False, sched_round_budget_tokens=4096),
        device=dev)
    with oneshot:
        one = oneshot.submit(prompt, sp)
        one.text()
    one_chunks = oneshot.stats["prefill_chunks"]
    del oneshot
    if (st["prefill_chunks"] != 7 or st["prefix_cache_hit_tokens"] != 640
            or one_chunks != 0):
        fail(f"chunked admission: {st['prefill_chunks']} chunk programs "
             f"(want 6 cold + 1 warm), {st['prefix_cache_hit_tokens']} hit "
             f"tokens (want 640), one-shot engine {one_chunks} chunks")
    want = reference_tokens(torch, params, cfg, prompt, n_new)
    for name, got in (("chunked cold", cold.token_ids),
                      ("warm hit", warm.token_ids),
                      ("one-shot", one.token_ids)):
        if got != want:
            fail(f"float32 {name} admission of {len(prompt)} tokens gave "
                 f"greedy tokens {got}, the full-forward reference {want}")
    say(f"model check: 2-layer llama-2-7b width, float32: a {len(prompt)}-"
        f"token prompt admitted in 6 chunks of at most 128 (budget "
        f"{st['sched_round_budget_tokens']} tokens, {source}), then as a "
        f"prefix hit (640 cached tokens, one final chunk), gives the "
        f"one-shot engine's greedy tokens, equal to the full-forward "
        f"reference ({time.monotonic() - t0:.1f} s)")


def greedy_tokens(engine, prompts, n_new: int):
    """``n_new`` greedy tokens (``ignore_eos``) for each prompt, all
    submitted before the serve thread starts (one schedule on any
    engine)."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    streams = [engine.submit(p, SamplingParams(
        max_tokens=n_new, top_k=1, ignore_eos=True)) for p in prompts]
    with engine:
        for s in streams:
            s.text()
    return [s.token_ids for s in streams]


class QuantReference:
    """The quantized model check's model and its CPU reference: llama-2-7b's
    full width cut to 1 layer, float32 weights from seed 0 quantized on the
    card to int4_awq (group 128), an int8 KV pool, TF32 off; greedy tokens
    for prompts of 40, 125 and 300 tokens (plus bos), 8 new tokens each,
    from the engine on the CPU with the same parameters, moved there (the
    kernels' plain versions, so the reference is independent of both
    kernels). The CPU run takes far longer than the card's, so it starts
    in a thread at once and overlaps the kernel build and the kernel
    phases; ``cpu_tokens`` joins it."""

    N_NEW = 8

    def __init__(self, torch, dev):
        import threading
        from dataclasses import replace

        from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
        from generativeaiexamples_tpu_torch.models import llama
        from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
        from generativeaiexamples_tpu_torch.models.tokenizer import \
            ByteTokenizer
        from generativeaiexamples_tpu_torch.ops.quant import quantize_params

        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = replace(LLAMA2_7B, num_layers=1)
        self.params = quantize_params(
            llama.init_params(self.cfg, seed=0, dtype=torch.float32,
                              device=dev), "int4_awq", group_size=128)
        # The budget is pinned: the card engines (captured and eager) and
        # the CPU engine plan alike (every prompt one bucket).
        self.ecfg = EngineConfig(
            max_slots=4, max_input_length=512, max_output_length=16,
            prefill_buckets=(128, 512), dtype="float32", kv_pool_tokens=None,
            kv_quant="int8", sched_round_budget_tokens=4096)
        self.prompts = [[1] + [3 + (7 * i + j) % 256 for i in range(n)]
                        for j, n in ((0, 40), (1, 125), (2, 300))]

        def to_cpu(tree):
            if isinstance(tree, dict):
                return {k: to_cpu(v) for k, v in tree.items()}
            return tree.cpu()

        cpu_params = to_cpu(self.params)
        self._box: dict = {}
        self.t0 = time.monotonic()

        def run():
            try:
                self._box["tokens"] = greedy_tokens(
                    Engine(cpu_params, self.cfg, ByteTokenizer(), self.ecfg,
                           device="cpu"), self.prompts, self.N_NEW)
            except BaseException as exc:  # noqa: BLE001 - re-raised on join
                self._box["error"] = exc
            self._box["seconds"] = time.monotonic() - self.t0

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def cpu_tokens(self):
        self._thread.join()
        if "error" in self._box:
            fail(f"the CPU reference engine failed: {self._box['error']!r}")
        return self._box["tokens"], self._box["seconds"]


def check_model_quant(torch, dev, ref: QuantReference) -> None:
    """The quantized path's engine on the card against the same engine on
    the CPU (``QuantReference``): the card engine runs kernels #2 and #3
    on every call, replaying its captured programs; its greedy tokens, and
    an eager card engine's (``cuda_graphs=False``), must equal the CPU
    engine's. The card engine's float32 activations take #3's fp32 GEMV
    at decode (and for each prefill's lm_head row) and the tiled path for
    the prefill projections, never a tensor-core path ("tc", "wg"); the
    decode step's lm_head in the fused tail's vocab tiles, each a strided
    column slice of the head read in place."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import Engine
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul
    from generativeaiexamples_tpu_torch.ops.paged_attention import \
        paged_attention_decode

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, ecfg, prompts = ref.cfg, ref.params, ref.ecfg, ref.prompts
    t0 = time.monotonic()
    engine = Engine(params, cfg, ByteTokenizer(), ecfg, device=dev)
    # Counted from here: construction's warm-up launches are not the path.
    paged_attention_decode.int8_launches = 0
    int4_matmul.launches = 0
    int4_matmul.launches_by_path = dict.fromkeys(
        int4_matmul.launches_by_path, 0)
    got = greedy_tokens(engine, prompts, ref.N_NEW)
    n8, n4 = paged_attention_decode.int8_launches, int4_matmul.launches
    by_path = dict(int4_matmul.launches_by_path)
    steps, prefills, dispatches = (engine.stats["decode_steps"],
                                   engine.stats["prefills"],
                                   engine.stats["prefill_dispatches"])
    n_tiles = head_tiles(engine)
    del engine
    want = {"tc": 0,
            "gemv": (7 * cfg.num_layers + n_tiles) * steps + prefills,
            "tile": 7 * cfg.num_layers * dispatches, "wg": 0}
    if n8 <= 0 or n4 <= 0 or steps <= 0 or by_path != want:
        fail(f"quantized engine on the card launched int8 attention {n8} "
             f"and int4 matmul {n4} times, by path {by_path} over {steps} "
             f"decode steps and {prefills} prefills; expected {want}")
    eager = greedy_tokens(Engine(params, cfg, ByteTokenizer(),
                                 replace(ecfg, cuda_graphs=False),
                                 device=dev), prompts, ref.N_NEW)
    if eager != got:
        fail(f"quantized engine: captured programs gave greedy tokens {got}, "
             f"the eager engine {eager}")
    t_card = time.monotonic() - t0
    want, t_cpu = ref.cpu_tokens()
    for p, a, b in zip(prompts, got, want):
        if len(a) != ref.N_NEW or a != b:
            fail(f"quantized engine greedy tokens on the card {a} differ "
                 f"from the CPU engine's {b} (prompt of {len(p)})")
    say(f"model check: 1-layer llama-2-7b width, float32, int4_awq weights, "
        f"int8 KV pool: card engine greedy tokens (captured programs and "
        f"the eager engine alike; int8 attention {n8} launches, int4 matmul "
        f"{n4}: {by_path}) equal the CPU engine's for prompts of "
        f"{[len(p) for p in prompts]} tokens (card {t_card:.1f} s; CPU "
        f"{t_cpu:.1f} s from the start, in a thread)")
    del ref.params, params
    torch.cuda.empty_cache()


# ------------------------------------------------------------- serve phase

def serve_app(app, grace: Optional[float] = None):
    """Run an aiohttp app on a free local port in a thread; returns
    (base url, stop function). ``grace``: seconds the stop gives requests
    in flight before it closes their connections (aiohttp's default
    otherwise), so a stop mid-stream looks like a replica dying."""
    import asyncio
    import threading

    from aiohttp import web

    loop = asyncio.new_event_loop()
    box: dict = {}
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            site_kw = {}
            if grace is None:
                runner = web.AppRunner(app)
            else:
                try:
                    runner = web.AppRunner(app, shutdown_timeout=grace)
                except TypeError:   # aiohttp before 3.9: a site argument
                    runner = web.AppRunner(app)
                    site_kw["shutdown_timeout"] = grace
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0, **site_kw)
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
    if not started.wait(60):
        fail("HTTP server did not start")

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)

    return f"http://127.0.0.1:{box['port']}", stop


def post(url: str, body: dict, timeout: float = 300) -> str:
    return call(url, body, timeout=timeout)[1]


def call(url: str, body=None, headers=None, timeout: float = 300):
    """(response headers, text) of a GET (``body`` None) or a JSON POST;
    fails on a status other than 200."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as exc:
        fail(f"{url} answered {exc.code}: {exc.read().decode()[:300]}")


# Prompt lengths (byte tokens incl. bos): inside one page, one short of a
# page, a page exactly, and several pages; 32 new tokens carry the first
# three across a page boundary.
SERVE_PROMPTS = ["Tell me about paged attention. " * 3, "a" * 126, "b" * 127,
                 "The quick brown fox. " * 40]
ENGINE_PROMPT = "Count to ten:"
# The chat requests of the serve phase: a greedy one with a system
# message, and a sampled one (the route's default body: temperature 1,
# top_k 0, top_p 1) with a seed.
CHAT_MESSAGES = [
    {"role": "system", "content": "Answer from the retrieved passages."},
    {"role": "user", "content": "What does the paged KV pool hold?"}]
SAMPLED_MESSAGES = [{"role": "user", "content": "Write a line on GPUs."}]
CHAT_NEW = 24


def metric_values(text: str) -> dict:
    """Every sample of a Prometheus text exposition, name{labels} ->
    value; fails on a line that does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name] = float(value)
        except ValueError:
            fail(f"/metrics line does not parse: {line!r}")
    return out


def wait_idle(engine, timeout: float = 120) -> None:
    """Until no slot is held and no round is in flight (each round's
    record is complete then)."""
    deadline = time.monotonic() + timeout
    while engine.stats["active_slots"] or engine.stats["dispatch_queue_depth"]:
        if time.monotonic() > deadline:
            fail("the served engine did not go idle")
        time.sleep(0.005)


def serve_chat(base: str, engine, label: str, card: str) -> dict:
    """The chat requests, inside a serve phase's launch-count window:
    a greedy /v1/chat/completions with a client X-Request-ID (echoed,
    its timeline in /debug/requests with the queue wait and the first
    readback); then, on an idle engine whose sampling state is put back
    to its construction state (admission counter, round generator), a
    streamed sampled chat with a seed; then a request with
    X-Deadline-Ms: 1 (finish deadline_queue or deadline, its counter
    moved). /metrics around them: it parses, and its round counter moves
    by the records of this engine that /debug/rounds shows completed in
    the meantime (counted apart, by the round recorder's ring). Its
    decode records have steps and device time, and their median bw_util
    lies in (0, 1.05]. Returns the chat requests' texts and token ids
    (recorded as the harvest delivers them) for the checks after the
    window."""
    wait_idle(engine)
    delivered: dict = {}
    emit = engine._emit_token

    def recording(req, token, now):
        delivered.setdefault(req.stream.request_id, []).append(token)
        emit(req, token, now)

    engine._emit_token = recording

    def done_rounds() -> set:
        body = json.loads(call(base + "/debug/rounds?limit=512&engine="
                               + engine.engine_tag)[1])
        return {r["round_id"] for r in body["rounds"] if r["done"]}

    rounds0 = done_rounds()
    scrape0 = metric_values(call(base + "/metrics")[1])
    rid = "chip-smoke-chat-" + "".join(c if c.isalnum() else "-"
                                       for c in label)
    headers, raw = call(base + "/v1/chat/completions", {
        "messages": CHAT_MESSAGES, "max_tokens": CHAT_NEW, "temperature": 0},
        {"X-Request-ID": rid})
    greedy = json.loads(raw)
    if greedy["id"] != rid or headers.get("X-Request-ID") != rid:
        fail(f"[{label}] X-Request-ID {rid!r} came back as "
             f"{greedy['id']!r} / {headers.get('X-Request-ID')!r}")
    if greedy["object"] != "chat.completion":
        fail(f"[{label}] chat body object {greedy['object']!r}")
    wait_idle(engine)
    engine._step_counter = itertools.count()
    engine._round_gen.manual_seed(engine.cfg.seed)
    sampled_body = {"messages": SAMPLED_MESSAGES, "max_tokens": CHAT_NEW,
                    "seed": 7, "stream": True}
    sampled_rid = rid + "-sampled"
    _, raw = call(base + "/v1/chat/completions", sampled_body,
                  {"X-Request-ID": sampled_rid})
    events = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
    if not events or events[-1] != "[DONE]":
        fail(f"[{label}] the sampled chat stream did not end with [DONE]")
    chunks = [json.loads(e) for e in events[:-1]]
    sampled = "".join(c["choices"][0]["delta"]["content"] for c in chunks)
    before = engine.stats
    _, raw = call(base + "/v1/chat/completions", {
        "messages": CHAT_MESSAGES[1:], "max_tokens": 8, "temperature": 0},
        {"X-Deadline-Ms": "1"})
    finish = json.loads(raw)["choices"][0]["finish_reason"]
    wait_idle(engine)
    engine._emit_token = emit
    after = engine.stats
    key = {"deadline_queue": "deadline_queue_drops",
           "deadline": "deadline_stops"}.get(finish)
    if key is None or after[key] != before[key] + 1:
        fail(f"[{label}] X-Deadline-Ms: 1 finished {finish!r} with "
             f"deadline counters {before['deadline_queue_drops']} -> "
             f"{after['deadline_queue_drops']} (queue), "
             f"{before['deadline_stops']} -> {after['deadline_stops']}")
    scrape1 = metric_values(call(base + "/metrics")[1])
    counted = (scrape1["engine_rounds_total"]
               - scrape0.get("engine_rounds_total", 0.0))
    completed = len(done_rounds() - rounds0)
    if not counted == completed > 0:
        fail(f"[{label}] /metrics engine_rounds_total moved {counted}, "
             f"/debug/rounds shows {completed} more completed records")
    snap = json.loads(call(base + "/debug/requests?limit=200")[1])
    tl = next((t for t in snap["completed"] if t["request_id"] == rid), None)
    names = {e["event"] for e in tl["events"]} if tl else set()
    if not {"engine_admit_pickup", "engine_first_readback"} <= names:
        fail(f"[{label}] /debug/requests timeline of {rid!r}: {names}")
    rounds = json.loads(call(base + f"/debug/rounds?limit=512&engine="
                             f"{engine.engine_tag}")[1])["rounds"]
    decode = [r for r in rounds if r["done"] and r["plan"]["decode_steps"]]
    if not decode or any(r["execution"]["device_ms"] <= 0 for r in decode):
        fail(f"[{label}] /debug/rounds holds {len(decode)} decode records, "
             f"device_ms {[r['execution']['device_ms'] for r in decode]}")
    bw = sorted(r["outcome"]["bw_util"] for r in decode)
    median = bw[len(bw) // 2]
    device_ms = sorted(r["execution"]["device_ms"] for r in decode)
    if not 0 < median <= 1.05:
        fail(f"[{label}] median bw_util of {len(bw)} decode rounds is "
             f"{median}, outside (0, 1.05]: {bw}")
    say(f"chat [{label}]: greedy /v1/chat/completions {rid!r} echoed, "
        f"{greedy['usage']['completion_tokens']} tokens, timeline events "
        f"{sorted(names)}; sampled streamed chat (seed 7): "
        f"{len(chunks) - 1} chunks; X-Deadline-Ms 1 -> {finish}; /metrics "
        f"{len(scrape1)} samples, {counted:.0f} rounds counted = records "
        f"completed; "
        f"{len(decode)} decode round records: bw_util min {bw[0]:.3f}, "
        f"p10 {bw[len(bw) // 10]:.3f}, median {median:.3f}, p90 "
        f"{bw[9 * len(bw) // 10]:.3f}, max {bw[-1]:.3f} (device_ms a host-"
        f"clock estimate under pipelining), median device_ms "
        f"{device_ms[len(bw) // 2]:.3f} [{card}]")
    return {"greedy": greedy["choices"][0]["message"]["content"],
            "greedy_ids": delivered.get(rid, []), "sampled": sampled,
            "sampled_ids": delivered.get(sampled_rid, []),
            "sampled_body": sampled_body}


def check_chat_texts(engine, chat: dict, label: str) -> None:
    """After the window, on the stopped served engine: the greedy chat's
    token ids and text are the engine's greedy ones for ``render_chat``
    of the same messages (prefix cache cleared: a cold admission, as the
    request had); and an eager engine (``cuda_graphs=False``) on the same
    weights, planning under the same budget, gives the sampled chat's
    token ids and text for the same body and seed (the served engine's
    sampling state was put back to its construction state before that
    request). Random weights over the byte tokenizer mostly sample ids
    past the bytes, whose text is empty: the ids are the check."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import Engine, SamplingParams
    from generativeaiexamples_tpu_torch.serving.openai_api import (
        _sampling_from_body, render_chat)

    tok = engine.tokenizer
    engine.clear_prefix_cache()
    s = engine.submit(tok.encode(render_chat(CHAT_MESSAGES)),
                      SamplingParams(max_tokens=CHAT_NEW, temperature=0))
    for _ in range(400):
        if s.finish_reason is not None:
            break
        engine._step()
    if (s.token_ids != chat["greedy_ids"] or s.text() != chat["greedy"]
            or len(s.token_ids) != CHAT_NEW):
        fail(f"[{label}] greedy chat tokens {chat['greedy_ids']} "
             f"({chat['greedy']!r}) are not the engine's greedy tokens "
             f"{s.token_ids} ({s.text()!r}) for the same messages")
    greedy_ids = s.token_ids
    eager = Engine(engine.params, engine.model_cfg, tok, replace(
        engine.cfg, cuda_graphs=False,
        sched_round_budget_tokens=engine.stats["sched_round_budget_tokens"]),
        device=engine.device)
    s = eager.submit(tok.encode(render_chat(SAMPLED_MESSAGES)),
                     _sampling_from_body(chat["sampled_body"],
                                         engine.cfg.max_output_length))
    for _ in range(400):
        if s.finish_reason is not None:
            break
        eager._step()
    if (s.token_ids != chat["sampled_ids"] or s.text() != chat["sampled"]
            or not s.token_ids):
        fail(f"[{label}] sampled chat (seed 7): the captured programs gave "
             f"{chat['sampled_ids']} ({chat['sampled']!r}), the eager "
             f"engine {s.token_ids} ({s.text()!r})")
    say(f"chat [{label}]: greedy chat tokens {greedy_ids[:8]}... and text "
        f"= the engine's greedy ones; sampled chat tokens "
        f"{s.token_ids[:8]}... ({len(s.token_ids)}, finish "
        f"{s.finish_reason}, distinct {len(set(s.token_ids))}) and text = "
        f"the eager engine's for seed 7")
    del eager


def serve(torch, dev, card: str, quantization: str = "",
          kv_quant: str = "") -> dict:
    """A main path: llama-2-7b-chat at full width and depth, bf16 random
    weights made on the card from seed 0 (quantized there to
    ``quantization``, over a ``kv_quant`` pool), served through the port's
    aiohttp /v1/completions. Every kernel count is set to 0 just before
    the counted requests and read just after; each kernel of the path
    must have run once per layer per decode step (attention) or once per
    projection per forward (int4), and the other path's kernels not at
    all. Then ``graphs_vs_eager`` and ``serve_admission`` on the same
    weights. Returns the launch counts of the served requests plus those
    of the admission path (in all and, for #3, by path), and the stopped
    engine with its untraced timings for ``traced_profiles``."""
    from concurrent.futures import ThreadPoolExecutor

    from generativeaiexamples_tpu_torch.engine import (EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.serving.model_server import (
        build_services, create_server_app)

    t0 = time.monotonic()
    ecfg = EngineConfig(max_slots=8, max_input_length=1024,
                        max_output_length=64, prefill_buckets=(128, 512, 1024),
                        page_size=128, kv_pool_tokens=8 * (1024 + 64),
                        dtype="bfloat16", kv_quant=kv_quant)
    engine, name = build_services("llama-2-7b-chat", engine_cfg=ecfg, seed=0,
                                  device=dev, quantization=quantization)
    t1 = time.monotonic()
    engine.prewarm()
    if engine.stats["requests"] != 0:
        fail(f"prewarm left {engine.stats['requests']} requests counted")
    say(f"serve [{quantization or 'bf16'}]: prewarm served its worst-case "
        f"request and the ladder pair in {time.monotonic() - t1:.1f} s, "
        f"pool {engine.stats['pool_pages']} pages")
    torch.cuda.synchronize()
    mcfg = engine.model_cfg
    mode = f"{quantization or 'bf16'} weights, {kv_quant or 'bf16'} KV"
    n_bytes = sum(t.numel() * t.element_size()
                  for t in llama.param_tensors(engine.params))
    say(f"serve [{mode}]: {name} L={mcfg.num_layers} D={mcfg.hidden_size} "
        f"H={mcfg.num_heads} KV={mcfg.num_kv_heads} hd={mcfg.head_dim} "
        f"V={mcfg.vocab_size}, {n_bytes / 1e9:.2f} GB of weights, pool "
        f"{engine.stats['pool_pages']} pages of {ecfg.page_size}, built in "
        f"{time.monotonic() - t0:.1f} s")
    base, stop_server = serve_app(create_server_app(engine,
                                                    model_name=name))
    try:
        bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0,
                   "stream": i == 1} for i, p in enumerate(SERVE_PROMPTS)]
        # Warm-up request (first cuBLAS/kernel loads), outside the count.
        post(base + "/v1/completions", {"prompt": "warm", "max_tokens": 2,
                                        "temperature": 0})

        stats0 = engine.stats
        tok0 = engine.stats["tokens_generated"]
        zero_launch_counts()
        t1 = time.monotonic()
        with ThreadPoolExecutor(len(bodies)) as pool:
            outs = list(pool.map(
                lambda b: post(base + "/v1/completions", b), bodies))
        wall = time.monotonic() - t1
        tokens_http = engine.stats["tokens_generated"] - tok0
        stream = engine.submit(engine.tokenizer.encode(ENGINE_PROMPT),
                               SamplingParams(max_tokens=32, ignore_eos=True,
                                              temperature=0))
        stream.text()
        chat = serve_chat(base, engine, mode, card)
        torch.cuda.synchronize()
        run = read_launch_counts(engine, stats0)
    finally:
        stop_server()
        engine.stop()
    check_chat_texts(engine, chat, mode)

    for i, (body, raw) in enumerate(zip(bodies, outs)):
        if body["stream"]:
            events = [ln[6:] for ln in raw.splitlines()
                      if ln.startswith("data: ")]
            if not events or events[-1] != "[DONE]":
                fail(f"request {i}: SSE stream did not end with [DONE]")
            finish = json.loads(events[-2])["choices"][0]["finish_reason"]
        else:
            out = json.loads(raw)
            finish = out["choices"][0]["finish_reason"]
            n = out["usage"]["completion_tokens"]
            if not 1 <= n <= 32:
                fail(f"request {i}: {n} completion tokens")
        if finish not in ("length", "eos", "stop"):
            fail(f"request {i}: finish_reason {finish!r}")
        say(f"serve [{mode}]: request {i} ({len(body['prompt']) + 1} prompt "
            f"tokens, "
            f"stream={body['stream']}): finish_reason={finish}")
    if len(stream.token_ids) != 32 or stream.finish_reason != "length":
        fail(f"ignore_eos request gave {len(stream.token_ids)} tokens, "
             f"finish {stream.finish_reason!r}")
    if not all(0 <= t < mcfg.vocab_size for t in stream.token_ids):
        fail("ignore_eos request produced out-of-vocab ids")
    check_launch_counts(f"[{mode}]", run, mcfg.num_layers, quantization,
                        kv_quant, head_tiles(engine))
    counts, by_path = run["launches"], run["by_path"]
    steps, prefills = run["decode_steps"], run["prefills"]
    # Both rungs of the active-row ladder ran: rounds of one stream (the
    # ignore_eos request) sample 1 row, concurrent ones all 8.
    B = ecfg.max_slots
    sampled, skipped = (run["sampler_rows_sampled"],
                        run["sampler_rows_skipped"])
    if not (steps < sampled < B * steps and sampled + skipped == B * steps):
        fail(f"[{mode}] the fused tail sampled {sampled} and skipped "
             f"{skipped} rows over {steps} decode steps: not both ladder "
             f"rungs (1 and {B} rows)")
    say(f"serve [{mode}]: fused tail over {steps} decode steps sampled "
        f"{sampled} rows and skipped {skipped} (ladder rungs 1 and {B})")
    decode_s = stream.finish_time - stream.first_token_time
    say(f"serve [{mode}]: {len(bodies)} concurrent /v1/completions in "
        f"{wall:.3f} s, {tokens_http} tokens ({tokens_http / wall:.1f} tok/s "
        f"aggregate); single ignore_eos request: TTFT {stream.ttft_ms:.1f} "
        f"ms, decode {31 / decode_s:.1f} tok/s; launches {counts} (int4 "
        f"by path {by_path}) over {steps} decode steps and {prefills} "
        f"prefills [{card}]")
    untraced = graphs_vs_eager(torch, dev, card, engine, mode)
    admission = serve_admission(torch, dev, card, engine, mode,
                                quantization)
    torch.cuda.empty_cache()
    return {"launches": {k: n + admission["launches"][k]
                         for k, n in counts.items()},
            "by_path": {k: n + admission["by_path"][k]
                        for k, n in by_path.items()},
            "profile": (mode, engine, untraced)}


# Speculative decoding: prompts whose answers can copy spans of them
# (prompt lookup drafts from the context) beside the serve prompts; the
# near-tie rule's threshold on the plain engine's top-2 logit gap where
# the spec engine parts from it (bf16 rounding moves a 7B logit by a few
# hundredths between two computation orders; the verify forward runs
# #3 "wg" at M = 64 and a gathered attention where decode runs "tc" at
# M = 8 and #1/#2).
SPEC_PROMPTS = ["The cat sat on the mat. The dog sat on the log. " * 6,
                "one two three four five six seven eight nine ten " * 5]
SPEC_NEW = 40
SPEC_TIE = 0.5


def free_memory(torch) -> None:
    """Hand the memory of the engines a phase dropped back to the card
    (a cycle of references would otherwise hold their pools until the
    collector runs) and print what stays allocated."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    say(f"memory: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"reserved")


def first_parting(torch, engine, ids, plain, spec):
    """None when ``spec`` equals ``plain``; else (position, top-2 gap of
    the plain engine's logits there)."""
    if spec == plain:
        return None
    k = next((j for j, (a, b) in enumerate(zip(plain, spec)) if a != b),
             min(len(plain), len(spec)))
    return k, top2_gap(torch, engine, ids + plain[:k])


def serve_spec(torch, dev, card: str, served, mode: str,
               quantization: str) -> dict:
    """Speculative decoding at full width and depth on the served
    engine's weights: an engine with ``spec_decode`` (captured verify
    rounds per page window, greedy flag and rung) serves the spec and
    serve prompts greedily in one batch (verify rounds at the 8-slot
    rung), one draftable prompt alone (the 1-row rung) and a sampled
    request, in a counted window: every verify round's 224 projections
    on #3 "wg" at M = 64 and its lm_head tiles on "wg" (8 rows x S) or
    "tc" (1 row x S), #1/#2 only in the classic rounds between them.
    Greedy tokens equal the plain served engine's up to the first
    position where the plain engine's top-2 logit gap is under
    SPEC_TIE (where they part is printed); ``spec_accepted_tokens`` > 0;
    the sampled request keeps its length. Prints the calibrator's budget
    moves and calibrated costs, and the verify round's device time,
    tokens per verify slot-step and the gathered attention's share
    (``profile_decode.measure_verify``, untraced; ``profile_decode
    --spec`` traces a verify round). Returns the counts, the verify
    rounds' "wg" launches and the calibrated decode step."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import Engine, SamplingParams
    from generativeaiexamples_tpu_torch.tools.profile_decode import \
        measure_verify

    t0 = time.monotonic()
    spec = Engine(served.params, served.model_cfg, served.tokenizer,
                  replace(served.cfg, spec_decode=True), device=dev)
    S = spec._spec_S
    say(f"spec [{mode}]: engine with S = {S} built in "
        f"{time.monotonic() - t0:.1f} s: {len(spec._verify_graphs)} verify "
        f"programs over windows {spec._windows} pages, graph pool "
        f"{spec.graph_pool_bytes / 1e9:.2f} GB; measured verify "
        f"{spec._sched.cost.verify_ms_per_token:.4f} ms per position, "
        f"decode {spec._sched.cost.decode_step_ms:.3f} ms per step")
    tok = spec.tokenizer
    greedy_ids = [tok.encode(p) for p in SPEC_PROMPTS + SERVE_PROMPTS[:2]]
    sp = SamplingParams(max_tokens=SPEC_NEW, temperature=0, ignore_eos=True)
    sampled_sp = SamplingParams(max_tokens=24, temperature=0.8, top_k=40,
                                ignore_eos=True, random_seed=3)
    rungs = []
    real = spec._dispatch_verify

    def counted(drafts, rec=None):
        rungs.append(spec._ba_for(len(spec._armed())))
        return real(drafts, rec)
    spec._dispatch_verify = counted
    spec.start()
    spec.submit(tok.encode("warm"), SamplingParams(max_tokens=2)).text()
    wait_idle(spec)
    stats0 = spec.stats
    zero_launch_counts()
    rungs.clear()
    batch = [spec.submit(i, sp) for i in greedy_ids]
    sampled = spec.submit(tok.encode(SPEC_PROMPTS[0]), sampled_sp)
    for s in batch + [sampled]:
        s.text()
    alone = spec.submit(greedy_ids[0], sp)
    alone.text()
    torch.cuda.synchronize()
    run = read_launch_counts(spec, stats0)
    now = spec.stats
    spec.stop()
    del spec._dispatch_verify   # the class's method again, no cycle
    V = now["spec_verify_rounds"] - stats0["spec_verify_rounds"]
    v_one = rungs.count(1)
    accepted = now["spec_accepted_tokens"] - stats0["spec_accepted_tokens"]
    drafted = now["spec_draft_tokens"] - stats0["spec_draft_tokens"]
    per_step = ((now["spec_verify_tokens"] - stats0["spec_verify_tokens"])
                / max(1, now["spec_verify_slot_steps"]
                      - stats0["spec_verify_slot_steps"]))
    if V <= 0 or accepted <= 0:
        fail(f"[{mode}] spec: {V} verify rounds, {accepted} drafts accepted "
             f"of {drafted}")
    if len(sampled.token_ids) != 24 or sampled.finish_reason != "length":
        fail(f"[{mode}] spec: the sampled request gave "
             f"{len(sampled.token_ids)} tokens, finish "
             f"{sampled.finish_reason!r}")
    # Launches by formula: classic steps run #1/#2 per layer and #3 "tc";
    # a verify round runs its 224 projections at M = 64 on "wg" and its
    # lm_head tiles at M = rung x S ("wg" at 8 rows, "tc" at 1).
    L, tiles = served.model_cfg.num_layers, head_tiles(spec)
    classic = run["decode_steps"] - V
    attn = ("paged_attention_decode_int8" if served.cfg.kv_quant
            else "paged_attention_decode")
    want = {"paged_attention_decode": 0, "paged_attention_decode_int8": 0,
            "int4_matmul": 0}
    want[attn] = L * classic
    want_path = {"tc": 0, "gemv": 0, "tile": 0, "wg": 0}
    verify_wg = 0
    if quantization:
        verify_wg = 7 * L * V + tiles * (V - v_one)
        want_path = {"tc": (7 * L + tiles) * classic + run["prefills"]
                     + tiles * v_one, "gemv": 0, "tile": 0,
                     "wg": 7 * L * run["prefill_dispatches"] + verify_wg}
        want["int4_matmul"] = want_path["tc"] + want_path["wg"]
    if run["launches"] != want or run["by_path"] != want_path:
        fail(f"[{mode}] spec kernel launches {run['launches']} (int4 by path "
             f"{run['by_path']}) over {classic} classic steps and {V} verify "
             f"rounds ({v_one} at the 1-row rung), {run['prefills']} "
             f"admissions; expected {want} ({want_path})")
    say(f"spec [{mode}]: {V} verify rounds ({v_one} at 1 row) and "
        f"{classic} classic steps; drafts accepted {accepted} of {drafted} "
        f"({accepted / max(1, drafted):.1%}); {per_step:.3f} tokens per "
        f"verify slot-step; launches {run['launches']} (int4 by path "
        f"{run['by_path']}) as the formula says [{card}]")
    # Greedy: the plain served engine on the same prompts, both cold.
    served.clear_prefix_cache()
    served.start()
    plain = [served.submit(i, sp) for i in greedy_ids]
    for s in plain:
        s.text()
    served.stop()
    served.clear_prefix_cache()
    for i, (ids, p, g) in enumerate(zip(greedy_ids, plain, batch)):
        part = first_parting(torch, served, ids, p.token_ids, g.token_ids)
        if part is None:
            say(f"spec [{mode}]: prompt {i}: {len(g.token_ids)} greedy "
                f"tokens equal the plain engine's")
            continue
        k, gap = part
        if gap >= SPEC_TIE:
            fail(f"[{mode}] spec prompt {i}: greedy token {k} is "
                 f"{g.token_ids[k]}, the plain engine's {p.token_ids[k]} "
                 f"with a top-2 logit gap of {gap} (>= {SPEC_TIE})")
        say(f"spec [{mode}]: prompt {i}: equal to the plain engine's up to "
            f"token {k}, where they part at a near-tie (top-2 gap {gap:.4f}"
            f" < {SPEC_TIE})")
    part = first_parting(torch, served, greedy_ids[0],
                         plain[0].token_ids, alone.token_ids)
    if part is not None and part[1] >= SPEC_TIE:
        fail(f"[{mode}] spec: the lone draftable request parts from the "
             f"plain engine at token {part[0]}, top-2 gap {part[1]}")
    cost, prior = spec._sched.cost, spec._calib.prior if spec._calib \
        else spec._sched.cost
    say(f"spec [{mode}]: calibrator: {now['sched_budget_recalibrations']} "
        f"budget moves, budget {now['sched_round_budget_tokens']}; decode "
        f"{prior.decode_step_ms:.4f} -> {cost.decode_step_ms:.4f} ms/step, "
        f"verify {prior.verify_ms_per_token:.5f} -> "
        f"{cost.verify_ms_per_token:.5f} ms/position, prefill "
        f"{prior.prefill_ms_per_token:.5f} -> "
        f"{cost.prefill_ms_per_token:.5f} ms/token [{card}]")
    ver = measure_verify(spec, 512, rounds=5, traced=False)
    say(f"spec [{mode}]: 8 slots at ~512 tokens: verify round "
        f"{ver['verify_ms']:.3f} ms (window {ver['window_pages']} pages) "
        f"against an 8-step decode round {ver['decode_round_ms']:.3f} ms; "
        f"{ver['verify_ms_per_position']:.4f} vs "
        f"{ver['decode_ms_per_position']:.4f} ms per slot-position; break "
        f"even at {ver['break_even_tokens_per_slot_step']:.2f} tokens per "
        f"verify slot-step (this run: {per_step:.3f}); the gathered "
        f"attention {ver['gathered_attention_ms']:.3f} ms "
        f"({ver['gathered_attention_share']:.1%} of the round) [{card}]")
    del spec
    free_memory(torch)
    return {"launches": run["launches"], "by_path": run["by_path"],
            "verify_wg": verify_wg,
            "calibrated_decode_ms": cost.decode_step_ms}


# The host KV tier's phase: a 2-slot engine whose pool holds about two
# requests, so three other prompts evict a served prompt's prefix.
TIER_PROMPT = ("Passage: the host tier keeps evicted prefix pages in pinned "
               "memory and copies them back at admission. " * 12)[:999]
TIER_CHURN = [("Other passage %d: unrelated text fills the pool. " % i * 20)
              [:999] for i in range(3)]


def pool_pages_of(engine, ids) -> dict:
    """Device copies of the pool pages of the cached blocks of ``ids``."""
    from generativeaiexamples_tpu_torch.engine.prefix_cache import \
        hash_blocks
    out = {}
    for h in hash_blocks(ids, engine.cfg.page_size):
        pg = engine._prefix_cache.page_of(h)
        if pg is not None:
            out[h] = {k: v[:, pg].clone()
                      for k, v in engine._state["cache"].items()}
    return out


def kv_tier_phase(torch, dev, card: str, served, mode: str,
                  quantization: str) -> dict:
    """The host KV tier at full width and depth on the served engine's
    weights, on eager 2-slot engines, in a counted window: a 1000-token
    prompt is served cold and again (a prefix hit), three other prompts
    evict its 7 cached pages (offloaded through pinned memory), and the
    prompt served again restores them: the restored pages are bit-equal to the offloaded
    ones and the greedy tokens equal the hit's (the same pages through
    the same program), the cold run's up to a near-tie. Then
    ``suspend_session`` of the prompt, ``resume_session`` of the blob on
    a second engine over the same parameters, and the prompt served
    there: restored, with the hit's continuation. Prints the D2H and H2D
    ms per page and GB/s (``Engine.measure_page_io``, CUDA events).
    Returns the launch counts (checked as the serve phases')."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import Engine, SamplingParams

    # Eager engines (their builds capture nothing): the tier's copies run
    # eagerly in any engine, and tests/test_torch_cuda.py holds them in a
    # graph engine.
    cfg = replace(served.cfg, max_slots=2, kv_pool_tokens=2 * (1024 + 64),
                  kv_host_pool_tokens=16 * 1024, cuda_graphs=False)
    tok = served.tokenizer
    ids = tok.encode(TIER_PROMPT)
    sp = SamplingParams(max_tokens=16, temperature=0, ignore_eos=True)
    t0 = time.monotonic()
    eng = Engine(served.params, served.model_cfg, tok, cfg, device=dev)
    # The resuming engine is built before the counted window: a build's
    # warm-up launches count.
    other = Engine(served.params, served.model_cfg, tok, cfg, device=dev)
    say(f"kv tier [{mode}]: two engines with {eng.stats['pool_pages']} pool "
        f"pages and a {cfg.kv_host_pool_tokens}-token host tier each built "
        f"in {time.monotonic() - t0:.1f} s")
    stats0, ostats0 = eng.stats, other.stats
    zero_launch_counts()
    eng.start()
    cold = eng.submit(ids, sp)
    cold.text()
    hit = eng.submit(ids, sp)
    hit.text()
    wait_idle(eng)
    eng.stop()
    before = pool_pages_of(eng, ids)
    n_blocks = len(before)
    eng.start()
    for text in TIER_CHURN:
        eng.submit(tok.encode(text), sp).text()
    deadline = time.monotonic() + 60
    while eng.stats["kv_tier_offload_pages"] < n_blocks:
        if time.monotonic() > deadline:
            fail(f"[{mode}] kv tier: {eng.stats['kv_tier_offload_pages']} of "
                 f"{n_blocks} pages offloaded")
        time.sleep(0.01)
    eng.stop()
    if pool_pages_of(eng, ids):
        fail(f"[{mode}] kv tier: the prompt's pages were not evicted")
    eng.start()
    warm = eng.submit(ids, sp)
    warm.text()
    wait_idle(eng)
    eng.stop()
    st = eng.stats
    restored = st["kv_tier_restore_pages"] - stats0["kv_tier_restore_pages"]
    after = pool_pages_of(eng, ids)
    if restored != n_blocks or len(after) != n_blocks:
        fail(f"[{mode}] kv tier: restored {restored} pages, {len(after)} "
             f"cached, of {n_blocks}")
    for h, leaves in after.items():
        for name, t in leaves.items():
            if not torch.equal(t, before[h][name]):
                fail(f"[{mode}] kv tier: restored page {name} differs from "
                     f"the offloaded bytes")
    if warm.token_ids != hit.token_ids:
        fail(f"[{mode}] kv tier: restored tokens {warm.token_ids} differ "
             f"from the prefix hit's {hit.token_ids}")
    blob = eng.suspend_session(ids)
    if blob is None or eng.stats["kv_tier_suspended_blocks"] != n_blocks:
        fail(f"[{mode}] kv tier: suspend gave no blob of {n_blocks} blocks")
    n = other.resume_session(blob)
    other.start()
    resumed = other.submit(ids, sp)
    resumed.text()
    wait_idle(other)
    other.stop()
    ost = other.stats
    if n != n_blocks or ost["kv_tier_restore_pages"] != n_blocks:
        fail(f"[{mode}] kv tier: resume took {n} blocks, restored "
             f"{ost['kv_tier_restore_pages']} of {n_blocks}")
    if resumed.token_ids != hit.token_ids:
        fail(f"[{mode}] kv tier: the resumed session continues "
             f"{resumed.token_ids}, the hit {hit.token_ids}")
    torch.cuda.synchronize()
    run = read_launch_counts(eng, stats0)
    for key in ("decode_steps", "prefills", "prefill_dispatches",
                "prefill_chunks"):
        run[key] += ost[key] - ostats0[key]
    check_launch_counts(f"[{mode}] kv tier", run,
                        served.model_cfg.num_layers, quantization,
                        served.cfg.kv_quant, head_tiles(eng))
    # After the counted window: a full forward launches kernels too.
    part = first_parting(torch, served, ids, cold.token_ids, hit.token_ids)
    if part is not None and part[1] >= SPEC_TIE:
        fail(f"[{mode}] kv tier: the warm tokens part from the cold run at "
             f"token {part[0]} with top-2 gap {part[1]}")
    d2h, h2d = eng.measure_page_io(16)
    page_bytes = (eng.cfg.page_size * eng._kv_bytes_per_token())
    parting = ("" if part is None else f" (the cold run parts at token "
               f"{part[0]}, top-2 gap {part[1]:.4f})")
    say(f"kv tier [{mode}]: {n_blocks} pages offloaded and restored bit-"
        f"equal, tokens = the prefix hit's{parting}"
        f"; suspend -> {len(blob)} byte blob -> resume on a second engine: "
        f"same continuation; page I/O "
        f"({page_bytes} bytes a page): D2H {d2h:.4f} ms/page "
        f"({page_bytes / d2h / 1e6:.2f} GB/s), H2D {h2d:.4f} ms/page "
        f"({page_bytes / h2d / 1e6:.2f} GB/s) [{card}]")
    del eng, other
    free_memory(torch)
    return run


def zero_launch_counts() -> None:
    """Set every kernel's launch count to 0 (a replay adds its capture's
    counts, so the counts stay exact across captured programs)."""
    from generativeaiexamples_tpu_torch.engine import graphs
    graphs.set_launch_counts(dict.fromkeys(graphs.launch_counts(), 0))


def read_launch_counts(engine, stats0: dict) -> dict:
    """The kernels' launch counts since ``zero_launch_counts`` and the
    engine's work since ``stats0`` (its stats then)."""
    from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul
    from generativeaiexamples_tpu_torch.ops.paged_attention import \
        paged_attention_decode
    now = engine.stats
    out = {k: now[k] - stats0[k] for k in (
        "decode_steps", "prefills", "prefill_dispatches", "prefill_chunks",
        "sampler_rows_sampled", "sampler_rows_skipped")}
    out["launches"] = {
        "paged_attention_decode": paged_attention_decode.launches,
        "paged_attention_decode_int8": paged_attention_decode.int8_launches,
        "int4_matmul": int4_matmul.launches}
    out["by_path"] = dict(int4_matmul.launches_by_path)
    return out


def head_tiles(engine) -> int:
    """The lm_head products of one decode step: one per vocab tile of the
    fused tail, or the whole head at once under the materialized one."""
    if not engine.cfg.fused_tail:
        return 1
    return engine.model_cfg.vocab_size // engine._sampler_tile


def check_launch_counts(label: str, run: dict, L: int, quantization: str,
                        kv_quant: str, n_tiles: int) -> None:
    """Every layer of every decode step went through the pool's attention
    kernel, once; under int4 weights every projection through #3: one per
    projection (7 per layer) per prefill program (one-shot admission or
    chunk; the bucket's rows on "wg") and per decode step (the sampled
    rows on "tc"), plus the lm_head's ``n_tiles`` vocab tiles on "tc" per
    decode step (the fused tail) and its row per admission (its one-shot
    program or final chunk samples one row whole); none on "tile" or
    "gemv"; the other pool kind's kernel never."""
    steps, prefills = run["decode_steps"], run["prefills"]
    dispatches = run["prefill_dispatches"]
    attn = "paged_attention_decode_int8" if kv_quant else \
        "paged_attention_decode"
    want = {"paged_attention_decode": 0, "paged_attention_decode_int8": 0,
            "int4_matmul": 0}
    want[attn] = L * steps
    want_path = {"tc": 0, "gemv": 0, "tile": 0, "wg": 0}
    if quantization in ("int4", "int4_awq"):
        want_path = {"tc": (7 * L + n_tiles) * steps + prefills, "gemv": 0,
                     "tile": 0, "wg": 7 * L * dispatches}
        want["int4_matmul"] = want_path["tc"] + want_path["wg"]
    if (steps <= 0 or prefills <= 0 or run["launches"] != want
            or run["by_path"] != want_path):
        fail(f"{label} kernel launches {run['launches']} (int4 by path "
             f"{run['by_path']}) over {steps} decode steps, {prefills} "
             f"admissions and {dispatches} prefill programs; expected "
             f"{want} ({want_path})")


# The admission phase's prompts: a shared system prompt of 600 byte
# tokens (with bos) before each of two questions, four decoding streams'
# prompts, and a 2900-token document prompt.
SYSTEM_PROMPT = ("Answer from the retrieved passages only, and cite them. "
                 * 11)[:599]
QUESTIONS = [" Q: What does the paged KV pool hold?",
             " Q: How are prompts admitted under load?"]
DOC_PROMPT = ("Passage: the engine plans each round under a token budget. "
              * 50)[:2899]


def serve_admission(torch, dev, card: str, served, mode: str,
                    quantization: str) -> dict:
    """The admission path at full depth, on the served engine's weights:
    an engine for 3000-token prompts (buckets to 3072, 8 slots) serves,
    through its serve thread, a shared-system-prompt pair one after the
    other (the second maps the first's cached pages: hit tokens, warm
    against cold TTFT) and then a 2900-token prompt that arrives while 4
    streams decode, first under the budget the engine measured at
    construction (the prompt goes in chunks beside the decode rounds),
    then on an engine with the budget pinned high (one 3072-token
    admission, the behaviour before the scheduler). Prints the chunks,
    the interleaved rounds and the largest gap between two deliveries of
    tokens to a decoding stream while the long prompt is admitted. The
    launch counts are set to 0 before each engine's requests and read
    after: every kernel of the path must have run as
    ``check_launch_counts`` says. Returns the measured engine's counts."""
    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)

    tok = served.tokenizer
    mcfg = served.model_cfg
    base = dict(max_slots=8, max_input_length=3000, max_output_length=320,
                page_size=128, kv_pool_tokens=8 * (3072 + 320),
                dtype="bfloat16", kv_quant=served.cfg.kv_quant)
    greedy = dict(top_k=1, ignore_eos=True)
    pair = [tok.encode(SYSTEM_PROMPT + q) for q in QUESTIONS]
    decoders = [tok.encode(f"Stream {i}: count the pages. " * 4)
                for i in range(4)]
    doc = tok.encode(DOC_PROMPT)
    results = {}
    for label, pin in (("measured", None), ("pinned high", 8192)):
        t0 = time.monotonic()
        engine = Engine(served.params, mcfg, tok, EngineConfig(
            **base, sched_round_budget_tokens=pin), device=dev)
        programs = sum(len(t) for t in (
            engine._round_graphs, engine._admit_graphs,
            engine._extend_graphs, engine._final_graphs))
        build_s = time.monotonic() - t0
        with engine:
            engine.submit(tok.encode("warm"), SamplingParams(
                max_tokens=2, **greedy)).text()
            torch.cuda.synchronize()
            stats0 = engine.stats
            zero_launch_counts()
            cold = engine.submit(pair[0], SamplingParams(max_tokens=8,
                                                         **greedy))
            cold.text()
            warm = engine.submit(pair[1], SamplingParams(max_tokens=8,
                                                         **greedy))
            warm.text()
            hit = engine.stats["prefix_cache_hit_tokens"] - stats0[
                "prefix_cache_hit_tokens"]
            streams = [engine.submit(p, SamplingParams(max_tokens=300,
                                                       **greedy))
                       for p in decoders]
            while min(len(s.token_ids) for s in streams) < 24:
                time.sleep(0.001)
            before = engine.stats
            t_sub = time.monotonic()
            long_ = engine.submit(doc, SamplingParams(max_tokens=8,
                                                      **greedy))
            long_.text()
            during = engine.stats
            for s in streams:
                s.text()
            torch.cuda.synchronize()
            run = read_launch_counts(engine, stats0)
        check_launch_counts(f"[{mode}] admission ({label})", run,
                            mcfg.num_layers, quantization, base["kv_quant"],
                            head_tiles(engine))
        if pin is None:
            arrival_ttft(card, engine, mode)
        # Gaps between two read-backs that delivered tokens to a decoding
        # stream (a round's tokens share one time), during the long
        # prompt's admission and outside it.
        t_first = long_.first_token_time
        gaps, steady = [], []
        for s in streams:
            t = sorted(set(s.token_times))
            for a, b in zip(t, t[1:]):
                (gaps if b > t_sub and a < t_first else steady).append(b - a)
        outs = [cold, warm, long_] + streams
        if any(len(s.token_ids) != n for s, n in zip(
                outs, [8, 8, 8] + [300] * 4)) or not all(
                0 <= t < mcfg.vocab_size for s in outs for t in s.token_ids):
            fail(f"[{mode}] admission ({label}): token counts "
                 f"{[len(s.token_ids) for s in outs]} or ids out of vocab")
        chunks = during["prefill_chunks"] - before["prefill_chunks"]
        inter = (during["sched_interleaved_rounds"]
                 - before["sched_interleaved_rounds"])
        budget = engine.stats["sched_round_budget_tokens"]
        results[label] = dict(hit=hit, chunks=chunks, run=run)
        say(f"admission [{mode}] ({label} budget {budget} tokens; {programs}"
            f" programs captured in {build_s:.1f} s, graph pool "
            f"{engine.graph_pool_bytes} bytes): shared-system-prompt pair of"
            f" {len(pair[0])} and {len(pair[1])} tokens: {hit} hit tokens, "
            f"TTFT cold {cold.ttft_ms:.1f} ms, warm {warm.ttft_ms:.1f} ms; "
            f"{len(doc)}-token prompt during 4 decoding streams: TTFT "
            f"{long_.ttft_ms:.1f} ms, {chunks} chunks, {inter} interleaved "
            f"rounds, largest delivery gap of a decoding stream during its "
            f"admission {max(gaps) * 1e3:.1f} ms (median outside it "
            f"{sorted(steady)[len(steady) // 2] * 1e3:.1f} ms) [{card}]")
        del engine
        torch.cuda.empty_cache()
    measured, pinned = results["measured"], results["pinned high"]
    if measured["chunks"] < 2 or pinned["chunks"] != 0:
        fail(f"[{mode}] the long prompt went in {measured['chunks']} chunks "
             f"under the measured budget and {pinned['chunks']} pinned high; "
             f"expected several and none")
    if measured["hit"] != 512 or pinned["hit"] != 512:
        fail(f"[{mode}] shared-system-prompt hits {measured['hit']} and "
             f"{pinned['hit']} tokens; expected 512 (4 pages)")
    return measured["run"]


def arrival_ttft(card: str, engine, mode: str) -> None:
    """The time to first token of a 128-token request arriving at a
    random moment beside 4 decoding streams (512-token prompts), with the
    harvest worker (dispatch depth 2) and with rounds read back in line
    (1), in turns 2, 1, 2, 1 of 6 arrivals each on the stopped engine;
    each turn's prompts are new (no prefix hit)."""
    from generativeaiexamples_tpu_torch.tools.profile_decode import \
        measure_arrival_ttft

    got = {2: [], 1: []}
    for i, d in enumerate((2, 1, 2, 1)):
        got[d] += measure_arrival_ttft(engine, d, seed=100 + i)["ttft_ms"]
    for d, ttft in got.items():
        ttft.sort()
        say(f"arrival [{mode}]: dispatch depth {d}: TTFT of a 128-token "
            f"request beside 4 decoding streams, {len(ttft)} arrivals: mean "
            f"{sum(ttft) / len(ttft):.1f} ms, median "
            f"{ttft[len(ttft) // 2]:.1f}, range {ttft[0]:.1f}-{ttft[-1]:.1f} "
            f"[{card}]")


def top2_gap(torch, engine, ids) -> float:
    """The gap between the two largest logits of the token after ``ids``,
    from a full forward of the served weights (no cache, no kernel)."""
    from generativeaiexamples_tpu_torch.models import llama
    dev = engine.device
    with torch.no_grad():
        t = torch.tensor([ids], dtype=torch.int32, device=dev)
        pos = torch.arange(len(ids), dtype=torch.int32, device=dev)[None, :]
        logits, _ = llama.apply(engine.params, engine.model_cfg, t, pos)
        top = logits[0, -1].float().topk(2).values
    return float(top[0] - top[1])


def graphs_vs_eager(torch, dev, card: str, engine, mode: str) -> dict:
    """The served engine (every round and admission a replay of a program
    it captured at construction) against an eager engine on the same
    weights (``cuda_graphs=False``): the serve prompts and the engine
    prompt, 32 greedy tokens each (``ignore_eos``), one schedule on both
    (all submitted, then the serve loop's step driven on this thread,
    each round read back in line), must give equal tokens; a difference
    fails with its first step and the top-2 logit gap there; so must an
    eager engine with the materialized tail (``fused_tail=False``, the
    oracle: (B, V) logits, one whole-head product). Then
    ``profile_decode``'s untraced measurements on the served engine: a
    decode round of 8 slots with 512-token prompts (host-clock step over
    4 rounds) at dispatch depth 2 (the harvest worker), 1 (in line), 2
    and 1, and a bucket-128 admission (host-clock time to the first
    token, mean of 4); the same 8-slot step on a graph engine with the
    materialized tail, in turns (materialized, fused, fused,
    materialized); one stream's step with the active-row ladder and with
    every round forced onto the 8-row rung, in turns; and the tail alone
    (``measure_tail``: fused at 8 and 1 rows, materialized, greedy and
    sampled; the fused tail at tiles of 4000, 8000 and 16000). Returns the
    step times by depth, the admission's time and the materialized graph
    engine (traced last)."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import Engine, SamplingParams
    from generativeaiexamples_tpu_torch.tools.profile_decode import (
        measure_decode, measure_prefill, tail_table)

    ids = [engine.tokenizer.encode(p) for p in SERVE_PROMPTS + [ENGINE_PROMPT]]
    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True)
    # The served engine still caches the serve prompts' pages: both
    # engines start cold, so both prefill the same way.
    engine.clear_prefix_cache()
    # The eager engine plans with the served engine's measured budget, so
    # both make one schedule.
    budget = engine.stats["sched_round_budget_tokens"]
    eager = Engine(engine.params, engine.model_cfg, engine.tokenizer,
                   replace(engine.cfg, cuda_graphs=False,
                           sched_round_budget_tokens=budget), device=dev)
    oracle = Engine(engine.params, engine.model_cfg, engine.tokenizer,
                    replace(engine.cfg, cuda_graphs=False, fused_tail=False,
                            sched_round_budget_tokens=budget), device=dev)
    runs = {}
    for name, eng in (("graphs", engine), ("eager", eager),
                      ("materialized", oracle)):
        streams = [eng.submit(i, sp) for i in ids]
        for _ in range(100):
            if all(s.finish_reason is not None for s in streams):
                break
            eng._step()
        runs[name] = [s.token_ids for s in streams]
        if any(len(t) != 32 for t in runs[name]):
            fail(f"[{mode}] {name} engine: {[len(t) for t in runs[name]]} "
                 f"tokens")
    del eager, oracle
    for other in ("eager", "materialized"):
        for i, (a, b) in enumerate(zip(runs["graphs"], runs[other])):
            if a != b:
                k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
                gap = top2_gap(torch, engine, ids[i] + a[:k])
                fail(f"[{mode}] prompt {i} ({len(ids[i])} tokens): the "
                     f"captured programs' greedy token {k} is {a[k]}, the "
                     f"{other} engine's {b[k]} (top-2 logit gap there "
                     f"{gap})")
    # The decode step with the harvest worker (2 rounds in flight) and
    # with each round read back on the serve thread, on one engine, and a
    # bucket-128 admission, all untraced: no profiler has run in this
    # process yet, so these are a server's timings (traced_profiles
    # traces last).
    decs = [measure_decode(engine, 8, 512, rounds=4, dispatch_depth=d,
                           traced=False) for d in (2, 1, 2, 1)]
    pre = measure_prefill(engine, 128, rounds=4, traced=False)
    # The materialized tail's graph engine on the same weights, and the
    # 8-slot step of both in turns.
    t0 = time.monotonic()
    mat = Engine(engine.params, engine.model_cfg, engine.tokenizer,
                 replace(engine.cfg, fused_tail=False), device=dev)
    mat_build = time.monotonic() - t0
    turns = [(name, measure_decode(e, 8, 512, rounds=4, dispatch_depth=2,
                                   traced=False))
             for name, e in (("materialized", mat), ("fused", engine),
                             ("fused", engine), ("materialized", mat))]
    # One stream: the ladder's 1-row rung, against every round forced
    # onto the 8-row rung (its captured programs), in turns.
    ladder = engine._ba_ladder
    single = []
    for rungs in (ladder, ladder[-1:], ladder, ladder[-1:]):
        engine._ba_ladder = rungs
        single.append((rungs, measure_decode(engine, 1, 512, rounds=4,
                                             dispatch_depth=2,
                                             traced=False)["step_ms"]))
    engine._ba_ladder = ladder
    tails = tail_table(engine, tiles=(4000, 8000, 16000))
    say(f"graphs [{mode}]: greedy tokens of the {len(ids)} serve prompts "
        f"equal the eager engine's and the materialized-tail eager "
        f"engine's; captured programs hold "
        f"{engine.graph_pool_bytes} bytes of pool, memory reserved "
        f"{torch.cuda.memory_reserved(dev)} bytes")
    for run in decs:
        say(f"graphs [{mode}]: dispatch depth {run['dispatch_depth']} (peak "
            f"{run['dispatch_depth_peak']}, untraced): decode step "
            f"{run['step_ms']:.3f} ms (host clock, 8 slots, context "
            f"~{run['context']}); serve thread {run['serve_ms_per_step']:.3f}"
            f" ms/step with the flight and round recorders on, harvest wait "
            f"{run['harvest_wait_ms_per_step']:.3f} [{card}]")
    if any(r["dispatch_depth_peak"] != r["dispatch_depth"] for r in decs):
        fail(f"[{mode}] a decode measurement never had its dispatch depth "
             f"of rounds in flight")
    say(f"graphs [{mode}]: bucket-128 TTFT {pre['prefill_ms']:.3f} ms (host "
        f"clock, untraced) [{card}]")
    say(f"tail [{mode}]: materialized-tail graph engine built in "
        f"{mat_build:.1f} s, {len(mat._round_graphs)} round programs "
        f"(fused: {len(engine._round_graphs)}); 8-slot decode step, depth "
        f"2, untraced, in turns: " + ", ".join(
            f"{name} {r['step_ms']:.3f} ms" for name, r in turns)
        + f" [{card}]")
    say(f"tail [{mode}]: one stream, depth 2, untraced, in turns: "
        + ", ".join(f"rungs {r} {ms:.3f} ms ({1e3 / ms:.1f} tok/s)"
                    for r, ms in single) + f" [{card}]")
    for t in tails:
        say(f"tail [{mode}]: {'fused' if t['fused'] else 'materialized'} "
            f"tail alone, {t['rows']} rows, "
            f"{'greedy' if t['greedy'] else 'sampled'}"
            + (f", tile {t['tile']}" if t["fused"] else "")
            + f": {t['ms']:.4f} ms/step (device, CUDA events over a graph "
            f"of 20), int4 launches per step {t.get('int4_launches')} "
            f"[{card}]")
    torch.cuda.empty_cache()
    return {"step_ms": {d: [r["step_ms"] for r in decs
                            if r["dispatch_depth"] == d] for d in (2, 1)},
            "prefill_ms": pre["prefill_ms"], "materialized": mat}


def traced_profiles(torch, card: str, served: list) -> None:
    """The traced measurements, after every untraced one: once a
    torch.profiler session has run, CUPTI stays attached for the rest of
    the process and changes how the card runs CUDA graphs (a replayed
    round's launch costs the host milliseconds). For each served engine
    (mode, engine, its untraced timings): one traced decode round at
    depth 2 (device time, busy time, by kernel; busy share against the
    untraced depth-2 step) and one traced bucket-128 admission; then the
    same traced round on the materialized-tail engine, the fused tail
    alone traced (its kernels per step, busy time), and one lm_head tile
    product traced: its kernels must hold no copy (the strided column
    slice reaches cuBLAS or #3 in place)."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.tools.profile_decode import (
        _device_events, _kernel_times, _profile, measure_decode,
        measure_prefill, measure_tail)

    while served:
        mode, engine, untraced = served.pop(0)
        mat = untraced.pop("materialized")
        dec = measure_decode(engine, 8, 512, rounds=4, dispatch_depth=2)
        mat_dec = measure_decode(mat, 8, 512, rounds=4, dispatch_depth=2)
        mat.stop()
        del mat
        tail = measure_tail(engine, 8, False, True, traced=True)
        hn = torch.randn((8, engine.model_cfg.hidden_size),
                         device=engine.device).to(torch.bfloat16)
        tile = engine._sampler_tile
        llama.lm_head_tile(engine.params, engine.model_cfg, hn, tile, tile)
        torch.cuda.synchronize()
        with _profile() as prof:
            llama.lm_head_tile(engine.params, engine.model_cfg, hn, tile,
                               tile)
            torch.cuda.synchronize()
        head_kernels = sorted(_kernel_times(_device_events(prof)))
        if not head_kernels or any("copy" in k.lower() for k in
                                   head_kernels):
            fail(f"traced [{mode}]: an lm_head tile product ran kernels "
                 f"{head_kernels}: a copy of the strided slice, or none")
        pre = measure_prefill(engine, 128, rounds=4)
        busy = dec["device_busy_ms_per_step"]
        step, step_1 = (min(untraced["step_ms"][d]) for d in (2, 1))
        say(f"traced [{mode}]: the spec engine's calibrated decode step "
            f"{untraced['calibrated_decode_ms']:.4f} ms beside this traced "
            f"round's device {dec['device_ms_per_step']:.4f} ms/step (busy "
            f"{busy:.4f}) [{card}]")
        kernels = {k: round(v, 3)
                   for k, v in dec["kernel_ms_per_step"].items()}
        say(f"traced [{mode}]: decode round (depth 2; traced-session step "
            f"{dec['step_ms']:.3f} ms): device {dec['device_ms_per_step']:.3f}"
            f" ms/step (busy {busy:.3f}), busy share of the untraced depth-2 "
            f"step {step:.3f} ms {busy / step:.1%}, of the untraced depth-1 "
            f"step {step_1:.3f} ms {busy / step_1:.1%}; "
            f"kernels per step (ms) {kernels} over "
            f"{dec['kernel_launches']} launches [{card}]")
        say(f"traced [{mode}]: materialized-tail round: device "
            f"{mat_dec['device_ms_per_step']:.3f} ms/step (busy "
            f"{mat_dec['device_busy_ms_per_step']:.3f}) over "
            f"{mat_dec['kernels_per_step']:.0f} device ops per step; fused: "
            f"busy {busy:.3f} over {dec['kernels_per_step']:.0f} [{card}]")
        say(f"traced [{mode}]: fused tail alone (8 rows, sampled): busy "
            f"{tail['busy_ms']:.4f} ms/step over "
            f"{tail['kernels_per_step']:.0f} device ops per step, so the "
            f"rest of the fused step is {busy - tail['busy_ms']:.3f} ms; top "
            f"{tail['top_kernels']}; an lm_head tile product runs "
            f"{head_kernels} [{card}]")
        say(f"traced [{mode}]: bucket-128 admission device "
            f"{pre['device_ms']:.3f} ms (busy {pre['device_busy_ms']:.3f}), "
            f"busy share of the untraced TTFT {untraced['prefill_ms']:.3f} ms "
            f"{pre['device_busy_ms'] / untraced['prefill_ms']:.1%} [{card}]")
        if "int4" in mode:
            check_profiler_route(engine, mode, card)
        engine.stop()
        del engine
        torch.cuda.empty_cache()


def check_profiler_route(engine, mode: str, card: str) -> None:
    """The model server's profiler routes on the served int4 engine:
    POST /profiler/start (into a temporary directory), one streamed
    request, POST /profiler/stop; the Chrome trace written there must
    name the paged attention's split kernel and an int4 kernel."""
    import shutil
    import tempfile

    from generativeaiexamples_tpu_torch.serving.model_server import \
        create_server_app

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    base, stop_server = serve_app(create_server_app(engine,
                                                    model_name="traced"))
    try:
        call(base + "/profiler/start", {"dir": trace_dir})
        post(base + "/v1/completions", {"prompt": ENGINE_PROMPT,
                                        "max_tokens": 12, "temperature": 0,
                                        "stream": True})
        out = json.loads(call(base + "/profiler/stop", {})[1])
        with open(out["trace"]) as fh:
            trace = json.load(fh)
        size = os.path.getsize(out["trace"])
    finally:
        stop_server()
        shutil.rmtree(trace_dir, ignore_errors=True)
    kernels = sorted({e.get("name", "") for e in trace.get("traceEvents", [])
                      if e.get("cat") == "kernel"})
    split = [k for k in kernels if "paged_decode_split_kernel" in k]
    int4 = [k for k in kernels if "int4" in k]
    if not split or not int4:
        fail(f"profiler [{mode}]: the /profiler trace names no "
             f"paged_decode_split_kernel or no int4 kernel: {kernels[:40]}")
    say(f"profiler [{mode}]: /profiler/start + /stop around one request "
        f"wrote a {size} byte Chrome trace of {len(kernels)} kernel names, "
        f"among them {split[0][:60]!r} and {int4[0][:60]!r} [{card}]")


# ------------------------------------------------------- checkpoint phase

GOLDEN = "tests/fixtures/golden_tiny"
# A sentence the golden model's training corpus (docs/*.md) holds
# verbatim: trained weights score it far under ln(32000) = 10.4 nats.
CORPUS_SNIPPET = ("The stack is three services plus the subsystems they "
                  "share — the same topology as the reference RAG "
                  "pipeline")
GOLDEN_PROMPTS = ["Paged KV caching shares", "Continuous batching admits",
                  "The router sends each request"]
GOLDEN_NEW = 16


def golden_cpu_tokens(torch, params, tok, ecfg) -> list:
    """The greedy tokens of GOLDEN_PROMPTS from the same engine on the
    CPU, over ``params`` moved there (the kernels' plain versions)."""
    from generativeaiexamples_tpu_torch.engine import Engine
    from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.cpu()

    engine = Engine(to_cpu(params), GOLDEN_TINY, tok, ecfg, device="cpu")
    return greedy_tokens(engine, [tok.encode(p) for p in GOLDEN_PROMPTS],
                         GOLDEN_NEW)


def check_golden(torch, dev, card: str, quantization: str = "",
                 kv_quant: str = "") -> float:
    """The trained golden-tiny checkpoint (hidden 64, 2 layers, GQA 4/2,
    head_dim 16, the real 32k sentencepiece vocabulary) built through
    ``build_services(model_path=...)`` in bf16 (quantized on the card to
    ``quantization``, over a ``kv_quant`` pool) and served over the
    port's HTTP app: one streamed /v1/completions, counted (#1, or #2
    and #3, on every decode layer and projection), then /v1/score of the
    corpus snippet (NLL under 6.0 nats). The streamed text must equal
    decode() of the served engine's greedy tokens for the same request,
    and the greedy tokens of three prompts equal the same engine's on the
    CPU with the same parameters. Returns the score's mean NLL."""
    from generativeaiexamples_tpu_torch.engine import (EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.serving.model_server import (
        build_services, create_server_app)

    t0 = time.monotonic()
    mode = f"{quantization or 'bf16'} weights, {kv_quant or 'bf16'} KV"
    ecfg = EngineConfig(max_slots=4, max_input_length=256,
                        max_output_length=64, prefill_buckets=(64, 128, 256),
                        page_size=16, kv_pool_tokens=None, dtype="bfloat16",
                        kv_quant=kv_quant, sched_round_budget_tokens=1024)
    engine, name = build_services("golden-tiny", model_path=GOLDEN,
                                  engine_cfg=ecfg, device=dev,
                                  quantization=quantization)
    tok = engine.tokenizer
    mcfg = engine.model_cfg
    base, stop_server = serve_app(create_server_app(engine,
                                                    model_name=name))
    try:
        post(base + "/v1/completions", {"prompt": "warm", "max_tokens": 2,
                                        "temperature": 0})
        torch.cuda.synchronize()
        stats0 = engine.stats
        zero_launch_counts()
        raw = post(base + "/v1/completions", {
            "prompt": GOLDEN_PROMPTS[0], "max_tokens": GOLDEN_NEW,
            "temperature": 0, "stream": True})
        torch.cuda.synchronize()
        run = read_launch_counts(engine, stats0)
        events = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
        if not events or events[-1] != "[DONE]":
            fail(f"golden [{mode}]: the SSE stream did not end with [DONE]")
        streamed = "".join(json.loads(e)["choices"][0]["text"]
                           for e in events[:-1])
        same = engine.submit(tok.encode(GOLDEN_PROMPTS[0]), SamplingParams(
            max_tokens=GOLDEN_NEW, top_k=1))
        same.text()
        score = json.loads(post(base + "/v1/score",
                                {"text": CORPUS_SNIPPET}))
    finally:
        stop_server()
        engine.stop()
    check_launch_counts(f"golden [{mode}]", run, mcfg.num_layers,
                        quantization, kv_quant, head_tiles(engine))
    if streamed != tok.decode(same.token_ids) or len(streamed) < 10:
        fail(f"golden [{mode}]: streamed text {streamed!r} is not "
             f"decode() of the greedy tokens {same.token_ids}")
    nll = score["mean_nll"]
    if not nll < 6.0:
        fail(f"golden [{mode}]: /v1/score NLL {nll} of the corpus snippet "
             f"is not under 6.0 nats")
    engine.clear_prefix_cache()
    got = greedy_tokens(engine, [tok.encode(p) for p in GOLDEN_PROMPTS],
                        GOLDEN_NEW)
    want = golden_cpu_tokens(torch, engine.params, tok, ecfg)
    for p, a, b in zip(GOLDEN_PROMPTS, got, want):
        if a != b:
            k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            fail(f"golden [{mode}]: prompt {p!r}: greedy tokens on the card "
                 f"{a} differ from the CPU engine's {b} from token {k}")
    say(f"golden [{mode}]: trained checkpoint via build_services(model_path"
        f"=...) over HTTP: streamed {GOLDEN_NEW} tokens = decode(token_ids) "
        f"{streamed!r}; launches {run['launches']} (int4 by path "
        f"{run['by_path']}) over {run['decode_steps']} decode steps; greedy "
        f"tokens of {len(GOLDEN_PROMPTS)} prompts equal the CPU engine's; "
        f"/v1/score NLL {nll:.4f} over {score['tokens']} tokens "
        f"({time.monotonic() - t0:.1f} s) [{card}]")
    del engine
    torch.cuda.empty_cache()
    return nll


def hf_names(cfg) -> dict:
    """Every tensor of an HF llama checkpoint for ``cfg``: name -> (its
    (out, in) shape, the port's leaf, layer or None, whether the port
    stores it transposed)."""
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.q_dim, cfg.kv_dim
    out = {"model.embed_tokens.weight": ((V, D), "embed", None, False),
           "model.norm.weight": ((D,), "final_norm", None, False),
           "lm_head.weight": ((V, D), "lm_head", None, True)}
    for i in range(cfg.num_layers):
        for rest, shape, leaf in (
                ("input_layernorm", (D,), "attn_norm"),
                ("post_attention_layernorm", (D,), "mlp_norm"),
                ("self_attn.q_proj", (q, D), "wq"),
                ("self_attn.k_proj", (kv, D), "wk"),
                ("self_attn.v_proj", (kv, D), "wv"),
                ("self_attn.o_proj", (D, q), "wo"),
                ("mlp.gate_proj", (F, D), "w_gate"),
                ("mlp.up_proj", (F, D), "w_up"),
                ("mlp.down_proj", (D, F), "w_down")):
            out[f"model.layers.{i}.{rest}.weight"] = (shape, leaf, i,
                                                      len(shape) == 2)
    return out


def check_full_width_load(torch, dev, card: str) -> None:
    """llama-2-7b-chat's geometry (D 4096, F 11008, V 32000, 32 heads, hd
    128), depth cut to 4 layers to bound disk and time, written from seed
    0 as an HF-named fp16 checkpoint in two shards with an index (fp16 as
    llama-2-7b-chat-hf ships), with a config.json and golden-tiny's
    tokenizer.model (the same 32k vocabulary), into a temporary
    directory. ``load_checkpoint`` alone is timed to bf16 on the card
    (the files' pages are in the host's cache from the write just
    before). Then the operator's entry point, ``build_services(
    "llama-2-7b-chat", model_path=DIR)``, which takes the depth from the
    config.json and the tokenizer from the directory: in bf16 every
    tensor of the engine's parameters must equal the same fp16 -> bf16
    cast done in memory, bit for bit, and it serves one greedy request;
    then with ``quantization="int4_awq"`` over an int8 pool (the group
    chosen for the loaded config, the weights quantized on the card as
    they load) it serves one more."""
    import os
    import shutil
    import tempfile
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import (EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models import import_hf
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    from generativeaiexamples_tpu_torch.models.safetensors import \
        save_sharded
    from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul
    from generativeaiexamples_tpu_torch.serving.model_server import (
        awq_group, build_services)

    cfg = replace(LLAMA2_7B, num_layers=4)
    names = hf_names(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    fp16 = {}
    for name, (shape, _, _, _) in names.items():
        t = torch.randn(shape, generator=gen, device=dev)
        if len(shape) == 1:
            t = 1 + 0.1 * t
        else:
            t = t * shape[1] ** -0.5
        fp16[name] = t.to(torch.float16)
    n_bytes = sum(t.numel() * 2 for t in fp16.values())
    ecfg = EngineConfig(max_slots=2, max_input_length=128,
                        max_output_length=32, prefill_buckets=(128,),
                        kv_pool_tokens=None, dtype="bfloat16")

    def one_request(engine) -> tuple:
        with engine:
            s = engine.submit(engine.tokenizer.encode(GOLDEN_PROMPTS[1]),
                              SamplingParams(max_tokens=16, top_k=1,
                                             ignore_eos=True))
            text = s.text()
        if (len(s.token_ids) != 16 or s.finish_reason != "length" or not all(
                0 <= t < cfg.vocab_size for t in s.token_ids)):
            fail(f"full width: the loaded engine gave {s.token_ids} "
                 f"({s.finish_reason})")
        return text

    tmp = tempfile.mkdtemp(prefix="chip_smoke_7b4_")
    try:
        t0 = time.monotonic()
        files = save_sharded(fp16, tmp, shards=2)
        shutil.copy(os.path.join(GOLDEN, "tokenizer.model"), tmp)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"architectures": ["LlamaForCausalLM"],
                       "vocab_size": cfg.vocab_size,
                       "hidden_size": cfg.hidden_size,
                       "intermediate_size": cfg.intermediate_size,
                       "num_hidden_layers": cfg.num_layers,
                       "num_attention_heads": cfg.num_heads,
                       "num_key_value_heads": cfg.num_kv_heads,
                       "max_position_embeddings":
                           cfg.max_position_embeddings,
                       "rms_norm_eps": cfg.rms_norm_eps,
                       "torch_dtype": "float16"}, f)
        write_s = time.monotonic() - t0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params = import_hf.load_checkpoint(tmp, cfg, dtype=torch.bfloat16,
                                           device=dev)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        del params
        t0 = time.monotonic()
        engine, _ = build_services("llama-2-7b-chat", model_path=tmp,
                                   engine_cfg=ecfg, device=dev)
        build_s = time.monotonic() - t0
        if engine.model_cfg != cfg:
            fail(f"full width: build_services made {engine.model_cfg}, not "
                 f"the 4-layer config of the checkpoint's config.json")
        for name, t in fp16.items():
            _, leaf, idx, transposed = names[name]
            got = (engine.params[leaf] if idx is None
                   else engine.params["layers"][leaf][idx])
            want = t.to(torch.bfloat16)
            if transposed:
                want = want.T
            if got.dtype != torch.bfloat16 or not torch.equal(got, want):
                fail(f"full width: loaded {name} is not the fp16 -> bf16 "
                     f"cast of the tensor written")
        del fp16
        text = one_request(engine)
        del engine
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        engine, _ = build_services("llama-2-7b-chat", model_path=tmp,
                                   engine_cfg=replace(ecfg, kv_quant="int8"),
                                   device=dev, quantization="int4_awq")
        build_q_s = time.monotonic() - t0
        int4_matmul.launches_by_path = dict.fromkeys(
            int4_matmul.launches_by_path, 0)
        text_q = one_request(engine)
        by_path = dict(int4_matmul.launches_by_path)
        if not (by_path["tc"] and by_path["wg"]):
            fail(f"full width: the int4_awq engine launched {by_path}")
        del engine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    say(f"full width: llama-2-7b-chat geometry, depth cut to "
        f"{cfg.num_layers} of 32 layers: {n_bytes / 1e9:.3f} GB of fp16 in "
        f"{files} (+ index) written in {write_s:.1f} s; load_checkpoint to "
        f"bf16 on the card {load_s:.2f} s = {n_bytes / 1e9 / load_s:.2f} "
        f"GB/s (file pages cached by the write); build_services(model_path"
        f"=...) in bf16 {build_s:.1f} s (load and engine construction), "
        f"every tensor bit-equal to the fp16 -> bf16 cast in memory, one "
        f"greedy request: 16 tokens {text!r}; with int4_awq (group "
        f"{awq_group(cfg)}) + int8 KV {build_q_s:.1f} s, one greedy "
        f"request: 16 tokens {text_q!r}, int4 launches by path {by_path} "
        f"[{card}]")


def checkpoint_phase(torch, dev, card: str) -> None:
    """(a) golden-tiny's trained weights, bf16 and int4 + int8 KV, through
    the served path; (b) the full-width fp16 checkpoint load."""
    nll_bf16 = check_golden(torch, dev, card)
    nll_q = check_golden(torch, dev, card, quantization="int4",
                         kv_quant="int8")
    say(f"golden: /v1/score NLL of the corpus snippet: bf16 {nll_bf16:.4f}, "
        f"int4 weights + int8 KV {nll_q:.4f} (delta "
        f"{nll_q - nll_bf16:+.4f}) [{card}]")
    check_full_width_load(torch, dev, card)


# ------------------------------------------------------------- RAG phase

RAG_QUESTIONS = ["How does the chain server stream an answer?",
                 "What does the router do when a replica drains?",
                 "How are long prompts admitted beside decoding streams?"]
RAG_NEW = 32
# Rows of the seeded corpus the store's search is timed over.
RAG_BIG_ROWS = 1_000_000
# Card encoder against the CPU: float32 on both, TF32 off; the sums run
# in another order (unit vectors, so an absolute bound).
ENCODER_ATOL = 1e-4


def docs_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs")


def golden_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "golden_tiny")


def upload(base: str, path: str) -> dict:
    """POST one file to the chain server's /uploadDocument (multipart)."""
    import urllib.error
    import urllib.request
    boundary = os.urandom(12).hex()
    with open(path, "rb") as f:
        payload = f.read()
    data = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f" filename=\"{os.path.basename(path)}\"\r\nContent-Type: "
            f"text/markdown\r\n\r\n").encode() + payload + \
        f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(base + "/uploadDocument", data=data, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        fail(f"/uploadDocument of {path} answered {exc.code}: "
             f"{exc.read().decode()[:300]}")


def stream_generate(base: str, body: dict, rid: str) -> tuple:
    """(seconds to the first byte, text) of a streamed /generate."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(base + "/generate",
                                 data=json.dumps(body).encode(), headers={
                                     "Content-Type": "application/json",
                                     "X-Request-ID": rid})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            first = resp.read(1)
            ttfb = time.monotonic() - t0
            text = (first + resp.read()).decode()
    except urllib.error.HTTPError as exc:
        fail(f"/generate answered {exc.code}: {exc.read().decode()[:300]}")
    return ttfb, text


def check_rag_encoder(torch, dev, svc) -> None:
    """The served encoder (e5-large-v2's geometry, float32, random weights
    from seed 0 on the card) cut to its first 2 layers, on the card and on
    the CPU with the same numbers: 8 passages in the 512 bucket and one
    query in the 128 bucket give the same pooled embeddings."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.embed.encoder import EmbeddingService

    cfg2 = replace(svc.cfg, num_layers=2)
    cut = {"embed": svc.params["embed"],
           "layers": {k: v[:2] for k, v in svc.params["layers"].items()}}
    cpu = {g: {k: v.cpu() for k, v in t.items()} for g, t in cut.items()}
    card = EmbeddingService(cut, cfg2, svc.tokenizer)
    host = EmbeddingService(cpu, cfg2, svc.tokenizer)
    names = sorted(os.listdir(docs_dir()))[:8]
    passages = []
    for n in names:
        with open(os.path.join(docs_dir(), n), encoding="utf-8") as f:
            passages.append(f.read()[:1500])
    query = RAG_QUESTIONS[0]
    if (card.pack([f"passage: {p}" for p in passages]).shape != (2, 8, 512)
            or card.pack([f"query: {query}"]).shape != (2, 1, 128)):
        fail("the encoder check's inputs miss the 8 x 512 / 1 x 128 buckets")
    got = {"passages": card.embed_documents(passages),
           "query": card.embed_query(query)}
    want = {"passages": host.embed_documents(passages),
            "query": host.embed_query(query)}
    errs = {k: float(abs(got[k] - want[k]).max()) for k in got}
    ok = all(e <= ENCODER_ATOL for e in errs.values())
    say(f"rag encoder: e5-large-v2 width (D {cfg2.hidden_size}, F "
        f"{cfg2.intermediate_size}, H {cfg2.num_heads}) at 2 layers, card "
        f"vs CPU, float32 with torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}: max abs error passages "
        f"(8 x 512) {errs['passages']:.3g}, query (1 x 128) "
        f"{errs['query']:.3g}, tolerance {ENCODER_ATOL}")
    if not ok:
        fail(f"the card encoder disagrees with the CPU: {errs}")


def check_search_ids(bot, questions) -> None:
    """The chain's search (``DocumentIndex.similarity_search``, behind
    /documentSearch) against the numpy backend on the stored float32
    vectors: equal ids; where they differ, numpy's scores of the
    card's ids must match numpy's own top-k scores position by position
    within the bfloat16 rounding bound of the card's product (2^-8 of
    |q| max|x|: near-ties), and the check says so."""
    import numpy as np

    from generativeaiexamples_tpu_torch.retrieval.exact import ExactStore

    store, index = bot.index.store, bot.index
    k = bot.config.retriever.top_k
    ref = ExactStore(dim=store.dim, backend="numpy")
    ref.add(store._data[:store._n])
    for q in questions:
        vec = np.asarray(index.embedder.embed_query(q), np.float32)
        got = [d.id for d in index.similarity_search(q, k=k)]
        hits = ref.search(vec, k=len(store))[0]
        want = [h.id for h in hits[:k]]
        if got == want:
            say(f"rag search: {q!r}: card ids {got} = numpy's")
            continue
        exact = {h.id: h.score for h in hits}
        bound = 2.0 ** -8 * float(np.linalg.norm(vec)) * float(
            np.linalg.norm(store._data[:store._n], axis=1).max())
        gap = max(abs(exact[a] - exact[b]) for a, b in zip(got, want))
        say(f"rag search: {q!r}: card ids {got}, numpy's {want} (sets "
            f"equal: {set(got) == set(want)}): near-ties, numpy scores "
            f"differ by at most {gap:.3g} position by position, bf16 "
            f"bound {bound:.3g}")
        if len(got) != k or gap > bound:
            fail(f"/documentSearch ids {got} differ from numpy's {want} "
                 f"beyond the bf16 rounding bound")


def rag_search_times(torch, dev, card: str, store, q) -> None:
    """The exact-cuda store's search: host clock through ``search`` over
    the ingested corpus (median of 20), and device time (CUDA events over
    20 calls) of the matmul + top-k over it and over a seeded 1,000,000 x
    1024 bfloat16 corpus, beside the byte bound (the base and the live
    mask read once)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.retrieval.cuda_search import \
        search_scores

    host = []
    for _ in range(20):
        t0 = time.monotonic()
        store.search(q, k=4)
        host.append((time.monotonic() - t0) * 1e3)
    host.sort()
    be = store._cuda
    qd = torch.from_numpy(np.asarray(q, np.float32)[None]).to(dev)

    def device_ms(base, sq, mask):
        for _ in range(3):
            search_scores(base, sq, mask, qd, 4, "ip")
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            search_scores(base, sq, mask, qd, 4, "ip")
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / 20

    n = be.base.shape[0]
    ms = device_ms(be.base, be.sq, be.mask)
    bound = n * (be.base.shape[1] * 2 + 4) / HBM_BYTES_PER_S * 1e3
    say(f"rag search: exact-cuda over the ingested {len(store)} chunks "
        f"({n} padded rows x {be.base.shape[1]}): host clock median "
        f"{host[10]:.3f} ms (range {host[0]:.3f}-{host[-1]:.3f}), device "
        f"{ms:.4f} ms, byte bound {bound:.5f} ms [{card}]")
    N, D = RAG_BIG_ROWS, qd.shape[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    big = torch.randn((N, D), generator=gen, device=dev)
    big /= big.norm(dim=1, keepdim=True)
    sq = torch.ones(N, device=dev)
    base = big.to(torch.bfloat16)
    del big
    mask = torch.ones(N, device=dev)
    ms = device_ms(base, sq, mask)
    bound = N * (D * 2 + 4) / HBM_BYTES_PER_S * 1e3
    say(f"rag search: {N:,} x {D} bf16 corpus (seed 0, "
        f"{base.numel() * 2 / 2 ** 30:.2f} GiB): device {ms:.4f} ms per "
        f"query (matmul + top-4), byte bound {bound:.4f} ms "
        f"({bound / ms:.0%}) [{card}]")
    del base, sq, mask
    torch.cuda.empty_cache()


def rag_stage_times(base: str, mode: str, card: str) -> None:
    """/generate TTFT through the chain server (client's first byte),
    split by the request timeline's stages; median of 3 KB requests."""
    rows = []
    for i in range(3):
        rid = f"rag-ttft-{mode.split()[0]}-{i}"
        ttfb, _ = stream_generate(base, {
            "question": RAG_QUESTIONS[i], "use_knowledge_base": True,
            "num_tokens": 4}, rid)
        _, text = call(base + "/debug/requests?limit=50")
        tl = next((t for t in json.loads(text)["completed"]
                   if t["request_id"] == rid), None)
        if tl is None:
            fail(f"no completed timeline for {rid}")
        st = {e["event"]: e["dur_ms"] for e in tl["events"] if "dur_ms" in e}
        need = ("embedding", "retrieve", "templating", "llm_first_chunk",
                "engine_ttft")
        if any(s not in st for s in need):
            fail(f"the /generate timeline lacks stages: {sorted(st)}")
        rows.append({"ttfb": ttfb * 1e3, **{s: st[s] for s in need}})
    med = {k: sorted(r[k] for r in rows)[1] for k in rows[0]}
    say(f"rag ttft [{mode}]: /generate first byte {med['ttfb']:.1f} ms "
        f"(median of 3); stages: embedding {med['embedding']:.1f}, "
        f"retrieve {med['retrieve']:.1f} (embedding included), templating "
        f"{med['templating']:.2f}, llm_first_chunk "
        f"{med['llm_first_chunk']:.1f}, engine_ttft "
        f"{med['engine_ttft']:.1f} ms [{card}]")
    return med


# The reference's chain derives its fused-RAG spec from the configuration
# (chunk_size + 32 tokens a chunk, a 64-token question bucket, the encoder
# at 128 tokens): the smoke derives it again to check the chain's.
RAG_Q_BUCKET = 64


def expected_fused_spec(cfg, tok, page: int) -> dict:
    """The fields of the fused-RAG spec the chain should derive from the
    reference's defaults, computed here from the template's token counts."""
    probe = cfg.prompts.rag_template.format(context_str="\x00",
                                            query_str="\x01")
    prefix, rest = probe.split("\x00", 1)
    mid, suffix = rest.split("\x01", 1)
    lens = [len(tok.encode(prefix, add_bos=True)),
            len(tok.encode(mid, add_bos=False)),
            len(tok.encode(suffix, add_bos=False))]
    sep = len(tok.encode("\n\n", add_bos=False))
    C, K = cfg.text_splitter.chunk_size + 32, cfg.retriever.top_k
    budget = min(cfg.retriever.max_context_tokens, K * (C + sep))
    bucket = -(-(sum(lens) + RAG_Q_BUCKET + budget) // page) * page
    return {"chunk_tokens": C, "top_k": K, "ctx_budget": budget,
            "bucket": bucket, "q_bucket": RAG_Q_BUCKET, "enc_bucket": 128}


def numpy_assembly(spec, toks: list, rows: list, q_ids: list) -> list:
    """The prompt ids the fused program should assemble for the retrieved
    ``rows`` (the chunks' token lists ``toks``): template prefix, the
    leading chunks that fit the context budget joined by the separator,
    then the template's middle, the question and its suffix, cut to the
    bucket."""
    out, used = list(spec.prefix_ids), 0
    for rank, r in enumerate(rows):
        doc = toks[r][:spec.chunk_tokens]
        if not doc:
            continue
        cost = len(doc) + (len(spec.sep_ids) if rank else 0)
        if used + cost > spec.ctx_budget:
            break
        out += (list(spec.sep_ids) if rank else []) + doc
        used += cost
    out += list(spec.mid_ids) + list(q_ids) + list(spec.suffix_ids)
    return out[:spec.bucket]


def fused_stage_times(base: str, mode: str, card: str) -> dict:
    """Fused /generate TTFT through the chain server (client's first
    byte) and its timeline's stages; median of 3 KB requests."""
    rows = []
    for i in range(3):
        rid = f"rag-fused-ttft-{mode.split()[0]}-{i}"
        ttfb, _ = stream_generate(base, {
            "question": RAG_QUESTIONS[i], "use_knowledge_base": True,
            "num_tokens": 4}, rid)
        _, text = call(base + "/debug/requests?limit=50")
        tl = next((t for t in json.loads(text)["completed"]
                   if t["request_id"] == rid), None)
        if tl is None:
            fail(f"no completed timeline for {rid}")
        st = {e["event"]: e["dur_ms"] for e in tl["events"] if "dur_ms" in e}
        need = ("llm_first_chunk", "engine_ttft", "engine_admit_dispatch")
        if any(s not in st for s in need) or "retrieve" in st:
            fail(f"the fused /generate timeline has stages {sorted(st)}")
        rows.append({"ttfb": ttfb * 1e3, **{s: st[s] for s in need}})
    return {k: sorted(r[k] for r in rows)[1] for k in rows[0]}


def fused_replay_ms(torch, engine, q_enc, q_llm, q_len) -> tuple:
    """Device milliseconds of the captured greedy fused admission (CUDA
    events over 5 replays after one, on the staged inputs of the last
    fused request, the engine stopped and idle; the replays re-arm that
    request's retired slot, which is then deactivated) and of its
    retrieval and assembly alone, captured by themselves (``time_cuda``)."""
    if engine._slots:
        fail("the fused replay needs an idle engine")
    prog = engine._rag_graphs[(True,)]
    prog.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        prog.replay()
    b.record()
    torch.cuda.synchronize()
    engine._state["active"].fill_(False)
    fused = engine._fused_rag
    alone = time_cuda(torch, lambda: fused.assemble(q_enc, q_llm, q_len), 5)
    return a.elapsed_time(b) / 5, alone


# Scores of unit vectors in float32 over D dimensions: two orders of
# summation differ by at most ~D ulps of 1.
def f32_tie(D: int) -> float:
    return D * 2.0 ** -23


def serve_rag_fused(torch, dev, card: str, engine, svc, index, cfg,
                    upload_dir: str, mode: str, quantization: str,
                    host: dict) -> dict:
    """The chatbot's default path, fused RAG, on ``engine`` over the
    ingested ``index``: a ``QAChatbot`` with the default ``fused_rag``
    mirrors the corpus onto the engine (``_sync_fused_corpus``, what each
    ingest runs: one fused program per greedy captured over a
    1024-row corpus) and must be ready, with the spec the reference's
    defaults give; greedy /generate questions with the knowledge base
    through its chain server (launch counts set to 0 just before and read
    just after, by the serve phases' formula; each request a fused
    admission); then each question through ``submit_rag`` on this engine
    and on an eager one (``cuda_graphs=False``): equal tokens, rows and
    assembled lengths, and the /generate text; the rows equal a numpy
    float32 top-k over the exported corpus vectors for the service's
    query vector (near-ties within float32 rounding named); the length
    read back is a numpy assembly's of those rows; the eager engine's
    plain greedy tokens for those assembled ids (``Engine.submit``, at
    the fused bucket) equal the fused ones. Prints the fused /generate
    TTFT beside the host path's (``host``) and the fused admission's
    replay time. Returns the launch counts."""
    from dataclasses import replace

    import numpy as np

    from generativeaiexamples_tpu_torch.chains.examples.developer_rag \
        import QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.chains.server import create_app
    from generativeaiexamples_tpu_torch.engine import Engine, SamplingParams

    tok = engine.tokenizer
    fbot = QAChatbot(llm=EngineLLM(engine), embedder=svc, index=index,
                     config=cfg)
    t0 = time.monotonic()
    fbot._sync_fused_corpus()
    sync_s = time.monotonic() - t0
    spec = fbot._fused_spec
    want = expected_fused_spec(cfg, tok, engine.cfg.page_size)
    if not fbot._fused_ready or spec is None:
        fail(f"[{mode}] fused RAG did not turn on (see the log above)")
    if {k: getattr(spec, k) for k in want} != want:
        fail(f"[{mode}] the chain's fused spec {spec} is not {want}")
    fused = engine._fused_rag
    if (set(engine._rag_graphs) != {(True,), (False,)}
            or fused.capacity != 1024 or engine.fused_rag_spec != spec):
        fail(f"[{mode}] fused programs {sorted(engine._rag_graphs)} over "
             f"{fused.capacity} rows")
    ids, vecs, texts = index.export_corpus()
    say(f"rag fused [{mode}]: spec bucket {spec.bucket}, C "
        f"{spec.chunk_tokens}, top-{spec.top_k}, budget {spec.ctx_budget}, "
        f"template {len(spec.prefix_ids)}+{len(spec.mid_ids)}+"
        f"{len(spec.suffix_ids)} tokens; corpus {len(ids)} rows in "
        f"{fused.capacity}; sync (tokenize, upload, capture 2 programs) "
        f"{sync_s:.2f} s, captured programs added "
        f"{engine.rag_graph_bytes / 2 ** 20:.1f} MiB reserved [{card}]")
    fbase, stop_chain = serve_app(create_app(fbot, upload_dir))
    try:
        stream_generate(fbase, {"question": "warm up", "num_tokens": 2},
                        "rag-fused-warm")
        torch.cuda.synchronize()
        stats0 = engine.stats
        zero_launch_counts()
        texts_g, sources = [], []
        for i, q in enumerate(RAG_QUESTIONS):
            texts_g.append(stream_generate(fbase, {
                "question": q, "use_knowledge_base": True,
                "num_tokens": RAG_NEW}, f"rag-fused-{i}")[1])
            sources.append(fbot.last_sources)
        torch.cuda.synchronize()
        run = read_launch_counts(engine, stats0)
        check_launch_counts(f"[{mode}] rag fused", run,
                            engine.model_cfg.num_layers, quantization,
                            engine.cfg.kv_quant, head_tiles(engine))
        moved = engine.stats["rag_admissions"] - stats0["rag_admissions"]
        if moved != len(RAG_QUESTIONS) or run["prefills"] != moved:
            fail(f"[{mode}] {moved} fused admissions for "
                 f"{len(RAG_QUESTIONS)} /generate requests")
        say(f"rag fused [{mode}]: launches {run['launches']} (int4 by path "
            f"{run['by_path']}) over {run['decode_steps']} decode steps and "
            f"{moved} fused admissions")
        names = set(index.sources())
        for q, src in zip(RAG_QUESTIONS, sources):
            if len(src) != spec.top_k or not {s["source"] for s in src} \
                    <= names:
                fail(f"[{mode}] last_sources for {q!r}: {src}")
        med = fused_stage_times(fbase, mode, card)
    finally:
        stop_chain()
        engine.stop()
    say(f"rag fused ttft [{mode}]: /generate first byte {med['ttfb']:.1f} "
        f"ms (host path {host['ttfb']:.1f}), engine_ttft "
        f"{med['engine_ttft']:.1f} ms (host path {host['engine_ttft']:.1f}),"
        f" llm_first_chunk {med['llm_first_chunk']:.1f} (host path "
        f"{host['llm_first_chunk']:.1f}), admission dispatch on the host "
        f"{med['engine_admit_dispatch']:.2f} ms; median of 3 [{card}]")

    # The same questions straight through the engines, captured and eager.
    # The eager engine prefills a plain prompt as the fused program does:
    # one-shot (its budget pinned high), in the fused bucket, and cold (no
    # prefix cache: questions that retrieve the same first chunk share a
    # block, and a hit prefills its rest in a chunk that rounds
    # differently).
    eager = Engine(engine.params, engine.model_cfg, tok, replace(
        engine.cfg, cuda_graphs=False, prefill_buckets=(spec.bucket,),
        kv_pool_tokens=2 * (engine.cfg.max_cache_len + 128),
        sched_round_budget_tokens=4096, prefix_cache=False), device=dev)
    eager.enable_fused_rag(svc.params, svc.cfg, spec)
    toks = [tok.encode(t, add_bos=False)[:spec.chunk_tokens] for t in texts]
    toks_c = np.zeros((len(toks), spec.chunk_tokens), np.int32)
    lens_c = np.array([len(t) for t in toks], np.int32)
    for i, t in enumerate(toks):
        toks_c[i, :len(t)] = t
    eager.set_rag_corpus(vecs, toks_c, lens_c)
    sp = SamplingParams(max_tokens=RAG_NEW, top_k=1,
                        stop_words=["</s>", "[INST]"])
    enc_tok, D = svc.tokenizer, vecs.shape[1]
    ties = []
    engine.start()
    eager.start()
    for q, text in zip(RAG_QUESTIONS, texts_g):
        q_ids = tok.encode(q, add_bos=False)
        enc_ids = enc_tok.encode(f"query: {q}")
        got = {}
        for name, e in (("captured", engine), ("eager", eager)):
            st = e.submit_rag(q_ids, enc_ids, sp)
            got[name] = (st.text(), st.token_ids, st.source_ids,
                         st.rag_length)
        if got["captured"] != got["eager"]:
            fail(f"[{mode}] {q!r}: captured fused admission gave "
                 f"{got['captured'][1:]}, eager {got['eager'][1:]}")
        text_c, tokens, rows, length = got["captured"]
        if text_c != text:
            fail(f"[{mode}] {q!r}: /generate streamed {text!r}, submit_rag "
                 f"{text_c!r}")
        qvec = np.asarray(svc.embed_query(q), np.float32)
        scores = vecs @ qvec
        order = [int(i) for i in np.argsort(-scores, kind="stable")]
        want_rows = order[:spec.top_k]
        for a_, b_ in zip(rows, want_rows):
            if a_ != b_:
                gap = abs(float(scores[a_]) - float(scores[b_]))
                if gap > f32_tie(D):
                    fail(f"[{mode}] {q!r}: on-card rows {rows}, numpy's "
                         f"{want_rows} (score gap {gap:.3g} > "
                         f"{f32_tie(D):.3g})")
                ties.append((q, a_, b_, gap))
        prompt = numpy_assembly(spec, toks, rows, q_ids)
        if length != len(prompt):
            fail(f"[{mode}] {q!r}: assembled length {length}, numpy's "
                 f"{len(prompt)}")
        plain = eager.submit(prompt, sp)
        plain.text()
        if plain.token_ids != tokens:
            a_, b_ = tokens, plain.token_ids
            k = next((j for j, (x, y) in enumerate(zip(a_, b_)) if x != y),
                     min(len(a_), len(b_)))
            gap = top2_gap(torch, engine, prompt + a_[:k])
            fail(f"[{mode}] {q!r}: fused token {k} differs from the plain "
                 f"engine's for the assembled {len(prompt)} ids: {a_} vs "
                 f"{b_} (top-2 logit gap there {gap})")
        say(f"rag fused [{mode}]: {q!r}: rows {rows} = numpy's top-"
            f"{spec.top_k}{' (near-ties named below)' if ties else ''}; "
            f"assembled {length} tokens = numpy's; captured = eager = "
            f"plain engine on those ids ({len(tokens)} tokens), = /generate")
    for q, a_, b_, gap in ties:
        say(f"rag fused [{mode}]: near-tie for {q!r}: rows {a_} and {b_} "
            f"score within {gap:.3g} (float32 bound {f32_tie(D):.3g})")
    eager.stop()
    engine.stop()
    del eager
    # The fused admission's device time on the captured program.
    x = engine._rag_in[1]
    Se, Sq = spec.enc_bucket, spec.q_bucket
    total, alone = fused_replay_ms(torch, engine, x[:2 * Se].view(2, Se),
                                   x[2 * Se:2 * Se + Sq], x[-1:])
    say(f"rag fused [{mode}]: the fused admission replays in {total:.3f} ms "
        f"device (bucket {spec.bucket}: embed, top-{spec.top_k} over "
        f"{fused.capacity} rows, assembly, prefill, insert), retrieval and "
        f"assembly alone {alone:.3f} ms [{card}]")
    torch.cuda.empty_cache()
    return run


def serve_rag(torch, dev, card: str, served: list) -> dict:
    """The RAG chatbot's main path on the card: the e5-large-v2 embedder
    (float32, seed 0, byte tokenizer; checked against the CPU at 2
    layers), an ``exact-cuda`` store and the port's chain server over a
    3000-token engine of each served mode's weights (``served``: (engine,
    quantization) pairs) with golden-tiny's 32,000-piece vocabulary.
    Ingests every ``docs/*.md`` through
    /uploadDocument (once: both modes search the same store), checks
    /documentSearch against the numpy backend, streams greedy /generate
    questions with the knowledge base (launch counts set to 0 just before
    and read just after, by the serve phases' formula), holds each text
    to the engine's greedy text for the prompt the chain assembled and
    the degraded counter at 0; in the bf16 mode also one /generate
    through ``OpenAICompatLLM`` against the model server and one
    /v1/embeddings. Prints the ingest, embed, search and TTFT times.
    Returns the launch counts by mode."""
    import shutil
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.chains.examples.developer_rag \
        import QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import (EngineLLM,
                                                           OpenAICompatLLM)
    from generativeaiexamples_tpu_torch.chains.server import create_app
    from generativeaiexamples_tpu_torch.embed.encoder import get_embedder
    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.obs import metrics as obs_metrics
    from generativeaiexamples_tpu_torch.retrieval.docstore import Document
    from generativeaiexamples_tpu_torch.serving.model_server import \
        create_server_app
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    svc = get_embedder("torch-cuda", "e5-large-v2", device=dev)
    torch.cuda.synchronize()
    say(f"rag: e5-large-v2 embedder (24 layers, float32, seed 0) built on "
        f"the card in {time.monotonic() - t0:.1f} s")
    check_rag_encoder(torch, dev, svc)
    cfg = from_dict(AppConfig, {"vector_store": {"name": "exact-cuda"}})
    if (cfg.text_splitter.chunk_size, cfg.text_splitter.chunk_overlap,
            cfg.retriever.top_k, cfg.retriever.max_context_tokens) != (
            510, 200, 4, 1500):
        fail("the chatbot's defaults are not the reference's")
    upload_dir = tempfile.mkdtemp(prefix="chip_smoke_rag_")
    # The engines read and write text with a 32,000-piece sentencepiece
    # vocabulary (golden-tiny's, llama-2's size), so the random weights'
    # tokens stream as visible text; the byte tokenizer would drop every
    # id past 258.
    tok = get_tokenizer(golden_dir())
    index, out = None, {}
    for engine0, quantization in served:
        mode = f"{quantization or 'bf16'} weights, " \
               f"{engine0.cfg.kv_quant or 'bf16'} KV"
        ecfg = EngineConfig(max_slots=8, max_input_length=3000,
                            max_output_length=320, page_size=128,
                            kv_pool_tokens=8 * (3072 + 320),
                            dtype="bfloat16", kv_quant=engine0.cfg.kv_quant)
        if tok.vocab_size != engine0.model_cfg.vocab_size:
            fail(f"the RAG tokenizer has {tok.vocab_size} pieces, the model "
                 f"{engine0.model_cfg.vocab_size}")
        t0 = time.monotonic()
        engine = Engine(engine0.params, engine0.model_cfg, tok, ecfg,
                        device=dev)
        say(f"rag [{mode}]: 3000-token engine built in "
            f"{time.monotonic() - t0:.1f} s")
        bot = QAChatbot(llm=EngineLLM(engine), embedder=svc, index=index,
                        config=cfg, fused_rag=False)
        base, stop_chain = serve_app(create_app(bot, upload_dir))
        try:
            if index is None:
                index = bot.index
                names = sorted(n for n in os.listdir(docs_dir())
                               if n.endswith(".md"))
                size = sum(os.path.getsize(os.path.join(docs_dir(), n))
                           for n in names)
                t0 = time.monotonic()
                for n in names:
                    upload(base, os.path.join(docs_dir(), n))
                ingest_s = time.monotonic() - t0
                if len(names) != 18 or len(index.sources()) != 18:
                    fail(f"ingested {index.sources()} of {names}")
                say(f"rag ingest: {len(names)} docs ({size} bytes) -> "
                    f"{len(index)} chunks in {ingest_s:.2f} s "
                    f"({len(index) / ingest_s:.1f} chunks/s) through "
                    f"/uploadDocument [{card}]")
                check_search_ids(bot, RAG_QUESTIONS)
                times = []
                for _ in range(20):
                    t1 = time.monotonic()
                    svc.embed_query(RAG_QUESTIONS[0])
                    times.append((time.monotonic() - t1) * 1e3)
                times.sort()
                ds = []
                for _ in range(5):
                    t1 = time.monotonic()
                    call(base + "/documentSearch",
                         {"content": RAG_QUESTIONS[0], "num_docs": 4})
                    ds.append((time.monotonic() - t1) * 1e3)
                ds.sort()
                say(f"rag: query embed (1 x 128, 24 layers) median "
                    f"{times[10]:.2f} ms (range {times[0]:.2f}-"
                    f"{times[-1]:.2f}, 20 calls); /documentSearch median "
                    f"{ds[2]:.2f} ms (5 calls) [{card}]")
                rag_search_times(torch, dev, card, index.store,
                                 svc.embed_query(RAG_QUESTIONS[0]))
            # Warm-up (first-use costs), then a cold prefix cache.
            stream_generate(base, {"question": "warm up",
                                   "num_tokens": 2}, "rag-warm")
            engine.stop()
            engine.clear_prefix_cache()
            key0 = {k: v for k, v in obs_metrics.REGISTRY.snapshot().items()
                    if k.startswith("degraded_total")}
            torch.cuda.synchronize()
            stats0 = engine.stats
            zero_launch_counts()
            texts = [stream_generate(base, {
                "question": q, "use_knowledge_base": True,
                "num_tokens": RAG_NEW}, f"rag-{i}")[1]
                for i, q in enumerate(RAG_QUESTIONS)]
            torch.cuda.synchronize()
            run = read_launch_counts(engine, stats0)
            check_launch_counts(f"[{mode}] rag", run,
                                engine.model_cfg.num_layers, quantization,
                                ecfg.kv_quant, head_tiles(engine))
            key1 = {k: v for k, v in obs_metrics.REGISTRY.snapshot().items()
                    if k.startswith("degraded_total")}
            if key1 != key0 or any(t.startswith("[notice]") for t in texts):
                fail(f"[{mode}] a /generate answer was degraded: {key1}")
            prompts = []
            for q in RAG_QUESTIONS:
                _, text = call(base + "/documentSearch",
                               {"content": q, "num_docs": 4})
                docs = [Document(text=h["content"]) for h in json.loads(text)]
                prompts.append(bot.rag_prompt(docs, q))
            engine.stop()
            engine.clear_prefix_cache()
            for q, prompt, text in zip(RAG_QUESTIONS, prompts, texts):
                want = engine.generate_text(prompt, SamplingParams(
                    max_tokens=RAG_NEW, top_k=1,
                    stop_words=["</s>", "[INST]"]))
                n_prompt = len(engine.tokenizer.encode(prompt))
                if text != want:
                    fail(f"[{mode}] /generate streamed {text!r}; the engine's"
                         f" greedy text for the chain's prompt is {want!r}")
                say(f"rag [{mode}]: {q!r}: {n_prompt}-token prompt, "
                    f"/generate = the engine's greedy text ({len(text)} "
                    f"chars)")
            say(f"rag [{mode}]: launches {run['launches']} (int4 by path "
                f"{run['by_path']}) over {run['decode_steps']} decode steps,"
                f" {run['prefills']} admissions and "
                f"{run['prefill_dispatches']} prefill programs")
            host = rag_stage_times(base, mode, card)
            fused_run = serve_rag_fused(torch, dev, card, engine, svc,
                                        index, cfg, upload_dir, mode,
                                        quantization, host)
            if not quantization:
                engine.stop()
                engine.clear_prefix_cache()
                mbase, stop_model = serve_app(create_server_app(
                    engine, svc, model_name="llama-2-7b-chat"))
                remote = QAChatbot(llm=OpenAICompatLLM(mbase), embedder=svc,
                                   index=index, config=cfg, fused_rag=False)
                rbase, stop_remote = serve_app(create_app(remote,
                                                          upload_dir))
                try:
                    _, text = stream_generate(rbase, {
                        "question": RAG_QUESTIONS[0],
                        "use_knowledge_base": True,
                        "num_tokens": RAG_NEW}, "rag-remote")
                    _, emb = call(mbase + "/v1/embeddings", {
                        "input": [RAG_QUESTIONS[0]],
                        "input_type": "passage"})
                finally:
                    stop_remote()
                    stop_model()
                if text != texts[0]:
                    fail(f"/generate through OpenAICompatLLM gave {text!r}, "
                         f"in process {texts[0]!r}")
                vec = np.array(json.loads(emb)["data"][0]["embedding"])
                err = float(abs(vec - svc.embed_documents(
                    [RAG_QUESTIONS[0]])[0]).max())
                if vec.shape != (svc.dim,) or err > 1e-5:
                    fail(f"/v1/embeddings: shape {vec.shape}, error {err}")
                say(f"rag [{mode}]: /generate through OpenAICompatLLM "
                    f"against the model server's /v1/completions = the "
                    f"in-process text; /v1/embeddings {svc.dim}-d within "
                    f"{err:.2g} of the service")
        finally:
            stop_chain()
            engine.stop()
        out[quantization] = {key: {k: n + fused_run[key][k]
                                   for k, n in run[key].items()}
                             for key in ("launches", "by_path")}
        del engine, bot
        torch.cuda.empty_cache()
    shutil.rmtree(upload_dir, ignore_errors=True)
    return out


# The fleet phase (``serve_fleet``): three replicas of llama-2-7b-chat at
# full width and depth (int4-AWQ weights shared, each engine its own int8
# pool and host tier) behind the port's router over loopback HTTP.
FLEET_NEW = 32
FLEET_CONTEXT = 1850          # codepoint tokens of a long context
FLEET_DELAY = "engine.dispatch=delay:0.1"   # stretches a stream past a kill


class CodepointTokenizer:
    """Token ``i`` is the character ``chr(BASE + i)``, so every id sequence
    the random weights emit round-trips through its text: the router's
    failover replays the streamed text, and the byte tokenizer would drop
    every id past 258. Text below ``BASE`` (the chat template, questions)
    encodes as UTF-8 bytes (ids 3..258, as the byte tokenizer)."""

    pad_id, bos_id, eos_id = 0, 1, 2
    BASE = 0x20000

    def __init__(self, vocab_size: int):
        self._vocab = int(vocab_size)

    @property
    def vocab_size(self) -> int:
        return self._vocab

    def encode(self, text: str, *, add_bos: bool = True) -> list:
        ids = []
        for ch in text:
            o = ord(ch)
            if o >= self.BASE:
                ids.append(o - self.BASE)
            else:
                ids.extend(b + 3 for b in ch.encode("utf-8"))
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids) -> str:
        return "".join(chr(self.BASE + int(i)) for i in ids)

    def piece_id(self, piece: str):
        ids = self.encode(piece, add_bos=False)
        return ids[0] if len(ids) == 1 else None


def fleet_text(tag: str, n: int) -> str:
    """``n`` codepoint tokens from a seed named by ``tag``: a long context
    that streams as 4-byte UTF-8 characters, one token each."""
    import hashlib

    import numpy as np
    seed = int.from_bytes(hashlib.blake2b(tag.encode(),
                                          digest_size=4).digest(), "little")
    ids = np.random.default_rng(seed).integers(3, 32000, n)
    return "".join(chr(CodepointTokenizer.BASE + int(i)) for i in ids)


def fleet_call(url: str, body=None, headers=None, timeout: float = 300,
               read: int = 0):
    """(status, headers, body bytes) of a POST of ``body`` as UTF-8 JSON
    (a GET when None). ``read`` > 0 returns the open response after that
    many bytes instead (the caller reads the rest)."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(
        body, ensure_ascii=False).encode("utf-8")
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()
    if read:
        return resp.status, dict(resp.headers), (resp, resp.read(read))
    with resp:
        return resp.status, dict(resp.headers), resp.read()


def fleet_generate(url: str, body: dict, rid: str,
                   headers=None) -> tuple:
    """(headers, text, seconds to the first byte) of a streamed /generate
    that must answer 200 with no error frame."""
    t0 = time.monotonic()
    status, hdrs, (resp, first) = fleet_call(
        url + "/generate", body, {"X-Request-ID": rid, **(headers or {})},
        read=1)
    ttfb = time.monotonic() - t0
    with resp:
        text = (first + resp.read()).decode("utf-8")
    if status != 200 or "[error]" in text or "event: error" in text:
        fail(f"fleet: /generate {rid} on {url} answered {status}: "
             f"{text[:300]!r}")
    return hdrs, text, ttfb


def timeline_of(recorder, rid: str, timeout: float = 10.0) -> dict:
    """The completed timeline of ``rid`` in a flight recorder (a stream's
    last byte may reach the client just before its timeline completes)."""
    deadline = time.monotonic() + timeout
    while True:
        for tl in recorder.snapshot(limit=1000)["completed"]:
            if tl["request_id"] == rid:
                return tl
        if time.monotonic() > deadline:
            fail(f"fleet: no completed timeline {rid!r}")
        time.sleep(0.01)


def stage_ms(tl: dict, name: str) -> float:
    """The summed duration of a timeline's ``name`` stages."""
    return sum(e.get("dur_ms", 0.0) for e in tl["events"]
               if e["event"] == name)


def serve_fleet(torch, dev, card: str, served) -> dict:
    """The fleet tier on the card: three engines of llama-2-7b-chat at full
    width and depth on the served int4-AWQ weights (one set of weight
    tensors; each engine its own int8 pool, explicit size, and host tier),
    r0 and r1 ``unified`` and r2 ``prefill``, each behind the port's chain
    server, the port's router in front, all over loopback HTTP. Launch
    counts are set to 0 just before the checks and read just after; they
    hold to the serve phases' formula over the three engines' work
    together and join the int4 mode's in the kernels line. Checks:

    1. Handoff: a ~2100-token ``/generate`` (no knowledge base, > 4096
       bytes) through the router takes the two-leg handoff (a handoff in
       the counters, no fallback, no price-out); r2 exported pages; the
       decode target admitted a prefix hit (restored pages; computed at
       most one page plus the tail); its text equals, token for token,
       the other unified replica's for the same request with the prefix
       held locally (served cold, then again), and the cold text up to a
       near-tie (a parting top-2 logit gap under ``SPEC_TIE``).
    2. Pages: the decode target's pool pages of the chain equal r2's bit
       for bit.
    3. Pull: a prefill leg whose push misses (a dead target), then
       ``X-KV-Transfer-From`` on the decode replica pulls the pages over
       ``/control/kv_pages``; router-driven (``ROUTER_KV_TRANSFER=1``, a
       second router over r0 and r1): a prompt placed on one replica,
       that replica drained, the same prompt lands on the other with a
       donor hint and pulls. Transfer pages > 0, text = the locally warm
       text.
    4. Affinity: a two-turn conversation's second turn lands on the
       first turn's replica (the router's placement and affinity-hit
       counters, the place event's matched blocks, the engine's prefix
       hits).
    5. Failover: the serving replica's site stops mid-stream; the router
       replays the transcript on the sibling (``router_resume_total``
       ok) and the stitched text equals an uninterrupted run up to a
       near-tie.
    6. Drain: r1 drained with a stream in flight takes no new placement
       and its stream completes.
    7. Launches: over a lone prefill leg only #3 "wg" and the admission's
       lm_head row on "tc" move (r2); over a lone decode on a decode
       replica, #2 and #3 "tc" (and "wg" for its tail chunk).

    Prints each handoff leg's time (prefill, export = gather + serialize,
    the blob's MB, push = wire + import, import alone, restore), the
    decode TTFT after a handoff against the unified cold TTFT on the same
    prompt, ``handoff_beats_prefill``'s answer and inputs against the
    measured legs, and the router's overhead (router-observed first byte
    minus the replica's) over 8 requests. Returns the launch counts."""
    import statistics
    import tempfile
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.chains.examples.developer_rag \
        import QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.chains.server import create_app
    from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.engine import kv_tier
    from generativeaiexamples_tpu_torch.obs import flight as obs_flight
    from generativeaiexamples_tpu_torch.obs import metrics as obs_metrics
    from generativeaiexamples_tpu_torch.router.server import (
        ROUTER, create_router_app)
    from generativeaiexamples_tpu_torch.router.table import \
        handoff_beats_prefill
    from generativeaiexamples_tpu_torch.utils import faults
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict

    mode = "int4_awq weights, int8 KV"
    # Earlier phases' engines (the RAG phase's 3000-token pools) go back
    # to the card first: a reference cycle would otherwise hold them.
    free_memory(torch)
    mcfg = served.model_cfg
    tok = CodepointTokenizer(mcfg.vocab_size)
    page = 128
    # A blob of a 2000-token prefix is ~0.5 GB: the fetch and the push
    # get a bound that fits it (a deployment setting, read at build).
    env0 = {k: os.environ.get(k) for k in ("KV_TRANSFER_TIMEOUT_S",
                                           "ROUTER_KV_TRANSFER")}
    os.environ["KV_TRANSFER_TIMEOUT_S"] = "60"
    base_cfg = EngineConfig(
        max_slots=4, max_input_length=2304, max_output_length=64,
        prefill_buckets=(128, 512), page_size=page,
        kv_pool_tokens=4 * (2304 + 128), kv_host_pool_tokens=6144,
        dtype="bfloat16", kv_quant="int8", sched_round_budget_tokens=2048)
    # The engines share the served weight tensors: each holds the same
    # objects, and no engine writes them (a tensor's version counter
    # moves on every in-place write).
    weights0 = weight_marks(served.params)
    t0 = time.monotonic()
    engines = {}
    for name, role in (("r0", "unified"), ("r1", "unified"),
                       ("r2", "prefill")):
        engines[name] = Engine(served.params, mcfg, tok,
                               replace(base_cfg, role=role), device=dev)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    for name, e in engines.items():
        if e.params is not served.params \
                or weight_marks(e.params) != weights0:
            fail(f"fleet: engine {name} copied or wrote the served "
                 f"weights")
    say(f"fleet [{mode}]: r0/r1 unified, r2 prefill, one set of weights, "
        f"{engines['r0'].stats['pool_pages']} pool pages and a "
        f"{base_cfg.kv_host_pool_tokens}-token host tier each, built in "
        f"{build_s:.1f} s")
    cfg = from_dict(AppConfig, {"embeddings": {"model_engine": "hash",
                                               "dimensions": 32}})
    upload_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    urls, stops = {}, {}
    for name, e in engines.items():
        bot = QAChatbot(llm=EngineLLM(e), embedder=HashEmbedder(dim=32),
                        config=cfg, fused_rag=False)
        urls[name], stops[name] = serve_app(create_app(bot, upload_dir,
                                                       config=cfg),
                                            grace=0.2)
    router_app = create_router_app(
        [(n, urls[n]) for n in ("r0", "r1", "r2")], policy="affinity",
        heartbeat_s=1.0, run_heartbeat=True)
    router = router_app[ROUTER]
    rurl, stop_router = serve_app(router_app)
    stop_router2 = None
    killed = set()

    def snap(name: str) -> float:
        return obs_metrics.REGISTRY.snapshot().get(name, 0.0)

    def heartbeat(url: str = rurl) -> None:
        fleet_call(url + "/control/heartbeat", {})

    def body_of(tag: str, n_ctx: int = FLEET_CONTEXT,
                new: int = FLEET_NEW) -> dict:
        return {"question": f"What does passage {tag} describe?",
                "context": fleet_text(tag, n_ctx),
                "use_knowledge_base": False, "num_tokens": new}

    def ids_of(body: dict) -> list:
        return tok.encode(cfg.prompts.chat_template.format(
            context_str=body["context"], query_str=body["question"]))

    def warm_mirror(name: str, body: dict, tag: str) -> tuple:
        """The text of ``body`` on replica ``name`` cold, then again with
        its prompt pages held there (a prefix hit), and the cold TTFB."""
        _, cold, ttfb = fleet_generate(urls[name], body, f"{tag}-cold")
        _, warm, _ = fleet_generate(urls[name], body, f"{tag}-warm")
        return cold, warm, ttfb

    def parting(body: dict, a: str, b: str):
        """None when the texts are equal; else (token, top-2 gap of the
        served weights' logits there)."""
        ids = ids_of(body)
        return first_parting(torch, served, ids,
                             tok.encode(a, add_bos=False),
                             tok.encode(b, add_bos=False))

    deferred = []   # near-tie checks, run after the counted window
    try:
        for name in ("r0", "r1"):
            fleet_generate(urls[name], {"question": "warm up",
                                        "use_knowledge_base": False,
                                        "num_tokens": 2}, f"fleet-warm-{name}")
        status, _, raw = fleet_call(urls["r2"] + "/control/prefill",
                                    {"question": "warm up"})
        if status != 200:
            fail(f"fleet: r2's warm-up prefill leg answered {status}: {raw}")
        # The warm-ups leave the chat template's first page cached on every
        # replica (r2 also in its host tier, from the export): each long
        # prompt below is a one-page hit and one chunk on any replica, so
        # replicas compute the same pages for the same prompt.
        for e in engines.values():
            wait_idle(e)
        heartbeat()
        roles = {r["name"]: r["role"] for r in json.loads(
            fleet_call(rurl + "/router/replicas")[2])["replicas"]}
        if roles != {"r0": "unified", "r1": "unified", "r2": "prefill"}:
            fail(f"fleet: the router sees roles {roles}")
        torch.cuda.synchronize()
        stats0 = {n: e.stats for n, e in engines.items()}
        zero_launch_counts()

        # 1-2. The handoff through the router.
        body_a = body_of("A")
        raw_len = len(json.dumps(body_a, ensure_ascii=False).encode())
        h0 = snap("router_disagg_handoffs_total")
        fb0 = {k: v for k, v in obs_metrics.REGISTRY.snapshot().items()
               if k.startswith("router_disagg_fallbacks_total")}
        ids_a = ids_of(body_a)
        n_pages = len(ids_a) // page
        held = {n: len(pool_pages_of(engines[n], ids_a)) for n in ("r0", "r1")}
        before = {n: e.stats for n, e in engines.items()}
        hdrs, text_a, ttfb_a = fleet_generate(rurl, body_a, "fleet-handoff")
        dec = hdrs.get("X-Routed-Replica")
        if dec not in ("r0", "r1"):
            fail(f"fleet: the handoff's decode leg ran on {dec!r}")
        uni = "r1" if dec == "r0" else "r0"
        fb1 = {k: v for k, v in obs_metrics.REGISTRY.snapshot().items()
               if k.startswith("router_disagg_fallbacks_total")}
        if snap("router_disagg_handoffs_total") != h0 + 1 or fb1 != fb0:
            fail(f"fleet: no completed handoff (handoffs "
                 f"{snap('router_disagg_handoffs_total') - h0}, fallbacks "
                 f"{fb0} -> {fb1}): a price-out or a fallback")
        d_after, p_after = engines[dec].stats, engines["r2"].stats
        exported = (p_after["kv_tier_export_pages"]
                    - before["r2"]["kv_tier_export_pages"])
        restored = (d_after["kv_tier_restore_pages"]
                    - before[dec]["kv_tier_restore_pages"])
        computed = (d_after["sched_prefill_tokens"]
                    - before[dec]["sched_prefill_tokens"])
        hit = (d_after["prefix_cache_hit_tokens"]
               - before[dec]["prefix_cache_hit_tokens"])
        if (exported != n_pages or restored != n_pages - held[dec]
                or restored <= 0 or hit != n_pages * page):
            fail(f"fleet: r2 exported {exported} pages of the {n_pages} the "
                 f"prompt fills; {dec} held {held[dec]}, restored "
                 f"{restored}, reused {hit} tokens")
        if computed > len(ids_a) - (n_pages - 1) * page:
            fail(f"fleet: {dec} computed {computed} of {len(ids_a)} prompt "
                 f"tokens after the handoff: not a prefix hit")
        got_pages, want_pages = (pool_pages_of(engines[dec], ids_a),
                                 pool_pages_of(engines["r2"], ids_a))
        if len(got_pages) != n_pages or set(got_pages) != set(want_pages):
            fail(f"fleet: {dec} holds {len(got_pages)} pages of the chain, "
                 f"r2 {len(want_pages)}")
        for h, leaves in got_pages.items():
            for leaf, t in leaves.items():
                if not torch.equal(t, want_pages[h][leaf]):
                    fail(f"fleet: {dec}'s page {leaf} of the chain differs "
                         f"from r2's")
        del got_pages, want_pages
        rtl = router.flight.snapshot(limit=100)["completed"]
        rtl = next(t for t in rtl if t["request_id"] == "fleet-handoff")
        cap = next(r for r in json.loads(fleet_call(
            rurl + "/router/replicas")[2])["replicas"]
            if r["name"] == dec).get("capacity") or {}
        cold_a, warm_a, ttfb_uni = warm_mirror(uni, body_a, "fleet-uni-A")
        if text_a != warm_a:
            fail(f"fleet: the handoff's text differs from {uni}'s with the "
                 f"prefix held locally")
        deferred.append(("handoff vs unified cold", body_a, cold_a, text_a))

        # 3a. The pull leg: the push misses, the decode replica pulls.
        body_b = body_of("B")
        status, _, raw = fleet_call(
            urls["r2"] + "/control/prefill", body_b,
            {"X-KV-Push-To": "http://127.0.0.1:1"})
        leg = json.loads(raw) if status == 200 else {}
        if status != 200 or leg.get("pushed") or not leg.get("blocks"):
            fail(f"fleet: the missed push answered {status}: {raw[:200]}")
        t_before = engines["r0"].stats["kv_tier_transfer_pages"]
        _, text_b, _ = fleet_generate(
            urls["r0"], body_b, "fleet-pull",
            {"X-KV-Transfer-From": urls["r2"]})
        pulled = engines["r0"].stats["kv_tier_transfer_pages"] - t_before
        if pulled <= 0:
            fail("fleet: X-KV-Transfer-From moved no page")
        _, warm_b, _ = warm_mirror("r1", body_b, "fleet-uni-B")
        if text_b != warm_b:
            fail("fleet: the pulled pages' text differs from r1's with the "
                 "prefix held locally")

        # 3b. Router-driven transfer over r0 and r1.
        os.environ["ROUTER_KV_TRANSFER"] = "1"
        router2_app = create_router_app(
            [(n, urls[n]) for n in ("r0", "r1")], policy="affinity",
            heartbeat_s=30.0, run_heartbeat=False)
        r2url, stop_router2 = serve_app(router2_app)
        heartbeat(r2url)
        body_e = body_of("E")
        hdrs, _, _ = fleet_generate(r2url, body_e, "fleet-rt-1")
        donor = hdrs["X-Routed-Replica"]
        other = "r1" if donor == "r0" else "r0"
        _, warm_e, _ = fleet_generate(urls[donor], body_e, "fleet-rt-warm")
        fleet_call(urls[donor] + "/control/drain", {})
        heartbeat(r2url)
        hints0 = snap("router_kv_transfer_hints_total")
        t_before = engines[other].stats["kv_tier_transfer_pages"]
        hdrs, text_e, _ = fleet_generate(r2url, body_e, "fleet-rt-2")
        moved = engines[other].stats["kv_tier_transfer_pages"] - t_before
        fleet_call(urls[donor] + "/control/undrain", {})
        if (hdrs["X-Routed-Replica"] != other or moved <= 0
                or snap("router_kv_transfer_hints_total") != hints0 + 1):
            fail(f"fleet: router-driven transfer: placed on "
                 f"{hdrs['X-Routed-Replica']}, {moved} pages pulled, "
                 f"hints {snap('router_kv_transfer_hints_total') - hints0}")
        if text_e != warm_e:
            fail("fleet: the router-driven pull's text differs from the "
                 "donor's warm text")
        heartbeat()

        # Leg times: a handoff driven leg by leg (prompt C). On r2 the
        # three calls ``/control/prefill`` makes, timed one by one: the
        # 1-token prefill, the export (gather + serialize) and the push
        # into r0 (wire + import); then r0's decode; r1 cold on the same
        # prompt for the unified TTFT.
        body_c = body_of("C")
        ids_c = ids_of(body_c)
        r2 = engines["r2"]
        pf0 = r2.stats
        launches0 = launch_snapshot()
        t1 = time.monotonic()
        r2.stream_text(cfg.prompts.chat_template.format(
            context_str=body_c["context"], query_str=body_c["question"]),
            SamplingParams(max_tokens=1, top_k=1),
            request_id="fleet-legs-prefill").text()
        t2 = time.monotonic()
        blob, n_blk = r2.export_handoff(ids_c)
        t3 = time.monotonic()
        if not kv_tier.push_blob(urls["r0"], blob, timeout_s=60):
            fail("fleet: the timed push into r0 was refused")
        t4 = time.monotonic()
        leg = {"blocks": n_blk, "blob_bytes": len(blob),
               "ms": {"prefill": (t2 - t1) * 1e3, "export": (t3 - t2) * 1e3,
                      "push": (t4 - t3) * 1e3}}
        t1 = time.monotonic()
        kv_tier.from_blob(blob)
        import_ms = (time.monotonic() - t1) * 1e3
        del blob
        torch.cuda.synchronize()
        launches1 = launch_snapshot()
        pf1 = engines["r2"].stats
        check_lone_window("r2 prefill leg", launches0, launches1,
                          pf0, pf1, mcfg.num_layers,
                          head_tiles(engines["r2"]), want_steps=False)
        d0 = engines["r0"].stats
        _, text_c, ttfb_c = fleet_generate(urls["r0"], body_c,
                                           "fleet-legs")
        torch.cuda.synchronize()
        launches2 = launch_snapshot()
        check_lone_window("r0 decode after a push", launches1, launches2,
                          d0, engines["r0"].stats, mcfg.num_layers,
                          head_tiles(engines["r0"]), want_steps=True)
        ltl = timeline_of(obs_flight.RECORDER, "fleet-legs")
        _, _, ttfb_c_uni = fleet_generate(urls["r1"], body_c,
                                          "fleet-legs-uni")
        utl = timeline_of(obs_flight.RECORDER, "fleet-legs-uni")

        # 4. Affinity: two turns of one conversation.
        system = ("You answer questions about the fleet router. " * 30)
        turn1 = {"question": "Which replica holds my prefix?",
                 "context": system, "use_knowledge_base": False,
                 "num_tokens": 8}
        hits0 = snap("router_affinity_hits")
        hdrs, answer1, _ = fleet_generate(rurl, turn1, "fleet-aff-1")
        home = hdrs["X-Routed-Replica"]
        placed0 = snap(f'router_placed_total{{replica="{home}"}}')
        phit0 = engines[home].stats.get("prefix_cache_hit_tokens", 0)
        turn2 = dict(turn1, question="And the next turn?",
                     context=system + "\nUser: " + turn1["question"]
                     + "\nAssistant: " + answer1)
        hdrs, _, _ = fleet_generate(rurl, turn2, "fleet-aff-2")
        atl = next(t for t in router.flight.snapshot(limit=100)["completed"]
                   if t["request_id"] == "fleet-aff-2")
        place = next(e["value"] for e in atl["events"]
                     if e["event"] == "place")
        phit = engines[home].stats.get("prefix_cache_hit_tokens", 0) - phit0
        if (hdrs["X-Routed-Replica"] != home
                or snap(f'router_placed_total{{replica="{home}"}}')
                != placed0 + 1
                or snap("router_affinity_hits") < hits0 + 1
                or place["affinity_blocks"] <= 0 or phit <= 0):
            fail(f"fleet: the second turn went to "
                 f"{hdrs['X-Routed-Replica']} (first: {home}), affinity "
                 f"blocks {place['affinity_blocks']}, prefix hit {phit}")

        # Router overhead: 8 short requests, the router's first byte
        # against the replica's.
        overhead = []
        for i in range(8):
            rid = f"fleet-ovh-{i}"
            fleet_generate(rurl, {"question": f"Short question {i}?",
                                  "use_knowledge_base": False,
                                  "num_tokens": 4}, rid)
            r_tl = next(t for t in router.flight.snapshot(
                limit=100)["completed"] if t["request_id"] == rid)
            c_tl = timeline_of(obs_flight.RECORDER, rid)
            overhead.append(r_tl["meta"]["ttft_ms"]
                            - c_tl["meta"]["ttft_ms"])

        # 6. Drain r1 with a stream of its own in flight.
        faults.set_plan(FLEET_DELAY)
        try:
            held = None
            for i in range(4):
                status, hdrs, (resp, first) = fleet_call(
                    rurl + "/generate",
                    {"question": f"Drain stream {i}?", "num_tokens": 48,
                     "use_knowledge_base": False},
                    {"X-Request-ID": f"fleet-drain-{i}"}, read=1)
                if status == 200 and hdrs["X-Routed-Replica"] == "r1":
                    held = (resp, first, f"fleet-drain-{i}")
                    break
                with resp:
                    resp.read()
            if held is None:
                fail("fleet: no router placement landed on r1")
            fleet_call(urls["r1"] + "/control/drain", {})
            heartbeat()
            placed_r1 = snap('router_placed_total{replica="r1"}')
            for i in range(4):
                hdrs, _, _ = fleet_generate(rurl, {
                    "question": f"While r1 drains {i}?", "num_tokens": 2,
                    "use_knowledge_base": False}, f"fleet-drained-{i}")
                if hdrs["X-Routed-Replica"] == "r1":
                    fail("fleet: the draining r1 took a new placement")
            with held[0] as resp:
                rest = (held[1] + resp.read()).decode("utf-8")
        finally:
            faults.clear()
        finish = timeline_of(obs_flight.RECORDER,
                             held[2])["meta"].get("finish")
        if snap('router_placed_total{replica="r1"}') != placed_r1 \
                or "[error]" in rest or finish not in ("length", "eos"):
            fail(f"fleet: r1's in-flight stream finished {finish!r} with "
                 f"{len(rest)} characters while draining")
        fleet_call(urls["r1"] + "/control/undrain", {})
        heartbeat()

        # 5. Failover: an uninterrupted run, then the same request with
        # its replica's site stopped mid-stream.
        body_f = {"question": "Tell a long story about replicas.",
                  "context": system, "use_knowledge_base": False,
                  "num_tokens": 64}
        hdrs, full_f, _ = fleet_generate(rurl, body_f, "fleet-fo-ref")
        resumes0 = snap('router_resume_total{outcome="ok"}')
        faults.set_plan(FLEET_DELAY)
        try:
            status, hdrs, (resp, first) = fleet_call(
                rurl + "/generate", body_f,
                {"X-Request-ID": "fleet-fo-kill"}, read=1)
            victim = hdrs.get("X-Routed-Replica")
            if status != 200 or victim not in ("r0", "r1"):
                fail(f"fleet: failover stream answered {status} on "
                     f"{victim!r}")
            stops[victim]()
            killed.add(victim)
            with resp:
                stitched = (first + resp.read()).decode("utf-8")
        finally:
            faults.clear()
        if ("[error]" in stitched or "event: error" in stitched
                or snap('router_resume_total{outcome="ok"}')
                != resumes0 + 1):
            fail(f"fleet: no clean resume after stopping {victim}: "
                 f"{stitched[-200:]!r}")
        deferred.append(("failover vs uninterrupted", body_f, full_f,
                         stitched))
        # The stopped replica's engine retires its abandoned stream at its
        # next harvested token: every engine idle, then the counts.
        for e in engines.values():
            wait_idle(e)
        torch.cuda.synchronize()
        run = read_launch_counts(engines["r0"], stats0["r0"])
        run.update({k: sum(engines[n].stats[k] - stats0[n][k]
                           for n in engines)
                    for k in ("decode_steps", "prefills",
                              "prefill_dispatches", "prefill_chunks",
                              "sampler_rows_sampled",
                              "sampler_rows_skipped")})
        if weight_marks(served.params) != weights0:
            fail("fleet: serving wrote the shared weights")
        check_launch_counts(f"[{mode}] fleet", run, mcfg.num_layers,
                            "int4_awq", "int8", head_tiles(engines["r0"]))
        r2_work = {k: engines["r2"].stats[k] - stats0["r2"][k]
                   for k in ("decode_steps", "prefills",
                             "prefill_dispatches")}
        dec_steps = {n: engines[n].stats["decode_steps"]
                     - stats0[n]["decode_steps"] for n in ("r0", "r1")}
        if r2_work["decode_steps"] or not r2_work["prefill_dispatches"] \
                or not all(dec_steps.values()):
            fail(f"fleet: r2's work {r2_work}, the decode replicas' steps "
                 f"{dec_steps}")
    finally:
        faults.clear()
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if stop_router2 is not None:
            stop_router2()
        stop_router()
        for name, stop in stops.items():
            if name not in killed:
                stop()
        for e in engines.values():
            e.stop()

    # After the counted window: full forwards for the near-tie rule, the
    # page I/O, and the legs.
    for label, body, want, got in deferred:
        part = parting(body, want, got)
        if part is not None and part[1] >= SPEC_TIE:
            fail(f"fleet: {label}: the texts part at token {part[0]} with "
                 f"top-2 gap {part[1]}")
        say(f"fleet [{mode}]: {label}: " + (
            "equal" if part is None else
            f"part at token {part[0]} (top-2 gap {part[1]:.4f}, a near-tie)"))
    d2h, h2d = engines["r0"].measure_page_io(16)
    mb = leg["blob_bytes"] / 1e6
    pages_c = leg["blocks"]
    restore_ms = stage_ms(ltl, "engine_kv_restore")
    prefill_tok_ms = leg["ms"]["prefill"] / len(ids_c)
    measured_page_ms = (leg["ms"]["export"] + leg["ms"]["push"]
                        + restore_ms) / pages_c
    say(f"fleet [{mode}]: handoff legs for a {len(ids_c)}-token prompt "
        f"({pages_c} pages, blob {mb:.2f} MB): prefill "
        f"{leg['ms']['prefill']:.2f} ms, export (gather + serialize) "
        f"{leg['ms']['export']:.2f} ms, push (wire + import) "
        f"{leg['ms']['push']:.2f} ms ({mb / leg['ms']['push'] * 1e3:.2f} "
        f"MB/s), import alone (parse + CRC) {import_ms:.2f} ms, restore "
        f"{restore_ms:.2f} ms (host), decode TTFT after the push "
        f"{ltl['meta']['ttft_ms']:.2f} ms (first byte {ttfb_c * 1e3:.2f} "
        f"ms) vs unified cold TTFT {utl['meta']['ttft_ms']:.2f} ms (first "
        f"byte {ttfb_c_uni * 1e3:.2f} ms); page I/O D2H {d2h:.4f} / H2D "
        f"{h2d:.4f} ms/page [{card}]")
    say(f"fleet [{mode}]: through the router: handoff first byte "
        f"{ttfb_a * 1e3:.2f} ms (prefill leg "
        f"{stage_ms(rtl, 'router_disagg_prefill'):.2f} ms) vs {uni} cold "
        f"{ttfb_uni * 1e3:.2f} ms for the same {len(ids_a)}-token prompt; "
        f"computed on {dec} after the handoff: {computed} tokens [{card}]")
    priced = handoff_beats_prefill(cap, raw_len)
    per_page = (float(cap.get("d2h_ms_per_page", 0) or 0)
                + float(cap.get("h2d_ms_per_page", 0) or 0))
    say(f"fleet [{mode}]: handoff_beats_prefill -> {priced} on {dec}'s "
        f"capacity (page_size {cap.get('page_size')}, d2h "
        f"{cap.get('d2h_ms_per_page')} + h2d {cap.get('h2d_ms_per_page')} "
        f"= {per_page} ms/page, prefill_ms_per_token "
        f"{cap.get('prefill_ms_per_token')}) for {raw_len} bytes; measured "
        f"here: {measured_page_ms:.3f} ms/page for the whole handoff vs "
        f"{prefill_tok_ms * page:.3f} ms to prefill a page's tokens -> "
        f"{measured_page_ms < prefill_tok_ms * page} [{card}]")
    overhead.sort()
    say(f"fleet [{mode}]: router overhead (router first byte - replica "
        f"TTFT) over 8 requests: median "
        f"{statistics.median(overhead):.2f} ms, range {overhead[0]:.2f}-"
        f"{overhead[-1]:.2f} ms [{card}]")
    say(f"fleet [{mode}]: launches {run['launches']} (int4 by path "
        f"{run['by_path']}) over {run['decode_steps']} decode steps, "
        f"{run['prefills']} admissions and {run['prefill_dispatches']} "
        f"prefill programs on three replicas; r2 (prefill) {r2_work}")
    del engines
    free_memory(torch)
    return run


def weight_marks(tree) -> list:
    """(address, in-place write count) of every tensor of a parameter
    tree, in a fixed order: equal marks mean the same tensors, unwritten."""
    import torch
    if isinstance(tree, dict):
        return [m for k in sorted(tree) for m in weight_marks(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [m for v in tree for m in weight_marks(v)]
    if isinstance(tree, torch.Tensor):
        return [(tree.data_ptr(), tree._version)]
    return []


def launch_snapshot() -> dict:
    """The kernels' launch counts since ``zero_launch_counts``."""
    from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul
    from generativeaiexamples_tpu_torch.ops.paged_attention import \
        paged_attention_decode
    return {"paged_attention_decode": paged_attention_decode.launches,
            "paged_attention_decode_int8":
                paged_attention_decode.int8_launches,
            **dict(int4_matmul.launches_by_path)}


def check_lone_window(label: str, c0: dict, c1: dict, s0: dict, s1: dict,
                      L: int, n_tiles: int, want_steps: bool) -> None:
    """One replica's work alone between two launch snapshots: int8
    attention on every layer of its decode steps; #3 "tc" on every decode
    projection and head tile and each admission's head row; "wg" on every
    prefill program's projections; nothing else."""
    d = {k: c1[k] - c0[k] for k in c0}
    steps = s1["decode_steps"] - s0["decode_steps"]
    prefills = s1["prefills"] - s0["prefills"]
    programs = s1["prefill_dispatches"] - s0["prefill_dispatches"]
    want = {"paged_attention_decode": 0,
            "paged_attention_decode_int8": L * steps,
            "tc": (7 * L + n_tiles) * steps + prefills, "gemv": 0,
            "tile": 0, "wg": 7 * L * programs}
    if d != want or not programs or bool(steps) != want_steps:
        fail(f"fleet: {label}: launches {d} over {steps} decode steps, "
             f"{prefills} admissions and {programs} prefill programs; "
             f"expected {want}")
    say(f"fleet: {label}: launches {d} ({steps} decode steps, {prefills} "
        f"admissions, {programs} prefill programs)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    try:
        from generativeaiexamples_tpu_torch.kernels import build
    except ImportError as exc:
        fail(f"the port package is not importable here: {exc}")
    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    phases = {}
    t0 = time.monotonic()

    def lap(name):
        nonlocal t0
        phases[name] = round(time.monotonic() - t0, 1)
        t0 = time.monotonic()

    quant_ref = QuantReference(torch, dev)
    lap("quant_reference_start")

    took = build.build_all()
    say(f"kernel build: {time.monotonic() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                say(f"ptxas {name}: {line.strip()}")
    lap("build")

    check_paged_attention(torch, dev, torch.float32)
    kernels = [check_paged_attention(torch, dev, torch.bfloat16)]
    check_paged_attention(torch, dev, torch.float32, quant=True)
    kernels.append(check_paged_attention(torch, dev, torch.bfloat16,
                                         quant=True))
    torch.cuda.empty_cache()
    lap("attention")
    kernels.extend(check_int4_matmul(torch, dev))
    lap("int4_matmul")
    check_fused_tail(torch, dev, card)
    lap("fused_tail")
    check_model(torch, dev)
    lap("model")
    check_model_quant(torch, dev, quant_ref)
    lap("model_quant")
    checkpoint_phase(torch, dev, card)
    lap("checkpoint")
    # Each path's kernels take their launch counts from that path's run.
    bf16 = serve(torch, dev, card)
    lap("serve_bf16")
    quantized = serve(torch, dev, card, quantization="int4_awq",
                      kv_quant="int8")
    lap("serve_int4")
    # Speculative decoding and the host KV tier on each mode's weights;
    # their counts join the mode's in the kernels line.
    for run, q in ((bf16, ""), (quantized, "int4_awq")):
        mode, engine, untraced = run["profile"]
        spec = serve_spec(torch, dev, card, engine, mode, q)
        tier = kv_tier_phase(torch, dev, card, engine, mode, q)
        for key in ("launches", "by_path"):
            run[key] = {k: n + spec[key][k] + tier[key][k]
                        for k, n in run[key].items()}
        run["verify_wg"] = spec["verify_wg"]
        untraced["calibrated_decode_ms"] = spec["calibrated_decode_ms"]
    lap("serve_spec_kv_tier")
    # The RAG chatbot over each mode's weights; its counts join the
    # mode's in the kernels line.
    rag = serve_rag(torch, dev, card, [(bf16["profile"][1], ""),
                                       (quantized["profile"][1],
                                        "int4_awq")])
    for run, q in ((bf16, ""), (quantized, "int4_awq")):
        for key in ("launches", "by_path"):
            run[key] = {k: n + rag[q][key][k] for k, n in run[key].items()}
    lap("serve_rag")
    # The fleet tier on the int4 weights: three replicas behind the
    # router; its counts join the int4 mode's in the kernels line.
    fleet = serve_fleet(torch, dev, card, quantized["profile"][1])
    for key in ("launches", "by_path"):
        quantized[key] = {k: n + fleet[key][k]
                          for k, n in quantized[key].items()}
    lap("serve_fleet")
    # Last: the first profiler session changes how the card runs graphs.
    traced_profiles(torch, card, [bf16.pop("profile"),
                                  quantized.pop("profile")])
    lap("traced")
    for row in kernels:
        run = bf16 if row["name"] == "paged_attention_decode" else quantized
        row["launches"] = (run["by_path"][row["path"]] if "path" in row
                           else run["launches"][row["name"]])
        if row.get("shape", "").startswith("verify"):
            # The verify rounds' "wg" launches of the int4 spec phase.
            row["launches"] = quantized["verify_wg"]
    say(f"phase seconds: {phases}, total {sum(phases.values()):.1f}")

    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
