#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``generativeaiexamples_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

(``python3 chip_smoke.py --golden-readings`` builds the kernels and
prints only the readings the golden gate's limits were set from.
``python3 chip_smoke.py --tp 4`` runs only the multi-card phases,
phases 12 to 14 below, on a machine with four cards; ``--tp 4 --only
mesh`` the kernel checks and phase 14 alone.)

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
   Then each mode's admission path on the same weights cut to 8 layers
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
   Inside each mode's RAG window, the application periphery
   (``serve_periphery``, timed as a phase of its own) on the same
   engine, embedder and chain server: the model server (now with the
   Triton generate extension and the job routes) and the gRPC
   ``LLMService``; one greedy 64-token prompt through Triton generate
   and generate_stream (``TritonShimClient``), /v1/jobs (``JobsClient``,
   one answered at submit or after polls, one 202 then polls), gRPC
   unary and stream, ``TorchLLM`` over gRPC and HTTP and
   ``TorchLlamaIndexLLM``, each text equal to /v1/completions'; the web
   frontend in front of the chain server (/api/generate = /generate,
   /api/search = /documentSearch; in the last mode a .pptx and a .docx
   built with zipfile through /api/upload, each then the top hit for
   its own text); the multimodal assistant through the chain server's
   ``--example`` path (a deck uploaded; the answer equal to the engine's
   greedy text for the prompt it assembled; the fact check); in the
   first mode the streaming ingest pipeline over docs/*.md into a fresh
   ``exact-cuda`` store (chunk texts and ids equal to the /uploadDocument
   index's, top-4 ids equal or named near-ties). Every request runs in a
   launch-count window of its own, checked by the serve formula and
   added to the kernels line. Prints each front end's first byte and
   total ms against /v1/completions', the frontend's first byte against
   the chain server's, and the pipeline's chunks/s against
   /uploadDocument's.
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
   of llama-2-7b-chat at full width, cut to ``FLEET_LAYERS`` (8) layers,
   sharing one set of weight tensors (r0 and r1 unified, r2 prefill; int8 pools and host tiers of
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

10. Customization and evaluation (``customize``, after the Nemotron
   phases and before the llama-2 serve phases, while no engine holds the
   card): #3 under autograd at llama-2-7b's projection shapes and M =
   2048 (AWQ and GPTQ leaves; dx against a dequantized bf16 product's,
   forward and backward timed); the raw head's logits product under
   autograd; then on llama-2-7b-chat at full width and depth (random bf16
   weights, seed 0) LoRA (rank 8 on wq..wo, Adam 1e-2, 8 steps of 4 x
   512) over the bf16 base and QLoRA over the base quantized to int4_awq
   (first gradients against the dequantized bf16 base's; the training
   window's #3 "wg" forwards and backward products counted, added to the
   kernels line), each base's digest unchanged, each merged tree served
   with its launch counts and the eager engine's tokens; full-parameter
   SFT (AdamW, notebook 10's masked batch); the golden tool trained on
   the card, exported, read back bit-equal and scored through
   /v1/score; and the live eval through the chain server on it
   (retrieval metrics equal to a CPU index's; exact-cuda beside).

11. The mixture-of-experts family (Mixtral-8x7B: 8 experts, top-2,
   sparse capacity-routed; H 32, KV 8, so G = 4 query heads a kv head),
   after the Nemotron phases: #1 and #2 held against their plain versions
   at G = 4 in the kernel phase (the same lengths, tolerances and bit-exact
   appends; timed L2-cold beside their bound), and #3 at its N = 1024
   ``wk``/``wv`` shape; ``check_family_model``: 2 layers at full width in
   float32 and int4_awq + int8 KV, captured and eager card engines against
   the CPU engine's greedy tokens (``FamilyReference``, a thread from the
   start, as Nemotron's), then ``check_moe_routing`` (route_topk card =
   CPU at T = 8 and 1024; sparse = dense in bf16 with nothing dropped);
   ``serve_family`` (Nemotron's phase)
   in bf16 and int4_awq (experts bf16) + int8 KV at full width cut to
   ``MIXTRAL_LAYERS`` = 24 of 32 layers (the bf16 tree of 32 does not fit
   the card), from ``fresh_slot_state``
   where runs are compared (under MoE an idle slot's row claims expert
   capacity too), with the decode step, the MoE layers' share of it and
   a 1024-token prefill printed.
12. Tensor parallelism. The default run checks the three kernels at the
   shapes each rank gives them at tp = 4 (``check_tp_shards``: #1/#2 at
   Llama-2-70B's H 16 / KV 2, G = 8, and Mixtral's H 8 / KV 2; #3 at every
   70B shard shape, M = 1, 8, 128, 1024), printed beside their bounds,
   and at the shapes of the mesh phases (``check_mesh_shards``): the
   ring's tiled block update at an sp = 4 rank's (Llama-2-7B's 32 heads,
   8192 local queries against one 8192-row block) in float32 against
   dense attention and timed in bf16; #1/#2 at one slot of 32768 rows
   (G = 1, timed L2-cold beside their bound); #3 ``wg`` at M = 8192 on
   Llama-2-7B's w_gate and w_down; the local expert products at ep = 4
   (2 of Mixtral's 8 experts).
   ``--tp 4`` (four cards) runs only: the same kernel check, then
   ``tp_parity`` on four spawned ranks in one NCCL group (Llama-2-70B's
   width; 2 layers float32 with TF32 off: logits within 1e-4 x max|logit|
   of the one-card model on rank 0's card, greedy tokens equal but at a
   near tie, the sharded fused tail equal to the materialized one, spec
   decoding greedy and sampled (``fused_verify_sample_tp``); 8 layers
   bf16: greedy tokens up to the first near tie, its top-2 gap printed;
   #1 once per layer per decode step on every rank; the all-reduce and
   header times), then ``serve_tp_cli``: llama-2-70b-chat at all 80
   layers through the model server's CLI at ``--tensor-parallelism 4``
   in bf16 and in int4_awq + int8 KV, and mixtral-8x7b-instruct at all
   32 layers in bf16, each rank's launch counts read around 4
   completions and the timed requests (decode step, all-reduce share,
   a 1000-token prefill), and a clean SIGTERM exit.
13. Checkpoints at tp (``--tp 4`` only, ``tp_checkpoint_phase``):
   Llama-2-70B's width cut to ``TP_CKPT_LAYERS`` = 2 layers, written
   from seed 0 by the port's writer as a bf16 safetensors directory and
   a GPTQ directory (group 128), each served through the CLI at
   ``--tensor-parallelism 4 --model-path`` (bf16 in float32, GPTQ in
   bf16): every rank's device peak over its load at most 1.1x its shard
   and its host RSS growth under 40% of the checkpoint; greedy texts
   equal the engines' built from the seed-0 shards; #1 (and #3) launches
   as counted on every rank; ``/v1/score`` in float32 against one card
   within 1e-4 x max|NLL|. Then on four spawned ranks a session
   suspended and resumed (the uninterrupted run's tokens; the float32
   shards read back from each rank's weight-cache entry), a tp = 4
   handoff continued on one card (tokens equal up to a near tie), and
   fused RAG over ``docs/*.md`` chunks equal to the host path.
14. The rest of the serving mesh (``--tp 4``, ``mesh_phases``), after
   ``check_mesh_shards``: ep parity on four spawned ranks (Mixtral's
   width cut to 2 layers, float32, TF32 off, at ep = 4 and ep = 2 x tp
   = 2: logits within 1e-4 x max|logit| of one card's on rank 0's card,
   greedy tokens through ``Engine(mesh=)`` equal but at a near tie, #1
   on every rank; int4_awq + int8 KV at ep = 4: #2 and #3 counted on
   every rank); the ep serve (Mixtral-8x7B at all 32 layers, bf16,
   through ``Engine(mesh=)`` at ep = 4 and, in the same run, tp = 4: the
   decode step at 1 and 8 streams, the MoE layers' share, the combine
   all-reduce's time, #1 once per layer per step on every rank); sp
   parity (Llama-2-7B's width cut to 2 layers, float32, sp = 4, S 4096:
   ``apply_prefill_sp``'s K/V and last logits and ``score`` within 1e-4
   x max of each rank's one-card forward); multi-host (70B width at 2
   layers written as a bf16 checkpoint, served in float32 at tp = 4 by
   one CLI and by two CLIs on cards 0,1 and 2,3 joined by
   ``--coordinator``/``--num-processes``/``--process-id``: equal texts,
   #1 on every rank, both exit 0 on SIGTERM); the sp serve (LLaMA-2-7B-
   32K's geometry at all 32 layers, seed 0, bf16 and int4_awq + int8 KV,
   sp = 4: one 32768-token prompt in one ring admission, 64 greedy
   tokens, #1/#2 on every rank, the TTFT beside the one-card chunked
   admission's on card 0, tokens equal up to the first near tie, the 32k
   score over sp).

Exits 2 without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def env_set(**values: str):
    """The environment with ``values`` set for the block, then restored."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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

def check_paged_attention(torch, dev, dtype, quant: bool = False,
                          kv_heads: int = 32, heads: int = 32,
                          label: str = "", lengths: Optional[list] = None):
    """The paged decode kernel against its plain version at llama-2-7b
    decode shapes: B=8, H=KV=32, hd=128, page=128, layer 1 of an L=2
    pool, lengths covering 0, page-1, page, page+1 and long contexts, or
    with ``kv_heads`` 8 at Mixtral-8x7B's (H 32, KV 8: G = 4 query heads a
    kv head, the kernel's ``MAXG = 8`` instantiations), or with ``heads``
    and ``kv_heads`` a tensor-parallel rank's shard (``label`` names it),
    or at ``lengths`` (one slot each, then without the uniform 8 x 2048
    timing).
    q and cur_k/cur_v are in ``dtype``; the pools too (#1), or, under
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

    own_lengths = lengths is not None
    if not own_lengths:
        lengths = [0, 1, 127, 128, 129, 1000, 2047, 3000]
    B, H, KV, hd, page, L = len(lengths), heads, kv_heads, 128, 128, 2
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
    shape = f"G={H // KV}" + (f" ({label}: H {H}, KV {KV})" if label else
                              " (Mixtral-8x7B: H 32, KV 8)" if KV != H
                              else " (llama-2-7b: H = KV = 32)")

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
        say(f"kernel {name} float32 {shape}: max_abs_err={err} (atol "
            f"{atol}); appends bit-exact, no row past a length read")
        return None

    warm_ms = time_cuda(torch, lambda: kernel(new), iters=50)
    plain_ms = time_cuda(torch, lambda: plain(ref_pools), iters=5, warmup=1)
    del new, ref_pools, pools
    torch.cuda.empty_cache()
    ms, bound, by, layers = time_attention(torch, dev, dtype, quant, lengths,
                                           KV, H)
    say(f"kernel {name} {shape}: max_abs_err={err} ms={ms} (L2-cold: "
        f"{layers} "
        f"pool layers cycled) warm_l2_ms={warm_ms} (one pool, every call "
        f"on the same rows) plain_ms={plain_ms} bound_ms={bound} ({by}; "
        f"{bound / ms:.1%} of it) library_ms=null (no single PyTorch call "
        f"computes paged attention{' over int8 pages' if quant else ''} "
        f"with the in-place append)")
    if not own_lengths:
        uni_ms, uni_bound, uni_by, uni_layers = time_attention(
            torch, dev, dtype, quant, [2048] * B, KV, H)
        say(f"kernel {name} {shape} uniform {B} x 2048 rows: ms={uni_ms} "
            f"(L2-cold: {uni_layers} pool layers cycled) bound_ms="
            f"{uni_bound} ({uni_by}; {uni_bound / uni_ms:.1%} of it)")
    return {
        "name": name,
        "shape": shape,
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


def time_attention(torch, dev, dtype, quant, lengths, kv_heads=32,
                   heads=32):
    """L2-cold device time of one paged attention call (bf16 or float32
    q; bf16/f32 pools, or int8 pools under ``quant``) at llama-2-7b decode
    shapes (H = KV = 32, hd = page = 128), or Mixtral's with ``kv_heads``
    8, over ``lengths``: the timed
    calls cycle the ``layer`` argument over a pool with enough layers that
    more than 100 MB of live rows are read between two reads of one row
    (the L2 cache holds 50 MB). Returns (ms, bound ms, what bounds it,
    layers cycled)."""
    from generativeaiexamples_tpu_torch.ops.kv_quant import quantize_rows
    from generativeaiexamples_tpu_torch.ops.paged_attention import \
        paged_attention_decode

    B, H, KV, hd, page = len(lengths), heads, kv_heads, 128, 128
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
            _KERNEL_DTYPES[out_dtype], x.data_ptr(), q4.data_ptr(),
            scale.data_ptr(), None, out.data_ptr(),
            None, 0, None, 0, M, K, N, K // G, N, N,
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"int4_matmul tile path (code 2) failed with CUDA error "
                 f"{err}")
        return out
    return call


# #3's row shapes on the result line: llama-2-7b's w_gate, and
# Mixtral-8x7B's wk/wv (N = KV 8 x head_dim 128), by the rows' key prefix.
ROW_SHAPES = {(4096, 11008): "", (4096, 1024): "mixtral_"}


def check_int4_matmul(torch, dev):
    """The packed-int4 kernel against its plain version at every
    projection shape of llama-2-7b, (K, N) in {(4096, 4096), (4096, 11008),
    (11008, 4096), (4096, 32000)}, and Mixtral-8x7B's wk/wv, (4096, 1024)
    (its other int4 projections have llama-2-7b's shapes), M in {1, 3, 8, 9, 128, 200, 1024} (the
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
    (M = 1024), and the same two at Mixtral's wk/wv shape."""
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.ops.int4_matmul import (
        _path, int4_matmul, int4_matmul_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
              (4096, 1024)]
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
                        if (M in (8, 1024) and (K, N) in ROW_SHAPES
                                and group == 128 and bf16
                                and out_dtype == torch.bfloat16):
                            row_err[ROW_SHAPES[(K, N)] + path] = err
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
            if M in (8, 1024) and (K, N) in ROW_SHAPES and (
                    path in ("tc", "wg")):
                key = ROW_SHAPES[(K, N)] + path
                rows[key] = {
                    "name": "int4_matmul",
                    **({"shape": f"mixtral wk/wv M={M} K={K} N={N}"}
                       if key.startswith("mixtral") else {}),
                    "route": "cuda",
                    "source":
                        "generativeaiexamples_tpu_torch/csrc/int4_matmul.cu",
                    "replaces":
                        "generativeaiexamples_tpu/ops/int4_matmul.py:83",
                    "path": path,
                    "launches": 0,
                    "max_abs_err": row_err[key],
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
                                       if k.startswith(("head", "verify",
                                                        "mixtral"))]


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


def gptq_leaf(torch, gen, K: int, N: int, dev, group: int = 128) -> dict:
    """A random GPTQ-format int4 leaf of a (K, N) weight: q4 nibbles in
    [-8, 7], group scales and zero points as ``import_quantized`` makes
    them from a checkpoint's 4-bit zeros uz, ``gbias = (7 - uz) * s``."""
    G = K // group
    q = torch.randint(-8, 8, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    q4 = (q[0::2] & 0x0F) | (q[1::2] << 4)
    s = (torch.rand((G, N), generator=gen, device=dev) + 0.5) * (
        0.02 * K ** -0.5)
    uz = torch.randint(0, 16, (G, N), generator=gen, device=dev)
    return {"q4": q4, "gscale": s, "gbias": (7.0 - uz.float()) * s}


# The shapes #3 is checked at with GPTQ zero points: llama-2-7b's w_gate,
# Nemotron-8B's w_up and w_down (K = 16384, the largest reduction here).
GBIAS_SHAPES = (("7b-w_gate", 4096, 11008), ("nemotron-w_up", 4096, 16384),
                ("nemotron-w_down", 16384, 4096))


def check_int4_gbias(torch, dev) -> dict:
    """#3 with GPTQ zero points (``gbias``) against its plain version at
    ``GBIAS_SHAPES``, M in {1, 8} ("tc") and {64, 128, 1024} ("wg"), bf16
    x, out bf16 and float32. The kernel sums the bf16 x it reads for the
    zero-point term; the plain version (the reference's
    ``_grouped_matmul``) sums float32 x, which here is the same bf16 x
    widened exactly (a GPTQ leaf has no pre-scale), so the two differ
    only in fp32 summation order: held to the tolerances of
    ``check_int4_matmul`` (float32 out atol 1e-4 * max|ref|, rtol 1e-4;
    bf16 out rtol 1e-2). Each case must launch its path once, counted in
    ``int4_matmul.gbias_launches``. Then times, at every shape and M in
    {1, 8, 64, 128, 1024}, the kernel with zero points beside the same
    kernel without them (the AWQ format), the plain version, the bound
    (the zero points' bytes included) and ``aten._weight_int4pack_mm``,
    whose (scale, zero) pairs carry non-zero zero points and so compute
    the same function. Returns the kernels line's rows: "gbias-tc" and
    "gbias-wg" at Nemotron's w_up (M = 8 and 1024), "nemotron-tc" and
    "nemotron-wg" without zero points at its w_down (K = 16384)."""
    from generativeaiexamples_tpu_torch.ops.int4_matmul import (
        _path, int4_matmul, int4_matmul_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(5)
    rows, worst = {}, 0.0
    for name, K, N in GBIAS_SHAPES:
        leaf = gptq_leaf(torch, gen, K, N, dev)
        for M in (1, 8, 64, 128, 1024):
            x = torch.randn((M, K), generator=gen,
                            device=dev).to(torch.bfloat16)
            path = "tc" if M <= 8 else "wg"
            if _path(M, K, N, 128, x.dtype) != path:
                fail(f"gbias M={M} K={K} N={N} would not take {path!r}")
            for out_dtype, zeros in itertools.product(
                    (torch.bfloat16, torch.float32), (True, False)):
                gb = leaf["gbias"] if zeros else None
                n0 = (int4_matmul.launches_by_path[path],
                      int4_matmul.gbias_launches)
                got = int4_matmul(x, leaf["q4"], leaf["gscale"], gbias=gb,
                                  out_dtype=out_dtype)
                if (int4_matmul.launches_by_path[path],
                        int4_matmul.gbias_launches) != (n0[0] + 1,
                                                        n0[1] + zeros):
                    fail(f"gbias={zeros} M={M} K={K} N={N} did not launch "
                         f"{path!r} once")
                ref = int4_matmul_plain(x, leaf["q4"], leaf["gscale"],
                                        gbias=gb, out_dtype=out_dtype)
                peak = ref.float().abs().max().item()
                err = (got.float() - ref.float()).abs().max().item()
                rtol = 1e-4 if out_dtype == torch.float32 else 1e-2
                if not (torch.isfinite(got.float()).all() and torch.allclose(
                        got.float(), ref.float(), atol=1e-4 * peak,
                        rtol=rtol)):
                    fail(f"int4_matmul [{path}] gbias={zeros} M={M} K={K} "
                         f"N={N} out={out_dtype} disagrees with its plain "
                         f"version: max abs err {err} (max|ref| {peak})")
                worst = max(worst, err / max(peak, 1e-30))
                if out_dtype == torch.bfloat16 and M in (8, 1024):
                    rows.setdefault((name, M), {})[zeros] = err
        say(f"kernel int4_matmul with gbias {name} K={K} N={N}: M=1, 8 "
            f"(tc), 64, 128, 1024 (wg) x bf16/f32 out agree with the plain "
            f"version")
        wbytes = leaf["q4"].numel() + 8 * leaf["gscale"].numel()
        copies = 1 + (120 << 20) // wbytes
        leaves = [leaf] + [{k: v.clone() for k, v in leaf.items()}
                           for _ in range(copies - 1)]
        for M in (1, 8, 64, 128, 1024):
            x = torch.randn((M, K), generator=gen,
                            device=dev).to(torch.bfloat16)
            path = "tc" if M <= 8 else "wg"
            iters = 20 if M == 1024 else 200
            ms = time_cuda(torch, [
                (lambda lf=lf: int4_matmul(x, lf["q4"], lf["gscale"],
                                           gbias=lf["gbias"]))
                for lf in leaves], iters=iters)
            awq_ms = time_cuda(torch, [
                (lambda lf=lf: int4_matmul(x, lf["q4"], lf["gscale"]))
                for lf in leaves], iters=iters)
            plain_ms = time_cuda(torch, lambda: int4_matmul_plain(
                x, leaf["q4"], leaf["gscale"], gbias=leaf["gbias"]),
                iters=3, warmup=1)
            lib_ms, lib_note = int4_library_ms(torch, dev, M, K, N, 128,
                                               iters)
            G = K // 128
            flops = 2 * M * K * N + 2 * M * G * N
            for with_zeros, t in ((True, ms), (False, awq_ms)):
                nbytes = (K // 2 * N + (8 if with_zeros else 4) * G * N
                          + M * K * 2 + M * N * 2)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                flops_ms = flops / BF16_FLOPS * 1e3
                bound = max(bytes_ms, flops_ms)
                by = "bytes" if bytes_ms >= flops_ms else "operations"
                say(f"kernel int4_matmul [{path}] {name} M={M} K={K} N={N} "
                    f"group=128 x=bfloat16 "
                    f"{'with gbias' if with_zeros else 'without gbias'}: "
                    f"ms={t} plain_ms={plain_ms} bound_ms={bound} ({by}; "
                    f"{nbytes} bytes, {flops} flops; {bound / t:.1%} of "
                    f"it) library_ms={lib_ms} ({lib_note})"
                    f"{f' ({t / awq_ms:.3f}x without)' if with_zeros else ''}")
                key = (("gbias" if with_zeros else "nemotron")
                       if M in (8, 1024) else None)
                if key and ((with_zeros and name == "nemotron-w_up") or (
                        not with_zeros and name == "nemotron-w_down")):
                    rows[f"{key}-{path}"] = {
                        "name": "int4_matmul", "route": "cuda",
                        "source":
                            "generativeaiexamples_tpu_torch/csrc/"
                            "int4_matmul.cu",
                        "replaces":
                            "generativeaiexamples_tpu/ops/int4_matmul.py:83",
                        "path": path,
                        "shape": f"{name} M={M} K={K} N={N}"
                                 f"{' gbias' if with_zeros else ''}",
                        "launches": 0,
                        "max_abs_err": rows[(name, M)][with_zeros],
                        "ms": t, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "library_ms": lib_ms}
        del leaves, leaf
        torch.cuda.empty_cache()
    say(f"kernel int4_matmul with and without gbias at these shapes: "
        f"worst error over all cases relative to max|ref|: {worst}")
    return {k: v for k, v in rows.items() if isinstance(k, str)}


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
    eager.close()


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
        f"V={mcfg.vocab_size}, {n_bytes / 1e9:.2f} GB of weights ({n_bytes}"
        f" B; the round records count {engine._param_bytes} B a step, the "
        f"untied embedding table left out), pool "
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
    out["gbias"] = int4_matmul.gbias_launches
    return out


def head_tiles(engine) -> int:
    """The lm_head products of one decode step: one per vocab tile of the
    fused tail, or the whole head at once under the materialized one."""
    if not engine.cfg.fused_tail:
        return 1
    return engine.model_cfg.vocab_size // engine._sampler_tile


def check_launch_counts(label: str, run: dict, L: int, quantization: str,
                        kv_quant: str, n_tiles: int, per_layer: int = 7,
                        head: bool = True) -> None:
    """Every layer of every decode step went through the pool's attention
    kernel, once; under int4 weights every projection through #3: one per
    projection (``per_layer`` a layer: 7 for llama's swiglu, 6 for
    GPT-Next's squared-ReLU MLP, 4 for Mixtral's attention beside its
    bf16 experts) per prefill program (one-shot admission
    or chunk; the bucket's rows on "wg") and per decode step (the sampled
    rows on "tc"), plus the lm_head's ``n_tiles`` vocab tiles on "tc" per
    decode step (the fused tail) and its row per admission (its one-shot
    program or final chunk samples one row whole; none of these with a
    raw head, ``head`` False); none on "tile" or "gemv"; the other pool
    kind's kernel never."""
    steps, prefills = run["decode_steps"], run["prefills"]
    dispatches = run["prefill_dispatches"]
    attn = "paged_attention_decode_int8" if kv_quant else \
        "paged_attention_decode"
    want = {"paged_attention_decode": 0, "paged_attention_decode_int8": 0,
            "int4_matmul": 0}
    want[attn] = L * steps
    want_path = {"tc": 0, "gemv": 0, "tile": 0, "wg": 0}
    if quantization in ("int4", "int4_awq"):
        want_path = {"tc": (per_layer * L + n_tiles) * steps + prefills,
                     "gemv": 0, "tile": 0, "wg": per_layer * L * dispatches}
        want["int4_matmul"] = want_path["tc"] + want_path["wg"]
    if not head and quantization:
        # A raw head (a GPTQ checkpoint's): no #3 launch for the tail.
        want_path["tc"] -= n_tiles * steps + prefills
        want["int4_matmul"] -= n_tiles * steps + prefills
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


# The admission phase's 3000-token engines run the served 7B weights cut
# to this many layers: the phase checks chunking beside decode rounds,
# prefix hits and launch counts, which the depth does not change, and at
# 32 layers its four engines' capture took 160 s of a slow host's smoke,
# which must end within 1200 s.
ADMISSION_LAYERS = 8


def serve_admission(torch, dev, card: str, served, mode: str,
                    quantization: str) -> dict:
    """The admission path on the served engine's weights cut to their
    first ``ADMISSION_LAYERS`` layers (views): an engine for 3000-token
    prompts (buckets to 3072, 8 slots) serves,
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

    from dataclasses import replace

    tok = served.tokenizer
    mcfg = replace(served.model_cfg, num_layers=ADMISSION_LAYERS)
    params = depth_cut(served.params, ADMISSION_LAYERS)
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
        engine = Engine(params, mcfg, tok, EngineConfig(
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
        say(f"admission [{mode}] ({mcfg.num_layers} of "
            f"{served.model_cfg.num_layers} layers; {label} budget {budget} "
            f"tokens; {programs}"
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
        # The product always launches a kernel, so a trace without one
        # lost its device events: trace it again, at most three times.
        for _ in range(3):
            with _profile() as prof:
                llama.lm_head_tile(engine.params, engine.model_cfg, hn, tile,
                                   tile)
                torch.cuda.synchronize()
            head_kernels = sorted(_kernel_times(_device_events(prof)))
            if head_kernels:
                break
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
    with env_set(GAIE_WEIGHT_CACHE="0"):     # convert on every run
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
        with env_set(GAIE_WEIGHT_CACHE="0"):
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
        with env_set(GAIE_WEIGHT_CACHE="0"):
            engine, _ = build_services(
                "llama-2-7b-chat", model_path=tmp,
                engine_cfg=replace(ecfg, kv_quant="int8"), device=dev,
                quantization="int4_awq")
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
        f"=...) in bf16 {build_s:.1f} s (load and engine construction; "
        f"weight cache off, so no hash), "
        f"every tensor bit-equal to the fp16 -> bf16 cast in memory, one "
        f"greedy request: 16 tokens {text!r}; with int4_awq (group "
        f"{awq_group(cfg)}) + int8 KV {build_q_s:.1f} s, one greedy "
        f"request: 16 tokens {text_q!r}, int4 launches by path {by_path} "
        f"[{card}]")


def checkpoint_phase(torch, dev, card: str) -> dict:
    """(a) golden-tiny's trained weights, bf16 and int4 + int8 KV, through
    the served path; (b) the full-width fp16 checkpoint load; (c) the
    GPTQ, AWQ and NeMo formats and the weight cache
    (``check_quantized_formats``, ``check_nemo_load``). Returns the GPTQ
    run's #3 launches by path (its zero points' kernel rows)."""
    nll_bf16 = check_golden(torch, dev, card)
    nll_q = check_golden(torch, dev, card, quantization="int4",
                         kv_quant="int8")
    say(f"golden: /v1/score NLL of the corpus snippet: bf16 {nll_bf16:.4f}, "
        f"int4 weights + int8 KV {nll_q:.4f} (delta "
        f"{nll_q - nll_bf16:+.4f}) [{card}]")
    check_full_width_load(torch, dev, card)
    gptq = check_quantized_formats(torch, dev, card)
    check_nemo_load(torch, dev, card)
    return gptq


# The pre-quantized checkpoints' geometry: llama-2-7b's width, 2 layers
# (4 until the customize phase joined the smoke: their CPU engines took
# ~140 s of it), groups of 128 (the tensor-core paths' groups, as GPTQ
# and AWQ releases use).
QCKPT_LAYERS, QCKPT_GROUP = 2, 128
# The gap under which the card's and the CPU's bf16 greedy tokens may
# part: two computation orders move a logit of a 2-layer 7B-width model
# by a few hundredths, so a parting is only accepted where the CPU
# engine's own top-2 logits lie closer than this.
QCKPT_TIE = 0.1


def pack_int32(u4, dim: int):
    """uint4 values (int32 tensor, 0..15) -> int32 packed along ``dim``,
    value j at bits 4j (GPTQ's layout)."""
    import torch
    u = u4.movedim(dim, 0).to(torch.int64)
    out = torch.zeros((u.shape[0] // 8, *u.shape[1:]), dtype=torch.int64,
                      device=u.device)
    for j in range(8):
        out |= u[j::8] << (4 * j)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).movedim(0, dim).contiguous()


def quantized_state(torch, dev, cfg, fmt: str) -> dict:
    """An HF-named GPTQ or AMMO-AWQ state dict of ``cfg`` made on the card
    from seed 0 (fp16 embed, norms and lm_head as releases ship them):
    GPTQ random 4-bit weights, zero points and fp16 scales; AWQ fp16
    weights with their per-group amax and a pre-quant scale."""
    gen = torch.Generator(device=dev).manual_seed(0)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv, g = cfg.q_dim, cfg.kv_dim, QCKPT_GROUP
    state = {}
    for i in range(cfg.num_layers):
        for proj, (K, N) in (("self_attn.q_proj", (D, q)),
                             ("self_attn.k_proj", (D, kv)),
                             ("self_attn.v_proj", (D, kv)),
                             ("self_attn.o_proj", (q, D)),
                             ("mlp.gate_proj", (D, F)),
                             ("mlp.up_proj", (D, F)),
                             ("mlp.down_proj", (F, D))):
            base = f"model.layers.{i}.{proj}"
            if fmt == "gptq":
                u = torch.randint(0, 16, (K, N), generator=gen, device=dev,
                                  dtype=torch.int32)
                uz = torch.randint(0, 15, (K // g, N), generator=gen,
                                   device=dev, dtype=torch.int32)
                s = (torch.rand((K // g, N), generator=gen, device=dev)
                     + 0.5) * (0.05 * K ** -0.5)
                state[f"{base}.qweight"] = pack_int32(u, 0)
                state[f"{base}.qzeros"] = pack_int32(uz, 1)
                state[f"{base}.scales"] = s.to(torch.float16)
                state[f"{base}.g_idx"] = torch.arange(
                    K, device=dev, dtype=torch.int32) // g
            else:
                w = torch.randn((N, K), generator=gen, device=dev) * K ** -0.5
                state[f"{base}.weight"] = w.to(torch.float16)
                state[f"{base}.weight_quantizer._amax"] = w.abs().reshape(
                    N, K // g, g).amax(-1)
                state[f"{base}.input_quantizer._pre_quant_scale"] = (
                    torch.rand((K,), generator=gen, device=dev) + 0.5)
        for name in ("input_layernorm", "post_attention_layernorm"):
            state[f"model.layers.{i}.{name}.weight"] = (
                1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
            ).to(torch.float16)
    for key in ("model.embed_tokens.weight", "lm_head.weight"):
        state[key] = (torch.randn((V, D), generator=gen, device=dev)
                      * D ** -0.5).to(torch.float16)
    state["model.norm.weight"] = torch.ones((D,), device=dev,
                                            dtype=torch.float16)
    return state


def write_hf_dir(cfg, state: dict) -> str:
    """``state`` in two safetensors shards in a temporary directory, with
    a config.json of ``cfg`` and golden-tiny's tokenizer.model."""
    import shutil
    import tempfile

    from generativeaiexamples_tpu_torch.models.safetensors import \
        save_sharded
    tmp = tempfile.mkdtemp(prefix="chip_smoke_q_")
    save_sharded(state, tmp, shards=2)
    shutil.copy(os.path.join(GOLDEN, "tokenizer.model"), tmp)
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"],
                   "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "rms_norm_eps": cfg.rms_norm_eps,
                   "torch_dtype": "float16"}, f)
    return tmp


def tokens_against_cpu(torch, engine, prompts, n_new: int, label: str):
    """The engine's greedy tokens against the same engine's on the CPU
    over the same leaves (the kernels' plain versions; for a GPTQ leaf
    the reference's ``_grouped_matmul``), both in bf16, prefix caches
    cold and one schedule (the budget pinned). Equal, or parted only
    where the CPU engine's own top-2 logits lie within ``QCKPT_TIE``
    (named). Returns the card's tokens."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import Engine

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.cpu()

    engine.clear_prefix_cache()
    got = greedy_tokens(engine, prompts, n_new)
    cpu = Engine(to_cpu(engine.params), engine.model_cfg, engine.tokenizer,
                 replace(engine.cfg, sched_round_budget_tokens=engine.stats[
                     "sched_round_budget_tokens"]), device="cpu")
    want = greedy_tokens(cpu, prompts, n_new)
    notes = []
    for p, a, b in zip(prompts, got, want):
        if a == b:
            continue
        k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = top2_gap(torch, cpu, p + b[:k])
        if gap >= QCKPT_TIE:
            fail(f"{label}: prompt of {len(p)}: card greedy tokens {a} part "
                 f"from the CPU engine's {b} at {k}, where the CPU's top-2 "
                 f"logit gap is {gap} (>= {QCKPT_TIE})")
        notes.append(f"prompt of {len(p)} parts at token {k}, a near tie "
                     f"(CPU top-2 gap {gap:.4f})")
    cpu.close()
    return got, notes


def check_quantized_formats(torch, dev, card: str) -> dict:
    """``serve_quantized_formats`` with the weight cache on, in a
    temporary directory of its own that is removed afterwards."""
    import shutil
    import tempfile

    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_wc_")
    try:
        with env_set(GAIE_WEIGHT_CACHE_DIR=cache_dir, GAIE_WEIGHT_CACHE="1"):
            return serve_quantized_formats(torch, dev, card)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def serve_quantized_formats(torch, dev, card: str) -> dict:
    """GPTQ and AWQ checkpoints at llama-2-7b's width cut to
    ``QCKPT_LAYERS`` layers, groups of 128, written by this script
    (``quantized_state``: GPTQ with random zero points) into two
    safetensors shards each, served through ``build_services(
    "llama-2-7b-chat", model_path=DIR)`` in bf16 with a cold weight
    cache. Each serves greedy
    tokens for three prompts through its int4 leaves on #3's tensor-core
    paths (GPTQ: every launch with zero points, "tc" and "wg" both),
    equal to the same engine's on the CPU (``tokens_against_cpu``). Then
    a second ``build_services`` of the GPTQ directory comes from the
    weight cache: every leaf bit-equal to the first build's, the load
    seconds both ways. Returns the GPTQ run's #3 launches by path."""
    import shutil
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import EngineConfig
    from generativeaiexamples_tpu_torch.models import weight_cache
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    from generativeaiexamples_tpu_torch.serving import model_server

    cfg = replace(LLAMA2_7B, num_layers=QCKPT_LAYERS)
    # Short buckets: the CPU engine prefills them too.
    ecfg = EngineConfig(max_slots=4, max_input_length=64,
                        max_output_length=16, prefill_buckets=(32, 64),
                        page_size=16, kv_pool_tokens=None, dtype="bfloat16")
    gptq_paths = None
    for fmt in ("gptq", "awq"):
        t0 = time.monotonic()
        d = write_hf_dir(cfg, quantized_state(torch, dev, cfg, fmt))
        write_s = time.monotonic() - t0
        try:
            engine, _ = model_server.build_services(
                "llama-2-7b-chat", model_path=d, engine_cfg=ecfg,
                device=dev)
            load = dict(model_server.last_load)
            if (engine.model_cfg != cfg or load["format"] != fmt
                    or load["from_cache"]):
                fail(f"{fmt}: build_services made {engine.model_cfg} "
                     f"from a {load['format']} load (from cache "
                     f"{load['from_cache']})")
            want = {"gptq": {"q4", "gscale", "gbias"},
                    "awq": {"q4", "gscale", "pre_scale"}}[fmt]
            if set(engine.params["layers"]["w_down"]) != want:
                fail(f"{fmt}: leaves "
                     f"{set(engine.params['layers']['w_down'])}")
            tok = engine.tokenizer
            prompts = [tok.encode(p) for p in GOLDEN_PROMPTS]
            zero_launch_counts()
            stats0 = engine.stats
            got, notes = tokens_against_cpu(
                torch, engine, prompts, 8, f"{fmt} checkpoint")
            # The CPU engine's calls count nothing: the card's run.
            run = read_launch_counts(engine, stats0)
            by_path = run["by_path"]
            if not (by_path["tc"] and by_path["wg"]) or by_path[
                    "gemv"] or by_path["tile"] or (
                    fmt == "gptq" and run["gbias"] != by_path["tc"]
                    + by_path["wg"]) or (fmt == "awq" and run["gbias"]):
                fail(f"{fmt}: #3 launches {by_path}, with zero points "
                     f"{run['gbias']}")
            say(f"{fmt}: llama-2-7b width, {QCKPT_LAYERS} layers, group "
                f"{QCKPT_GROUP}: written in {write_s:.1f} s; "
                f"build_services(model_path=...) loaded it in "
                f"{load['seconds']:.2f} s (cold cache) and served greedy "
                f"tokens of {len(prompts)} prompts equal to the CPU "
                f"engine's over the same leaves"
                f"{' (' + '; '.join(notes) + ')' if notes else ''}; #3 "
                f"launches {by_path}, {run['gbias']} with zero points "
                f"[{card}]")
            if fmt == "gptq":
                gptq_paths = dict(by_path)
                first = weight_cache.flatten(engine.params)
                cold_s = load["seconds"]
                engine.close()
                engine, _ = model_server.build_services(
                    "llama-2-7b-chat", model_path=d, engine_cfg=ecfg,
                    device=dev)
                load = dict(model_server.last_load)
                again = weight_cache.flatten(engine.params)
                if not load["from_cache"] or set(first) != set(again):
                    fail(f"gptq: the second build was not served from "
                         f"the weight cache: {load}")
                for name, t in first.items():
                    if (again[name].dtype != t.dtype
                            or not torch.equal(again[name], t)):
                        fail(f"gptq: cached leaf {name} differs from "
                             f"the converted one")
                n_bytes = sum(t.numel() * t.element_size()
                              for t in first.values())
                say(f"weight cache: the second build_services of the "
                    f"GPTQ directory read its {len(first)} leaves "
                    f"({n_bytes / 1e9:.3f} GB) back from the cache in "
                    f"{load['seconds']:.2f} s against {cold_s:.2f} s to "
                    f"convert (hash, load, cache write included), every "
                    f"leaf bit-equal (identity {load['identity']}) "
                    f"[{card}]")
                del first, again
            engine.close()
        finally:
            shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return gptq_paths


def check_nemo_load(torch, dev, card: str) -> None:
    """A ``.nemo`` archive of Nemotron-8B's width (V 256000, F 16384)
    cut to 2 layers: random bf16 weights from seed 0 with random
    layernorm1p offsets, fused into megatron naming (``query_key_value``
    per head group, ``dense_h_to_4h`` = W_up), saved with a
    model_config.yaml into a tar; served through ``build_services(
    "nemotron-8b-chat", model_path=DIR)``, which takes the depth from the
    archive's config. Its greedy tokens equal those of an engine over the
    same weights handed over as a numpy tree (``params_from_numpy``), and
    every leaf is bit-equal to that tree's."""
    import io
    import shutil
    import tarfile
    import tempfile
    from dataclasses import replace

    import numpy as np

    from generativeaiexamples_tpu_torch.engine import EngineConfig, Engine
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import NEMOTRON_8B
    from generativeaiexamples_tpu_torch.models.convert import \
        params_from_numpy
    from generativeaiexamples_tpu_torch.serving import model_server

    cfg = replace(NEMOTRON_8B, num_layers=2)
    p = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for lay in (p["layers"], p):
        for k in [k for k in lay if k.endswith(("_norm", "_norm_b"))]:
            lay[k] = (0.1 * torch.randn(lay[k].shape, generator=gen,
                                        device=dev)).to(torch.bfloat16)
    L, KV, hd, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, \
        cfg.hidden_size
    g = cfg.num_heads // KV
    P = "model.language_model."
    state = {}
    lay = p["layers"]
    for i in range(L):
        base = f"{P}encoder.layers.{i}."
        qkv = torch.cat([lay["wq"][i].T.reshape(KV, g * hd, D),
                         lay["wk"][i].T.reshape(KV, hd, D),
                         lay["wv"][i].T.reshape(KV, hd, D)], dim=1)
        state[base + "self_attention.query_key_value.weight"] = \
            qkv.reshape(-1, D)
        state[base + "self_attention.dense.weight"] = lay["wo"][i].T
        state[base + "mlp.dense_h_to_4h.weight"] = lay["w_up"][i].T
        state[base + "mlp.dense_4h_to_h.weight"] = lay["w_down"][i].T
        for ours, theirs in (("attn_norm", "input_layernorm"),
                             ("mlp_norm", "post_attention_layernorm")):
            state[f"{base}{theirs}.weight"] = lay[ours][i]
            state[f"{base}{theirs}.bias"] = lay[ours + "_b"][i]
    state[P + "embedding.word_embeddings.weight"] = p["embed"]
    state[P + "encoder.final_layernorm.weight"] = p["final_norm"]
    state[P + "encoder.final_layernorm.bias"] = p["final_norm_b"]
    state[P + "output_layer.weight"] = p["lm_head"].T
    state = {k: v.contiguous().cpu() for k, v in state.items()}
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nemo_")
    try:
        buf = io.BytesIO()
        torch.save(state, buf)
        del state
        yaml_text = (f"num_layers: {L}\nhidden_size: {D}\n"
                     f"ffn_hidden_size: {cfg.intermediate_size}\n"
                     f"num_attention_heads: {cfg.num_heads}\n"
                     f"num_query_groups: {KV}\n"
                     f"max_position_embeddings: "
                     f"{cfg.max_position_embeddings}\n"
                     f"normalization: layernorm1p\n"
                     f"activation: squared-relu\n"
                     f"tokenizer:\n  library: sentencepiece\n")
        n_bytes = buf.tell()
        with tarfile.open(os.path.join(tmp, "nemotron.nemo"), "w") as tar:
            info = tarfile.TarInfo("model_config.yaml")
            info.size = len(yaml_text.encode())
            tar.addfile(info, io.BytesIO(yaml_text.encode()))
            info = tarfile.TarInfo("model_weights.ckpt")
            info.size = n_bytes
            buf.seek(0)
            tar.addfile(info, buf)
        del buf
        write_s = time.monotonic() - t0
        ecfg = EngineConfig(max_slots=4, max_input_length=256,
                            max_output_length=32, prefill_buckets=(128, 256),
                            kv_pool_tokens=None, dtype="bfloat16")
        tok = CodepointTokenizer(cfg.vocab_size)
        with env_set(GAIE_WEIGHT_CACHE="0"):     # nothing to cache here
            engine, _ = model_server.build_services(
                "nemotron-8b-chat", model_path=tmp, engine_cfg=ecfg,
                device=dev, tokenizer=tok)
        load = dict(model_server.last_load)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if engine.model_cfg != cfg or load["format"] != "nemo":
        fail(f"nemo: build_services made {engine.model_cfg} from "
             f"{load['format']}")
    t1 = time.monotonic()
    tree = {k: ({n: np.asarray(t.float().cpu()) for n, t in v.items()}
                if isinstance(v, dict) else np.asarray(v.float().cpu()))
            for k, v in p.items()}
    del p
    ref = params_from_numpy(tree, dev, torch.bfloat16, cfg=cfg)
    numpy_s = time.monotonic() - t1
    del tree
    loaded = llama_leaves(engine.params)
    for name, t in llama_leaves(ref).items():
        got = loaded[name]
        if got.dtype != t.dtype or not torch.equal(got, t):
            fail(f"nemo: loaded leaf {name} differs from the numpy tree's")
    prompts = [tok.encode(x) for x in SERVE_PROMPTS[:3]]
    got = greedy_tokens(engine, prompts, 12)
    engine.close()
    other = Engine(ref, cfg, tok, ecfg, device=dev)
    want = greedy_tokens(other, prompts, 12)
    other.close()
    del ref
    if got != want:
        fail(f"nemo: the archive's engine gave {got}, the numpy tree's "
             f"{want}")
    say(f"nemo: Nemotron-8B width (V {cfg.vocab_size}, F "
        f"{cfg.intermediate_size}) cut to {L} layers, {n_bytes / 1e9:.3f} GB "
        f"of bf16 megatron tensors: archive written in {write_s:.1f} s, "
        f"build_services(model_path=...) read and placed it in "
        f"{load['seconds']:.2f} s (numpy tree {numpy_s:.1f} s); every leaf "
        f"bit-equal to the numpy tree's and greedy tokens of "
        f"{len(prompts)} prompts equal [{card}]")
    torch.cuda.empty_cache()


def llama_leaves(params) -> dict:
    """Every tensor of a parameter tree by ``/``-joined name."""
    from generativeaiexamples_tpu_torch.models.weight_cache import flatten
    return flatten(params)


# ----------------------------------- the second and third families' phases

# Mixtral-8x7B's depth served on one 80 GB card. One layer is 2.90 GB in
# bf16 (1,451,270,144 parameters, the 8 experts 1,409,286,144 of them);
# 32 layers plus the embedding and head are 93.4 GB. 24 layers (70.2 GB)
# leave room for the KV pool, the captured programs' memory pool and an
# eager comparison engine.
MIXTRAL_LAYERS = 24
# Bound of sparse_moe_ffn against the dense all-experts oracle in bf16 at
# full width, relative to max|dense|: both sum the same bf16 products in
# fp32 within each expert, then round the expert's output to bf16 before
# the gate weights (dense: summed over all 8 experts in bf16 by einsum),
# so they part by a few bf16 ulps of the largest output (2^-8 each).
MOE_BF16_RTOL = 2e-2


def host_memory_gb() -> tuple:
    """(total, available) host memory in GB, from /proc/meminfo."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            info[key] = int(rest.split()[0]) * 1024
    return info["MemTotal"] / 1e9, info["MemAvailable"] / 1e9


def tree_to(tree, device, memo=None):
    """``tree`` copied to ``device``, a tensor shared by two trees (the
    raw leaves quantization leaves alone) copied once and shared again."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: tree_to(v, device, memo) for k, v in tree.items()}
    if id(tree) not in memo:
        memo[id(tree)] = tree.to(device)
    return memo[id(tree)]


class FamilyReference:
    """A model family's 2-layer check and its CPU reference: ``cfg``'s
    full width (Nemotron-8B: V 256000, F 16384, layernorm1p,
    squared-ReLU; Mixtral-8x7B: 8 experts, top-2, H 32 / KV 8) cut to 2
    layers, float32 weights from seed 0 on the card with random norm
    weights (0.1 N(0, 1) about each norm's identity: 0 for layernorm1p's
    weights and offsets, 1 for rmsnorm's), TF32 off; as made (float32 KV)
    and quantized on the card to int4_awq (group 128; Mixtral's experts
    and router stay float32) over an int8 KV pool. Both trees go to the
    host, sharing the leaves quantization left raw, and leave the card;
    greedy tokens of prompts of 40, 125 and 300 tokens (plus bos), 8 new
    each, from the engine on the CPU with the same parameters (the
    kernels' plain versions), in a thread from the start, as
    ``QuantReference``."""

    N_NEW = 8

    def __init__(self, torch, dev, cfg):
        import threading
        from dataclasses import replace

        from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
        from generativeaiexamples_tpu_torch.models import llama
        from generativeaiexamples_tpu_torch.ops.quant import quantize_params

        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = replace(cfg, num_layers=2)
        raw = llama.init_params(self.cfg, seed=0, dtype=torch.float32,
                                device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        for lay in (raw["layers"], raw):
            for k in [k for k in lay if k.endswith(("_norm", "_norm_b"))]:
                unit = cfg.norm == "rmsnorm"
                lay[k] = unit + 0.1 * torch.randn(lay[k].shape, generator=gen,
                                                  device=dev)
        card = {"f32": raw,
                "int4": quantize_params(raw, "int4_awq", group_size=128)}
        self.cpu = tree_to(card, "cpu")
        del card, raw
        torch.cuda.empty_cache()
        self.ecfg = {q: EngineConfig(
            max_slots=4, max_input_length=512, max_output_length=16,
            prefill_buckets=(128, 512), dtype="float32", kv_pool_tokens=None,
            kv_quant="int8" if q == "int4" else "",
            sched_round_budget_tokens=4096) for q in self.cpu}
        self.prompts = [[1] + [3 + (7 * i + j) % 256 for i in range(n)]
                        for j, n in ((0, 40), (1, 125), (2, 300))]
        self._box: dict = {}
        self.t0 = time.monotonic()

        def run():
            try:
                for q, p in self.cpu.items():
                    self._box[q] = greedy_tokens(
                        Engine(p, self.cfg, CodepointTokenizer(
                            self.cfg.vocab_size), self.ecfg[q],
                               device="cpu"), self.prompts, self.N_NEW)
            except BaseException as exc:  # noqa: BLE001 - re-raised on join
                self._box["error"] = exc
            self._box["seconds"] = time.monotonic() - self.t0

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def cpu_tokens(self, q: str):
        self._thread.join()
        if "error" in self._box:
            fail(f"the CPU reference failed: {self._box['error']!r}")
        return self._box[q], self._box["seconds"]


def check_family_model(torch, dev, ref: FamilyReference, label: str) -> None:
    """``ref``'s model on the card: for each of its two modes, the captured
    engine's and an eager engine's greedy tokens equal the CPU engine's;
    the kernels ran on every decode layer (#1 or #2) and, under int4 with
    float32 activations, #3's "gemv" on the int4 projections (6 a layer
    for GPT-Next, Mixtral's 4 attention ones) per decode step plus the
    head tiles and "tile" on them per prefill program. For an MoE family
    then ``check_moe_routing`` on the float32 tree. The trees leave the
    card at the end."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import Engine

    L = ref.cfg.num_layers
    memo: dict = {}
    for q, cpu_params in ref.cpu.items():
        t0 = time.monotonic()
        params = tree_to(cpu_params, dev, memo)
        per_layer = sum(isinstance(v, dict)
                        for v in params["layers"].values())
        tok = CodepointTokenizer(ref.cfg.vocab_size)
        engine = Engine(params, ref.cfg, tok, ref.ecfg[q], device=dev)
        zero_launch_counts()
        stats0 = engine.stats
        got = greedy_tokens(engine, ref.prompts, ref.N_NEW)
        run = read_launch_counts(engine, stats0)
        n_tiles = head_tiles(engine)
        engine.close()
        steps, dispatches = run["decode_steps"], run["prefill_dispatches"]
        attn = ("paged_attention_decode_int8" if q == "int4"
                else "paged_attention_decode")
        want_path = ({"tc": 0, "gemv": (per_layer * L + n_tiles) * steps
                      + run["prefills"], "tile": per_layer * L * dispatches,
                      "wg": 0} if q == "int4"
                     else dict.fromkeys(run["by_path"], 0))
        if (run["launches"][attn] != L * steps or run["by_path"] != want_path
                or (q == "int4") != (per_layer > 0)):
            fail(f"{label} [{q}]: launches {run['launches']}, #3 "
                 f"{run['by_path']} over {steps} steps ({per_layer} int4 "
                 f"leaves a layer); expected {attn} {L * steps}, #3 "
                 f"{want_path}")
        eager = Engine(params, ref.cfg, tok, replace(ref.ecfg[q],
                                                     cuda_graphs=False),
                       device=dev)
        e_got = greedy_tokens(eager, ref.prompts, ref.N_NEW)
        eager.close()
        if e_got != got:
            fail(f"{label} [{q}]: captured programs gave {got}, the eager "
                 f"engine {e_got}")
        t_card = time.monotonic() - t0
        want, t_cpu = ref.cpu_tokens(q)
        for p, a, b in zip(ref.prompts, got, want):
            if len(a) != ref.N_NEW or a != b:
                fail(f"{label} [{q}]: card greedy tokens {a} differ from "
                     f"the CPU engine's {b} (prompt of {len(p)})")
        say(f"model check: 2-layer {label}, float32 "
            f"{'int4_awq weights + int8 KV' if q == 'int4' else 'weights'}: "
            f"captured and eager card engines' greedy tokens equal the CPU "
            f"engine's for prompts of {[len(p) for p in ref.prompts]} tokens "
            f"(launches {run['launches']}, #3 {run['by_path']}; card "
            f"{t_card:.1f} s, CPU {t_cpu:.1f} s from the start, in a thread)")
    if ref.cfg.num_experts:
        check_moe_routing(torch, dev, tree_to(ref.cpu["f32"], dev, memo),
                          ref.cfg)
    del ref.cpu, memo, params
    free_memory(torch)


def check_moe_routing(torch, dev, params, cfg) -> None:
    """The MoE layer's routing and its sparse form on the card at full
    width: ``route_topk`` on the card and on the CPU gives identical
    expert, slot and keep (weights within 1e-6) for the same float32
    logits, at T = 8 (the decode step's slots; capacity 4) and T = 1024
    (the largest prefill bucket; capacity 512), with an all-zero row and
    a repeated row among them (ties); and ``sparse_moe_ffn`` with a
    capacity factor of E / k (C = T: nothing can drop) equals the dense
    all-experts oracle (``moe_impl="dense"``) on layer 0's weights in
    bf16 within ``MOE_BF16_RTOL`` of max|dense|, on every row whose bf16
    and float32 router logits pick the same experts (at least 95%)."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.parallel.moe import (expert_capacity,
                                                             route_topk)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    gen = torch.Generator(device=dev).manual_seed(4)
    for T in (8, 1024):
        logits = torch.randn((T, E), generator=gen, device=dev)
        logits[1] = 0.0
        logits[3] = logits[2]
        C = expert_capacity(T, E, k, cfg.moe_capacity_factor)
        got = route_topk(logits, k, C)
        want = route_topk(logits.cpu(), k, C)
        for name, g, w in zip(("expert", "slot", "weight", "keep"), got,
                              want):
            g = g.cpu()
            same = (torch.allclose(g, w, atol=1e-6, rtol=0)
                    if name == "weight" else torch.equal(g, w))
            if not same:
                fail(f"route_topk T={T}: the card's {name} differs from the "
                     f"CPU's")
        say(f"moe routing T={T} (capacity {C}): card = CPU for expert, slot "
            f"and keep; {int((~got[3]).sum())} of {T * k} claims dropped")
    lay = llama.layer_params(params, 0)
    lp = {key: lay[key].to(torch.bfloat16)
          for key in ("router", "w_gate", "w_up", "w_down")}
    roomy = replace(cfg, moe_capacity_factor=E / k)
    for T in (8, 1024):
        x = torch.randn((1, T, cfg.hidden_size), generator=gen,
                        device=dev).to(torch.bfloat16)
        sparse = llama._moe_mlp(x, lp, roomy).float()[0]
        dense = llama._moe_mlp(x, lp, replace(roomy, moe_impl="dense"))
        dense = dense.float()[0]
        # The dense oracle routes on bf16 logits (the activations' dtype),
        # the sparse path on float32 ones, as in the reference: a row whose
        # two logits are within a bf16 rounding of each other may take
        # another expert in each. Such rows are counted and left out.
        pick = [torch.sort(lg, dim=-1, descending=True,
                           stable=True)[1][:, :k].sort(dim=-1)[0]
                for lg in (x[0].float() @ lp["router"].float(),
                           x[0] @ lp["router"])]
        same = (pick[0] == pick[1]).all(dim=-1)
        peak = dense.abs().max().item()
        err = (sparse - dense)[same].abs().max().item()
        if not (torch.isfinite(sparse).all() and err <= MOE_BF16_RTOL * peak
                and int(same.sum()) >= 0.95 * T):
            fail(f"sparse_moe_ffn T={T} parts from the dense oracle in bf16: "
                 f"max abs err {err} over the {int(same.sum())} of {T} rows "
                 f"that both route alike (max|dense| {peak}, bound "
                 f"{MOE_BF16_RTOL} x)")
        say(f"moe sparse = dense T={T} bf16 (capacity factor {E / k:g}, no "
            f"drop): max abs err {err} = {err / peak:.2e} x max|dense| "
            f"{peak} (bound {MOE_BF16_RTOL}) over {int(same.sum())} of {T} "
            f"rows; {T - int(same.sum())} rows route apart (bf16 against "
            f"float32 router logits)")


@contextlib.contextmanager
def served_depth(name: str, layers: Optional[int]):
    """Registry model ``name`` cut to ``layers`` layers (None: its full
    depth) while the block runs (``build_services`` reads the registry);
    yields the full-depth config."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.models import configs
    full = configs.MODEL_REGISTRY[name]
    if layers is not None:
        configs.MODEL_REGISTRY[name] = replace(full, num_layers=layers)
    try:
        yield full
    finally:
        configs.MODEL_REGISTRY[name] = full


def fresh_slot_state(torch, engine) -> None:
    """Put an idle engine's slot order and its slots' last tokens back to
    construction state. Under MoE a request's tokens depend on the slots
    beside it: every decode step routes all ``max_slots`` rows, an idle
    slot's row (its last token at position 0) claims expert capacity too,
    and rows claim in slot order (the reference's semantics, which the
    port keeps). Two runs of a request compared with each other start
    from one slot history: this one, a fresh engine's."""
    if engine.stats["active_slots"]:
        fail("fresh_slot_state needs an idle engine")
    engine._free_slots[:] = range(engine.cfg.max_slots)
    engine._state["last_token"].zero_()
    torch.cuda.synchronize()


def moe_share(torch, engine, step_ms: float) -> dict:
    """Device time of one decode step's MoE layers: ``_moe_mlp`` on 8
    rows (the decode step's slots, bf16) of each layer's weights in turn
    (so each call reads its experts cold), CUDA-graph replay; its byte
    bound (the router and all 8 experts' weights, which every decode step
    streams: each expert holds a capacity buffer); and the share of the
    host-clock step ``step_ms`` the layers take."""
    from generativeaiexamples_tpu_torch.models import llama
    cfg, L = engine.model_cfg, engine.model_cfg.num_layers
    gen = torch.Generator(device=engine.device).manual_seed(5)
    x = torch.randn((8, 1, cfg.hidden_size), generator=gen,
                    device=engine.device).to(torch.bfloat16)
    layers = [llama.layer_params(engine.params, i) for i in range(L)]
    ms = time_cuda(torch, [(lambda lp=lp: llama._moe_mlp(x, lp, cfg))
                           for lp in layers], iters=2 * L, warmup=L)
    nbytes = sum(layers[0][k].numel() * layers[0][k].element_size()
                 for k in ("router", "w_gate", "w_up", "w_down"))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"moe_ms": ms, "moe_bound_ms": bound, "moe_bytes": nbytes,
            "moe_share": L * ms / step_ms}


def serve_family(torch, dev, card: str, name: str, quantization: str = "",
                 kv_quant: str = "", layers: Optional[int] = None) -> dict:
    """A second family's main path: registry model ``name`` at full width
    (nemotron-8b-chat, GPT-Next with V 256000, at full depth;
    mixtral-8x7b-instruct, sparse MoE with G = 4, cut to ``layers``), bf16
    random weights made on the card from seed 0 (quantized there to
    ``quantization``; Mixtral's experts and router stay bf16), over a
    ``kv_quant`` pool, 8 slots, page 128, buckets to 1024, through
    ``build_services`` and the port's aiohttp app, with the codepoint
    tokenizer (random weights sample ids past the bytes). Counted window:
    the serve prompts as concurrent greedy /v1/completions, an ignore_eos
    request and the chat requests (``serve_chat``, from
    ``fresh_slot_state``); #1 or #2 L times a decode step, under int4 #3
    "tc" (P L + head tiles) a step plus each admission's head row and
    "wg" P L a prefill program (P the layer's int4 projections: 6 for
    GPT-Next, Mixtral's 4 attention ones). After it ``check_chat_texts``;
    the decode step (8 slots at ~560 tokens, host clock at dispatch depth
    2) beside the bytes it streams and their bound, for MoE the MoE
    layers' share of it (``moe_share``), and a 1024-token prefill; then
    the served engine's greedy tokens (prefix cache cleared) equal an
    eager engine's and an eager engine's with the materialized tail (the
    whole (8, V) logits), all three planning one schedule from one slot
    history (the served budget and chunk cap; under MoE the budget held
    at 4096). Every engine is closed at the end. Returns the window's
    launch counts."""
    from concurrent.futures import ThreadPoolExecutor
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.serving.model_server import (
        build_services, create_server_app)
    from generativeaiexamples_tpu_torch.tools.profile_decode import (
        measure_decode, measure_prefill)

    t0 = time.monotonic()
    mode = (f"{name.split('-')[0]} {quantization or 'bf16'} weights, "
            f"{kv_quant or 'bf16'} KV")
    ecfg = EngineConfig(max_slots=8, max_input_length=1024,
                        max_output_length=64, prefill_buckets=(128, 512, 1024),
                        page_size=128, kv_pool_tokens=8 * (1024 + 64),
                        dtype="bfloat16", kv_quant=kv_quant)
    with served_depth(name, layers) as full:
        engine, name = build_services(
            name, engine_cfg=ecfg, seed=0, device=dev,
            quantization=quantization,
            tokenizer=CodepointTokenizer(full.vocab_size))
    mcfg = engine.model_cfg
    if mcfg != replace(full, num_layers=layers or full.num_layers):
        fail(f"{name} is {mcfg}")
    built = time.monotonic() - t0
    engine.prewarm()
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size()
                  for t in llama.param_tensors(engine.params))
    per_layer = sum(isinstance(v, dict)
                    for v in engine.params["layers"].values())
    moe = (f" E={mcfg.num_experts} k={mcfg.num_experts_per_tok}"
           if mcfg.num_experts else "")
    say(f"serve [{mode}]: {name} at full width, L={mcfg.num_layers} of "
        f"{full.num_layers} D={mcfg.hidden_size} "
        f"F={mcfg.intermediate_size}{moe} H={mcfg.num_heads} "
        f"KV={mcfg.num_kv_heads} V={mcfg.vocab_size} {mcfg.norm}/"
        f"{mcfg.mlp}, {n_bytes / 1e9:.2f} GB of weights ({per_layer} int4 "
        f"leaves a layer), {engine._param_bytes / 1e9:.2f} GB streamed a "
        f"step, pool {engine.stats['pool_pages']} pages; built in "
        f"{built:.1f} s, prewarmed in {time.monotonic() - t0 - built:.1f} s; "
        f"card memory {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    base, stop_server = serve_app(create_server_app(engine,
                                                    model_name=name))
    try:
        bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0,
                   "stream": i == 1} for i, p in enumerate(SERVE_PROMPTS)]
        post(base + "/v1/completions", {"prompt": "warm", "max_tokens": 2,
                                        "temperature": 0})
        stats0 = engine.stats
        tok0 = stats0["tokens_generated"]
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
        wait_idle(engine)
        fresh_slot_state(torch, engine)   # as the chat checks' reruns
        chat = serve_chat(base, engine, mode, card)
        torch.cuda.synchronize()
        run = read_launch_counts(engine, stats0)
    finally:
        stop_server()
        engine.stop()
    for i, raw in enumerate(outs):
        if bodies[i]["stream"]:
            events = [ln[6:] for ln in raw.splitlines()
                      if ln.startswith("data: ")]
            if not events or events[-1] != "[DONE]":
                fail(f"[{mode}] request {i}: SSE stream did not end")
        elif not 1 <= json.loads(raw)["usage"]["completion_tokens"] <= 32:
            fail(f"[{mode}] request {i}: {raw[:200]}")
    if len(stream.token_ids) != 32 or not all(
            0 <= t < mcfg.vocab_size for t in stream.token_ids):
        fail(f"[{mode}] ignore_eos request gave {stream.token_ids}")
    check_launch_counts(f"[{mode}]", run, mcfg.num_layers, quantization,
                        kv_quant, head_tiles(engine), per_layer=per_layer)
    fresh_slot_state(torch, engine)
    check_chat_texts(engine, chat, mode)
    decode_s = stream.finish_time - stream.first_token_time
    say(f"serve [{mode}]: {len(bodies)} concurrent /v1/completions in "
        f"{wall:.3f} s, {tokens_http} tokens ({tokens_http / wall:.1f} tok/s "
        f"aggregate); single ignore_eos request: TTFT {stream.ttft_ms:.1f} "
        f"ms, decode {31 / decode_s:.1f} tok/s; launches {run['launches']} "
        f"(int4 by path {run['by_path']}) over {run['decode_steps']} decode "
        f"steps and {run['prefills']} prefills [{card}]")
    # The step (and the MoE layers' share), untraced; a 1024-token prefill.
    dec = measure_decode(engine, 8, 512, rounds=4, dispatch_depth=2,
                         traced=False)
    share = ""
    if mcfg.num_experts:
        m = moe_share(torch, engine, dec["step_ms"])
        share = (f"; MoE layer (8 rows, bf16 experts, L2-cold) "
                 f"{m['moe_ms']:.4f} ms against its {m['moe_bound_ms']:.4f} "
                 f"ms byte bound ({m['moe_bytes']} bytes), x "
                 f"{mcfg.num_layers} = {m['moe_share']:.1%} of the step")
    with engine.pinned_round_budget(1024):    # one program, not chunks
        pre = measure_prefill(engine, 1024, rounds=2, traced=False)
    say(f"serve [{mode}]: decode step {dec['step_ms']:.3f} ms (8 slots at "
        f"~{dec['context']} tokens, host clock, dispatch depth 2), "
        f"{dec['step_bytes']} bytes a step, byte bound "
        f"{dec['step_bound_ms']:.3f} ms "
        f"({dec['step_bound_ms'] / dec['step_ms']:.1%} of it){share}; "
        f"prefill of a 1024-token bucket {pre['prefill_ms']:.3f} ms [{card}]")
    # Captured = eager = materialized tail, one schedule from one slot
    # history (``fresh_slot_state``). The served engine's planner carries
    # state from its traffic (the scarcity rotation); under MoE a
    # different schedule is a different result (rows compete for expert
    # capacity, and a chunk's padding rows claim slots), so there the
    # budget is held at 4096, where no rotation occurs.
    ids = [engine.tokenizer.encode(p) for p in SERVE_PROMPTS]
    sp = SamplingParams(max_tokens=16, temperature=0, ignore_eos=True)
    engine.clear_prefix_cache()
    fresh_slot_state(torch, engine)
    chunk = engine._sched.chunk_tokens
    runs = {}
    with engine.pinned_round_budget(
            4096 if mcfg.num_experts else None) as budget:
        for label, kw in (("graphs", None),
                          ("eager", {"cuda_graphs": False}),
                          ("materialized", {"cuda_graphs": False,
                                            "fused_tail": False})):
            eng = engine if kw is None else Engine(
                engine.params, mcfg, engine.tokenizer,
                replace(engine.cfg, sched_round_budget_tokens=budget,
                        sched_prefill_chunk_tokens=chunk, **kw),
                device=dev)
            chunks0 = eng.stats["prefill_chunks"]
            streams = [eng.submit(i, sp) for i in ids]
            for _ in range(100):
                if all(s.finish_reason is not None for s in streams):
                    break
                eng._step()
            runs[label] = ([s.token_ids for s in streams],
                           eng.stats["prefill_chunks"] - chunks0)
            if eng is not engine:
                eng.close()
    for other in ("eager", "materialized"):
        for i, (a, b) in enumerate(zip(runs["graphs"][0], runs[other][0])):
            if a != b or len(a) != 16:
                k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                fail(f"[{mode}] prompt {i}: the captured programs' greedy "
                     f"tokens {a} part from the {other} engine's {b} at {k} "
                     f"(top-2 logit gap "
                     f"{top2_gap(torch, engine, ids[i] + a[:k])}; chunk "
                     f"programs {runs['graphs'][1]} against "
                     f"{runs[other][1]}, budget {budget})")
    say(f"serve [{mode}]: greedy tokens of the {len(ids)} serve prompts "
        f"equal: captured programs, eager engine, eager engine with the "
        f"materialized tail over V={mcfg.vocab_size} "
        f"({time.monotonic() - t0:.1f} s in the phase) [{card}]")
    engine.close()
    free_memory(torch)
    return {"launches": run["launches"], "by_path": run["by_path"]}


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

    from generativeaiexamples_tpu_torch.frontend.chat_client import (
        multipart_body)
    data, ctype = multipart_body(path)
    req = urllib.request.Request(base + "/uploadDocument", data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        fail(f"/uploadDocument of {path} answered {exc.code}: "
             f"{exc.read().decode()[:300]}")


def stream_generate(base: str, body: dict, rid: str,
                    path: str = "/generate") -> tuple:
    """(seconds to the first byte, text, seconds to the end) of a streamed
    POST to ``base + path``: the chain server's /generate, or the
    frontend's /api/generate."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(base + path,
                                 data=json.dumps(body).encode(), headers={
                                     "Content-Type": "application/json",
                                     "X-Request-ID": rid})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            first = resp.read(1)
            ttfb = time.monotonic() - t0
            text = (first + resp.read()).decode()
            total = time.monotonic() - t0
    except urllib.error.HTTPError as exc:
        fail(f"{path} answered {exc.code}: {exc.read().decode()[:300]}")
    return ttfb, text, total


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
        ttfb, _, _ = stream_generate(base, {
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
        ttfb, _, _ = stream_generate(base, {
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


def serve_rag(torch, dev, card: str, served: list, then=None) -> dict:
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
    ``then``, when given, is called at the end of each mode with what the
    mode holds (``serve_periphery``'s argument). Returns the launch
    counts by mode."""
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
    index, out, upload_run = None, {}, None
    for i_mode, (engine0, quantization) in enumerate(served):
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
                upload_run = (len(index), ingest_s)
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
                    _, text, _ = stream_generate(rbase, {
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
            if then is not None:
                then({"engine": engine, "svc": svc, "index": index,
                      "cfg": cfg, "base": base, "texts": texts,
                      "mode": mode, "quantization": quantization,
                      "first": i_mode == 0,
                      "last": i_mode == len(served) - 1,
                      "upload": upload_run})
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


# The application periphery (``serve_periphery``), inside each mode's RAG
# window on its engine, embedder, store and chain server.
PERIPHERY_PROMPT = ("Question: what does the paged KV pool of a serving "
                    "engine hold, and why is it paged? Answer:")
PERIPHERY_NEW = 64
ASSISTANT_QUESTION = "What does the fused admission program run?"
DECK_SLIDES = [
    ("Fused admission", "The fused admission program runs retrieval, "
     "prompt assembly and prefill as one captured program on the card.",
     "Say that the corpus lives in static device buffers."),
    ("Paged KV pool", "The pool holds the keys and values of every slot "
     "in pages of 128 tokens.", ""),
]
MEMO_LINES = ["Kernel memo: the split-K pass writes partial sums into a "
              "float32 scratch, and the merge pass adds them.",
              "The int4 matmul takes the tc path at small M."]


def office_files(dirpath: str) -> tuple:
    """(deck.pptx, memo.docx) in ``dirpath``, built with zipfile: two
    slides with text runs, speaker notes on the first (through its
    relationship file) and an image; a memo of two paragraphs."""
    import zipfile
    a = "http://schemas.openxmlformats.org/drawingml/2006/main"
    rel = ("http://schemas.openxmlformats.org/officeDocument/2006/"
           "relationships/")
    deck = os.path.join(dirpath, "deck.pptx")
    with zipfile.ZipFile(deck, "w") as z:
        for i, (title, body, notes) in enumerate(DECK_SLIDES, 1):
            z.writestr(f"ppt/slides/slide{i}.xml",
                       f'<p:sld xmlns:p="p" xmlns:a="{a}"><a:t>{title}</a:t>'
                       f'<a:t>{body}</a:t></p:sld>')
            targets = [("image", f"../media/image{i}.png")]
            if notes:
                z.writestr(f"ppt/notesSlides/notesSlide{i}.xml",
                           f'<p:notes xmlns:p="p" xmlns:a="{a}"><a:t>'
                           f'{notes}</a:t></p:notes>')
                targets.append(("notesSlide",
                                f"../notesSlides/notesSlide{i}.xml"))
            z.writestr(f"ppt/slides/_rels/slide{i}.xml.rels", (
                '<Relationships xmlns="http://schemas.openxmlformats.org/'
                'package/2006/relationships">' + "".join(
                    f'<Relationship Id="rId{j}" Type="{rel}{kind}" '
                    f'Target="{t}"/>' for j, (kind, t) in enumerate(targets))
                + "</Relationships>"))
            z.writestr(f"ppt/media/image{i}.png", b"\x89PNG" + bytes(16))
    memo = os.path.join(dirpath, "memo.docx")
    w = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
    with zipfile.ZipFile(memo, "w") as z:
        z.writestr("word/document.xml", f'<w:document xmlns:w="{w}"><w:body>'
                   + "".join(f"<w:p><w:r><w:t>{line}</w:t></w:r></w:p>"
                             for line in MEMO_LINES) + "</w:body></w:document>")
    return deck, memo


def timed_text(pieces) -> tuple:
    """(text, ms to the first piece, ms to the end) of an iterator of
    text pieces, timed from the call that makes it."""
    t0 = time.monotonic()
    first, parts = None, []
    for piece in pieces():
        if first is None and piece:
            first = time.monotonic()
        parts.append(piece)
    end = time.monotonic()
    return ("".join(parts), ((first or end) - t0) * 1e3, (end - t0) * 1e3)


def completion_pieces(base: str, body: dict):
    """The text deltas of a streamed /v1/completions."""
    from generativeaiexamples_tpu_torch.serving.client import (
        iter_sse_data, post_with_retry)
    with post_with_retry(base + "/v1/completions", {**body, "stream": True},
                         timeout=300) as resp:
        for data in iter_sse_data(resp):
            if data == "[DONE]":
                return
            yield json.loads(data)["choices"][0].get("text") or ""


def check_same_index(svc, want_index, got_index, questions) -> None:
    """Two indexes of the same corpus: the same chunk texts under the same
    ids, and the same top-4 ids for each question, or near-ties: the
    first index's exact scores of the two id lists within the bf16
    rounding bound position by position (named)."""
    import numpy as np

    ids = sorted(want_index._docs)
    if ids != sorted(got_index._docs) or any(
            want_index.get(i).text != got_index.get(i).text for i in ids):
        fail("the ingest pipeline's chunks differ from /uploadDocument's")
    a = want_index.store._data[:want_index.store._n]
    b = got_index.store._data[:got_index.store._n]
    err = float(abs(a - b).max())
    for q in questions:
        got = [d.id for d in got_index.similarity_search(q, k=4)]
        want = [d.id for d in want_index.similarity_search(q, k=4)]
        if got == want:
            continue
        vec = np.asarray(svc.embed_query(q), np.float32)
        exact = a @ vec
        gap = max(abs(exact[x] - exact[y]) for x, y in zip(got, want))
        bound = 2.0 ** -8 * float(np.linalg.norm(vec)) * float(
            np.linalg.norm(a, axis=1).max())
        say(f"ingest: {q!r}: ids {got} against {want}: near-ties, exact "
            f"scores apart by at most {gap:.3g} position by position "
            f"(bf16 bound {bound:.3g})")
        if len(got) != 4 or gap > bound:
            fail(f"ingest: top-4 ids {got} for {q!r}, /uploadDocument's "
                 f"index {want}")
    say(f"ingest: {len(ids)} chunks, texts and ids equal to "
        f"/uploadDocument's; stored vectors within {err:.3g}; top-4 ids of "
        f"{len(questions)} questions equal (or named near-ties)")


def serve_periphery(torch, dev, card: str, rag: dict) -> dict:
    """The application periphery over one mode's RAG engine (``rag``:
    what ``serve_rag`` holds for the mode: engine, embedder, index,
    config, chain server, its cold /generate texts, the upload rate).
    The model server (with the Triton and job routes) and the gRPC
    service on the engine: one greedy 64-token prompt through Triton
    generate and generate_stream, /v1/jobs (one 200 or 202, and one 202
    then polls on a jobs app without a grace period), gRPC unary and
    stream, ``TorchLLM`` over gRPC and HTTP and ``TorchLlamaIndexLLM``,
    each text equal to /v1/completions'; the web frontend in front of
    the chain server (/api/generate = /generate, /api/search =
    /documentSearch; in the last mode a .pptx and a .docx through
    /api/upload, each then found); the multimodal assistant through the
    chain server's ``--example`` path (a deck uploaded, one greedy
    answer equal to the engine's for the prompt it assembled, then the
    fact check); in the first mode the ingest pipeline over docs/*.md
    into a fresh ``exact-cuda`` store against the /uploadDocument index.
    Every request runs in its own launch-count window (the prefix cache
    cleared before it), checked by the serve phases' formula. Prints
    each front end's first byte and total ms. Returns the launch
    counts."""
    import shutil
    import tempfile

    from aiohttp import web

    from generativeaiexamples_tpu_torch.assistant.guardrails import \
        fact_check
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.chains.readers import read_document
    from generativeaiexamples_tpu_torch.chains.server import (
        create_app, discover_example)
    from generativeaiexamples_tpu_torch.chains.splitter import (
        TokenTextSplitter, cap_context)
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    from generativeaiexamples_tpu_torch.frontend.chat_client import (
        ChatClient, multipart_body)
    from generativeaiexamples_tpu_torch.frontend.server import \
        create_app as frontend_app
    from generativeaiexamples_tpu_torch.ingest import (FilesystemSource,
                                                       IngestPipeline)
    from generativeaiexamples_tpu_torch.integrations.langchain_torch import \
        TorchLLM
    from generativeaiexamples_tpu_torch.integrations.llamaindex_torch import \
        TorchLlamaIndexLLM
    from generativeaiexamples_tpu_torch.retrieval.docstore import \
        DocumentIndex
    from generativeaiexamples_tpu_torch.retrieval.store import \
        store_from_config
    from generativeaiexamples_tpu_torch.serving import jobs_api
    from generativeaiexamples_tpu_torch.serving.client import (
        JobsClient, TritonShimClient, post_with_retry)
    from generativeaiexamples_tpu_torch.serving.model_server import \
        create_server_app
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict
    from generativeaiexamples_tpu_torch.utils.errors import ConfigError

    engine, svc, mode = rag["engine"], rag["svc"], rag["mode"]
    quantization, name = rag["quantization"], "llama-2-7b-chat"
    total = {"launches": {}, "by_path": {}}

    def counted(label: str, fn):
        """``fn()`` in a launch-count window of its own, the prefix cache
        cleared before it."""
        engine.stop()
        engine.clear_prefix_cache()
        torch.cuda.synchronize()
        stats0 = engine.stats
        zero_launch_counts()
        out = fn()
        wait_idle(engine)
        torch.cuda.synchronize()
        run = read_launch_counts(engine, stats0)
        check_launch_counts(f"[{mode}] {label}", run,
                            engine.model_cfg.num_layers, quantization,
                            engine.cfg.kv_quant, head_tiles(engine))
        for key in ("launches", "by_path"):
            for k, n in run[key].items():
                total[key][k] = total[key].get(k, 0) + n
        return out

    # 1. The model server's front ends, each against /v1/completions.
    try:
        from generativeaiexamples_tpu_torch.serving.grpc_server import (
            GrpcLLMClient, require_grpc, serve_grpc)
        require_grpc()
        have_grpc = True
    except ConfigError as exc:
        have_grpc = False
        say(f"periphery [{mode}]: the gRPC front end was not driven: the "
            f"grpc package is not installed here ({exc})")
    mbase, stop_model = serve_app(create_server_app(engine, svc, name))
    jobs_now = web.Application()
    jobs_api.add_jobs_routes(jobs_now, engine, name, sync_wait=0.0)
    jbase, stop_jobs = serve_app(jobs_now)
    grpc_srv = (serve_grpc(engine, name, svc,
                           max_output=engine.cfg.max_output_length,
                           host="127.0.0.1", port=0) if have_grpc else None)
    P, N = PERIPHERY_PROMPT, PERIPHERY_NEW
    body = {"prompt": P, "max_tokens": N, "temperature": 0}
    times, jobs_status = {}, {}
    try:
        want = counted("completions", lambda: json.loads(post(
            mbase + "/v1/completions", body))["choices"][0]["text"])
        if len(want) < 8:
            fail(f"[{mode}] /v1/completions gave {want!r}")
        triton = TritonShimClient(mbase, name)
        jobs = JobsClient(mbase, poll_interval=0.01)
        polled = JobsClient(jbase, poll_interval=0.01)

        def job(client, key):
            def run():
                snap = client.submit(P, max_tokens=N, temperature=0)
                jobs_status[key] = snap["status"]
                yield snap["text"] if snap["status"] == "done" else \
                    client.wait(snap["id"])["text"]
            return run
        paths = {
            "/v1/completions (stream)": lambda: completion_pieces(mbase,
                                                                  body),
            "triton generate": lambda: iter([triton.generate(P, N)]),
            "triton generate_stream": lambda: triton.generate_stream(P, N),
            "jobs": job(jobs, "jobs"),
            "jobs 202 -> poll": job(polled, "jobs 202 -> poll"),
            "TorchLLM http": lambda: (c.text for c in TorchLLM(
                server_url=mbase, mode="http", tokens=N)._stream(P,
                                                                 stop=[])),
        }
        if have_grpc:
            target = f"127.0.0.1:{grpc_srv._bound_port}"
            grpc_client = GrpcLLMClient(target)
            grpc_client.wait_ready()
            paths.update({
                "grpc unary": lambda: iter([grpc_client.generate(
                    P, max_tokens=N)]),
                "grpc stream": lambda: grpc_client.generate_stream(
                    P, max_tokens=N),
                "TorchLLM grpc": lambda: (c.text for c in TorchLLM(
                    server_url=target, mode="grpc", tokens=N)._stream(
                        P, stop=[])),
            })
        li_mode, li_url = (("grpc", f"127.0.0.1:{grpc_srv._bound_port}")
                           if have_grpc else ("http", mbase))
        paths["TorchLlamaIndexLLM " + li_mode] = lambda: (
            r.delta for r in TorchLlamaIndexLLM(
                server_url=li_url, mode=li_mode,
                tokens=N).stream_complete(P))
        for label, fn in paths.items():
            text, first, end = counted(label, lambda: timed_text(fn))
            if text != want:
                fail(f"[{mode}] {label} gave {text!r}; /v1/completions "
                     f"{want!r}")
            times[label] = (first, end)
        if jobs_status["jobs 202 -> poll"] != "running":
            fail(f"[{mode}] the job without a grace period answered "
                 f"{jobs_status['jobs 202 -> poll']} at submit, not 202")
        if have_grpc:
            vec = grpc_client.embed([RAG_QUESTIONS[0]])[0]
            err = float(abs(vec - svc.embed_documents(
                [RAG_QUESTIONS[0]])[0]).max())
            if err > 1e-5:
                fail(f"[{mode}] gRPC Embed is {err} from the service")
            grpc_client.close()
    finally:
        if grpc_srv is not None:
            grpc_srv.stop(grace=None)
        stop_jobs()
        stop_model()
    base_ms = times["/v1/completions (stream)"]
    say(f"periphery [{mode}]: {len(times)} front ends x {N} greedy tokens, "
        f"each text = /v1/completions' ({len(want)} chars); first byte / "
        f"total ms: " + "; ".join(f"{k} {a:.1f} / {b:.1f}"
                                  for k, (a, b) in times.items())
        + f"; jobs at submit: {jobs_status['jobs']} (1 s grace), "
        f"{jobs_status['jobs 202 -> poll']} (none) [{card}]")
    say(f"periphery [{mode}]: each front end's total beyond "
        f"/v1/completions' streamed {base_ms[1]:.1f} ms: " + ", ".join(
            f"{k} {b - base_ms[1]:+.1f}" for k, (a, b) in times.items()
            if k != "/v1/completions (stream)") + f" ms [{card}]")

    # 2. The web frontend in front of the chain server.
    base = rag["base"]
    fbase, stop_front = serve_app(frontend_app(ChatClient(base)))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_periphery_")
    try:
        q = {"question": RAG_QUESTIONS[0], "use_knowledge_base": True,
             "num_tokens": RAG_NEW}
        direct = counted("chain /generate", lambda: stream_generate(
            base, q, f"periphery-chain-{mode}"))
        proxied = counted("frontend /api/generate", lambda: stream_generate(
            fbase, q, f"periphery-front-{mode}", path="/api/generate"))
        if not direct[1] == proxied[1] == rag["texts"][0]:
            fail(f"[{mode}] /api/generate gave {proxied[1]!r}, /generate "
                 f"{direct[1]!r}, serve_rag's /generate {rag['texts'][0]!r}")
        s = {"content": RAG_QUESTIONS[0], "num_docs": 4}
        if json.loads(post(fbase + "/api/search", s)) != json.loads(
                post(base + "/documentSearch", s)):
            fail(f"[{mode}] /api/search differs from /documentSearch")
        say(f"periphery [{mode}]: frontend /api/generate = the chain "
            f"server's /generate ({len(direct[1])} chars); first byte "
            f"{proxied[0] * 1e3:.1f} ms through the frontend against "
            f"{direct[0] * 1e3:.1f} ms direct (total "
            f"{proxied[2] * 1e3:.1f} / {direct[2] * 1e3:.1f}); "
            f"/api/search = /documentSearch [{card}]")
        deck, memo = office_files(tmp)
        if rag["last"]:
            # The embedder's weights are random: each file's chunk is
            # looked for by its own text among every hit, and its rank
            # printed.
            ranks = []
            splitter = TokenTextSplitter(
                chunk_size=rag["cfg"].text_splitter.chunk_size,
                chunk_overlap=rag["cfg"].text_splitter.chunk_overlap)
            for path in (deck, memo):
                data, ctype = multipart_body(path)
                with post_with_retry(fbase + "/api/upload", data=data,
                                     headers={"Content-Type": ctype},
                                     timeout=300) as resp:
                    entry = json.loads(resp.read())
                chunks = splitter.split_text(read_document(path))
                hits = json.loads(post(base + "/documentSearch", {
                    "content": chunks[0], "num_docs": len(rag["index"])}))
                found = [i for i, h in enumerate(hits)
                         if h["source"] == os.path.basename(path)]
                if entry["status"] != "ingested" or sorted(
                        hits[i]["content"] for i in found) != sorted(chunks):
                    fail(f"[{mode}] {path} through /api/upload: {entry}; "
                         f"/documentSearch does not return its chunks")
                ranks.append(f"{os.path.basename(path)} ({len(chunks)} "
                             f"chunks) first at rank {found[0] + 1} of "
                             f"{len(hits)}")
            say(f"periphery [{mode}]: deck.pptx and memo.docx uploaded "
                f"through /api/upload (read by the assistant's parsers), "
                f"each found by /documentSearch for its own first chunk: "
                f"{', '.join(ranks)}")

        # 3. The multimodal assistant through the --example path.
        cls = discover_example("generativeaiexamples_tpu_torch.assistant."
                               "assistant")
        acfg = from_dict(AppConfig, {"vector_store": {"name": "exact-cuda"}})
        asst = cls(llm=EngineLLM(engine), embedder=svc, config=acfg,
                   feedback_path=os.path.join(tmp, "feedback.jsonl"))
        abase, stop_asst = serve_app(create_app(asst, os.path.join(
            tmp, "assistant")))
        try:
            upload(abase, deck)
            docs = asst.index.similarity_search(
                ASSISTANT_QUESTION, k=acfg.retriever.top_k)
            context = "\n\n".join(cap_context(
                [d.text for d in docs],
                max_tokens=acfg.retriever.max_context_tokens,
                tokenizer=asst.splitter.tok))
            prompt = asst._prompt(context, ASSISTANT_QUESTION)
            _, text, _ = counted("assistant /generate",
                                 lambda: stream_generate(
                abase, {"question": ASSISTANT_QUESTION,
                        "use_knowledge_base": True,
                        "num_tokens": RAG_NEW}, f"assistant-{mode}"))
        finally:
            stop_asst()
        answer, _, suffix = text.partition("\n\n[fact check:")
        engine.stop()
        engine.clear_prefix_cache()
        want_answer = engine.generate_text(prompt, SamplingParams(
            max_tokens=RAG_NEW, top_k=1, stop_words=["</s>", "[INST]"]))
        if answer != want_answer or len(answer) < 8:
            fail(f"[{mode}] the assistant answered {answer!r}; the engine's "
                 f"greedy text for its prompt is {want_answer!r}")
        verdict = counted("fact check", lambda: fact_check(
            asst.llm, context, ASSISTANT_QUESTION, answer))
        slides = sorted({d.metadata.get("slide") for d in docs})
        say(f"periphery [{mode}]: assistant over deck.pptx "
            f"({len(asst.index)} chunks; retrieved slides {slides}): "
            f"answer = the engine's greedy text for its "
            f"{len(engine.tokenizer.encode(prompt))}-token prompt "
            f"({len(answer)} chars); fact check in /generate: "
            f"{'appended' if suffix else 'no verdict parsed'}; on its own: "
            f"supported={verdict.supported}, "
            f"{len(verdict.explanation)} chars of explanation")
    finally:
        stop_front()
        shutil.rmtree(tmp, ignore_errors=True)

    # 4. The ingest pipeline against the /uploadDocument index.
    if rag["first"]:
        cfg = rag["cfg"]
        pidx = DocumentIndex(svc, store=store_from_config(cfg.vector_store,
                                                          svc.dim))
        t0 = time.monotonic()
        stats = IngestPipeline(
            FilesystemSource(os.path.join(docs_dir(), "*.md")), pidx,
            chunk_size=cfg.text_splitter.chunk_size,
            chunk_overlap=cfg.text_splitter.chunk_overlap,
            batch_size=32).run_sync()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        check_same_index(svc, rag["index"], pidx, RAG_QUESTIONS)
        n_up, up_s = rag["upload"]
        say(f"ingest pipeline: {stats.items_in} files -> "
            f"{stats.chunks_stored} chunks in {stats.batches} batches of "
            f"up to 32 in {secs:.2f} s ({stats.chunks_stored / secs:.1f} "
            f"chunks/s) against /uploadDocument's {n_up} chunks in "
            f"{up_s:.2f} s ({n_up / up_s:.1f} chunks/s) [{card}]")
        del pidx
    return total


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


# The fleet's replicas run the served 7B weights cut to this many layers:
# the phase checks routing, handoff, transfer and failover, which the
# depth does not change, and at 32 layers its three engines' construction
# alone took 84.5 s of a smoke that must end within 1200 s.
FLEET_LAYERS = 8


def depth_cut(params, layers: int):
    """``params`` cut to its first ``layers`` layers: views of the stacked
    layer leaves (quantized dict leaves leaf by leaf), the rest shared."""
    cut = {k: ({n: t[:layers] for n, t in v.items()} if isinstance(v, dict)
               else v[:layers])
           for k, v in params["layers"].items()}
    return {**params, "layers": cut}


def serve_fleet(torch, dev, card: str, served) -> dict:
    """The fleet tier on the card: three engines of llama-2-7b-chat at full
    width on the served int4-AWQ weights cut to their first
    ``FLEET_LAYERS`` layers (one set of weight tensors, views of the
    served ones; each engine its own int8 pool, explicit size, and host
    tier),
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
    from types import SimpleNamespace

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
    mcfg = replace(served.model_cfg, num_layers=FLEET_LAYERS)
    params = depth_cut(served.params, FLEET_LAYERS)
    # The near-tie checks' forward runs the fleet's model.
    model = SimpleNamespace(params=params, model_cfg=mcfg,
                            device=served.device)
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
    weights0 = weight_marks(params)
    t0 = time.monotonic()
    engines = {}
    for name, role in (("r0", "unified"), ("r1", "unified"),
                       ("r2", "prefill")):
        engines[name] = Engine(params, mcfg, tok,
                               replace(base_cfg, role=role), device=dev)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    for name, e in engines.items():
        if e.params is not params \
                or weight_marks(e.params) != weights0:
            fail(f"fleet: engine {name} copied or wrote the served "
                 f"weights")
    say(f"fleet [{mode}]: r0/r1 unified, r2 prefill, one set of weights "
        f"({FLEET_LAYERS} of {served.model_cfg.num_layers} layers), "
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
        return first_parting(torch, model, ids,
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
            r_tl = timeline_of(router.flight, rid)
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
        if weight_marks(params) != weights0:
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


# ------------------------------------------------------- customize phase

# The 7B training batches: LoRA/QLoRA (the reference test's recipe: rank
# 8 on wq..wo, Adam 1e-2) on one fixed batch, and full-parameter SFT at
# notebook 10's batch shape (prompt masked out of the loss, ``length``
# passed).
TUNE_B, TUNE_S, TUNE_STEPS, TUNE_RANK = 4, 512, 8, 8
SFT_B, SFT_S, SFT_PROMPT, SFT_STEPS, SFT_LR = 2, 256, 96, 4, 3e-4
# #3's backward is checked at every 7B projection shape at the training
# batch's rows, B x S.
INT4_BWD_SHAPES = (("wq", 4096, 4096), ("w_gate", 4096, 11008),
                   ("w_down", 11008, 4096))
# The bf16 tolerances (relative to max|ref|): the int4 backward against
# the product through a dequantized bf16 copy (both round the weight and
# the result to bf16, at different points: a few ulps of the largest
# entry), and the QLoRA adapters' first gradients against the same loss
# with every int4 leaf dequantized to bf16 (relative Frobenius error over
# 32 layers of bf16 activations). A product that lost its backward (an
# MLP with no gradient) misses either by far more.
INT4_BWD_ATOL, QLORA_GRAD_RTOL = 2e-2, 1e-1
TUNE_PROMPTS = ["Tell me about paged attention. " * 3, "a" * 126,
                "Summarize the fine-tuning run:"]
TUNE_NEW = 16
# The live eval of the card-trained golden-tiny: chunks of 150 tokens, 32
# answer tokens, 6 questions from 6 chunks, a 200-token context cap so the
# chain's prompts fit golden-tiny's 512 positions.
EVAL_ARGS = ["--chunk-size", "150", "--chunk-overlap", "30",
             "--max-questions", "6", "--max-chunks", "6", "--num-tokens",
             "32", "--max-context-tokens", "200", "--model-name",
             "golden-tiny"]


def int4_row(shape: str, path: str, err: float, ms: float, plain_ms: float,
             bound: float, by: str, lib_ms) -> dict:
    """A kernels-line row of #3 (launches filled in by ``main``)."""
    return {"name": "int4_matmul", "route": "cuda",
            "source": "generativeaiexamples_tpu_torch/csrc/int4_matmul.cu",
            "replaces": "generativeaiexamples_tpu/ops/int4_matmul.py:83",
            "path": path, "shape": shape, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms}


def int4_bound(M: int, K: int, N: int, G: int) -> tuple:
    """(bound ms, what bounds it) of an (M, K) x (K, N) int4 product with
    G group scales, bf16 in and out: each byte read or written once, the
    multiply-adds at the bf16 tensor-core peak."""
    nbytes = K // 2 * N + 4 * G * N + M * K * 2 + M * N * 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = 2 * M * K * N / BF16_FLOPS * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


def check_int4_backward(torch, dev, card: str) -> dict:
    """#3 under autograd (``int4_matmul_grad``, which ``quant.matmul``
    takes when x requires grad) at llama-2-7b's projection shapes and M =
    B x S = 2048 rows, for an AWQ leaf (groups of 128 with a pre-scale)
    and a GPTQ leaf (zero points): the forward must launch "wg" once and
    the backward count once, and autograd's dx must equal autograd's dx
    through a dequantized bf16 copy of the weight (``INT4_BWD_ATOL`` x
    max|ref|). Then times the forward kernel, the backward product
    (``int4_matmul_dx``), the plain version, a dense bf16 product of
    each direction and ``aten._weight_int4pack_mm`` at the AWQ leaf.
    Returns the kernels line's row for w_gate (the training window's
    launches are added by ``main``) and its backward times."""
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.ops.int4_matmul import (
        int4_matmul, int4_matmul_dx, int4_matmul_plain)

    gen = torch.Generator(device=dev).manual_seed(13)
    M = TUNE_B * TUNE_S
    row = None
    for name, K, N in INT4_BWD_SHAPES:
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        awq = quant.quantize_tensor_grouped(w, 128)
        awq["pre_scale"] = torch.rand((K,), generator=gen, device=dev) + 0.5
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        dy = torch.randn((M, N), generator=gen,
                         device=dev).to(torch.bfloat16)
        errs = {}
        for fmt, leaf in (("awq", awq),
                          ("gptq", gptq_leaf(torch, gen, K, N, dev))):
            n0 = (int4_matmul.launches_by_path["wg"],
                  int4_matmul.backward_launches)
            x1 = x.clone().requires_grad_(True)
            y1 = quant.matmul(x1, leaf)
            y1.backward(dy)
            if (int4_matmul.launches_by_path["wg"],
                    int4_matmul.backward_launches) != (n0[0] + 1, n0[1] + 1):
                fail(f"int4 backward {fmt} {name}: the forward did not "
                     f"launch 'wg' once and the backward run once")
            x2 = x.clone().requires_grad_(True)
            (x2 @ quant.dequantize(leaf, torch.bfloat16)).backward(dy)
            ref, got = x2.grad.float(), x1.grad.float()
            peak = ref.abs().max().item()
            err = (got - ref).abs().max().item()
            if not (torch.isfinite(got).all() and err <= INT4_BWD_ATOL
                    * peak):
                fail(f"int4 backward {fmt} {name} M={M} K={K} N={N}: dx "
                     f"max abs err {err} against the dequantized bf16 "
                     f"product (max|ref| {peak}; tolerance "
                     f"{INT4_BWD_ATOL} x max|ref|)")
            errs[fmt] = (err, peak)
            del x1, x2, y1
        G = K // 128
        xin = (x.float() * awq["pre_scale"]).to(torch.bfloat16)
        q4, gs = awq["q4"], awq["gscale"]
        fwd_ms = time_cuda(torch, lambda: int4_matmul(xin, q4, gs), iters=20)
        bwd_ms = time_cuda(torch, lambda: int4_matmul_dx(
            dy, q4, gs, dtype=torch.bfloat16), iters=20)
        plain_ms = time_cuda(torch, lambda: int4_matmul_plain(xin, q4, gs),
                             iters=3, warmup=1)
        wd = quant.dequantize(awq, torch.bfloat16)
        mm_ms = time_cuda(torch, lambda: x @ wd, iters=20)
        mm_t_ms = time_cuda(torch, lambda: dy @ wd.T, iters=20)
        lib_ms, lib_note = int4_library_ms(torch, dev, M, K, N, 128, 20)
        bound, by = int4_bound(M, K, N, G)
        say(f"int4 backward {name} M={M} K={K} N={N} group 128: dx equals "
            f"the dequantized bf16 product's (max abs err / max|ref|: awq "
            f"{errs['awq'][0]} / {errs['awq'][1]}, gptq {errs['gptq'][0]} / "
            f"{errs['gptq'][1]}); forward wg "
            f"{fwd_ms:.5f} ms, backward (bf16 dequantize + cuBLAS) "
            f"{bwd_ms:.5f} ms, bound {bound:.5f} ms ({by}) each way; plain "
            f"{plain_ms:.4f} ms; dense bf16 x @ W {mm_ms:.5f} ms, dy @ W^T "
            f"{mm_t_ms:.5f} ms; library {lib_ms} ({lib_note}) [{card}]")
        if name == "w_gate":
            row = int4_row(f"qlora M={M} K={K} N={N} awq", "wg",
                           errs["awq"][0], fwd_ms, plain_ms, bound, by,
                           lib_ms)
            row.update(backward_ms=bwd_ms, backward_bound_ms=bound,
                       backward_launches=0)
        del w, awq, wd, x, dy, xin
    torch.cuda.empty_cache()
    return row


def check_mm_f32_backward(torch, dev, card: str) -> None:
    """The logits product of a raw bf16 head (``quant.matmul_f32``: one
    ``torch.mm(..., out_dtype=torch.float32)`` on the card, which has no
    registered derivative) under autograd: it goes through
    ``quant._MatmulF32Fn``, and its backward gives dx and dW equal to a
    float32 product's (rtol 1e-2: bf16 gradients)."""
    from generativeaiexamples_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((256, 4096), generator=gen,
                    device=dev).to(torch.bfloat16).requires_grad_(True)
    w = (torch.randn((4096, 32000), generator=gen, device=dev)
         * 4096 ** -0.5).to(torch.bfloat16).requires_grad_(True)
    dy = torch.randn((256, 32000), generator=gen, device=dev)
    y = quant.matmul_f32(x, w)
    # y is a view of the Function's (M, N) output.
    fn = type(y.grad_fn.next_functions[0][0]).__name__
    if y.dtype != torch.float32 or "_MatmulF32Fn" not in fn:
        fail(f"matmul_f32 gave {y.dtype} through {fn}, not "
             f"quant._MatmulF32Fn")
    y.backward(dy)
    xf = x.detach().float().requires_grad_(True)
    wf = w.detach().float().requires_grad_(True)
    (xf @ wf).backward(dy)
    for label, got, ref in (("dx", x.grad, xf.grad), ("dW", w.grad, wf.grad)):
        err = (got.float() - ref).abs().max().item()
        peak = ref.abs().max().item()
        if not torch.allclose(got.float(), ref, rtol=1e-2, atol=1e-2 * peak):
            fail(f"matmul_f32 backward {label}: max abs err {err} "
                 f"(max|ref| {peak})")
    say(f"logits product backward: torch.mm(out_dtype=float32) under "
        f"autograd through {fn} gives dx and dW "
        f"equal to the float32 product's [{card}]")


def tree_digest(torch, tree) -> list:
    """(address, in-place write count, checksum) of every tensor of a
    parameter tree: a position-weighted sum of its bytes, 64 Mi bytes at
    a time, so equal digests mean unwritten, bit-equal tensors."""
    from generativeaiexamples_tpu_torch.models import llama
    step = 64 << 20
    weights = (torch.arange(step, device=tree["embed"].device) % 65521) + 1
    out = []
    for t in llama.param_tensors(tree):
        b = t.detach().contiguous().view(-1).view(torch.uint8)
        s = 0
        for i in range(0, b.numel(), step):
            c = b[i:i + step]
            s += int((c.to(torch.int64) * weights[:c.numel()]).sum())
        out.append((t.data_ptr(), t._version, s))
    return out


def tune_batch(torch, dev, V: int, seed: int) -> dict:
    """A fixed LM batch of random tokens, TUNE_B x TUNE_S, all in the
    loss."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(3, V, (TUNE_B, TUNE_S + 1), generator=gen,
                         device=dev)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": torch.ones((TUNE_B, TUNE_S), dtype=torch.int32,
                               device=dev)}


def train_lora(torch, dev, card: str, cfg, base, label: str,
               ref_grads=None) -> tuple:
    """TUNE_STEPS Adam(1e-2) steps of rank-TUNE_RANK adapters on wq..wo
    over the frozen ``base`` (merged in bf16, so the activations stay
    bf16), one fixed batch. Checks: the loss falls, the base's digest is
    unchanged and no base leaf requires or holds a gradient, every ``b``
    moved; with ``ref_grads`` (target -> (grad a, grad b) at the same
    initial adapters) the first step's gradients equal them within
    ``QLORA_GRAD_RTOL``. Prints step ms, tokens/s and peak memory.
    Returns (adapters, stats, the training window's launch counts)."""
    from generativeaiexamples_tpu_torch.engine import graphs
    from generativeaiexamples_tpu_torch.lora import (init_lora,
                                                     lora_parameters,
                                                     make_lora_train_step)
    from generativeaiexamples_tpu_torch.models import llama

    lora = init_lora(cfg, base, torch.Generator(device=dev).manual_seed(1),
                     rank=TUNE_RANK)
    step = make_lora_train_step(
        cfg, torch.optim.Adam(lora_parameters(lora), lr=1e-2),
        dtype=torch.bfloat16)
    batch = tune_batch(torch, dev, cfg.vocab_size, 2)
    digest = tree_digest(torch, base)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    losses, times, grad_err = [], [], {}
    for i in range(TUNE_STEPS):
        t0 = time.monotonic()
        losses.append(float(step(lora, base, batch)))
        times.append(time.monotonic() - t0)
        if i == 0 and ref_grads is not None:
            # At b = 0 the gradient of a is exactly 0 on both sides.
            for name, ab in lora.items():
                ga, gb = ab["a"].grad, ab["b"].grad.float()
                ref_a, ref_b = ref_grads[name]
                if ga.abs().max().item() or ref_a.abs().max().item():
                    fail(f"{label}: the first gradient of {name}.a is not "
                         f"0 at b = 0")
                grad_err[name + ".b"] = ((gb - ref_b).norm()
                                         / ref_b.norm()).item()
    torch.cuda.synchronize()
    counts = graphs.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not losses[-1] < losses[0] - 0.01:
        fail(f"{label}: the loss did not fall over {TUNE_STEPS} steps: "
             f"{losses}")
    if tree_digest(torch, base) != digest or any(
            t.requires_grad or t.grad is not None
            for t in llama.param_tensors(base)):
        fail(f"{label}: the frozen base changed or took a gradient")
    if not all(ab["b"].detach().abs().max().item() > 0
               for ab in lora.values()):
        fail(f"{label}: an adapter's b did not move")
    if grad_err and max(grad_err.values()) > QLORA_GRAD_RTOL:
        fail(f"{label}: first-step adapter gradients against the "
             f"dequantized bf16 base's: relative errors {grad_err} "
             f"(tolerance {QLORA_GRAD_RTOL})")
    step_ms = 1e3 * sorted(times[1:])[len(times[1:]) // 2]
    stats = {"losses": losses, "step_ms": step_ms,
             "first_step_ms": 1e3 * times[0], "peak_bytes": peak,
             "tokens_per_s": TUNE_B * TUNE_S / step_ms * 1e3,
             "grad_err": grad_err}
    say(f"{label}: rank {TUNE_RANK} on wq..wo, Adam 1e-2, batch "
        f"{TUNE_B} x {TUNE_S}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"over {TUNE_STEPS} steps; step {step_ms:.1f} ms median (first "
        f"{1e3 * times[0]:.1f} ms), {stats['tokens_per_s']:.0f} tokens/s; "
        f"peak {peak / 2**30:.2f} GiB allocated; base digest unchanged"
        + (f"; first-step gradients against the dequantized bf16 base: "
           f"worst relative error {max(grad_err.values()):.2e} "
           f"({', '.join(f'{k} {v:.1e}' for k, v in grad_err.items())})"
           if grad_err else "") + f" [{card}]")
    return lora, stats, counts


def serve_tuned(torch, dev, card: str, cfg, params, label: str,
                quantization: str, kv_quant: str) -> dict:
    """A tuned tree served: TUNE_PROMPTS through a captured engine, its
    launch counts set to 0 before and read after (``check_launch_counts``:
    #1 or #2 in every decode layer, #3 on every int4 projection; 3 a
    layer once wq..wo are merged), and the same greedy tokens from an
    eager engine (the budget pinned on both). Returns the counts."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models.tokenizer import \
        ByteTokenizer

    ecfg = EngineConfig(max_slots=4, max_input_length=256,
                        max_output_length=32, prefill_buckets=(128, 256),
                        page_size=128, kv_pool_tokens=4 * (256 + 32),
                        dtype="bfloat16", kv_quant=kv_quant,
                        sched_round_budget_tokens=1024)
    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in TUNE_PROMPTS]
    t0 = time.monotonic()
    engine = Engine(params, cfg, tok, ecfg, device=dev)
    built = time.monotonic() - t0
    greedy_tokens(engine, [tok.encode("warm")], 2)
    torch.cuda.synchronize()
    stats0 = engine.stats
    zero_launch_counts()
    got = greedy_tokens(engine, prompts, TUNE_NEW)
    torch.cuda.synchronize()
    run = read_launch_counts(engine, stats0)
    n_tiles = head_tiles(engine)
    engine.close()
    check_launch_counts(label, run, cfg.num_layers, quantization, kv_quant,
                        n_tiles, per_layer=3 if quantization else 7)
    eager = Engine(params, cfg, tok, replace(ecfg, cuda_graphs=False),
                   device=dev)
    want = greedy_tokens(eager, prompts, TUNE_NEW)
    eager.close()
    if got != want:
        fail(f"{label}: served greedy tokens {got} differ from the eager "
             f"engine's {want}")
    say(f"{label}: the merged tree served (built in {built:.1f} s): greedy "
        f"tokens of {len(prompts)} prompts equal the eager engine's; "
        f"launches {run['launches']} (int4 by path {run['by_path']}) over "
        f"{run['decode_steps']} decode steps and {run['prefills']} "
        f"admissions [{card}]")
    return run


def qlora_reference_grads(torch, cfg, qbase, lora_seed: int) -> dict:
    """The QLoRA loss's first gradients with every int4 leaf of ``qbase``
    dequantized to bf16 (plain bf16 products, no kernel), at the
    adapters ``train_lora`` starts from."""
    from generativeaiexamples_tpu_torch.lora import init_lora, merge_lora
    from generativeaiexamples_tpu_torch.ops.quant import (dequantize,
                                                          is_quantized)
    from generativeaiexamples_tpu_torch.training import forward_loss

    dev = qbase["embed"].device
    lora = init_lora(cfg, qbase,
                     torch.Generator(device=dev).manual_seed(lora_seed),
                     rank=TUNE_RANK)
    deq = {**qbase, "layers": {
        k: (dequantize(v, torch.bfloat16)
            if is_quantized(v) and k not in lora else v)
        for k, v in qbase["layers"].items()}}
    deq["lm_head"] = dequantize(qbase["lm_head"], torch.bfloat16)
    loss = forward_loss(merge_lora(deq, lora, dtype=torch.bfloat16), cfg,
                        tune_batch(torch, dev, cfg.vocab_size, 2))
    loss.backward()
    out = {k: (ab["a"].grad.float(), ab["b"].grad.float())
           for k, ab in lora.items()}
    del deq, lora, loss
    torch.cuda.empty_cache()
    return out


def sft_batch(torch, dev, V: int) -> dict:
    """Notebook 10's batch shape at SFT_B x SFT_S: random prompt and
    response tokens, the first SFT_PROMPT positions out of the loss, the
    second row right-padded after 200 tokens; ``length`` counts the real
    tokens."""
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(3, V, (SFT_B, SFT_S + 1), generator=gen,
                         device=dev)
    length = torch.tensor([SFT_S, 200][:SFT_B], device=dev)
    pos = torch.arange(SFT_S + 1, device=dev)
    toks = torch.where(pos[None] <= length[:, None], toks, 0)
    mask = ((pos[None, 1:] > SFT_PROMPT)
            & (pos[None, 1:] <= length[:, None])).to(torch.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask,
            "length": length}


def train_sft(torch, dev, card: str, cfg, params) -> dict:
    """Full-parameter SFT of ``params`` (bf16, made trainable here):
    ``torch.optim.AdamW`` (optax's decay 1e-4; moments in bf16, the
    parameters' dtype, one leaf at a time) for SFT_STEPS steps on
    ``sft_batch`` at full depth; the loss must fall, and running out of
    memory fails (59.25 GiB at its first measurement, PERF.md). Prints
    step ms, tokens/s and peak memory."""
    from generativeaiexamples_tpu_torch.training import (make_train_step,
                                                         trainable)

    batch = sft_batch(torch, dev, cfg.vocab_size)
    optim = torch.optim.AdamW(trainable(params), lr=SFT_LR,
                              weight_decay=1e-4, foreach=False)
    step = make_train_step(cfg, optim)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    try:
        for _ in range(SFT_STEPS):
            t0 = time.monotonic()
            losses.append(float(step(params, batch)))
            times.append(time.monotonic() - t0)
    except torch.cuda.OutOfMemoryError as exc:
        fail(f"sft: {cfg.num_layers} layers do not fit the card: {exc}")
    peak = torch.cuda.max_memory_allocated()
    n_states = sum(len(s) for s in optim.state.values())
    if not losses[-1] < losses[0]:
        fail(f"sft: the loss did not fall over {SFT_STEPS} steps: {losses}")
    step_ms = 1e3 * sorted(times[1:])[len(times[1:]) // 2]
    tokens = int(batch["length"].sum())
    say(f"sft: full-parameter AdamW (lr {SFT_LR}, decay 1e-4, bf16 moments) "
        f"at all {cfg.num_layers} layers, batch {SFT_B} x {SFT_S} "
        f"(prompt {SFT_PROMPT} out of the loss, lengths "
        f"{batch['length'].tolist()}): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {SFT_STEPS} steps; step {step_ms:.1f} ms "
        f"median (first {1e3 * times[0]:.1f} ms), {tokens / step_ms * 1e3:.0f} "
        f"tokens/s; peak {peak / 2**30:.2f} GiB allocated ({n_states} "
        f"optimizer state tensors) [{card}]")
    for t in trainable(params):
        t.grad = None
        t.requires_grad_(False)
    del optim, step
    return {"losses": losses, "step_ms": step_ms, "peak_bytes": peak,
            "tokens_per_s": tokens / step_ms * 1e3}


# The golden gate. GOLDEN_REF_BARE is the reference tool's own reading
# of CORPUS_SNIPPET alone at its default 300 steps (the JAX package's
# tools/make_golden_checkpoint.py trained on the CPU over today's
# docs/*.md, scored through its /v1/score). GOLDEN_BARE_MARGIN and
# GOLDEN_CTX_LIMIT (the snippet in its corpus context) were set from
# ``--golden-readings`` on an H100 (PERF.md, PR 18): the default trainer
# reads 6.5353 / 4.7963 at seed 0 (3.80-4.80 in context at seeds 0-2),
# the faulty trainers of GOLDEN_FAULTY, which each run trains and scores
# beside it, 6.6871 / 6.2210 (a third of the steps) and 6.2554 / 5.5191
# (the MLP never trained): the snippet alone does not part a dropped
# gradient from a sound trainer, in its context it does.
GOLDEN_REF_BARE = 6.6152
GOLDEN_BARE_MARGIN = 0.05
GOLDEN_CTX_LIMIT = 5.15
GOLDEN_FAULTY = (("100 steps", {"steps": 100}),
                 ("mlp frozen", {"frozen": ("w_gate", "w_up", "w_down")}))


def snippet_in_context() -> tuple:
    """(docs/architecture.md from its start through CORPUS_SNIPPET's span,
    the characters before the span): the snippet as the training corpus
    holds it (a line break where the snippet has a space)."""
    with open(os.path.join(docs_dir(), "architecture.md")) as f:
        text = f.read()
    i = text.index(CORPUS_SNIPPET[:40])
    return text[:i + len(CORPUS_SNIPPET)], i


def score_dir(torch, dev, path: str) -> tuple:
    """(mean NLL of CORPUS_SNIPPET alone, mean NLL of its tokens in its
    corpus context (``snippet_in_context``, per token), both through
    ``/v1/score`` of the model server over the checkpoint at ``path``,
    bf16 on the card; and the engine, kept for the live eval, its server
    stopped)."""
    from generativeaiexamples_tpu_torch.engine import EngineConfig
    from generativeaiexamples_tpu_torch.serving.model_server import (
        build_services, create_server_app)

    ecfg = EngineConfig(max_slots=4, max_input_length=384,
                        max_output_length=128,
                        prefill_buckets=(64, 128, 384), page_size=16,
                        kv_pool_tokens=None, dtype="bfloat16",
                        sched_round_budget_tokens=1024)
    with env_set(GAIE_WEIGHT_CACHE="0"):
        engine, name = build_services("golden-tiny", model_path=path,
                                      engine_cfg=ecfg, device=dev)
    head, before = snippet_in_context()
    ids = engine.tokenizer.encode(head)
    n = len(engine.tokenizer.encode(head[:before]))
    base, stop = serve_app(create_server_app(engine, model_name=name))
    try:
        bare = json.loads(post(base + "/v1/score", {"text": CORPUS_SNIPPET}))
        ctx = json.loads(post(base + "/v1/score", {"tokens": ids,
                                                   "per_token": True}))
    finally:
        stop()
        engine.stop()
    # nll[t] scores token t + 1: the snippet's tokens are n onward.
    in_ctx = sum(ctx["nll"][n - 1:]) / len(ctx["nll"][n - 1:])
    return bare["mean_nll"], in_ctx, engine


def golden_run(torch, dev, out: str, frozen: tuple = (), **kw) -> dict:
    """The port's golden tool on the card with ``kw`` over its defaults
    (300 steps of batch 16, seq 128, lr 3e-3, AdamW decay 1e-4; float32),
    the layer leaves named in ``frozen`` left out of the optimizer (a
    dropped gradient), exported to ``out`` (fp16 safetensors through the
    port's writer, config.json, tokenizer.model) and scored
    (``score_dir``): {"losses", "train_s", "bare", "ctx", "engine",
    "params" (the trained tree)}."""
    from generativeaiexamples_tpu_torch import training
    from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY
    from generativeaiexamples_tpu_torch.tools import make_golden_checkpoint \
        as golden

    tokenizer = os.path.join(golden_dir(), "tokenizer.model")
    plain = training.trainable

    def some(params):
        # ``trainable`` recurses through the module's name, so this drops
        # the frozen leaves at the layers level.
        return plain({k: v for k, v in params.items() if k not in frozen})

    training.trainable = some
    t0 = time.monotonic()
    try:
        params, losses = golden.train(docs_dir(), tokenizer, device=dev,
                                      log=lambda *_: None, **kw)
    finally:
        training.trainable = plain
    torch.cuda.synchronize()
    train_s = time.monotonic() - t0
    golden.export_hf(params, GOLDEN_TINY, out, tokenizer)
    bare, ctx, engine = score_dir(torch, dev, out)
    return {"losses": losses, "train_s": train_s, "bare": bare, "ctx": ctx,
            "engine": engine, "params": params}


def golden_on_card(torch, dev, card: str) -> tuple:
    """The golden tool on the card: golden-tiny trained with the tool's
    defaults, every exported tensor read back bit-equal to the fp16 cast
    of the trained tree, and served. /v1/score of CORPUS_SNIPPET alone
    must be no worse than the reference tool's own reading plus
    ``GOLDEN_BARE_MARGIN``, and of the snippet in its corpus context under
    ``GOLDEN_CTX_LIMIT``; each trainer of ``GOLDEN_FAULTY``, trained and
    scored in the same run, must miss one or both. Printed beside the
    committed fixture's scores. Returns (the served engine, the
    directory that holds the exports)."""
    import tempfile

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY
    from generativeaiexamples_tpu_torch.models.import_hf import \
        load_checkpoint

    fixture_bare, fixture_ctx, fixture_engine = score_dir(torch, dev,
                                                          golden_dir())
    fixture_engine.close()
    root = tempfile.mkdtemp(prefix="chip_smoke_golden_")
    faulty = {}
    for i, (label, kw) in enumerate(GOLDEN_FAULTY):
        run = golden_run(torch, dev, os.path.join(root, f"faulty{i}"), **kw)
        run["engine"].close()
        faulty[label] = (run["bare"], run["ctx"])
    out = os.path.join(root, "default")
    run = golden_run(torch, dev, out)
    losses, train_s = run["losses"], run["train_s"]
    back = load_checkpoint(out, GOLDEN_TINY, dtype=torch.float16, device=dev)
    for a, b in zip(llama.param_tensors(back),
                    llama.param_tensors(run["params"])):
        if not torch.equal(a, b.to(torch.float16)):
            fail("golden: an exported tensor did not read back bit-equal")
    del back
    bare, in_ctx, engine = run["bare"], run["ctx"], run["engine"]
    bare_limit = GOLDEN_REF_BARE + GOLDEN_BARE_MARGIN
    say(f"golden: {len(losses)} steps of 16 x 128 trained on the card in "
        f"{train_s:.1f} s ({len(losses) * 16 * 128 / train_s:.0f} "
        f"tokens/s; loss {losses[0]:.3f} -> {losses[-1]:.3f}), exported "
        f"and read back bit-equal; /v1/score NLL of the corpus snippet "
        f"alone {bare} (limit {bare_limit}: the reference tool's "
        f"{GOLDEN_REF_BARE} + {GOLDEN_BARE_MARGIN}), in its corpus context "
        f"{in_ctx} (limit {GOLDEN_CTX_LIMIT}); faulty trainers "
        + ", ".join(f"{k} {b} / {c}" for k, (b, c) in faulty.items())
        + f"; the committed fixture {fixture_bare} / {fixture_ctx} (bf16 "
        f"engines) [{card}]")
    if not (bare <= bare_limit and in_ctx < GOLDEN_CTX_LIMIT):
        fail(f"golden: the card-trained checkpoint scores the corpus "
             f"snippet at {bare} nats alone (limit {bare_limit}) and "
             f"{in_ctx} in its context (limit {GOLDEN_CTX_LIMIT})")
    passed = [k for k, (b, c) in faulty.items()
              if b <= bare_limit and c < GOLDEN_CTX_LIMIT]
    if passed:
        fail(f"golden: faulty trainers {passed} meet both limits, so the "
             f"gate does not tell a sound trainer from them: {faulty}")
    return engine, root


def golden_readings(torch, dev, card: str) -> None:
    """The readings the golden gate's limits were set from (``python3
    chip_smoke.py --golden-readings``): /v1/score of CORPUS_SNIPPET alone
    and in its context for the tool's default trainer at seeds 0-2, for
    faulty trainers (fewer steps, a smaller lr, the MLP leaves left out
    of the optimizer: a dropped gradient) and for the committed fixture,
    printed as one JSON object."""
    import shutil
    import tempfile

    fb, fc, fe = score_dir(torch, dev, golden_dir())
    fe.close()
    out = {"fixture": [fb, fc]}
    root = tempfile.mkdtemp(prefix="chip_smoke_golden_")
    runs = [("default seed 0", {}), ("default seed 1", {"seed": 1}),
            ("default seed 2", {"seed": 2}), ("30 steps", {"steps": 30}),
            ("100 steps", {"steps": 100}), ("lr / 10", {"lr": 3e-4}),
            ("lr / 100", {"lr": 3e-5}), GOLDEN_FAULTY[1]]
    try:
        for i, (label, kw) in enumerate(runs):
            run = golden_run(torch, dev, os.path.join(root, str(i)), **kw)
            run["engine"].close()
            out[label] = [run["bare"], run["ctx"], run["losses"][-1]]
            say(f"golden readings: {label}: alone {run['bare']}, in context "
                f"{run['ctx']}, final train loss {run['losses'][-1]} "
                f"[{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"golden_readings": out}), flush=True)


def live_eval_on_card(torch, dev, card: str, engine) -> dict:
    """The port's live eval (``tools/eval/live.py``) through the chain
    server on the card-trained golden-tiny (the engine judges too) with
    the hash embedder over docs/*.md and the ``exact`` store. The same
    questions then go through an index built on the CPU (hash embedder,
    exact store): equal ranked ids and retrieval metrics; and through an
    ``exact-cuda`` index on the card, whose bf16 rows may reorder
    near-ties: its metrics are printed beside and any question whose
    ranking differs is named."""
    from generativeaiexamples_tpu_torch.chains.examples.developer_rag import \
        QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EchoLLM
    from generativeaiexamples_tpu_torch.tools.eval import live
    from generativeaiexamples_tpu_torch.tools.eval.metrics import \
        retrieval_metrics

    t0 = time.monotonic()
    args = live.parser().parse_args(EVAL_ARGS + ["--corpus", docs_dir()])
    art = live.run_live(args, engine=engine)
    eval_s = time.monotonic() - t0
    m = art["metrics"]
    gen = art["generation"]
    if gen["answers"] != m["num_questions"] or not m["num_questions"] \
            or gen["non_empty"] != gen["answers"]:
        fail(f"live eval: {gen} for {m['num_questions']} questions")
    qs = art["questions"]

    def ranked(store: str):
        """The questions' top-k ids from a fresh index in ``store``."""
        ex = QAChatbot(llm=EchoLLM(), config=live.chatbot_config(
            live.parser().parse_args(EVAL_ARGS + ["--corpus", docs_dir(),
                                                  "--store", store])),
            fused_rag=False)
        live.ingest_corpus(ex, docs_dir())
        return [[h.id for h in ex.index.similarity_search(q["question"],
                                                          k=args.top_k)]
                for q in qs]

    def agg(ids_per_q):
        rs = [retrieval_metrics(ids, q["gt_doc_id"], args.top_k)
              for ids, q in zip(ids_per_q, qs)]
        rs = [r for r in rs if r is not None]
        return {k: round(sum(r[k] for r in rs) / len(rs), 4)
                for k in ("ndcg", "hit", "mrr")}

    cpu_ids = ranked("exact")
    if cpu_ids != [q["context_ids"] for q in qs]:
        fail(f"live eval: the CPU index ranks {cpu_ids}, the card run "
             f"{[q['context_ids'] for q in qs]}")
    cpu_m = agg(cpu_ids)
    if cpu_m != {k: m["retrieval"][k] for k in ("ndcg", "hit", "mrr")}:
        fail(f"live eval: retrieval {m['retrieval']} against the CPU "
             f"index's {cpu_m}")
    cuda_ids = ranked("exact-cuda")
    differ = [i for i, (a, b) in enumerate(zip(cuda_ids, cpu_ids)) if a != b]
    say(f"live eval: {m['num_questions']} questions "
        f"({m['synthetic_modes']}) over {art['corpus']['chunks']} chunks "
        f"answered through the chain server on the card-trained golden-tiny "
        f"in {eval_s:.1f} s; retrieval (exact) {m['retrieval']} = the CPU "
        f"index's; exact-cuda {agg(cuda_ids)}"
        f"{f', rankings differ at questions {differ}' if differ else ', same rankings'}; "
        f"judge {m['judge']} ({art['judge_prompts_clipped']} prompts "
        f"clipped to the context); faithfulness {m['faithfulness']} "
        f"({m['faithfulness_scored']} scored), context precision "
        f"{m['context_precision']} ({m['context_precision_scored']} scored)"
        f"; answers {gen} [{card}]")
    return {"retrieval": m["retrieval"], "judge": m["judge"],
            "seconds": eval_s}


def customize(torch, dev, card: str) -> dict:
    """Training and evaluation on the card (llama-2-7b-chat at full width
    and depth, random bf16 weights from seed 0): (a) #3's backward at the
    projection shapes and the logits product's backward; (b) LoRA over the
    bf16 base, then the merged tree served; (c) QLoRA over the base
    quantized on the card to int4_awq, its first gradients against the
    dequantized bf16 base's, the training window's #3 launches ("wg" and
    backward) counted, then the merged tree served over an int8 KV pool;
    (d) full-parameter SFT; (e) the golden tool; (f) the live eval.
    Returns the kernels line's QLoRA row and each served tree's counts."""
    from generativeaiexamples_tpu_torch.lora import merge_lora
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    from generativeaiexamples_tpu_torch.ops.quant import quantize_params

    free_memory(torch)
    row = check_int4_backward(torch, dev, card)
    check_mm_f32_backward(torch, dev, card)
    cfg = LLAMA2_7B
    base = llama.init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    lora, bf16_stats, _ = train_lora(torch, dev, card, cfg, base,
                                     "lora [bf16 base]")
    with torch.no_grad():
        merged = merge_lora(base, lora, dtype=torch.bfloat16)
    del lora
    bf16_run = serve_tuned(torch, dev, card, cfg, merged, "lora [bf16 base]",
                           "", "")
    del merged
    free_memory(torch)

    qbase = quantize_params(base, "int4_awq", 128)
    ref = qlora_reference_grads(torch, cfg, qbase, 1)
    lora, q_stats, counts = train_lora(torch, dev, card, cfg, qbase,
                                       "qlora [int4_awq base]", ref)
    del ref
    L = cfg.num_layers
    want = {"int4_matmul/wg": (3 * L + 1) * TUNE_STEPS,
            "int4_matmul_backward": (3 * L + 1) * TUNE_STEPS,
            "int4_matmul/tc": 0, "int4_matmul/gemv": 0,
            "int4_matmul/tile": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"qlora: training window launches {got}, expected {want} (the "
             f"3 MLP projections of each layer and the head, per step)")
    row["launches"] = got["int4_matmul/wg"]
    row["backward_launches"] = got["int4_matmul_backward"]
    with torch.no_grad():
        merged = merge_lora(qbase, lora, dtype=torch.bfloat16)
    del lora
    q_run = serve_tuned(torch, dev, card, cfg, merged,
                        "qlora [int4_awq base, int8 KV]", "int4_awq", "int8")
    del merged, qbase
    free_memory(torch)

    sft = train_sft(torch, dev, card, cfg, base)
    del base
    free_memory(torch)

    engine, golden_path = golden_on_card(torch, dev, card)
    try:
        live_eval_on_card(torch, dev, card, engine)
    finally:
        engine.close()
        import shutil
        shutil.rmtree(golden_path, ignore_errors=True)
    free_memory(torch)
    return {"row": row, "bf16": bf16_run, "int4": q_run,
            "lora": bf16_stats, "qlora": q_stats, "sft": sft}


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


# ------------------------------------------------- tensor-parallel serving

# #3 at Llama-2-70B's per-rank shapes under tp = 4: (name, K, N).
TP4_INT4_SHAPES = (("wq", 8192, 2048), ("wk/wv", 8192, 256),
                   ("wo", 2048, 8192), ("w_gate/w_up", 8192, 7168),
                   ("w_down", 7168, 8192), ("lm_head", 8192, 8000))
TP4_ROWS = (1, 8, 128, 1024)
# #1/#2 at the per-rank head counts under tp = 4: (label, H, KV).
TP4_HEADS = (("Llama-2-70B at tp = 4", 16, 2),
             ("Mixtral-8x7B at tp = 4", 8, 2))


def check_tp_shards(torch, dev) -> dict:
    """The three kernels at the shapes each rank gives them under tp = 4:
    #1 and #2 at Llama-2-70B's shard (H 16 / KV 2: G = 8, the kernel's
    full ``MAXG = 8`` group) and Mixtral-8x7B's (H 8 / KV 2: G = 4),
    float32 and bf16, held to their plain versions as
    ``check_paged_attention`` holds them and timed L2-cold with their
    bounds; #3 (bf16 x, group 128, the int4_awq format) at every 70B
    shard shape (wq, wk/wv, wo, w_gate/w_up, w_down, the head's vocab
    shard) at M = 1 and 8 ("tc") and 128 and 1024 ("wg"), held to its
    plain version (bf16 out rtol 1e-2, float32 out for the head rtol
    1e-4, atol 1e-4 * max|ref|) and timed L2-cold beside its plain
    version, its bound and the library yardstick. Returns the rows,
    keyed by kernel and shape."""
    rows = {}
    for label, H, KV in TP4_HEADS:
        for quant in (False, True):
            check_paged_attention(torch, dev, torch.float32, quant=quant,
                                  kv_heads=KV, heads=H, label=label)
            row = check_paged_attention(torch, dev, torch.bfloat16,
                                        quant=quant, kv_heads=KV, heads=H,
                                        label=label)
            rows[f"{row['name']} {label}"] = row
            torch.cuda.empty_cache()
    rows.update(check_int4_shards(torch, dev))
    return rows


def check_int4_shards(torch, dev) -> dict:
    """#3 at ``TP4_INT4_SHAPES`` x ``TP4_ROWS`` (``check_tp_shards``)."""
    return check_int4_rows(torch, dev, TP4_INT4_SHAPES, TP4_ROWS, "70B tp=4")


# The tensor-parallel parity run (``--tp``): Llama-2-70B's width, cut in
# depth; float32 (TF32 off) at 2 layers, bf16 at 8.
TP_F32_LAYERS = 2
TP_BF16_LAYERS = 8
TP_PROMPTS = ["Tell me about tensor parallelism. " * 3,
              "The quick brown fox jumps over the lazy dog. " * 4]
TP_SPEC_PROMPT = "The cat sat on the mat. The dog sat on the log. " * 6
TP_NEW = 24
# A parting of greedy tokens counts as a near tie below this top-2 logit
# gap of the one-card model: bf16 rounds at other places when the sums
# are split over ranks (about 2^-8 of a logit of size 1).
TP_TIE = {"float32": 1e-3, "bfloat16": 0.05}
# Float32 logits of the tp run against the one-card run: atol relative
# to max|logit| (sums over 28672 products in another order).
TP_LOGIT_RTOL = 1e-4


def tp_engine_cfg(dtype: str, vocab_size: int, **kw):
    """The parity engines' config: 4 slots, prompts up to 512 tokens,
    the tail streamed in tiles of 8000 at a 32000 vocab (each rank's
    whole vocab shard at tp = 4, and the one-card engine's tile too, so
    both draw the same noise; the default for a smaller vocab)."""
    from generativeaiexamples_tpu_torch.engine import EngineConfig
    return EngineConfig(max_slots=4, max_input_length=512,
                        max_output_length=64, prefill_buckets=(256, 512),
                        dtype=dtype, kv_pool_tokens=8192,
                        sampler_tile=8000 if vocab_size >= 32000 else None,
                        seed=0, **kw)


def tp_serve(engine, requests) -> Optional[list]:
    """The leader serves ``requests`` ((prompt ids, SamplingParams)) one
    after another and closes; a follower replays until the close. Returns
    the leader's token lists (None on a follower)."""
    if not engine.leader:
        engine.follow()
        engine.close()
        return None
    engine.start()
    try:
        outs = []
        for ids, sp in requests:
            stream = engine.submit(ids, sp)
            stream.text()
            outs.append(list(stream.token_ids))
        return outs
    finally:
        engine.close()


def parting_index(a: list, b: list) -> Optional[int]:
    """The first index where two token lists differ (None if equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def logits_gap(torch, params, cfg, ids: list) -> float:
    """The top-2 logit gap of the token after ``ids`` (one-card model,
    full forward). A long prompt is padded to a multiple of 512 rows (the
    pad, after the last row, is causally invisible to it), so attention
    takes its chunked path."""
    from generativeaiexamples_tpu_torch.models import llama
    dev = params["embed"].device
    n = len(ids)
    padded = list(ids) + [0] * (-n % 512 if n > 512 else 0)
    with torch.no_grad():
        t = torch.tensor([padded], dtype=torch.int32, device=dev)
        pos = torch.arange(len(padded), dtype=torch.int32,
                           device=dev)[None, :]
        hn = llama.apply(params, cfg, t, pos, return_hidden=True)[0]
        top = llama.project_logits(params, hn[:, n - 1])[0].float().topk(2)
    return float(top.values[0] - top.values[1])


def time_collectives(torch, dev, mesh, D: int) -> dict:
    """Device ms of one all-reduce at the decode step's shape (8 rows of
    D, bf16) and a 1024-row prefill's, each from one CUDA graph of many
    (captured as the engine captures them), and the host ms of one round
    header broadcast over the gloo group (a pickled header of an 8-slot
    round's staged writes)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.parallel import comm
    out = {}
    for rows, n in ((8, 160), (1024, 20)):
        x = torch.zeros((rows, D), dtype=torch.bfloat16, device=dev)
        for _ in range(3):
            comm.all_reduce_(x, mesh)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                comm.all_reduce_(x, mesh)
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out[f"all_reduce_{rows}_ms"] = start.elapsed_time(end) / n
        del graph
    header = ("run", "_round_body", (8, True, 8),
              [("copy", "act_idx", np.arange(8, dtype=np.int32))])
    t0 = time.monotonic()
    for _ in range(50):
        if mesh.leader:
            comm.broadcast_header(header, mesh)
        else:
            comm.receive_header(mesh)
    out["header_ms"] = (time.monotonic() - t0) / 50 * 1e3
    return out


def tp_parity(torch, dev, mesh, base=None, layers=(TP_F32_LAYERS,
                                                      TP_BF16_LAYERS)) -> dict:
    """The tensor-parallel model against the one-card model, on every rank
    of ``mesh`` (the leader, rank 0, also runs the one-card model on its
    card, with the same seed; ``base``: the geometry, Llama-2-70B's by
    default, cut to ``layers``). Returns the leader's comparisons, and on
    every rank its launch counts over the tp engines' serves and the
    collectives' times."""
    import dataclasses

    import numpy as np

    from generativeaiexamples_tpu_torch.engine import Engine, SamplingParams
    from generativeaiexamples_tpu_torch.engine import graphs
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_70B
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

    base = base or LLAMA2_70B
    tok = ByteTokenizer()
    lead = mesh.leader
    res = {"rank": mesh.rank}
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["comm"] = time_collectives(torch, dev, mesh, base.hidden_size)
    greedy = SamplingParams(max_tokens=TP_NEW, top_k=1, ignore_eos=True)
    sampled = SamplingParams(max_tokens=TP_NEW, temperature=0.8, top_k=40,
                             top_p=0.9, ignore_eos=True)
    prompts = [tok.encode(p) for p in TP_PROMPTS]
    spec_ids = tok.encode(TP_SPEC_PROMPT)

    def engine(params, cfg, dtype, m=mesh, **kw):
        return Engine(params, cfg, tok,
                      tp_engine_cfg(dtype, cfg.vocab_size, **kw),
                      device=dev, mesh=m)

    def counted(eng, requests):
        before = graphs.launch_counts()
        steps0 = eng.stats["decode_steps"]
        outs = tp_serve(eng, requests)
        return outs, graphs.count_delta(before, graphs.launch_counts()), (
            eng.stats["decode_steps"] - steps0)

    # float32, TF32 off: logits, then engines.
    cfg = dataclasses.replace(base, num_layers=layers[0])
    shard = llama.init_params(cfg, 0, torch.float32, dev, mesh=mesh)
    ids = np.random.default_rng(0).integers(3, 259, (1, 64))
    t = torch.tensor(ids, dtype=torch.int32, device=dev)
    pos = torch.arange(64, dtype=torch.int32, device=dev)[None, :]
    with torch.no_grad():
        logits = llama.apply(shard, cfg, t, pos, mesh=mesh)[0]
    f32 = {}
    f32["greedy"], res["f32_counts"], res["f32_steps"] = counted(
        engine(shard, cfg, "float32"), [(p, greedy) for p in prompts])
    f32["sampled"] = tp_serve(engine(shard, cfg, "float32"),
                              [(p, sampled) for p in prompts])
    f32["materialized"] = tp_serve(
        engine(shard, cfg, "float32", fused_tail=False),
        [(p, greedy) for p in prompts])
    spec = engine(shard, cfg, "float32", spec_decode=True,
                  spec_max_draft_tokens=4)
    f32["spec"] = tp_serve(spec, [(spec_ids, greedy)])
    res["spec_greedy_rounds"] = spec.stats["spec_verify_rounds"]
    spec = engine(shard, cfg, "float32", spec_decode=True,
                  spec_max_draft_tokens=4)
    # Near-greedy sampling keeps to the copy pattern, so drafts land; the
    # round is still a sampled one (fused_verify_sample_tp).
    f32["spec_sampled"] = tp_serve(spec, [(spec_ids, SamplingParams(
        max_tokens=TP_NEW, temperature=0.05, ignore_eos=True))])
    res["spec_sampled_rounds"] = spec.stats["spec_verify_rounds"]
    del spec
    f32["plain_spec_prompt"] = tp_serve(engine(shard, cfg, "float32"),
                                        [(spec_ids, greedy)])
    if lead:
        full = llama.init_params(cfg, 0, torch.float32, dev)
        with torch.no_grad():
            ref = llama.apply(full, cfg, t, pos)[0]
        res["f32_logit_err"] = (logits - ref).abs().max().item()
        res["f32_logit_peak"] = ref.abs().max().item()
        one = {"greedy": tp_serve(engine(full, cfg, "float32", m=None),
                                  [(p, greedy) for p in prompts]),
               "sampled": tp_serve(engine(full, cfg, "float32", m=None),
                                   [(p, sampled) for p in prompts])}
        res["f32"] = {"tp": f32, "one": one}
        res["f32_gaps"] = [
            logits_gap(torch, full, cfg, p + a[:i]) if i is not None
            else None for p, a, b in zip(prompts, f32["greedy"],
                                         one["greedy"])
            for i in [parting_index(a, b)]]
        at = parting_index(f32["spec"][0], f32["plain_spec_prompt"][0])
        res["spec_gap"] = (None if at is None else logits_gap(
            torch, full, cfg, spec_ids + f32["plain_spec_prompt"][0][:at]))
        del full
    del shard, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # bf16 at more depth: greedy tokens up to the first near tie.
    cfg = dataclasses.replace(base, num_layers=layers[1])
    shard = llama.init_params(cfg, 0, torch.bfloat16, dev, mesh=mesh)
    tp_out, res["bf16_counts"], res["bf16_steps"] = counted(
        engine(shard, cfg, "bfloat16"), [(p, greedy) for p in prompts])
    del shard
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if lead:
        full = llama.init_params(cfg, 0, torch.bfloat16, dev)
        one = tp_serve(engine(full, cfg, "bfloat16", m=None),
                       [(p, greedy) for p in prompts])
        res["bf16"] = {"tp": tp_out, "one": one}
        res["bf16_gaps"] = [
            logits_gap(torch, full, cfg, p + a[:i]) if i is not None
            else None for p, a, b in zip(prompts, tp_out, one)
            for i in [parting_index(a, b)]]
        res["bf16_min_gap"] = min(
            logits_gap(torch, full, cfg, p + a[:j])
            for p, a in zip(prompts, one) for j in range(len(a)))
        del full
    return res


def tp_rank_main(rank: int, world: int, init_method: str, queue,
                 task: str, arg=None, device: str = "cuda") -> None:
    """One rank of a ``--tp`` run (a spawned process on card ``rank``, or
    a gloo rank on the CPU with ``device="cpu"``): join the group, run
    ``task`` ("parity", or "ckpt" with ``arg``), put (rank, "ok", result)
    or (rank, "error", traceback) on ``queue``."""
    import traceback

    import torch
    import torch.distributed as dist
    try:
        from generativeaiexamples_tpu_torch.parallel.mesh import (
            MeshPlan, make_mesh, maybe_init_distributed)
        if device == "cpu":
            torch.set_num_threads(1)
        # A rank that hangs fails the group within 300 s.
        maybe_init_distributed(init_method, world, rank, device=device,
                               timeout_s=300)
        mesh = make_mesh(MeshPlan(tp=world), device=device)
        dev = (torch.device("cuda", rank) if device == "cuda"
               else torch.device("cpu"))
        if task == "parity":
            out = tp_parity(torch, dev, mesh)
        elif task == "ckpt":
            out = tp_ckpt_rank(torch, dev, mesh, arg)
        elif task in MESH_TASKS:
            out = MESH_TASKS[task](torch, dev, world, device, arg)
        else:
            raise ValueError(f"unknown task {task!r}")
        queue.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - reported, then re-raised
        queue.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, task: str, timeout: float, arg=None,
              device: str = "cuda") -> list:
    """``task`` on ``world`` spawned ranks (``tp_rank_main`` on
    ``device``); their results in rank order. A rank's error, a rank
    that dies, or one past ``timeout`` fails."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=tp_rank_main,
                         args=(r, world, init, q, task, arg, device),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, status, out = q.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.name for p in procs
                        if not p.is_alive() and p.exitcode not in (0, None)]
                if dead or time.monotonic() > deadline:
                    fail(f"tp {task}: ranks {dead or 'timed out'} without "
                         f"a result")
                continue
            if status != "ok":
                fail(f"tp {task}: rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


def check_tp_parity(results: list, L: tuple) -> dict:
    """The leader's comparisons of ``tp_parity`` and every rank's launch
    counts: #1 once per layer per decode step on every rank."""
    lead = results[0]
    err, peak = lead["f32_logit_err"], lead["f32_logit_peak"]
    say(f"tp parity float32, 70B width, {L[0]} layers (TF32 off): logits "
        f"max abs err {err} against max|logit| {peak} (tolerance "
        f"{TP_LOGIT_RTOL} x max|logit|)")
    if not err <= TP_LOGIT_RTOL * peak:
        fail(f"tp float32 logits disagree with the one-card model: {err}")

    def parted(label, tp_out, one_out, gaps, tie):
        for i, (a, b) in enumerate(zip(tp_out, one_out)):
            at = parting_index(a, b)
            gap = gaps[i] if gaps else None
            say(f"tp parity {label} prompt {i}: tp tokens {a}; one-card "
                f"{b}; first parting {at}"
                + (f" at a top-2 gap of {gap}" if at is not None else ""))
            if at is not None and not (gap is not None and gap < tie):
                fail(f"tp {label} greedy tokens part from the one-card "
                     f"model's at token {at} (top-2 gap {gap}, not a near "
                     f"tie below {tie})")

    f32 = lead["f32"]
    parted("float32", f32["tp"]["greedy"], f32["one"]["greedy"],
           lead["f32_gaps"], TP_TIE["float32"])
    if f32["tp"]["materialized"] != f32["tp"]["greedy"]:
        fail(f"tp sharded fused tail {f32['tp']['greedy']} != materialized "
             f"tail {f32['tp']['materialized']}")
    say("tp parity float32: the sharded fused tail's greedy tokens equal "
        "the materialized tail's")
    same = sum(x == y for a, b in zip(f32["tp"]["sampled"],
                                      f32["one"]["sampled"])
               for x, y in zip(a, b))
    say(f"tp parity float32 sampled (temperature 0.8, top_k 40, top_p "
        f"0.9; same generator seed, tiles of 8000): {same} of "
        f"{sum(map(len, f32['one']['sampled']))} tokens equal the one-card "
        f"engine's (tp {f32['tp']['sampled']}, one-card "
        f"{f32['one']['sampled']})")
    for out in f32["tp"]["sampled"] + f32["tp"]["spec_sampled"]:
        if len(out) != TP_NEW or not all(0 <= x < 32000 for x in out):
            fail(f"tp sampled tokens out of range: {out}")
    if (lead["spec_greedy_rounds"] <= 0 or lead["spec_sampled_rounds"] <= 0):
        fail(f"tp spec decoding ran no verify round (greedy "
             f"{lead['spec_greedy_rounds']}, sampled "
             f"{lead['spec_sampled_rounds']})")
    at = parting_index(f32["tp"]["spec"][0], f32["tp"]["plain_spec_prompt"][0])
    gap = lead["spec_gap"]
    say(f"tp spec decoding: greedy {lead['spec_greedy_rounds']} verify "
        f"rounds, tokens {f32['tp']['spec'][0]} against the plain engine's "
        f"{f32['tp']['plain_spec_prompt'][0]} (first parting {at}"
        + (f", top-2 gap {gap}" if at is not None else "") + "); sampled "
        f"{lead['spec_sampled_rounds']} verify rounds through "
        f"fused_verify_sample_tp, tokens {f32['tp']['spec_sampled'][0]}")
    if at is not None and not gap < TP_TIE["float32"]:
        fail("tp spec decoding's greedy tokens part from the plain "
             "engine's away from a near tie")
    bf16 = lead["bf16"]
    parted("bf16", bf16["tp"], bf16["one"], lead["bf16_gaps"],
           TP_TIE["bfloat16"])
    say(f"tp parity bf16, {L[1]} layers: smallest top-2 gap along the "
        f"one-card tokens {lead['bf16_min_gap']}")
    for r in results:
        for key, layers, steps in (("f32_counts", L[0], lead["f32_steps"]),
                                   ("bf16_counts", L[1], lead["bf16_steps"])):
            n = r[key].get("paged_attention_decode", 0)
            if steps <= 0 or n != layers * steps:
                fail(f"tp rank {r['rank']}: #1 launched {n} times over "
                     f"{steps} decode steps of {layers} layers ({key})")
    say(f"tp parity launches: #1 on every rank once per layer per decode "
        f"step ({lead['f32_steps']} and {lead['bf16_steps']} steps)")
    comm_ms = lead.get("comm")
    if comm_ms is None:       # a rehearsal on the CPU times nothing
        return None
    say(f"tp collectives (rank 0): all-reduce of 8 x 8192 bf16 "
        f"{comm_ms['all_reduce_8_ms']} ms, of 1024 x 8192 "
        f"{comm_ms['all_reduce_1024_ms']} ms (CUDA-graph replay); header "
        f"broadcast {comm_ms['header_ms']} ms (host clock, gloo)")
    return comm_ms


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def served_weight_bytes(cfg, tp: int, quantization: str) -> int:
    """The weight bytes one rank streams per decode step: its share of
    every projection and of the head (int4_awq: packed nibbles and group
    scales), not the embedding table (a step gathers its tokens' rows)."""
    from generativeaiexamples_tpu_torch.models import llama
    total = 0
    shapes = dict(llama.projection_shapes(cfg))
    shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
    for key, shape in shapes.items():
        n = 1
        for d in shape:
            n *= d
        quant = quantization and len(shape) <= 3 and key != "router"
        K = shape[-2]
        total += (n // 2 + 4 * (n // K) * (K // 128)) if quant else 2 * n
    return total // tp


def serve_tp_cli(name: str, tp: int, quantization: str = "",
                 kv_quant: str = "", layers: int = 0, device: str = "cuda",
                 check_launches: bool = True) -> dict:
    """A registry model served at tp = ``tp`` through the model server's
    CLI (``python -m generativeaiexamples_tpu_torch.serving NAME
    --tensor-parallelism TP --no-embedder``): rank 0 serves, ``tp - 1``
    follower processes replay. Each rank's launch counts are read
    (``/debug/launches``) around the served requests: 4 concurrent
    /v1/completions (2 greedy, 2 sampled), one stream's decode (a
    1-token request, then a 65-token one: the step on the host clock),
    8 streams' decode the same way, and a 1000-token prompt's prefill
    (bucket 1024; a 1-token request on the host clock). Every rank's
    #1 (bf16 pool) or #2 (int8) must have run once per layer per decode
    step, and under int4 weights #3 once per projection as
    ``check_launch_counts`` counts it. Then SIGTERM: the server and its
    followers must exit 0."""
    import signal
    import tempfile

    port = free_port()
    cmd = [sys.executable, "-m", "generativeaiexamples_tpu_torch.serving",
           name, "--device", device, "--no-embedder", "--grpc-port", "0",
           "--port", str(port), "--max-input-length", "1024",
           "--max-output-length", "80", "--max-batch-size", "8"]
    cmd += (["--tensor-parallelism", str(tp)] if device == "cuda" else
            ["--world-size", str(tp), "--dtype", "float32"])
    if quantization:
        cmd += ["--quantization", quantization]
    if kv_quant:
        cmd += ["--kv-quant", kv_quant]
    label = f"{name} tp={tp} {quantization or 'bf16'}" + (
        f" + {kv_quant} KV" if kv_quant else "")
    log_path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_tp_"),
                            "server.log")
    env = dict(os.environ, HISTORY_INTERVAL_S="0")
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env, start_new_session=True)
    base = f"http://127.0.0.1:{port}"
    out: dict = {"label": label}
    try:
        while True:
            if proc.poll() is not None:
                fail(f"{label}: the server exited with {proc.returncode} "
                     f"before answering; log {log_path}:\n"
                     + open(log_path).read()[-3000:])
            try:
                health = json.loads(call(base + "/health", timeout=10)[1])
                break
            except OSError:
                if time.monotonic() - t0 > 900:
                    fail(f"{label}: no /health within 900 s")
                time.sleep(2)
        out["startup_s"] = time.monotonic() - t0
        if health.get("tp") != tp:
            fail(f"{label}: /health says tp {health.get('tp')}")
        c0 = json.loads(call(base + "/debug/launches")[1])["ranks"]
        s0 = health["engine"]
        bodies = [{"prompt": p, "max_tokens": 32, "temperature": temp,
                   "top_p": 0.9, "ignore_eos": True}
                  for p, temp in zip(TP_PROMPTS * 2, (0, 0, 0.8, 0.8))]
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(4) as pool:
            texts = list(pool.map(
                lambda b: json.loads(post(base + "/v1/completions", b)),
                bodies))
        for body, resp in zip(bodies, texts):
            if resp["usage"]["completion_tokens"] != 32:
                fail(f"{label}: a completion gave {resp['usage']}")
        out["texts"] = [r["choices"][0]["text"] for r in texts]

        def timed(body, n=1):
            t = time.monotonic()
            with ThreadPoolExecutor(n) as pool:
                list(pool.map(lambda b: post(base + "/v1/completions", b),
                              [body] * n))
            return (time.monotonic() - t) * 1e3

        one = {"prompt": TP_PROMPTS[0], "max_tokens": 1, "temperature": 0}
        many = dict(one, max_tokens=65, ignore_eos=True)
        for n in (1, 8):
            first = timed(one, n)
            out[f"step_ms_{n}"] = (timed(many, n) - first) / 64
        prompt = ("Long context for the prefill timing. " * 40)[:1000]
        timed({"prompt": prompt, "max_tokens": 1, "temperature": 0})
        out["prefill_1024_ms"] = timed({"prompt": prompt[::-1],
                                        "max_tokens": 1, "temperature": 0})
        health = json.loads(call(base + "/health")[1])
        c1 = json.loads(call(base + "/debug/launches")[1])["ranks"]
        s1 = health["engine"]
        run = {k: s1[k] - s0[k] for k in ("decode_steps", "prefills",
                                         "prefill_dispatches")}
        out["run"] = run
        out["launches"] = []
        for rank, (a, b) in enumerate(zip(c0, c1)):
            delta = {k: b[k] - a.get(k, 0) for k in b}
            out["launches"].append(delta)
            if not check_launches:
                continue
            got = dict(run, launches={
                k: delta[k] for k in ("paged_attention_decode",
                                      "paged_attention_decode_int8",
                                      "int4_matmul")},
                by_path={p: delta.get(f"int4_matmul/{p}", 0)
                         for p in ("tc", "gemv", "tile", "wg")})
            check_launch_counts(f"{label} rank {rank}", got, layers,
                                quantization, kv_quant, n_tiles=1,
                                per_layer=4 if "mixtral" in name else 7)
        if check_launches:
            say(f"{label}: on every one of the {tp} ranks #1/#2 and #3 "
                f"launched as counted over {run['decode_steps']} decode "
                f"steps, {run['prefills']} admissions, "
                f"{run['prefill_dispatches']} prefill programs: "
                f"{out['launches'][0]}")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=180)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            fail(f"{label}: the server did not exit within 180 s of "
                 f"SIGTERM")
    if rc != 0:
        fail(f"{label}: the server exited with {rc}; log {log_path}:\n"
             + open(log_path).read()[-3000:])
    say(f"{label}: started in {out['startup_s']:.1f} s; texts "
        f"{[t[:24] for t in out['texts']]}")
    return out


# The checkpoint phase of ``--tp`` (phase 13): Llama-2-70B's width cut to
# this many layers, written from seed 0 by the port's writer as a bf16
# safetensors directory and a GPTQ directory of group 128, each with
# golden-tiny's 32,000-piece tokenizer. At 4 layers the phase took 421 s
# of four cards; 2 keep the whole --tp run within its chip budget.
TP_CKPT_LAYERS = 2
# The CLI's engine for those serves, and the reference engines built the
# same way (``tp_ckpt_engine_cfg``): 8 slots, 1024-token prompts, a fixed
# pool (the one-card reference runs on card 0 after the servers exit).
TP_CKPT_CLI = ["--max-input-length", "1024", "--max-output-length", "80",
               "--max-batch-size", "8", "--kv-pool-tokens", "16384"]
TP_CKPT_NEW = 24
TP_SCORE_TEXT = ("Tensor parallelism splits each weight of the model over "
                 "the cards, and every card computes its share. ") * 10
# A rank's device peak over its load against its shard's bytes, and its
# host resident growth against the checkpoint's bytes.
TP_LOAD_DEVICE_SLACK = 1.1
TP_LOAD_RSS_SHARE = 0.4
TP_SCORE_RTOL = 1e-4
TP_RAG_QUESTIONS = ["How does the engine admit a long prompt?",
                    "What does the host KV tier keep?"]
_HF_PROJ = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
            "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
            "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
            "w_down": "mlp.down_proj"}


def tp_ckpt_cfg(layers: int = 0, base=None):
    import dataclasses

    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_70B
    return dataclasses.replace(base or LLAMA2_70B,
                               num_layers=layers or TP_CKPT_LAYERS)


def tp_ckpt_engine_cfg(dtype: str, **kw):
    """The CLI's engine config for ``TP_CKPT_CLI`` (``_build_rank``'s)."""
    from generativeaiexamples_tpu_torch.engine import EngineConfig
    return EngineConfig(max_slots=8, max_input_length=1024,
                        max_output_length=80, page_size=128, dtype=dtype,
                        kv_pool_tokens=16384, seed=0, **kw)


def pack_u4(u, axis: int):
    """uint4 values (numpy) -> int32 words along ``axis``, value j at bits
    4j (GPTQ's packing)."""
    import numpy as np
    u = np.moveaxis(u.astype(np.uint32), axis, 0)
    out = np.zeros((u.shape[0] // 8, *u.shape[1:]), np.uint32)
    for j in range(8):
        out |= u[j::8] << (4 * j)
    return np.ascontiguousarray(np.moveaxis(out.view(np.int32), 0, axis))


def gptq_parts(torch, w, group: int = 128) -> tuple:
    """GPTQ's stored (qweight, qzeros, scales) of a (K, N) weight, on the
    host: per (group, column) an asymmetric 4-bit grid, w ~ (u - 1 - uz) *
    s with fp16 s. Groups lie along K, so a rank's block of the result is
    the result of its block."""
    K, N = w.shape
    g = w.float().reshape(K // group, group, N)
    lo, hi = g.amin(1), g.amax(1)
    s = ((hi - lo) / 15).clamp_min(1e-6).half().float()
    z = torch.clamp(torch.round(-lo / s), 1, 15)
    u = torch.clamp(torch.round(g / s[:, None]) + z[:, None], 0, 15)
    qweight = pack_u4(u.reshape(K, N).to(torch.uint8).cpu().numpy(), 0)
    qzeros = pack_u4((z - 1).to(torch.uint8).cpu().numpy(), 1)
    return (torch.from_numpy(qweight), torch.from_numpy(qzeros),
            s.half().cpu())


def write_tp_checkpoints(torch, dev, cfg, root: str,
                         kinds: tuple = ("bf16", "gptq")) -> dict:
    """The seed-0 bf16 tree of ``cfg`` (made on ``dev``) written by the
    port's writer (``save_sharded``) as an HF safetensors directory and a
    GPTQ directory of group 128 (its projections through ``gptq_parts``),
    each with a ``config.json`` and golden-tiny's tokenizer (``kinds``:
    which of the two). Returns {"bf16": dir, "gptq": dir, "bytes": {kind:
    tensor bytes}}."""
    import shutil

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.safetensors import \
        save_sharded
    tree = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    hf = {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
          "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads,
          "max_position_embeddings": cfg.max_position_embeddings,
          "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta}
    top = {"model.embed_tokens.weight": tree["embed"],
           "model.norm.weight": tree["final_norm"],
           "lm_head.weight": tree["lm_head"].T}
    lay = tree["layers"]
    out = {"bytes": {}}
    for kind in kinds:
        d = os.path.join(root, f"llama-2-70b-{kind}-{cfg.num_layers}l")
        os.makedirs(d, exist_ok=True)
        state = dict(top)
        for i in range(cfg.num_layers):
            base = f"model.layers.{i}."
            state[base + "input_layernorm.weight"] = lay["attn_norm"][i]
            state[base + "post_attention_layernorm.weight"] = \
                lay["mlp_norm"][i]
            for key, proj in _HF_PROJ.items():
                w = lay[key][i]
                if kind == "bf16":
                    state[f"{base}{proj}.weight"] = w.T
                    continue
                qw, qz, sc = gptq_parts(torch, w)
                state.update({f"{base}{proj}.qweight": qw,
                              f"{base}{proj}.qzeros": qz,
                              f"{base}{proj}.scales": sc})
        out["bytes"][kind] = sum(t.numel() * t.element_size()
                                 for t in state.values())
        save_sharded(state, d, shards=8)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf, f)
        shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 GOLDEN, "tokenizer.model"), d)
        out[kind] = d
        del state
    del tree, top, lay
    torch.cuda.empty_cache()
    return out


def tp_gptq_shard(torch, dev, cfg, mesh) -> dict:
    """This rank's GPTQ tree made from its own seed-0 bf16 shard
    (``init_params(..., mesh=)``) through ``gptq_parts`` and the port's
    ``gptq_leaf``: the bytes a rank reads from the GPTQ directory."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.import_quantized import \
        gptq_leaf
    shard = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                              mesh=mesh)
    layers = dict(shard["layers"])
    for key in _HF_PROJ:
        parts = [gptq_leaf(*(t.to(dev) for t in gptq_parts(
            torch, layers[key][i]))) for i in range(cfg.num_layers)]
        layers[key] = {k: torch.stack([p[k] for p in parts])
                       for k in parts[0]}
        del parts
    return dict(shard, layers=layers)


def tp_ckpt_rank(torch, dev, mesh, arg: dict) -> dict:
    """One rank of the checkpoint phase (``arg``: the directories, the
    prompts). Every rank returns its launch counts around its serves; the
    leader also: the reference engines' texts (float32 from the seed-0
    shard, bf16 from the GPTQ shard of ``tp_gptq_shard``), then on
    ``build_services`` over the bf16 directory at float32 (its weight
    cache entries written by the CLI's start: each rank's load report) a
    session served, suspended, resumed and served again, a handoff
    export of another prompt (its blob, for the one-card engine), and
    fused RAG with encoder-tiny over a corpus of ``docs/*.md`` chunks:
    each question's fused tokens beside the host path's (the plain
    engine's greedy tokens for the ids the fused program assembled) and
    both TTFTs."""
    import numpy as np

    from generativeaiexamples_tpu_torch.engine import (Engine,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.engine import graphs
    from generativeaiexamples_tpu_torch.engine.rag_fusion import (
        FusedRagSpec, build_prompt_parts, corpus_rows)
    from generativeaiexamples_tpu_torch.models import encoder as enc
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import ENCODER_TINY
    from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.serving import model_server as ms

    cfg = tp_ckpt_cfg(arg["layers"], arg.get("base"))
    tok = get_tokenizer(arg["bf16"])
    greedy = SamplingParams(max_tokens=arg["new"], top_k=1, ignore_eos=True)
    res: dict = {"rank": mesh.rank, "counts": {}}

    def run(name, engine, fn):
        before = graphs.launch_counts()
        steps0 = engine.stats["decode_steps"]
        if not engine.leader:
            engine.follow()
            engine.close()
            out = None
        else:
            engine.start()
            try:
                out = fn(engine)
            finally:
                steps = engine.stats["decode_steps"] - steps0
                engine.close()
            res[f"{name}_steps"] = steps
        res["counts"][name] = graphs.count_delta(before,
                                                 graphs.launch_counts())
        return out

    def texts(engine):
        return [engine.submit(tok.encode(p), greedy).text()
                for p in arg["prompts"]]

    # The references: the seed's float32 shard, and its GPTQ shard.
    shard = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                              mesh=mesh)
    shard = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
                 else v.float()) for k, v in shard.items()}
    res["ref_f32"] = run("ref_f32", Engine(
        shard, cfg, tok, tp_ckpt_engine_cfg("float32"), device=dev,
        mesh=mesh), texts)
    del shard
    torch.cuda.empty_cache()
    res["ref_gptq"] = run("ref_gptq", Engine(
        tp_gptq_shard(torch, dev, cfg, mesh), cfg, tok,
        tp_ckpt_engine_cfg("bfloat16"), device=dev, mesh=mesh), texts)
    torch.cuda.empty_cache()

    # The tier, suspend/resume and the handoff, on the checkpoint's
    # float32 shards (read back from the weight cache).
    engine, _ = ms.build_services(
        "llama-2-70b-chat", engine_cfg=tp_ckpt_engine_cfg(
            "float32", kv_host_pool_tokens=32768), device=dev,
        model_path=arg["bf16"], world_size=mesh.tp)
    res["cache_load"] = dict(ms.last_load)

    def tier(engine):
        out = {}
        hist = tok.encode(arg["prompts"][0] * 6)
        s = engine.submit(hist, greedy)
        s.text()
        out["cold"] = list(s.token_ids)
        t0 = time.monotonic()
        blob = engine.suspend_session(hist)
        out["suspend_ms"] = (time.monotonic() - t0) * 1e3
        out["suspend_bytes"] = len(blob)
        t0 = time.monotonic()
        out["resumed"] = engine.resume_session(blob)
        out["resume_ms"] = (time.monotonic() - t0) * 1e3
        r0 = engine.stats["kv_tier_restore_pages"]
        s = engine.submit(hist, greedy)
        s.text()
        out["warm"] = list(s.token_ids)
        out["restored"] = engine.stats["kv_tier_restore_pages"] - r0
        other = tok.encode(arg["prompts"][1] * 6)
        s = engine.submit(other, greedy)
        s.text()
        out["handoff_ids"], out["handoff_tokens"] = other, list(s.token_ids)
        t0 = time.monotonic()
        out["handoff"] = engine.export_handoff(other)
        out["handoff_ms"] = (time.monotonic() - t0) * 1e3
        return out
    res["tier"] = run("tier", engine, tier)
    del engine
    torch.cuda.empty_cache()

    # Fused RAG on the seed's bf16 shard.
    shard = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                              mesh=mesh)
    engine = Engine(shard, cfg, tok, tp_ckpt_engine_cfg("bfloat16"),
                    device=dev, mesh=mesh)

    def rag(engine):
        enc_params = enc.init_params(ENCODER_TINY, seed=0,
                                     dtype=torch.float32, device=dev)
        chunks = arg["chunks"]
        parts = build_prompt_parts(arg["template"], tok)
        spec = FusedRagSpec(**parts, top_k=4, ctx_budget=600, bucket=1024,
                            chunk_tokens=160, q_bucket=64, enc_bucket=128)
        toks, lens = corpus_rows(chunks, tok, spec.chunk_tokens)
        gen = np.random.default_rng(0)
        emb = gen.standard_normal((len(chunks), ENCODER_TINY.hidden_size)
                                  ).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        engine.enable_fused_rag(enc_params, ENCODER_TINY, spec)
        engine.set_rag_corpus(emb, toks, lens)
        out = []
        for q in arg["questions"]:
            q_ids = tok.encode(q, add_bos=False)
            q_enc = [101] + [3 + ord(c) % 500 for c in q][:100] + [102]
            s = engine.submit_rag(q_ids, q_enc, greedy)
            s.text()
            rows = list(s.source_ids)
            ids = numpy_assembly(spec, [list(t[:n]) for t, n in
                                        zip(toks, lens)], rows, q_ids)
            h = engine.submit(ids, greedy)
            h.text()
            out.append({"fused": list(s.token_ids), "rows": rows,
                        "length": s.rag_length, "assembled": len(ids),
                        "host": list(h.token_ids),
                        "fused_ttft_ms": s.ttft_ms,
                        "host_ttft_ms": h.ttft_ms})
        return out
    res["rag"] = run("rag", engine, rag)
    return res


def serve_tp_ckpt_cli(path: str, tp: int, dtype: str, prompts: list,
                      new: int, score_text: str = "", device: str = "cuda",
                      hosts: int = 1) -> dict:
    """A checkpoint directory served through the model server's CLI at
    ``--tensor-parallelism`` ``tp`` (``--world-size`` on the CPU):
    each rank's load report (``/debug/load``), greedy completions of
    ``prompts`` one after another with each rank's launch counts read
    just before and after (``/debug/launches``), ``/v1/score`` of
    ``score_text`` per token, a clean SIGTERM exit. ``hosts`` > 1: that
    many CLIs, one a host (``--coordinator``, ``--num-processes``,
    ``--process-id``; on the card each sees its ``tp / hosts`` cards
    through ``CUDA_VISIBLE_DEVICES``), only the first answering HTTP;
    SIGTERM to every one, and each must exit 0."""
    import signal
    import tempfile

    port = free_port()
    cmd = [sys.executable, "-m", "generativeaiexamples_tpu_torch.serving",
           "llama-2-70b-chat", "--model-path", path, "--device", device,
           "--dtype", dtype, "--no-embedder", "--grpc-port", "0",
           "--port", str(port), *TP_CKPT_CLI]
    cmd += (["--tensor-parallelism", str(tp)] if device == "cuda" else
            ["--world-size", str(tp)])
    label = f"checkpoint {os.path.basename(path)} tp={tp} {dtype}" + (
        f" over {hosts} hosts" if hosts > 1 else "")
    logs = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"),
                        "server{}.log")
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    t0 = time.monotonic()
    for h in range(hosts):
        env = dict(os.environ, HISTORY_INTERVAL_S="0")
        host_cmd = list(cmd)
        if hosts > 1:
            host_cmd += ["--coordinator", coordinator, "--num-processes",
                         str(hosts), "--process-id", str(h)]
            if device == "cuda":
                per = tp // hosts
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    str(h * per + i) for i in range(per))
        with open(logs.format(h), "w") as log:
            procs.append(subprocess.Popen(
                host_cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                start_new_session=True))
    base = f"http://127.0.0.1:{port}"
    out: dict = {"label": label}
    try:
        while True:
            for h, proc in enumerate(procs):
                if proc.poll() is not None:
                    fail(f"{label}: host {h}'s server exited with "
                         f"{proc.returncode} before answering; log:\n"
                         + open(logs.format(h)).read()[-3000:])
            try:
                health = json.loads(call(base + "/health", timeout=10)[1])
                break
            except OSError:
                if time.monotonic() - t0 > 900:
                    fail(f"{label}: no /health within 900 s")
                time.sleep(2)
        out["startup_s"] = time.monotonic() - t0
        if health.get("tp") != tp:
            fail(f"{label}: /health says tp {health.get('tp')}")
        out["load"] = json.loads(call(base + "/debug/load")[1])["ranks"]
        c0 = json.loads(call(base + "/debug/launches")[1])["ranks"]
        s0 = health["engine"]
        out["texts"] = []
        for p in prompts:
            resp = json.loads(post(base + "/v1/completions", {
                "prompt": p, "max_tokens": new, "temperature": 0,
                "ignore_eos": True}))
            if resp["usage"]["completion_tokens"] != new:
                fail(f"{label}: a completion gave {resp['usage']}")
            out["texts"].append(resp["choices"][0]["text"])
        c1 = json.loads(call(base + "/debug/launches")[1])["ranks"]
        s1 = json.loads(call(base + "/health")[1])["engine"]
        out["run"] = {k: s1[k] - s0[k] for k in ("decode_steps", "prefills",
                                                 "prefill_dispatches")}
        out["launches"] = [{k: b[k] - a.get(k, 0) for k in b}
                           for a, b in zip(c0, c1)]
        if len(out["launches"]) != tp:
            fail(f"{label}: /debug/launches lists {len(out['launches'])} "
                 f"ranks")
        if score_text:
            t = time.monotonic()
            out["score"] = json.loads(post(base + "/v1/score", {
                "text": score_text, "per_token": True}))
            out["score_ms"] = (time.monotonic() - t) * 1e3
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        rcs = []
        for h, proc in enumerate(procs):
            try:
                rcs.append(proc.wait(timeout=180))
            except subprocess.TimeoutExpired:
                for p in procs:
                    if p.poll() is None:
                        os.killpg(p.pid, signal.SIGKILL)
                fail(f"{label}: host {h}'s server did not exit within 180 "
                     f"s of SIGTERM")
    for h, rc in enumerate(rcs):
        if rc != 0:
            fail(f"{label}: host {h}'s server exited with {rc}; log:\n"
                 + open(logs.format(h)).read()[-3000:])
    return out


def check_tp_load(label: str, load: list, tree_bytes: int,
                  on_card: bool = True) -> list:
    """Each rank's cold load report: the device peak over the load at most
    ``TP_LOAD_DEVICE_SLACK`` x its served shard's bytes, the host resident
    growth under ``TP_LOAD_RSS_SHARE`` of the checkpoint's bytes (checked
    ``on_card`` only: a CPU rehearsal's tree is host memory)."""
    rows, over = [], []
    for r in load:
        if r.get("from_cache"):
            fail(f"{label} rank {r['rank']}: the cold start read the "
                 f"weight cache")
        dev_ratio = r["max_memory_allocated"] / r["tree_bytes"]
        rss_ratio = r["rss_growth"] / tree_bytes
        say(f"{label} rank {r['rank']}: loaded in {r['seconds']:.2f} s; "
            f"device peak {r['max_memory_allocated']} B against its shard's "
            f"{r['tree_bytes']} B ({dev_ratio:.4f}x, limit "
            f"{TP_LOAD_DEVICE_SLACK}); host RSS growth {r['rss_growth']} B "
            f"(peak {r['rss_peak']} B during the load, {r['rss_before']} B "
            f"resident before it) against the checkpoint's {tree_bytes} B "
            f"({rss_ratio:.4f}, limit {TP_LOAD_RSS_SHARE})")
        if on_card and r["rss_peak"] <= 0:
            fail(f"{label} rank {r['rank']}: no resident-memory reading")
        if on_card and (dev_ratio > TP_LOAD_DEVICE_SLACK
                        or rss_ratio >= TP_LOAD_RSS_SHARE):
            over.append(f"rank {r['rank']}: {dev_ratio:.3f}x its shard on "
                        f"the card, host growth {rss_ratio:.3f} of the tree")
        rows.append({"rank": r["rank"], "seconds": r["seconds"],
                     "device_ratio": dev_ratio, "rss_ratio": rss_ratio})
    if over:
        fail(f"{label}: over the load limits: {over}")
    return rows


def tp_checkpoint_phase(torch, tp: int, device: str = "cuda", base=None,
                        layers: int = 0, check_launches: bool = True
                        ) -> dict:
    """Phase 13 (``--tp``): checkpoints read rank by rank at Llama-2-70B's
    width, cut to ``TP_CKPT_LAYERS``: ``write_tp_checkpoints``, each
    directory through the CLI (the bf16 one served in float32, the GPTQ
    one in bf16): the cold load's memory (``check_tp_load``), greedy texts
    equal to the engines built from the seed-0 shards in the same config
    (``tp_ckpt_rank``: the same bytes and programs, so exactly), every
    rank's #1 (and #3 under GPTQ) once per layer per decode step (and per
    projection); ``/v1/score`` in float32 against the one-card score on
    card 0 within ``TP_SCORE_RTOL`` x max|NLL|; suspend/resume with the
    uninterrupted run's tokens, the tp handoff continued on one card
    (tokens equal up to a near tie, its gap printed); fused RAG's tokens
    equal the host path's. Returns the numbers it printed."""
    import shutil
    import tempfile

    from generativeaiexamples_tpu_torch.engine import Engine, SamplingParams
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.import_hf import \
        load_checkpoint
    from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer

    cfg = tp_ckpt_cfg(layers, base)
    L = cfg.num_layers
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        "cpu")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_dirs_")
    saved_cache = os.environ.get("GAIE_WEIGHT_CACHE_DIR")
    os.environ["GAIE_WEIGHT_CACHE_DIR"] = os.path.join(root, "weight_cache")
    out: dict = {}
    try:
        t0 = time.monotonic()
        dirs = write_tp_checkpoints(torch, dev, cfg, root)
        out["write_s"] = time.monotonic() - t0
        say(f"tp checkpoints: 70B width, {L} layers, written in "
            f"{out['write_s']:.1f} s: bf16 {dirs['bytes']['bf16']} B, GPTQ "
            f"group 128 {dirs['bytes']['gptq']} B")
        served = {
            "f32": serve_tp_ckpt_cli(dirs["bf16"], tp, "float32", TP_PROMPTS,
                                     TP_CKPT_NEW, TP_SCORE_TEXT,
                                     device=device),
            "gptq": serve_tp_ckpt_cli(dirs["gptq"], tp, "bfloat16",
                                      TP_PROMPTS, TP_CKPT_NEW,
                                      device=device)}
        out["load"] = {
            key: check_tp_load(served[key]["label"], served[key]["load"],
                               dirs["bytes"][kind], device == "cuda")
            for key, kind in (("f32", "bf16"), ("gptq", "gptq"))}
        docs = sorted(os.path.join("docs", n) for n in os.listdir("docs")
                      if n.endswith(".md"))[:4]
        chunks = [c for d in docs for c in
                  open(d, encoding="utf-8").read().split("\n\n")
                  if len(c) > 200][:64]
        arg = {"bf16": dirs["bf16"], "layers": L, "base": base,
               "prompts": TP_PROMPTS, "new": TP_CKPT_NEW, "chunks": chunks,
               "questions": TP_RAG_QUESTIONS,
               "template": ("[INST] <<SYS>>\nAnswer from the context.\n"
                            "<</SYS>>\nContext: {context_str}\n\nQuestion: "
                            "{query_str} [/INST]")}
        results = run_ranks(tp, "ckpt", timeout=900, arg=arg, device=device)
        lead = results[0]
        for key, ref in (("f32", "ref_f32"), ("gptq", "ref_gptq")):
            got = served[key]["texts"]
            say(f"{served[key]['label']}: started in "
                f"{served[key]['startup_s']:.1f} s; texts "
                f"{[t[:32] for t in got]}")
            if got != lead[ref]:
                fail(f"{served[key]['label']}: texts {got} differ from the "
                     f"engine's on the seed's shards {lead[ref]}")
            run = served[key]["run"]
            for r, delta in enumerate(served[key]["launches"]):
                if not check_launches:
                    continue
                check_launch_counts(
                    f"{served[key]['label']} rank {r}",
                    dict(run, launches={k: delta.get(k, 0) for k in (
                        "paged_attention_decode",
                        "paged_attention_decode_int8", "int4_matmul")},
                        by_path={p: delta.get(f"int4_matmul/{p}", 0)
                                 for p in ("tc", "gemv", "tile", "wg")}),
                    L, "int4" if key == "gptq" else "", "", n_tiles=0,
                    head=False)
        say(f"tp checkpoints: the CLI's greedy texts equal the engines' on "
            f"the seed's shards (float32 and GPTQ); launches as counted on "
            f"every rank")
        out["served"] = {k: {"startup_s": v["startup_s"],
                             "launches": v["launches"][0], "run": v["run"]}
                         for k, v in served.items()}
        # The one-card references on card 0.
        tok = get_tokenizer(dirs["bf16"])
        full = load_checkpoint(dirs["bf16"], cfg, torch.float32, dev)
        ids = tok.encode(TP_SCORE_TEXT)
        with torch.no_grad():
            one = llama.score(full, cfg, torch.tensor(
                [ids], dtype=torch.int32, device=dev))[0].double().cpu()
        tp_nll = torch.tensor(served["f32"]["score"]["nll"],
                              dtype=torch.float64)
        err = float((tp_nll - one).abs().max())
        peak = float(one.abs().max())
        out["score"] = {"err": err, "peak": peak, "tokens": len(ids),
                        "ms": served["f32"]["score_ms"]}
        say(f"tp checkpoints: /v1/score at tp={tp} in float32 over "
            f"{len(ids)} tokens ({served['f32']['score_ms']:.1f} ms, HTTP "
            f"included) against one card: max abs err {err} against "
            f"max|NLL| {peak} (tolerance {TP_SCORE_RTOL} x max|NLL|; the "
            f"server rounds to 1e-6)")
        if not err <= TP_SCORE_RTOL * peak + 1e-6:
            fail(f"tp /v1/score disagrees with one card: {err}")
        tier = lead["tier"]
        say(f"tp checkpoints: float32 shards from the weight cache in "
            f"{lead['cache_load']['seconds']:.2f} s on rank 0 (from_cache "
            f"{lead['cache_load']['from_cache']}); suspend "
            f"{tier['suspend_ms']:.1f} ms ({tier['suspend_bytes']} B), "
            f"resume {tier['resume_ms']:.1f} ms, {tier['restored']} pages "
            f"restored; handoff export {tier['handoff_ms']:.1f} ms")
        if (not lead["cache_load"]["from_cache"] or tier["restored"] <= 0
                or tier["warm"] != tier["cold"]):
            fail(f"tp tier: cache {lead['cache_load']['from_cache']}, "
                 f"restored {tier['restored']}, warm {tier['warm']} vs cold "
                 f"{tier['cold']}")
        blob, blocks = tier["handoff"]
        decode = Engine(full, cfg, tok, tp_ckpt_engine_cfg(
            "float32", kv_host_pool_tokens=32768), device=dev)
        try:
            if decode.resume_session(blob) != blocks:
                fail("the one-card engine did not take every handoff block")
            decode.start()
            s = decode.submit(tier["handoff_ids"], SamplingParams(
                max_tokens=TP_CKPT_NEW, top_k=1, ignore_eos=True))
            s.text()
            restored = decode.stats["kv_tier_restore_pages"]
        finally:
            decode.close()
        one_tokens, tp_tokens = list(s.token_ids), tier["handoff_tokens"]
        at = parting_index(tp_tokens, one_tokens)
        gap = (None if at is None else logits_gap(
            torch, full, cfg, tier["handoff_ids"] + one_tokens[:at]))
        out["handoff"] = {"blocks": blocks, "restored": restored,
                          "parting": at, "gap": gap,
                          "export_ms": tier["handoff_ms"]}
        say(f"tp checkpoints: the tp={tp} handoff ({blocks} blocks) "
            f"continued on one card with {restored} pages restored: tokens "
            f"{one_tokens} against tp's {tp_tokens}, first parting {at}"
            + (f" at a top-2 gap of {gap}" if at is not None else ""))
        if restored <= 0 or (at is not None
                             and not gap < TP_TIE["float32"]):
            fail("the handoff's continuation parts from tp's away from a "
                 "near tie")
        del full
        for q in lead["rag"]:
            say(f"tp fused RAG: rows {q['rows']}, assembled {q['length']} "
                f"tokens (numpy {q['assembled']}); fused {q['fused']} vs "
                f"host path {q['host']}; TTFT fused {q['fused_ttft_ms']:.1f}"
                f" ms, host path {q['host_ttft_ms']:.1f} ms (engine, host "
                f"clock)")
            if q["fused"] != q["host"] or q["length"] != q["assembled"]:
                fail("tp fused RAG differs from the host path")
        out["rag"] = lead["rag"]
        for r in results:
            for name, n_layers in (("ref_f32", L), ("tier", L),
                                   ("rag", L)):
                n = r["counts"][name].get("paged_attention_decode", 0)
                steps = lead[f"{name}_steps"]
                if check_launches and (steps <= 0 or n != n_layers * steps):
                    fail(f"tp rank {r['rank']} {name}: #1 launched {n} "
                         f"times over {steps} steps of {n_layers} layers")
            n3 = r["counts"]["ref_gptq"].get("int4_matmul", 0)
            if check_launches and n3 <= 0:
                fail(f"tp rank {r['rank']}: #3 never ran on the GPTQ shard")
        out["rank_counts"] = [r["counts"] for r in results]
        return out
    finally:
        if saved_cache is None:
            os.environ.pop("GAIE_WEIGHT_CACHE_DIR", None)
        else:
            os.environ["GAIE_WEIGHT_CACHE_DIR"] = saved_cache
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------- the rest of the serving mesh

# The mesh phases' geometry: sp = 4 over a 32768-token prompt (8192 rows
# a rank), Mixtral's 8 experts over ep = 4 (2 a rank).
MESH_SP = 4
SP_SEQ = 32768
SP_NEW = 64
# The sp parity run: Llama-2-7B's width cut to 2 layers, float32, S 4096.
SP_PARITY_S = 4096
MESH_PARITY_LAYERS = 2
# Float32 logits, K/V and NLL of a mesh run against one card's: atol
# relative to max|ref| (sums in another order).
MESH_RTOL = 1e-4
EP_PLANS = (("ep=4", {"ep": 4}), ("ep=2 x tp=2", {"ep": 2, "tp": 2}))
# #3 at the sp prefill's local rows (M = 8192 a rank) on Llama-2-7B's
# MLP shapes: (name, K, N).
SP_INT4_SHAPES = (("w_gate", 4096, 11008), ("w_down", 11008, 4096))


def llama_7b_32k():
    """LLaMA-2-7B-32K's geometry (togethercomputer/LLaMA-2-7B-32K):
    Llama-2-7B with linear rope scaling by 8 over 32768 positions."""
    import dataclasses

    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    return dataclasses.replace(LLAMA2_7B, max_position_embeddings=SP_SEQ,
                               rope_scaling_factor=8.0)


def check_mesh_shards(torch, dev) -> dict:
    """One card, the work each rank of the mesh phases does, at its
    shapes: the ring's tiled block update at an sp = 4 rank's (Llama-2-7B:
    32 heads, hd 128; 8192 local queries against one 8192-row visiting
    block: the diagonal block, causal, and an earlier rank's, all keys
    visible) in float32 (TF32 off) against dense ``gqa_attention`` (atol
    1e-4 x max|ref|), then timed in bf16 beside its operation bound; #1
    and #2 at one slot of 32768 rows, G = 1 (the sp serve's decode:
    ``check_paged_attention`` at ``lengths=[32768]``, timed L2-cold); #3
    ``wg`` at M = 8192 (a rank's prefill rows) on Llama-2-7B's w_gate and
    w_down; the local expert products at ep = 4 (2 of Mixtral's 8
    experts, bf16, on an 8-row decode step's capacity buffers) against a
    float32 product of the same experts (rtol 1e-2), timed beside their
    byte bound. Returns the kernels' rows, keyed."""
    from generativeaiexamples_tpu_torch.ops.attention import gqa_attention
    from generativeaiexamples_tpu_torch.parallel import moe
    from generativeaiexamples_tpu_torch.parallel.mesh import Mesh
    from generativeaiexamples_tpu_torch.parallel.ring_attention import (
        Q_TILE, ring_gqa_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(22)
    one = Mesh(shape={"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 1},
               device=dev)
    S, H, hd = SP_SEQ // MESH_SP, 32, 128
    q, k, v = (torch.randn((1, S, H, hd), generator=gen, device=dev)
               for _ in range(3))
    for label, q0 in (("diagonal block", 0), ("earlier rank's block", S)):
        pos = (q0 + torch.arange(S, device=dev, dtype=torch.int32))[None]
        got = ring_gqa_attention(q, k, v, pos, mesh=one)
        ref = gqa_attention(q, k, v, pos)
        peak = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        if not (torch.isfinite(got).all() and err <= 1e-4 * peak):
            fail(f"ring block update ({label}, float32) disagrees with "
                 f"dense attention: max abs err {err} (max|ref| {peak})")
        say(f"ring block update float32 at an sp={MESH_SP} rank's shape "
            f"({S} queries x {S} keys, H 32, hd 128, {label}): max abs "
            f"err {err} against dense gqa_attention (max|ref| {peak})")
        del got, ref
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    del q, k, v
    pos = (S + torch.arange(S, device=dev, dtype=torch.int32))[None]
    ms = time_cuda(torch, lambda: ring_gqa_attention(qb, kb, vb, pos,
                                                     mesh=one),
                   iters=3, warmup=1)
    flops = 4 * S * S * hd * H
    bound = flops / BF16_FLOPS * 1e3
    say(f"ring block update bf16 (plain PyTorch, {Q_TILE}-query tiles), "
        f"one rank's block a layer: {ms} ms against a {bound} ms operation "
        f"bound ({bound / ms:.1%}); a layer of the sp={MESH_SP} prefill "
        f"runs {MESH_SP} blocks")
    del qb, kb, vb
    torch.cuda.empty_cache()
    rows = {}
    for quant in (False, True):
        check_paged_attention(torch, dev, torch.float32, quant=quant,
                              lengths=[SP_SEQ], label="sp serve, one slot "
                              f"of {SP_SEQ} rows")
        row = check_paged_attention(torch, dev, torch.bfloat16, quant=quant,
                                    lengths=[SP_SEQ], label="sp serve, one "
                                    f"slot of {SP_SEQ} rows")
        rows[f"{row['name']} sp"] = row
        torch.cuda.empty_cache()
    rows.update(check_int4_rows(torch, dev, SP_INT4_SHAPES, (S,),
                                "7B sp prefill"))
    # The local expert products at ep = 4.
    E_local, D, F = 2, 4096, 14336
    C = moe.expert_capacity(8, 8, 2, 2.0)
    ws = [[torch.randn(shape, generator=gen, device=dev).mul_(
        shape[1] ** -0.5).to(torch.bfloat16) for shape in
        ((E_local, D, F), (E_local, D, F), (E_local, F, D))]
        for _ in range(2)]
    ei = torch.randn((E_local, C, D), generator=gen, device=dev).to(
        torch.bfloat16)
    got = moe._expert_ffn(ei, *ws[0]).float()
    g, u, d = (w.float() for w in ws[0])
    x = ei.float()
    ref = torch.bmm(torch.nn.functional.silu(torch.bmm(x, g))
                    * torch.bmm(x, u), d)
    err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, rtol=1e-2,
                          atol=1e-2 * ref.abs().max().item()):
        fail(f"ep=4 local expert products disagree with float32: {err}")
    del g, u, d, x, ref
    ms = time_cuda(torch, [(lambda w=w: moe._expert_ffn(ei, *w))
                           for w in ws], iters=20)
    nbytes = sum(w.numel() * 2 for w in ws[0])
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"ep=4 local expert products (2 of Mixtral's 8 experts, C {C} "
        f"rows each, bf16, three cuBLAS bmm): max abs err {err} against "
        f"float32; {ms} ms against a {bound} ms byte bound ({nbytes} "
        f"bytes; {bound / ms:.1%})")
    del ws, ei
    torch.cuda.empty_cache()
    return rows


def check_int4_rows(torch, dev, shapes, Ms, label: str) -> dict:
    """#3 (bf16 x, group 128, the int4_awq format) at ``shapes`` ((name,
    K, N)) x ``Ms`` rows: each call checked to take the path ``_path``
    names ("tc" at M <= 8, "wg" above), held to its plain version (bf16
    out rtol 1e-2; float32 out for the head, "lm_head", rtol 1e-4; atol
    1e-4 x max|ref|) and timed L2-cold (the calls cycle copies of the
    weight, > 120 MB of them) beside its plain version, its bound and the
    library yardstick. Returns the rows, keyed by shape; ``label`` names
    the geometry."""
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.ops.int4_matmul import (
        _path, int4_matmul, int4_matmul_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(20)
    rows = {}
    for name, K, N in shapes:
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        leaf = quant.quantize_tensor_grouped(w, 128)
        del w
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        wbytes = leaf["q4"].numel() + 4 * leaf["gscale"].numel()
        q4s = [leaf["q4"].clone() for _ in range(1 + (120 << 20) // wbytes)]
        for M in Ms:
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            path = "tc" if M <= 8 else "wg"
            if _path(M, K, N, 128, x.dtype) != path:
                fail(f"int4_matmul M={M} K={K} N={N} would not take the "
                     f"{path!r} path")
            before = int4_matmul.launches_by_path[path]
            got = int4_matmul(x, leaf["q4"], leaf["gscale"],
                              out_dtype=out_dtype)
            if int4_matmul.launches_by_path[path] != before + 1:
                fail(f"int4_matmul M={M} K={K} N={N} did not launch the "
                     f"{path!r} path")
            ref = int4_matmul_plain(x, leaf["q4"], leaf["gscale"],
                                    out_dtype=out_dtype)
            torch.cuda.synchronize()
            peak = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            rtol = 1e-4 if out_dtype == torch.float32 else 1e-2
            if not (got.shape == (M, N) and torch.isfinite(got.float()).all()
                    and torch.allclose(got.float(), ref.float(),
                                       atol=1e-4 * peak, rtol=rtol)):
                fail(f"int4_matmul [{path}] {label} {name} M={M} K={K} "
                     f"N={N} disagrees with its plain version: max abs err "
                     f"{err} (max|ref| {peak})")
            iters = 20 if M >= 1024 else 200
            ms = time_cuda(torch, [
                (lambda q4=q4: int4_matmul(x, q4, leaf["gscale"],
                                           out_dtype=out_dtype))
                for q4 in q4s], iters=iters)
            plain_ms = time_cuda(torch, lambda: int4_matmul_plain(
                x, leaf["q4"], leaf["gscale"], out_dtype=out_dtype),
                iters=3, warmup=1)
            lib_ms, lib_note = int4_library_ms(torch, dev, M, K, N, 128,
                                               iters)
            e_out = 4 if out_dtype == torch.float32 else 2
            nbytes = (K // 2 * N + 4 * (K // 128) * N + M * K * 2
                      + M * N * e_out)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            flops_ms = 2 * M * K * N / BF16_FLOPS * 1e3
            bound = max(bytes_ms, flops_ms)
            by = "bytes" if bytes_ms >= flops_ms else "operations"
            say(f"kernel int4_matmul [{path}] {label} {name} M={M} K={K} "
                f"N={N} group=128: max_abs_err={err} ms={ms} plain_ms="
                f"{plain_ms} bound_ms={bound} ({by}; {bound / ms:.1%} of "
                f"it) library_ms={lib_ms} ({lib_note})")
            rows[f"int4_matmul {label} {name} M={M}"] = int4_row(
                f"{label} {name} M={M} K={K} N={N}", path, err, ms,
                plain_ms, bound, by, lib_ms)
            del x, got, ref
        del q4s, leaf
        torch.cuda.empty_cache()
    return rows


def rank_counts(reports0: list, reports1: list) -> list:
    """Each rank's launch counts between two ``rank_reports``."""
    return [{k: b["launch_counts"][k] - a["launch_counts"].get(k, 0)
             for k in b["launch_counts"]}
            for a, b in zip(reports0, reports1)]


def check_rank_counts(label: str, counts: list, L: int, steps: int,
                      kv_quant: str = "") -> None:
    """#1 (or #2 under an int8 pool) once per layer per decode step on
    every rank."""
    attn = "paged_attention_decode_int8" if kv_quant else \
        "paged_attention_decode"
    for r, c in enumerate(counts):
        if steps <= 0 or c.get(attn, 0) != L * steps:
            fail(f"{label}: rank {r} launched {attn} {c.get(attn)} times "
                 f"over {steps} decode steps of {L} layers")


def ep_parity_rank(torch, dev, world: int, device: str, arg: dict) -> dict:
    """The ep parity phase on one rank: Mixtral's width cut to
    ``arg["layers"]`` (``arg["base"]``: the geometry) at ep = 4 and at
    ep = 2 x tp = 2, float32 (TF32 off): the logits of a 64-token forward
    (rank 0 also the one-card model's, on its card) and greedy tokens
    through ``Engine(mesh=)`` (fresh engines, one request at a time, so
    every engine has one slot history); each rank's launch counts. Then
    int4_awq + int8 KV at ep = 4 (attention int4, experts bf16): #2 and
    #3 counted on every rank."""
    import dataclasses

    import numpy as np

    from generativeaiexamples_tpu_torch.engine import Engine, SamplingParams
    from generativeaiexamples_tpu_torch.engine import graphs
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import MIXTRAL_8X7B
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.parallel.mesh import (MeshPlan,
                                                              make_mesh)

    cfg = dataclasses.replace(arg.get("base") or MIXTRAL_8X7B,
                              num_layers=arg["layers"])
    tok = ByteTokenizer()
    rank = torch.distributed.get_rank()
    lead = rank == 0
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    greedy = SamplingParams(max_tokens=TP_NEW, top_k=1, ignore_eos=True)
    prompts = [tok.encode(p) for p in TP_PROMPTS]
    ids = np.random.default_rng(0).integers(3, 259, (1, 64))
    t = torch.tensor(ids, dtype=torch.int32, device=dev)
    pos = torch.arange(64, dtype=torch.int32, device=dev)[None, :]

    def engine(params, dtype, mesh, **kw):
        return Engine(params, cfg, tok,
                      tp_engine_cfg(dtype, cfg.vocab_size, **kw),
                      device=dev, mesh=mesh)

    res: dict = {"rank": rank}
    full = ref = None
    if lead:
        full = llama.init_params(cfg, 0, torch.float32, dev)
        with torch.no_grad():
            ref = llama.apply(full, cfg, t, pos)[0]
        res["peak"] = ref.abs().max().item()
        res["one"] = tp_serve(engine(full, "float32", None),
                              [(p, greedy) for p in prompts])
    for label, plan in EP_PLANS:
        mesh = make_mesh(MeshPlan(**plan), device=device)
        shard = llama.init_params(cfg, 0, torch.float32, dev, mesh=mesh)
        with torch.no_grad():
            logits = llama.apply(shard, cfg, t, pos, mesh=mesh)[0]
        eng = engine(shard, "float32", mesh)
        # After construction: its captures' warm-ups launch too.
        before = graphs.launch_counts()
        steps0 = eng.stats["decode_steps"]
        out = tp_serve(eng, [(p, greedy) for p in prompts])
        res[label] = {"counts": graphs.count_delta(before,
                                                   graphs.launch_counts()),
                      "steps": eng.stats["decode_steps"] - steps0}
        if lead:
            res[label]["tokens"] = out
            res[label]["logit_err"] = (logits - ref).abs().max().item()
            res[label]["gaps"] = [
                logits_gap(torch, full, cfg, p + a[:i]) if i is not None
                else None for p, a, b in zip(prompts, out, res["one"])
                for i in [parting_index(a, b)]]
        del shard, logits, eng
    del full, ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mesh = make_mesh(MeshPlan(ep=world), device=device)
    shard = llama.init_params(cfg, 0, torch.bfloat16, dev, mesh=mesh,
                              quantization="int4_awq", group_size=128)
    eng = engine(shard, "bfloat16", mesh, kv_quant="int8")
    s0 = dict(eng.stats)
    before = graphs.launch_counts()
    out = tp_serve(eng, [(p, greedy) for p in prompts])
    delta = graphs.count_delta(before, graphs.launch_counts())
    run = {k: eng.stats[k] - s0[k] for k in ("decode_steps", "prefills",
                                             "prefill_dispatches")}
    res["int4"] = dict(run, tokens=out, n_tiles=head_tiles(eng), launches={
        k: delta.get(k, 0) for k in ("paged_attention_decode",
                                     "paged_attention_decode_int8",
                                     "int4_matmul")},
        by_path={p: delta.get(f"int4_matmul/{p}", 0)
                 for p in ("tc", "gemv", "tile", "wg")})
    return res


def check_ep_parity(results: list, layers: int,
                    check_launches: bool = True) -> None:
    """The leader's comparisons of ``ep_parity_rank`` and every rank's
    launch counts."""
    lead = results[0]
    for label, _ in EP_PLANS:
        got = lead[label]
        err, peak = got["logit_err"], lead["peak"]
        say(f"ep parity float32, Mixtral width, {layers} layers, {label} "
            f"(TF32 off): logits max abs err {err} against max|logit| "
            f"{peak} (tolerance {MESH_RTOL} x max|logit|)")
        if not err <= MESH_RTOL * peak:
            fail(f"{label} float32 logits disagree with one card's: {err}")
        for i, (a, b) in enumerate(zip(got["tokens"], lead["one"])):
            at = parting_index(a, b)
            gap = got["gaps"][i]
            say(f"ep parity {label} prompt {i}: tokens {a}; one-card {b}; "
                f"first parting {at}"
                + (f" at a top-2 gap of {gap}" if at is not None else ""))
            if at is not None and not (gap is not None
                                       and gap < TP_TIE["float32"]):
                fail(f"{label} greedy tokens part from one card's at token "
                     f"{at} (top-2 gap {gap}, not a near tie)")
        if check_launches:
            # The leader's steps: every rank replays its programs.
            steps = got["steps"]
            for r in results:
                n = r[label]["counts"].get("paged_attention_decode", 0)
                if steps <= 0 or n != layers * steps:
                    fail(f"{label} rank {r['rank']}: #1 launched {n} times "
                         f"over {steps} decode steps")
    run = lead["int4"]
    say(f"ep=4 int4_awq + int8 KV, {layers} layers: tokens "
        f"{run['tokens']}; rank 0 launches {run['launches']} "
        f"({run['by_path']})")
    for r in results:
        for out in r["int4"]["tokens"] or []:
            if len(out) != TP_NEW:
                fail(f"ep=4 int4 tokens {out}")
        if check_launches:
            check_launch_counts(f"ep=4 int4 rank {r['rank']}", dict(
                r["int4"], **{k: run[k] for k in (
                    "decode_steps", "prefills", "prefill_dispatches")}),
                layers, "int4_awq", "int8", n_tiles=run["n_tiles"],
                per_layer=4)
    if check_launches:
        say(f"ep parity launches: #1 once per layer per decode step on "
            f"every rank at {', '.join(p for p, _ in EP_PLANS)}; at ep=4 "
            f"int4 #2 and #3 ('tc' per projection and head tile, 'wg' per "
            f"prefill program) on every rank")


def time_moe_all_reduce(torch, dev, mesh, D: int, rows: int = 8,
                        n: int = 160) -> float:
    """Device ms of one MoE combine all-reduce over the ``ep x tp`` ranks
    at a decode step's shape (``rows`` x ``D`` bf16), from one CUDA graph
    of ``n`` of them, on every rank at once."""
    from generativeaiexamples_tpu_torch.parallel import comm
    x = torch.zeros((rows, D), dtype=torch.bfloat16, device=dev)
    for _ in range(3):
        comm.all_reduce_(x, mesh, "moe")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            comm.all_reduce_(x, mesh, "moe")
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def step_ms_by_streams(engine, ids: list) -> dict:
    """Host-clock decode step at 1 and 8 streams on a started engine: a
    1-token request, then a 65-token one (64 steps after the first
    token), ``n`` of each at once."""
    from concurrent.futures import ThreadPoolExecutor

    from generativeaiexamples_tpu_torch.engine import SamplingParams

    def timed(n: int, new: int) -> float:
        t = time.monotonic()
        with ThreadPoolExecutor(n) as pool:
            list(pool.map(lambda _: engine.submit(ids, SamplingParams(
                max_tokens=new, top_k=1, ignore_eos=True)).text(),
                range(n)))
        return (time.monotonic() - t) * 1e3

    out = {}
    for n in (1, 8):
        first = timed(n, 1)
        out[f"step_ms_{n}"] = (timed(n, 65) - first) / 64
    return out


def ep_serve_rank(torch, dev, world: int, device: str, arg: dict) -> dict:
    """The ep serve phase on one rank: Mixtral-8x7B at ``arg["layers"]``
    layers (all 32 on the card), bf16, random weights from seed 0, through
    ``Engine(mesh=)`` at ep = 4 and then at tp = 4 (the same run's
    comparison): every rank times the MoE combine's all-reduce over its
    group; the leader serves the timed requests (``step_ms_by_streams``)
    while the others follow; every rank's launch counts between two
    ``rank_reports``; the leader's MoE layers alone (this rank's experts,
    the all-reduce off) at 8 rows."""
    import dataclasses

    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import MIXTRAL_8X7B
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.parallel.mesh import (MeshPlan,
                                                              make_mesh)

    cfg = dataclasses.replace(arg.get("base") or MIXTRAL_8X7B,
                              num_layers=arg["layers"])
    tok = ByteTokenizer()
    ids = tok.encode(TP_PROMPTS[0])
    res: dict = {"rank": torch.distributed.get_rank()}
    for label, plan in (("ep=4", {"ep": world}), ("tp=4", {"tp": world})):
        mesh = make_mesh(MeshPlan(**plan), device=device)
        shard = llama.init_params(cfg, 0, torch.bfloat16, dev, mesh=mesh)
        eng = Engine(shard, cfg, tok, EngineConfig(
            max_slots=8, max_input_length=1024, max_output_length=80,
            prefill_buckets=(1024,), page_size=128, dtype="bfloat16",
            kv_pool_tokens=16384, seed=0), device=dev, mesh=mesh)
        out: dict = {}
        if dev.type == "cuda":
            axis = "moe" if label.startswith("ep") else "tp"
            out["all_reduce_ms"] = (
                time_moe_all_reduce(torch, dev, mesh, cfg.hidden_size)
                if axis == "moe" else
                time_collectives(torch, dev, mesh, cfg.hidden_size)[
                    "all_reduce_8_ms"])
        if eng.leader:
            r0 = eng.rank_reports()
            s0 = dict(eng.stats)
            eng.start()
            out.update(step_ms_by_streams(eng, ids))
            eng.stop()
            out["counts"] = rank_counts(r0, eng.rank_reports())
            out["steps"] = eng.stats["decode_steps"] - s0["decode_steps"]
            eng.close()
            if dev.type == "cuda":
                local = dataclasses.replace(mesh, moe_group=None,
                                            tp_group=None)
                x = torch.zeros((8, 1, cfg.hidden_size), device=dev,
                                dtype=torch.bfloat16)
                layers = [llama.layer_params(shard, i)
                          for i in range(cfg.num_layers)]
                lcfg = llama.tp_layout(cfg, mesh).cfg
                out["moe_ms"] = time_cuda(
                    torch, [(lambda lp=lp: llama._moe_mlp(x, lp, lcfg,
                                                          local))
                            for lp in layers],
                    iters=2 * cfg.num_layers, warmup=cfg.num_layers)
        else:
            eng.follow()
            eng.close()
        out["rank_bytes"] = sum(t.numel() * t.element_size()
                                for t in llama.param_tensors(shard))
        res[label] = out
        del shard, eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


def check_ep_serve(results: list, layers: int,
                   check_launches: bool = True) -> None:
    lead = results[0]
    for label in ("ep=4", "tp=4"):
        out = lead[label]
        if check_launches:
            check_rank_counts(f"Mixtral {label} serve", out["counts"],
                              layers, out["steps"])
        wbytes = max(r[label]["rank_bytes"] for r in results)
        bound = wbytes / HBM_BYTES_PER_S * 1e3
        line = (f"Mixtral-8x7B {layers} layers bf16 at {label} through "
                f"Engine(mesh=): decode step (host clock, 64 steps after "
                f"the first token) 1 stream {out['step_ms_1']:.3f} ms, 8 "
                f"streams {out['step_ms_8']:.3f} ms against a per-card "
                f"byte bound of {bound:.3f} ms ({wbytes} bytes a rank); "
                f"#1 launches on every rank {[c.get('paged_attention_decode') for c in out['counts']]} "
                f"over {out['steps']} steps ({layers} a step)")
        if "moe_ms" in out:
            n_ar = 2 * layers + 1 if label == "tp=4" else layers
            line += (f"; MoE layers alone (this rank's experts) "
                     f"{out['moe_ms']:.5f} ms x {layers} = "
                     f"{layers * out['moe_ms'] / out['step_ms_8']:.1%} of "
                     f"the 8-stream step; {n_ar} all-reduces a step at "
                     f"{out['all_reduce_ms']:.5f} ms = "
                     f"{n_ar * out['all_reduce_ms']:.3f} ms")
        say(line)
    say(f"Mixtral decode step at 8 streams: ep=4 "
        f"{lead['ep=4']['step_ms_8']:.3f} ms beside tp=4 "
        f"{lead['tp=4']['step_ms_8']:.3f} ms (same run)")


def sp_parity_rank(torch, dev, world: int, device: str, arg: dict) -> dict:
    """The sp parity phase on one rank (sp = 4): Llama-2-7B's width cut to
    ``arg["layers"]`` (``arg["base"]``), float32 (TF32 off), a prompt of
    ``arg["S"]`` tokens: ``apply_prefill_sp``'s K/V block and last logits
    against this rank's own one-card forward over a dense cache (the
    weights are replicated), and ``score`` over sp against the one-card
    score. Returns the errors and peaks."""
    import dataclasses

    import numpy as np

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    from generativeaiexamples_tpu_torch.parallel.mesh import (MeshPlan,
                                                              make_mesh)

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(arg.get("base") or LLAMA2_7B,
                              num_layers=arg["layers"])
    S = arg["S"]
    mesh = make_mesh(MeshPlan(sp=world), device=device)
    params = llama.init_params(cfg, 0, torch.float32, dev)
    ids = np.random.default_rng(1).integers(3, cfg.vocab_size, (1, S))
    tokens = torch.tensor(ids, dtype=torch.int32, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    length = S - 5
    k, v, last = llama.apply_prefill_sp(
        params, cfg, tokens, pos, mesh,
        torch.tensor([length], dtype=torch.int32, device=dev))
    with torch.no_grad():
        # Causal over every row, as the ring prefill is (rows past the
        # length are the engine's padding, never attended).
        cache = llama.init_kv_cache(cfg, 1, S, torch.float32, dev)
        logits, cache = llama.apply(params, cfg, tokens, pos, cache)
    per = S // world
    r = mesh.coords["sp"]
    rows = slice(r * per, (r + 1) * per)
    res = {"rank": mesh.rank}
    for name, got, want in (("k", k, cache["k"][:, :, rows]),
                            ("v", v, cache["v"][:, :, rows]),
                            ("last_logits", last, logits[:, length - 1])):
        res[name] = ((got - want).abs().max().item(),
                     want.abs().max().item())
    del k, v, cache, logits
    t0 = time.monotonic()
    nll = llama.score(params, cfg, tokens, mesh=mesh)
    res["score_s"] = time.monotonic() - t0
    ref = llama.score(params, cfg, tokens)
    res["score"] = ((nll - ref).abs().max().item(), ref.abs().max().item())
    return res


def check_sp_parity(results: list, layers: int, S: int) -> None:
    for r in results:
        for name in ("k", "v", "last_logits", "score"):
            err, peak = r[name]
            if not err <= MESH_RTOL * peak:
                fail(f"sp parity rank {r['rank']}: {name} max abs err {err} "
                     f"against max|ref| {peak}")
    say(f"sp parity float32, Llama-2-7B width, {layers} layers, sp="
        f"{len(results)}, S {S} (TF32 off), against each rank's one-card "
        f"forward: " + "; ".join(
            f"rank {r['rank']} " + ", ".join(
                f"{n} {r[n][0]:.3g}/{r[n][1]:.3g}"
                for n in ("k", "v", "last_logits", "score"))
            for r in results)
        + f" (max abs err / max|ref|, tolerance {MESH_RTOL} x); score "
        f"over sp {results[0]['score_s']:.2f} s (host clock)")


def sp_serve_rank(torch, dev, world: int, device: str, arg: dict) -> dict:
    """The sp serve phase on one rank: LLaMA-2-7B-32K's geometry
    (``arg["base"]``, at ``arg["layers"]``), random weights from seed 0,
    at sp = 4 through ``Engine(mesh=)``, in bf16 and in int4_awq + int8
    KV: one prompt of ``arg["S"]`` tokens admitted by one ring prefill,
    then ``arg["new"]`` greedy tokens (TTFT on the engine's clock), every
    rank's launch counts over it (``rank_reports``), then ``Engine.score``
    of the prompt over sp (host clock). Then rank 0, on its card alone,
    serves the same prompt on the same weights through the one-card
    engine's chunked admission (chunks of ``arg["chunk"]``): its TTFT and
    tokens, and the top-2 gap where the two part."""
    import dataclasses

    import numpy as np

    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.parallel.mesh import (MeshPlan,
                                                              make_mesh)

    cfg = dataclasses.replace(arg.get("base") or llama_7b_32k(),
                              num_layers=arg["layers"])
    S, page, new = arg["S"], 128, arg["new"]
    tok = ByteTokenizer()
    ids = [1] + np.random.default_rng(2).integers(
        3, cfg.vocab_size, S - 1).tolist()
    greedy = SamplingParams(max_tokens=new, top_k=1, ignore_eos=True)
    mesh = make_mesh(MeshPlan(sp=world), device=device)
    pool = (-(-(S + new) // page)) * page
    res: dict = {"rank": mesh.rank}
    kept = {}
    for mode, quant, kv in (("bf16", "", ""), ("int4", "int4_awq", "int8")):
        params = llama.init_params(cfg, 0, torch.bfloat16, dev,
                                   quantization=quant, group_size=128)
        eng = Engine(params, cfg, tok, EngineConfig(
            max_slots=2, max_input_length=S, max_output_length=new,
            prefill_buckets=(S,), page_size=page, dtype="bfloat16",
            kv_pool_tokens=pool, kv_quant=kv, sched_round_budget_tokens=S,
            seed=0), device=dev, mesh=mesh)
        out: dict = {}
        if eng.leader:
            r0 = eng.rank_reports()
            s0 = dict(eng.stats)
            eng.start()
            stream = eng.submit(ids, greedy)
            stream.text()
            out["tokens"] = list(stream.token_ids)
            out["ttft_ms"] = stream.ttft_ms
            run = {k: eng.stats[k] - s0[k] for k in (
                "decode_steps", "prefills", "prefill_dispatches",
                "prefill_chunks")}
            out["run"] = run
            out["counts"] = rank_counts(r0, eng.rank_reports())
            t0 = time.monotonic()
            nll = eng.score(ids)
            out["score_ms"] = (time.monotonic() - t0) * 1e3
            out["score_finite"] = bool(np.isfinite(nll).all()) and len(
                nll) == S - 1
            eng.close()
            kept[mode] = (params, kv)
        else:
            eng.follow()
            eng.close()
        res[mode] = out
        del eng
        if mode not in kept:
            del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if mesh.rank != 0:
        return res
    for mode, (params, kv) in kept.items():
        eng = Engine(params, cfg, tok, EngineConfig(
            max_slots=2, max_input_length=S, max_output_length=new,
            max_prefill_bucket=arg["chunk"], prefill_buckets=(arg["chunk"],),
            page_size=page, dtype="bfloat16", kv_pool_tokens=pool,
            kv_quant=kv, sched_round_budget_tokens=arg["chunk"],
            sched_prefill_chunk_tokens=arg["chunk"], seed=0), device=dev)
        s0 = dict(eng.stats)
        eng.start()
        stream = eng.submit(ids, greedy)
        stream.text()
        one = {"tokens": list(stream.token_ids), "ttft_ms": stream.ttft_ms,
               "chunks": eng.stats["prefill_chunks"] - s0["prefill_chunks"]}
        eng.close()
        del eng
        at = parting_index(res[mode]["tokens"], one["tokens"])
        one["parting"] = at
        if at is not None:
            one["gap"] = logits_gap(torch, params, cfg,
                                    ids + one["tokens"][:at])
        res[mode]["one"] = one
        del params
        kept[mode] = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


def check_sp_serve(results: list, layers: int, S: int, new: int,
                   check_launches: bool = True) -> None:
    lead = results[0]
    for mode, kv in (("bf16", ""), ("int4", "int8")):
        out, one = lead[mode], lead[mode]["one"]
        run = out["run"]
        if run["prefills"] != 1 or run["prefill_dispatches"] != 1 or \
                run["prefill_chunks"]:
            fail(f"sp serve {mode}: the {S}-token prompt was not one ring "
                 f"admission ({run})")
        if check_launches:
            check_rank_counts(f"sp serve {mode}", out["counts"], layers,
                              run["decode_steps"], kv)
        if len(out["tokens"]) != new or not out["score_finite"]:
            fail(f"sp serve {mode}: {len(out['tokens'])} tokens, score "
                 f"finite {out['score_finite']}")
        at = one["parting"]
        gap = one.get("gap")
        say(f"sp serve {mode}, LLaMA-2-7B-32K geometry, {layers} layers, "
            f"sp={len(results)}: a {S}-token prompt in one ring admission, "
            f"TTFT {out['ttft_ms']:.1f} ms against {one['ttft_ms']:.1f} ms "
            f"through the one-card chunked admission ({one['chunks']} "
            f"chunks) on card 0; tokens {out['tokens'][:16]}..., first "
            f"parting from the one-card engine's {at}"
            + (f" at a top-2 gap of {gap}" if at is not None else "")
            + f"; the {S}-token score over sp {out['score_ms']:.1f} ms "
            f"(host clock); #{'2' if kv else '1'} launches on every rank "
            f"{[c.get('paged_attention_decode' + ('_int8' if kv else '')) for c in out['counts']]} "
            f"over {run['decode_steps']} decode steps")
        if at is not None and not (gap is not None
                                   and gap < TP_TIE["bfloat16"]):
            fail(f"sp serve {mode}: tokens part from the one-card engine's "
                 f"at {at} (top-2 gap {gap}, not a near tie)")


def tp_multihost_phase(torch, tp: int, device: str = "cuda", base=None,
                       layers: int = 0, check_launches: bool = True) -> dict:
    """Multi-host rendezvous: Llama-2-70B's width cut to
    ``TP_CKPT_LAYERS`` written as a bf16 checkpoint, served in float32 at
    tp = ``tp`` through the CLI once in one process (``--tensor-parallelism``)
    and once as two hosts' CLIs (``--coordinator``, ``--num-processes 2``,
    ``--process-id 0/1``; on the card ``CUDA_VISIBLE_DEVICES`` 0,1 and
    2,3): equal greedy texts, #1 once per layer per decode step on every
    rank, both exit 0 on SIGTERM."""
    import shutil
    import tempfile

    dev = torch.device("cuda", 0) if device == "cuda" else \
        torch.device("cpu")
    cfg = tp_ckpt_cfg(layers, base)
    root = tempfile.mkdtemp(prefix="chip_smoke_hosts_")
    saved = os.environ.get("GAIE_SKIP_HASH")
    os.environ["GAIE_SKIP_HASH"] = "1"
    try:
        path = write_tp_checkpoints(torch, dev, cfg, root,
                                    kinds=("bf16",))["bf16"]
        # float32: NCCL may reduce in another order over two hosts'
        # transports; float32 sums agree far below any greedy tie.
        runs = {h: serve_tp_ckpt_cli(path, tp, "float32", TP_PROMPTS,
                                     TP_CKPT_NEW, device=device, hosts=h)
                for h in (1, 2)}
    finally:
        if saved is None:
            os.environ.pop("GAIE_SKIP_HASH", None)
        else:
            os.environ["GAIE_SKIP_HASH"] = saved
        shutil.rmtree(root, ignore_errors=True)
    one, two = runs[1], runs[2]
    if one["texts"] != two["texts"]:
        fail(f"two hosts' texts {two['texts']} != one process's "
             f"{one['texts']}")
    for label, run in runs.items():
        if check_launches:
            check_rank_counts(f"multi-host {label} host(s)", run["launches"],
                              cfg.num_layers, run["run"]["decode_steps"])
    say(f"multi-host: tp={tp} over two CLIs (--coordinator, "
        f"--num-processes 2, --process-id 0/1) serves the one-process "
        f"texts {[t[:24] for t in two['texts']]}; #1 on all {tp} ranks "
        f"once per layer per decode step; both exited 0 on SIGTERM; up in "
        f"{two['startup_s']:.1f} s against {one['startup_s']:.1f} s")
    return {h: {"startup_s": r["startup_s"], "launches": r["launches"]}
            for h, r in runs.items()}


MESH_TASKS = {"ep_parity": ep_parity_rank, "ep_serve": ep_serve_rank,
              "sp_parity": sp_parity_rank, "sp_serve": sp_serve_rank}


def mesh_phases(torch, tp: int, device: str = "cuda", bases=None,
                layers=None, check_launches: bool = True) -> dict:
    """The mesh phases of ``--tp`` (after phase 13): ep parity and int4,
    the ep serve beside tp, sp parity, multi-host, the sp serve. Returns
    the launch counts and seconds for the kernels line. ``bases`` and
    ``layers`` (dicts by phase) cut the geometry for a CPU rehearsal."""
    bases, layers = bases or {}, layers or {}
    took = {}
    t0 = time.monotonic()

    def lap(name):
        nonlocal t0
        took[name] = round(time.monotonic() - t0, 1)
        t0 = time.monotonic()

    L = layers.get("ep_parity", MESH_PARITY_LAYERS)
    check_ep_parity(run_ranks(tp, "ep_parity", 900, dict(
        base=bases.get("mixtral"), layers=L), device=device), L,
        check_launches)
    lap("ep_parity")
    L = layers.get("ep_serve", 32)
    serve = run_ranks(tp, "ep_serve", 1200, dict(
        base=bases.get("mixtral"), layers=L), device=device)
    check_ep_serve(serve, L, check_launches)
    lap("ep_serve")
    L, S = layers.get("sp_parity", MESH_PARITY_LAYERS), \
        layers.get("sp_parity_S", SP_PARITY_S)
    check_sp_parity(run_ranks(tp, "sp_parity", 600, dict(
        base=bases.get("llama"), layers=L, S=S), device=device), L, S)
    lap("sp_parity")
    hosts = tp_multihost_phase(torch, tp, device, base=bases.get("70b"),
                               layers=layers.get("multihost", 0),
                               check_launches=check_launches)
    lap("multihost")
    L, S = layers.get("sp_serve", 32), layers.get("sp_serve_S", SP_SEQ)
    new = layers.get("sp_new", SP_NEW)
    sp = run_ranks(tp, "sp_serve", 1200, dict(
        base=bases.get("llama32k"), layers=L, S=S, new=new,
        chunk=layers.get("sp_chunk", 4096)), device=device)
    check_sp_serve(sp, L, S, new, check_launches)
    lap("sp_serve")
    say(f"mesh phase seconds: {took}")
    return {"sp": sp, "ep": serve, "hosts": hosts, "seconds": took}


def main_tp(torch, tp: int, only: str = "") -> int:
    """``--tp N``: the multi-card phases only (see the module docstring,
    phases 12-14); ``only="mesh"``: the kernel checks and phase 14 alone.
    Fails on fewer than ``tp`` cards."""
    from generativeaiexamples_tpu_torch.kernels import build
    if torch.cuda.device_count() < tp:
        fail(f"--tp {tp} needs {tp} cards; this machine has "
             f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"cards: {card.splitlines()}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    phases: dict = {}
    t0 = time.monotonic()

    def lap(name):
        nonlocal t0
        phases[name] = round(time.monotonic() - t0, 1)
        t0 = time.monotonic()

    took = build.build_all()
    say(f"kernel build: {', '.join(f'{k} {v:.1f} s' for k, v in took.items())}")
    lap("build")
    mesh_rows = check_mesh_shards(torch, dev)
    torch.cuda.empty_cache()
    lap("mesh_shards")
    kernels = [] if only else tp_phases(torch, tp, dev, lap)
    mesh = mesh_phases(torch, tp)
    lap("mesh")
    # The mesh rows' launches: rank 0's over the sp serve's window (#1 in
    # bf16, #2 and #3 "wg" at M = 8192 in int4_awq + int8 KV).
    sp = mesh["sp"][0]
    for key, row in mesh_rows.items():
        counts = sp["bf16" if row["name"] == "paged_attention_decode"
                    else "int4"]["counts"][0]
        row["launches"] = counts.get(row["name"] if "path" not in row else
                                     f"int4_matmul/{row['path']}", 0)
        kernels.append(row)
    say(f"phase seconds: {phases}, total {sum(phases.values()):.1f}")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def tp_phases(torch, tp: int, dev, lap) -> list:
    """Phases 12 and 13 of ``--tp``; their rows of the kernels line."""
    from generativeaiexamples_tpu_torch.models.configs import (LLAMA2_70B,
                                                               MIXTRAL_8X7B)
    shard_rows = check_tp_shards(torch, dev)
    torch.cuda.empty_cache()
    lap("tp_shards")
    results = run_ranks(tp, "parity", timeout=900)
    comm_ms = check_tp_parity(results, (TP_F32_LAYERS, TP_BF16_LAYERS))
    lap("tp_parity")
    L = LLAMA2_70B.num_layers
    served = {}
    for key, quant, kv in (("bf16", "", ""), ("int4", "int4_awq", "int8")):
        served[key] = serve_tp_cli("llama-2-70b-chat", tp, quant, kv, L)
        lap(f"serve_70b_{key}")
    served["mixtral"] = serve_tp_cli("mixtral-8x7b-instruct", tp, layers=32)
    lap("serve_mixtral")
    ckpt = tp_checkpoint_phase(torch, tp)
    lap("checkpoints")
    for key, cfg, quant in (("bf16", LLAMA2_70B, ""),
                            ("int4", LLAMA2_70B, "int4_awq"),
                            ("mixtral", MIXTRAL_8X7B, "")):
        run = served[key]
        wbytes = served_weight_bytes(cfg, tp, quant)
        bound = wbytes / HBM_BYTES_PER_S * 1e3
        n_ar = 2 * cfg.num_layers + 1
        ar = n_ar * comm_ms["all_reduce_8_ms"]
        say(f"tp={tp} {run['label']}: decode step (host clock, 64 steps "
            f"after the first token) 1 stream {run['step_ms_1']:.3f} ms, 8 "
            f"streams {run['step_ms_8']:.3f} ms against a per-card byte "
            f"bound of {bound:.3f} ms ({wbytes} weight bytes a rank); "
            f"{n_ar} all-reduces a step at {comm_ms['all_reduce_8_ms']:.5f} "
            f"ms each = {ar:.3f} ms ({ar / run['step_ms_8']:.1%} of the "
            f"8-stream step); a 1000-token prompt's prefill (bucket 1024, "
            f"host clock, HTTP included) {run['prefill_1024_ms']:.1f} ms")
    # The kernels line: each row's launches from rank 0 of the serve that
    # runs its shape (70B bf16: #1; 70B int4 + int8 KV: #2 and #3; Mixtral
    # bf16: #1 at G = 4).
    kernels = []
    for key, row in shard_rows.items():
        if "Mixtral" in key:
            if row["name"] != "paged_attention_decode":
                continue
            row["launches"] = served["mixtral"]["launches"][0][row["name"]]
        elif row["name"] == "paged_attention_decode":
            row["launches"] = served["bf16"]["launches"][0][row["name"]]
        elif row["name"] == "paged_attention_decode_int8":
            row["launches"] = served["int4"]["launches"][0][row["name"]]
        else:
            if not row["shape"].startswith(("70B tp=4 w_gate/w_up M=8",
                                            "70B tp=4 w_gate/w_up M=1024",
                                            "70B tp=4 lm_head M=8")):
                continue
            row["launches"] = served["int4"]["launches"][0][
                f"int4_matmul/{row['path']}"]
        kernels.append(row)
    say(f"tp checkpoints summary: {json.dumps(ckpt, default=str)}")
    return kernels


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
    if sys.argv[1:2] == ["--tp"]:
        if not (len(sys.argv) == 3 or sys.argv[3:] == ["--only", "mesh"]) \
                or not sys.argv[2].isdigit():
            fail("usage: chip_smoke.py --tp N [--only mesh]")
        return main_tp(torch, int(sys.argv[2]), "mesh" if sys.argv[3:]
                       else "")
    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    if sys.argv[1:] == ["--golden-readings"]:
        build.build_all()
        golden_readings(torch, dev, card)
        return 0

    phases = {}
    t0 = time.monotonic()

    def lap(name):
        nonlocal t0
        phases[name] = round(time.monotonic() - t0, 1)
        t0 = time.monotonic()

    from generativeaiexamples_tpu_torch.models.configs import (MIXTRAL_8X7B,
                                                               NEMOTRON_8B)
    quant_ref = QuantReference(torch, dev)
    total, avail = host_memory_gb()
    say(f"host memory: {total:.1f} GB, {avail:.1f} GB available")
    nemo_ref = FamilyReference(torch, dev, NEMOTRON_8B)
    mixtral_ref = FamilyReference(torch, dev, MIXTRAL_8X7B)
    total, avail = host_memory_gb()
    say(f"host memory: {total:.1f} GB, {avail:.1f} GB available with the "
        f"three CPU references made")
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
    # Mixtral's GQA groups: G = 4 query heads a kv head.
    for quant in (False, True):
        check_paged_attention(torch, dev, torch.float32, quant=quant,
                              kv_heads=8)
        kernels.append(check_paged_attention(torch, dev, torch.bfloat16,
                                             quant=quant, kv_heads=8))
    torch.cuda.empty_cache()
    lap("attention")
    # The kernels at each rank's shapes under tp = 4 (printed; the
    # multi-card run, ``--tp 4``, serves them and puts them in its line).
    check_tp_shards(torch, dev)
    torch.cuda.empty_cache()
    lap("tp_shards")
    # ... and at the shapes of the mesh phases (sp = 4, ep = 4).
    check_mesh_shards(torch, dev)
    torch.cuda.empty_cache()
    lap("mesh_shards")
    kernels.extend(check_int4_matmul(torch, dev))
    lap("int4_matmul")
    gbias_rows = check_int4_gbias(torch, dev)
    lap("int4_gbias")
    check_fused_tail(torch, dev, card)
    lap("fused_tail")
    check_model(torch, dev)
    lap("model")
    check_model_quant(torch, dev, quant_ref)
    lap("model_quant")
    gptq_paths = checkpoint_phase(torch, dev, card)
    lap("checkpoint")
    # The second family at full width and depth; its engines are closed
    # before the llama-2 phases.
    serve_family(torch, dev, card, "nemotron-8b-chat")
    lap("serve_nemotron_bf16")
    nemo_int4 = serve_family(torch, dev, card, "nemotron-8b-chat",
                             quantization="int4_awq", kv_quant="int8")
    lap("serve_nemotron_int4")
    # Its CPU reference has run in a thread since the start.
    check_family_model(torch, dev, nemo_ref, "Nemotron-8B width "
                       "(layernorm1p, squared-ReLU, V 256000)")
    lap("model_nemotron")
    # The MoE family: its 2-layer model check against its CPU reference
    # (in a thread since the start), then served at full width.
    check_family_model(torch, dev, mixtral_ref, "Mixtral-8x7B width (8 "
                       "experts, top-2, H 32 / KV 8)")
    lap("model_mixtral")
    mixtral = {q: serve_family(torch, dev, card, "mixtral-8x7b-instruct",
                               quantization=quant, kv_quant=kv,
                               layers=MIXTRAL_LAYERS)
               for q, quant, kv in (("bf16", "", ""),
                                    ("int4", "int4_awq", "int8"))}
    lap("serve_mixtral")
    # Training and evaluation, while no engine holds the card; the tuned
    # trees' serve counts join each mode's in the kernels line.
    custom = customize(torch, dev, card)
    lap("customize")
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
    # The RAG chatbot over each mode's weights, and inside each mode's
    # window the application periphery on the same engine, embedder and
    # chain server (timed apart); both counts join the mode's in the
    # kernels line.
    periphery, periphery_s = {}, []

    def run_periphery(held: dict) -> None:
        t1 = time.monotonic()
        periphery[held["quantization"]] = serve_periphery(torch, dev, card,
                                                          held)
        periphery_s.append(time.monotonic() - t1)
    rag = serve_rag(torch, dev, card, [(bf16["profile"][1], ""),
                                       (quantized["profile"][1],
                                        "int4_awq")], then=run_periphery)
    for run, q in ((bf16, ""), (quantized, "int4_awq")):
        for key in ("launches", "by_path"):
            run[key] = {k: n + rag[q][key][k] + periphery[q][key].get(k, 0)
                        for k, n in run[key].items()}
    lap("serve_rag")
    phases["serve_rag"] = round(phases["serve_rag"] - sum(periphery_s), 1)
    phases["serve_periphery"] = round(sum(periphery_s), 1)
    # The fleet tier on the int4 weights: three replicas behind the
    # router; its counts join the int4 mode's in the kernels line.
    fleet = serve_fleet(torch, dev, card, quantized["profile"][1])
    for key in ("launches", "by_path"):
        quantized[key] = {k: n + fleet[key][k]
                          for k, n in quantized[key].items()}
    lap("serve_fleet")
    for run, q in ((bf16, "bf16"), (quantized, "int4")):
        for key in ("launches", "by_path"):
            run[key] = {k: n + custom[q][key][k] for k, n in run[key].items()}
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
        if row.get("shape", "").startswith(("G=4", "mixtral")):
            # Mixtral's shapes: its serve windows' counts.
            run = mixtral["int4" if row["name"] != "paged_attention_decode"
                          else "bf16"]
            row["launches"] = (run["by_path"][row["path"]] if "path" in row
                               else run["launches"][row["name"]])
    # #3 under autograd: the QLoRA training window's "wg" forwards and
    # backward products.
    kernels.append(custom["row"])
    # #3 with GPTQ zero points: the GPTQ checkpoint's run; at Nemotron's
    # shapes: the int4 Nemotron serve window.
    for key, row in sorted(gbias_rows.items()):
        row["launches"] = (gptq_paths if key.startswith("gbias")
                           else nemo_int4["by_path"])[row["path"]]
        kernels.append(row)
    say(f"phase seconds: {phases}, total {sum(phases.values()):.1f}")

    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
