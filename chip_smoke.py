#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``generativeaiexamples_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each fails loudly: a failure exits non-zero and the final
``{"ok": true, ...}`` line is never printed):

1. Card, power limit, torch/CUDA versions; builds every kernel from the
   sources in the checkout (one ``nvcc`` per source, started together).
2. Each kernel against its plain PyTorch version at the shapes the
   llama-2-7b decode path gives it, in float32 (atol 1e-4) and bfloat16
   (atol 1e-3, rtol 1e-2), plus its bfloat16 time beside its bound.
3. The engine against a plain reference on a small input: llama-2-7b's
   width cut to 2 layers, float32, greedy tokens through the engine (the
   kernel in every layer) against argmax of a full-sequence forward.
4. The main path: serves llama-2-7b-chat (bf16, full width and depth,
   random weights from seed 0) through the port's aiohttp
   ``/v1/completions`` (4 concurrent requests, one streamed) plus one
   ``ignore_eos`` engine request, and checks through the launch counts
   that every layer of every decode step went through the kernel.

Exits 2 without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak


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
    """Mean milliseconds per call from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ kernel phase

def check_paged_attention(torch, dev, dtype):
    """The paged decode kernel against its plain version at llama-2-7b
    decode shapes: B=8, H=KV=32, hd=128, page=128, layer 1 of an L=2
    pool, lengths covering 0, page-1, page, page+1 and long contexts.

    Tolerances, from the kernel's measured error: float32 atol 1e-4 (fp32
    accumulation in another order than the plain einsum; a dropped or
    extra row shifts a 3000-token slot's output by ~1e-3), bfloat16
    atol 1e-3 with rtol 1e-2 (both sides accumulate in fp32; the rtol
    covers one bf16 ulp on the large outputs of the length-0/1 slots).
    Returns the kernel's row of the result line for bfloat16 (timed
    against its plain version and bound), None for float32."""
    from generativeaiexamples_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_decode_plain)

    B, H, KV, hd, page, L = 8, 32, 32, 128, 128, 2
    lengths = [0, 1, 127, 128, 129, 1000, 2047, 3000]
    W = max(-(-(n + 1) // page) for n in lengths)
    N = 1 + B * W
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    q = randn(B, H, hd)
    pk0, pv0 = randn(L, N, KV, page, hd), randn(L, N, KV, page, hd)
    ck, cv = randn(B, KV, hd), randn(B, KV, hd)
    table = (1 + torch.arange(B * W, device=dev, dtype=torch.int32)
             ).reshape(B, W)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = lens > 0
    wp = torch.where(live, table.gather(1, (lens // page)[:, None].long())
                     [:, 0], torch.zeros_like(lens)).to(torch.int32)
    off = torch.where(live, lens % page, torch.zeros_like(lens)).to(
        torch.int32)
    layer = 1

    pk, pv = pk0.clone(), pv0.clone()
    out = paged_attention_decode(q, pk, pv, table, lens, ck, cv, wp, off,
                                 layer)
    rk, rv = pk0.clone(), pv0.clone()
    ref = paged_attention_decode_plain(q, rk, rv, table, lens, ck, cv, wp,
                                       off, layer)
    torch.cuda.synchronize()
    if out.shape != (B, H, hd) or out.dtype != dtype:
        fail(f"paged_attention_decode output {tuple(out.shape)} {out.dtype}")
    if not torch.isfinite(out.float()).all():
        fail("paged_attention_decode output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (1e-3, 1e-2)
    if not torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol):
        fail(f"paged_attention_decode ({dtype}) disagrees with its plain "
             f"version: max abs err {err} (atol {atol}, rtol {rtol})")

    def bits(t):
        return t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)

    # The appended rows are bit copies of cur_k/cur_v, and every other
    # pool byte is unchanged apart from the trash page 0.
    touched = torch.zeros((L, N, KV, page), dtype=torch.bool, device=dev)
    idx = live.nonzero()[:, 0]
    touched[layer, wp[idx].long(), :, off[idx].long()] = True
    touched[layer, 0] = True
    for name, new, old, cur in (("K", pk, pk0, ck), ("V", pv, pv0, cv)):
        if not torch.equal(bits(new[layer, wp[idx].long(), :,
                                    off[idx].long()]), bits(cur[idx])):
            fail(f"appended {name} rows are not bit copies of cur_{name}")
        keep = ~touched[..., None].expand_as(new)
        if not torch.equal(bits(new)[keep], bits(old)[keep]):
            fail(f"kernel changed {name} pool bytes outside the append")

    # The kernel reads no row at or past a slot's length: poisoning those
    # rows (and the trash page) with NaN leaves the output bit-identical.
    poison_k, poison_v = pk0.clone(), pv0.clone()
    rows = torch.arange(W * page, device=dev)
    for b, n in enumerate(lengths):
        dead = (rows >= n).reshape(W, page)
        for t in (poison_k, poison_v):
            view = t[layer, table[b].long()]            # (W, KV, page, hd)
            view[dead[:, None, :].expand(W, KV, page)] = float("nan")
            t[layer, table[b].long()] = view
    poison_k[layer, 0] = float("nan")
    poison_v[layer, 0] = float("nan")
    out_p = paged_attention_decode(q, poison_k, poison_v, table, lens, ck,
                                   cv, wp, off, layer)
    torch.cuda.synchronize()
    if not torch.equal(bits(out_p), bits(out)):
        fail("paged_attention_decode read rows at or past a slot's length")
    del poison_k, poison_v
    if dtype == torch.float32:
        say(f"kernel paged_attention_decode float32: max_abs_err={err} "
            f"(atol {atol}); appends bit-exact, no row past a length read")
        return None

    ms = time_cuda(torch, lambda: paged_attention_decode(
        q, pk, pv, table, lens, ck, cv, wp, off, layer), iters=50)
    plain_ms = time_cuda(torch, lambda: paged_attention_decode_plain(
        q, rk, rv, table, lens, ck, cv, wp, off, layer), iters=5, warmup=1)
    esize = 2
    live_rows = sum(lengths)
    nbytes = (2 * live_rows * KV * hd * esize      # K and V rows read once
              + 2 * B * H * hd * esize             # q in, out
              + 4 * B * KV * hd * esize            # cur_k/v in, append out
              + B * W * 4 + 3 * B * 4)             # table, lengths, wp, off
    flops = 2 * 2 * (live_rows + B) * H * hd       # QK^T and PV
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOPS * 1e3
    say(f"kernel paged_attention_decode: max_abs_err={err} ms={ms} "
        f"plain_ms={plain_ms} bound_ms={max(bytes_ms, flops_ms)} "
        f"({nbytes} bytes, {flops} flops) library_ms=null (no single "
        f"PyTorch call computes paged attention with the in-place append)")
    return {
        "name": "paged_attention_decode",
        "route": "cuda",
        "source": "generativeaiexamples_tpu_torch/csrc/paged_attention.cu",
        "replaces": "generativeaiexamples_tpu/ops/paged_attention.py:82",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,
    }


# ------------------------------------------------------------- model check

def check_model(torch, dev) -> None:
    """The port's engine against a plain greedy reference on a small
    input: llama-2-7b's full width cut to 2 layers, float32 weights from
    seed 0 (TF32 off), three concurrent greedy requests through the engine
    (the paged kernel in every layer) against argmax of a full-sequence
    ``llama.apply`` recomputed per token (no cache, no kernel)."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(LLAMA2_7B, num_layers=2)
    params = llama.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    engine = Engine(params, cfg, ByteTokenizer(), EngineConfig(
        max_slots=4, max_input_length=512, max_output_length=16,
        prefill_buckets=(128, 512), dtype="float32", kv_pool_tokens=None),
        device=dev)
    n_new = 8
    prompts = [[1] + [3 + (7 * i + j) % 256 for i in range(n)]
               for j, n in ((0, 40), (1, 125), (2, 300))]
    t0 = time.monotonic()
    with engine:
        streams = [engine.submit(p, SamplingParams(max_tokens=n_new, top_k=1,
                                                   ignore_eos=True))
                   for p in prompts]
        got = []
        for s in streams:
            s.text()
            got.append(s.token_ids)
    with torch.no_grad():
        for p, toks in zip(prompts, got):
            ids = list(p)
            for _ in range(n_new):
                t = torch.tensor([ids], dtype=torch.int32, device=dev)
                pos = torch.arange(len(ids), dtype=torch.int32,
                                   device=dev)[None, :]
                logits, _ = llama.apply(params, cfg, t, pos)
                if not torch.isfinite(logits).all():
                    fail("reference logits are not finite")
                ids.append(int(logits[0, -1].argmax()))
            if ids[len(p):] != toks:
                fail(f"engine greedy tokens {toks} differ from the plain "
                     f"reference {ids[len(p):]} (prompt of {len(p)})")
    say(f"model check: 2-layer llama-2-7b width, float32: engine greedy "
        f"tokens equal the plain full-forward reference for prompts of "
        f"{[len(p) for p in prompts]} tokens ({time.monotonic() - t0:.1f} s)")
    del engine, params
    torch.cuda.empty_cache()


# ------------------------------------------------------------- serve phase

def serve_app(app):
    """Run an aiohttp app on a free local port in a thread; returns
    (base url, stop function)."""
    import asyncio
    import threading

    from aiohttp import web

    loop = asyncio.new_event_loop()
    box: dict = {}
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
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
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            fail(f"{url} answered {resp.status}")
        return resp.read().decode()


def serve(torch, dev, card: str) -> dict:
    """The main path: llama-2-7b-chat at full width and depth, bf16 random
    weights made on the card from seed 0, served through the port's
    aiohttp /v1/completions. Returns the paged kernel's launch count over
    the run."""
    from concurrent.futures import ThreadPoolExecutor

    from generativeaiexamples_tpu_torch.engine import (EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.ops.paged_attention import \
        paged_attention_decode
    from generativeaiexamples_tpu_torch.serving.model_server import (
        build_services, create_server_app)

    t0 = time.monotonic()
    ecfg = EngineConfig(max_slots=8, max_input_length=1024,
                        max_output_length=64, prefill_buckets=(128, 512, 1024),
                        page_size=128, kv_pool_tokens=8 * (1024 + 64),
                        dtype="bfloat16")
    engine, name = build_services("llama-2-7b-chat", engine_cfg=ecfg, seed=0,
                                  device=dev)
    torch.cuda.synchronize()
    mcfg = engine.model_cfg
    n_params = sum(t.numel() for t in [engine.params["embed"],
                                       engine.params["lm_head"],
                                       *engine.params["layers"].values()])
    say(f"serve: {name} L={mcfg.num_layers} D={mcfg.hidden_size} "
        f"H={mcfg.num_heads} KV={mcfg.num_kv_heads} hd={mcfg.head_dim} "
        f"V={mcfg.vocab_size}, {n_params / 1e9:.2f} B bf16 params, pool "
        f"{engine.stats['pool_pages']} pages of {ecfg.page_size}, built in "
        f"{time.monotonic() - t0:.1f} s")
    base, stop_server = serve_app(create_server_app(engine, name))
    try:
        # Prompt lengths (byte tokens incl. bos): inside one page, one
        # short of a page, a page exactly, and several pages; 32 new tokens
        # carry the first three across a page boundary.
        prompts = ["Tell me about paged attention. " * 3,
                   "a" * 126, "b" * 127, "The quick brown fox. " * 40]
        bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0,
                   "stream": i == 1} for i, p in enumerate(prompts)]
        # Warm-up request (first cuBLAS/kernel loads), outside the count.
        post(base + "/v1/completions", {"prompt": "warm", "max_tokens": 2,
                                        "temperature": 0})

        steps0 = engine.stats["decode_steps"]
        tok0 = engine.stats["tokens_generated"]
        paged_attention_decode.launches = 0
        t1 = time.monotonic()
        with ThreadPoolExecutor(len(bodies)) as pool:
            outs = list(pool.map(
                lambda b: post(base + "/v1/completions", b), bodies))
        wall = time.monotonic() - t1
        tokens_http = engine.stats["tokens_generated"] - tok0
        stream = engine.submit(engine.tokenizer.encode("Count to ten:"),
                               SamplingParams(max_tokens=32, ignore_eos=True,
                                              temperature=0))
        stream.text()
        launches = paged_attention_decode.launches
        steps = engine.stats["decode_steps"] - steps0
        torch.cuda.synchronize()
    finally:
        stop_server()
        engine.stop()

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
        say(f"serve: request {i} ({len(body['prompt']) + 1} prompt tokens, "
            f"stream={body['stream']}): finish_reason={finish}")
    if len(stream.token_ids) != 32 or stream.finish_reason != "length":
        fail(f"ignore_eos request gave {len(stream.token_ids)} tokens, "
             f"finish {stream.finish_reason!r}")
    if not all(0 <= t < mcfg.vocab_size for t in stream.token_ids):
        fail("ignore_eos request produced out-of-vocab ids")
    if steps <= 0 or launches != mcfg.num_layers * steps:
        fail(f"paged kernel launched {launches} times over {steps} decode "
             f"steps; expected {mcfg.num_layers} per step")
    decode_s = stream.finish_time - stream.first_token_time
    say(f"serve: {len(bodies)} concurrent /v1/completions in {wall:.3f} s, "
        f"{tokens_http} tokens ({tokens_http / wall:.1f} tok/s aggregate); "
        f"single ignore_eos request: TTFT {stream.ttft_ms:.1f} ms, decode "
        f"{31 / decode_s:.1f} tok/s; paged kernel launches {launches} = "
        f"{mcfg.num_layers} layers x {steps} decode steps [{card}]")
    return {"launches": launches, "decode_steps": steps}


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

    t0 = time.monotonic()
    took = build.build_all()
    say(f"kernel build: {time.monotonic() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {name}: {line.strip()}")

    check_paged_attention(torch, dev, torch.float32)
    kernels = [check_paged_attention(torch, dev, torch.bfloat16)]
    torch.cuda.empty_cache()
    check_model(torch, dev)
    run = serve(torch, dev, card)
    kernels[0]["launches"] = run["launches"]

    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
