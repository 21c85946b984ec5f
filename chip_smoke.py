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
   the same bf16 x beside ``wg``.
3. The engines on a small input: llama-2-7b's width cut to 2 layers,
   float32 (TF32 off). bf16 path: greedy tokens through the engine (#1 in
   every layer) against argmax of a full-sequence forward. Quantized
   path (int4_awq weights, int8 KV pool): greedy tokens through the
   engine on the card (#2 and #3 on every call) against the same engine
   on the CPU with the same parameters (the plain versions). On the card
   each engine replays the decode rounds and admissions it captured as
   CUDA graphs at construction; an eager engine (``cuda_graphs=False``)
   must give the same tokens.
4. The main paths: serves llama-2-7b-chat (full width and depth, random
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
   decode round (host-clock step, device time, busy share) and
   bucket-128 admission are measured as ``tools/profile_decode.py`` does.

Exits 2 without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
            None, 0, None, 0, M, K, N, K // G,
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
    return [rows["tc"], rows["wg"]]


# ------------------------------------------------------------- model check

def check_model(torch, dev) -> None:
    """The port's engine against a plain greedy reference on a small
    input: llama-2-7b's full width cut to 2 layers, float32 weights from
    seed 0 (TF32 off), three concurrent greedy requests through the engine
    (its captured programs; the paged kernel in every layer) and through
    an eager engine (``cuda_graphs=False``), both against argmax of a
    full-sequence ``llama.apply`` recomputed per token (no cache, no
    kernel)."""
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
    for graphs_on in (True, False):
        engine = Engine(params, cfg, ByteTokenizer(), EngineConfig(
            max_slots=4, max_input_length=512, max_output_length=16,
            prefill_buckets=(128, 512), dtype="float32", kv_pool_tokens=None,
            cuda_graphs=graphs_on), device=dev)
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
        f"tokens (captured programs, and the eager engine alike) equal the "
        f"plain full-forward reference for prompts of "
        f"{[len(p) for p in prompts]} tokens ({time.monotonic() - t0:.1f} s)")
    del params
    torch.cuda.empty_cache()


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
        self.ecfg = EngineConfig(
            max_slots=4, max_input_length=512, max_output_length=16,
            prefill_buckets=(128, 512), dtype="float32", kv_pool_tokens=None,
            kv_quant="int8")
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
    the prefill projections, never a tensor-core path ("tc", "wg")."""
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
    steps, prefills = (engine.stats["decode_steps"],
                       engine.stats["prefills"])
    del engine
    per_forward = 7 * cfg.num_layers + 1
    want = {"tc": 0, "gemv": per_forward * steps + prefills,
            "tile": (per_forward - 1) * prefills, "wg": 0}
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


# Prompt lengths (byte tokens incl. bos): inside one page, one short of a
# page, a page exactly, and several pages; 32 new tokens carry the first
# three across a page boundary.
SERVE_PROMPTS = ["Tell me about paged attention. " * 3, "a" * 126, "b" * 127,
                 "The quick brown fox. " * 40]
ENGINE_PROMPT = "Count to ten:"


def serve(torch, dev, card: str, quantization: str = "",
          kv_quant: str = "") -> dict:
    """A main path: llama-2-7b-chat at full width and depth, bf16 random
    weights made on the card from seed 0 (quantized there to
    ``quantization``, over a ``kv_quant`` pool), served through the port's
    aiohttp /v1/completions. Every kernel count is set to 0 just before
    the counted requests and read just after; each kernel of the path
    must have run once per layer per decode step (attention) or once per
    projection per forward (int4), and the other path's kernels not at
    all. Returns the counts and the steps."""
    from concurrent.futures import ThreadPoolExecutor

    from generativeaiexamples_tpu_torch.engine import (EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul
    from generativeaiexamples_tpu_torch.ops.paged_attention import \
        paged_attention_decode
    from generativeaiexamples_tpu_torch.serving.model_server import (
        build_services, create_server_app)

    t0 = time.monotonic()
    ecfg = EngineConfig(max_slots=8, max_input_length=1024,
                        max_output_length=64, prefill_buckets=(128, 512, 1024),
                        page_size=128, kv_pool_tokens=8 * (1024 + 64),
                        dtype="bfloat16", kv_quant=kv_quant)
    engine, name = build_services("llama-2-7b-chat", engine_cfg=ecfg, seed=0,
                                  device=dev, quantization=quantization)
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
    base, stop_server = serve_app(create_server_app(engine, name))
    try:
        bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0,
                   "stream": i == 1} for i, p in enumerate(SERVE_PROMPTS)]
        # Warm-up request (first cuBLAS/kernel loads), outside the count.
        post(base + "/v1/completions", {"prompt": "warm", "max_tokens": 2,
                                        "temperature": 0})

        steps0 = engine.stats["decode_steps"]
        prefills0 = engine.stats["prefills"]
        tok0 = engine.stats["tokens_generated"]
        paged_attention_decode.launches = 0
        paged_attention_decode.int8_launches = 0
        int4_matmul.launches = 0
        int4_matmul.launches_by_path = dict.fromkeys(
            int4_matmul.launches_by_path, 0)
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
        counts = {"paged_attention_decode": paged_attention_decode.launches,
                  "paged_attention_decode_int8":
                      paged_attention_decode.int8_launches,
                  "int4_matmul": int4_matmul.launches}
        by_path = dict(int4_matmul.launches_by_path)
        steps = engine.stats["decode_steps"] - steps0
        prefills = engine.stats["prefills"] - prefills0
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
        say(f"serve [{mode}]: request {i} ({len(body['prompt']) + 1} prompt "
            f"tokens, "
            f"stream={body['stream']}): finish_reason={finish}")
    if len(stream.token_ids) != 32 or stream.finish_reason != "length":
        fail(f"ignore_eos request gave {len(stream.token_ids)} tokens, "
             f"finish {stream.finish_reason!r}")
    if not all(0 <= t < mcfg.vocab_size for t in stream.token_ids):
        fail("ignore_eos request produced out-of-vocab ids")
    # Attention: one launch per layer per decode step, of the pool's
    # kind. int4: one per projection (7 per layer) plus the lm_head, per
    # decode step and per prefill (which projects only its last row). By
    # #3's path (bf16 x): a decode step's 8 slots and a prefill's lm_head
    # row on "tc", a prefill's bucket rows on "wg".
    L = mcfg.num_layers
    attn = "paged_attention_decode_int8" if kv_quant else \
        "paged_attention_decode"
    want = {"paged_attention_decode": 0, "paged_attention_decode_int8": 0,
            "int4_matmul": 0}
    want[attn] = L * steps
    want_path = {"tc": 0, "gemv": 0, "tile": 0, "wg": 0}
    if quantization in ("int4", "int4_awq"):
        want["int4_matmul"] = (7 * L + 1) * (steps + prefills)
        want_path = {"tc": (7 * L + 1) * steps + prefills, "gemv": 0,
                     "tile": 0, "wg": 7 * L * prefills}
    if (steps <= 0 or prefills <= 0 or counts != want
            or by_path != want_path):
        fail(f"[{mode}] kernel launches {counts} (int4 by path {by_path}) "
             f"over {steps} decode steps and {prefills} prefills; expected "
             f"{want} ({want_path})")
    decode_s = stream.finish_time - stream.first_token_time
    say(f"serve [{mode}]: {len(bodies)} concurrent /v1/completions in "
        f"{wall:.3f} s, {tokens_http} tokens ({tokens_http / wall:.1f} tok/s "
        f"aggregate); single ignore_eos request: TTFT {stream.ttft_ms:.1f} "
        f"ms, decode {31 / decode_s:.1f} tok/s; launches {counts} (int4 "
        f"by path {by_path}) over {steps} decode steps and {prefills} "
        f"prefills [{card}]")
    graphs_vs_eager(torch, dev, card, engine, mode)
    del engine
    torch.cuda.empty_cache()
    return {"launches": counts, "by_path": by_path, "decode_steps": steps,
            "prefills": prefills}


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


def graphs_vs_eager(torch, dev, card: str, engine, mode: str) -> None:
    """The served engine (every round and admission a replay of a program
    it captured at construction) against an eager engine on the same
    weights (``cuda_graphs=False``): the serve prompts and the engine
    prompt, 32 greedy tokens each (``ignore_eos``), one schedule on both
    (all submitted, then the serve loop's step driven on this thread),
    must give equal tokens; a difference fails with its first step and
    the top-2 logit gap there. Then ``profile_decode``'s measurements on
    the served engine: a decode round of 8 slots with 512-token prompts
    (host-clock step over 4 rounds; device time, busy time and busy share
    of one traced round) and a bucket-128 admission (host-clock time to
    the first token, mean of 4)."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import Engine, SamplingParams
    from generativeaiexamples_tpu_torch.tools.profile_decode import (
        measure_decode, measure_prefill)

    ids = [engine.tokenizer.encode(p) for p in SERVE_PROMPTS + [ENGINE_PROMPT]]
    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True)
    eager = Engine(engine.params, engine.model_cfg, engine.tokenizer,
                   replace(engine.cfg, cuda_graphs=False), device=dev)
    runs = {}
    for name, eng in (("graphs", engine), ("eager", eager)):
        streams = [eng.submit(i, sp) for i in ids]
        for _ in range(100):
            if all(s.finish_reason is not None for s in streams):
                break
            eng._step()
        runs[name] = [s.token_ids for s in streams]
        if any(len(t) != 32 for t in runs[name]):
            fail(f"[{mode}] {name} engine: {[len(t) for t in runs[name]]} "
                 f"tokens")
    del eager
    for i, (a, b) in enumerate(zip(runs["graphs"], runs["eager"])):
        if a != b:
            k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = top2_gap(torch, engine, ids[i] + a[:k])
            fail(f"[{mode}] prompt {i} ({len(ids[i])} tokens): the captured "
                 f"programs' greedy token {k} is {a[k]}, the eager "
                 f"engine's {b[k]} (top-2 logit gap there {gap})")
    dec = measure_decode(engine, 8, 512, rounds=4)
    pre = measure_prefill(engine, 128, rounds=4)
    say(f"graphs [{mode}]: greedy tokens of the {len(ids)} serve prompts "
        f"equal the eager engine's; captured programs hold "
        f"{engine.graph_pool_bytes} bytes of pool, memory reserved "
        f"{torch.cuda.memory_reserved(dev)} bytes")
    say(f"graphs [{mode}]: decode step {dec['step_ms']:.3f} ms (host clock, "
        f"8 slots, context ~{dec['context']}), device "
        f"{dec['device_ms_per_step']:.3f} ms/step (busy "
        f"{dec['device_busy_ms_per_step']:.3f}), busy share "
        f"{dec['device_busy_share']:.1%}; kernels per step (ms) "
        f"{ {k: round(v, 3) for k, v in dec['kernel_ms_per_step'].items()} }"
        f" over {dec['kernel_launches']} launches; bucket-128 TTFT "
        f"{pre['prefill_ms']:.3f} ms (host clock), device "
        f"{pre['device_ms']:.3f} ms (busy {pre['device_busy_ms']:.3f}), "
        f"busy share {pre['device_busy_share']:.1%} [{card}]")
    torch.cuda.empty_cache()


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
    check_model(torch, dev)
    lap("model")
    check_model_quant(torch, dev, quant_ref)
    lap("model_quant")
    # Each path's kernels take their launch counts from that path's run.
    bf16 = serve(torch, dev, card)
    lap("serve_bf16")
    quantized = serve(torch, dev, card, quantization="int4_awq",
                      kv_quant="int8")
    lap("serve_int4")
    for row in kernels:
        run = bf16 if row["name"] == "paged_attention_decode" else quantized
        row["launches"] = (run["by_path"][row["path"]] if "path" in row
                           else run["launches"][row["name"]])
    say(f"phase seconds: {phases}, total {sum(phases.values()):.1f}")

    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
