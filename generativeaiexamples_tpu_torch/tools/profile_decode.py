"""Where a decode step's (or a prefill's) time goes, on the card.

    python -m generativeaiexamples_tpu_torch.tools.profile_decode \\
        [--model llama-2-7b-chat] [--slots 8] [--prompt-len 512] \\
        [--steps 8] [--rounds 4] [--trace decode_trace.json] \\
        [--quantization int4_awq] [--kv-quant int8] [--prefill BUCKET] \\
        [--chunk C --prefix P] [--eager] [--dispatch-depth 2[,1,...]] \\
        [--materialized-tail] [--tail-tiles 4000,8000,16000] [--spec]

Builds the port's engine for ``--model`` (a registry name: llama-2-7b-chat
by default, or nemotron-8b-chat for the GPT-Next family; random bf16
weights from ``--seed``, quantized on the device with ``--quantization``,
over a ``--kv-quant`` pool), fills
every slot with a ``--prompt-len`` prompt, and drives the serve loop's
``_step`` on this thread: after a warm-up round it times ``--rounds``
decode rounds of ``--steps`` steps with the host clock (each round ends
in a device->host read of its tokens), then traces one more round with
``torch.profiler`` and attributes its device time by kernel. Prints the
step time beside its weight-and-KV byte bound, the device's busy share
of the traced round, the port's kernels (paged attention, int4 matmul)
with their launches, and the top kernels; the last line is one JSON
object. Runs on the card; ``--device cpu`` rehearses the tool itself
at a small ``--model`` (its times are then CPU times, not the card's).

``--dispatch-depth`` sets how many decode rounds ride the device queue
(2: the harvest worker reads each round back while the next runs; 1:
each round is read back on this thread); a list (``2,1,2,1``) times each
depth in turn on one engine, untraced, before the traced round (at the
first). Untraced timings come first because the first profiler session
of a process leaves CUPTI attached, and on the card that changes how
CUDA graphs run: their launch then costs the host milliseconds and the
round's own device time changes (PERF.md section 5). A server runs no
profiler, so only timings taken before any trace are a server's.

On the card the engine replays the rounds and admissions it captured as
CUDA graphs at construction, and the profiler attributes each replayed
kernel by name; ``--eager`` builds the engine with
``EngineConfig(cuda_graphs=False)``, which issues every operation from the
host as before. ``measure_decode`` and ``measure_prefill`` take an engine
that exists already (``chip_smoke.py`` calls them).

The sampling tail is measured on its own as well (``measure_tail``, the
"sampler" group): one decode step's tail over the engine's slot state,
captured as a CUDA graph of back-to-back tails and timed with CUDA
events, at 8 rows and at 1 (the active-row ladder's rungs), greedy and
sampled, fused (the head tiles, the penalize and stream kernels, the
candidate merge; ``--tail-tiles`` sweeps the tile size) and
materialized ((B, V) logits, masks and a full sort, every row whatever
the occupancy). The traced tail lists its kernels and whether a copy
kernel ran (a head tile must reach its GEMM as a strided view). The
non-tail rest of a step is the traced round's busy time less the
tail's. ``--materialized-tail`` builds the engine with
``EngineConfig(fused_tail=False)`` (the oracle) for its decode rounds.

``--prefill BUCKET`` profiles one prefill instead: a prompt of BUCKET
tokens (any page multiple, the engine's one bucket, so no row is padding;
1664 is the chatbot's fused-RAG bucket) asking for one token, admitted by
one ``_step`` (prefill, KV insert, first token to the host).
After a warm-up it times ``--rounds`` such prefills with the host clock,
traces one more, and prints the prefill time, the device's busy share
of it and its device time by kernel (the int4 matmul by path).

``--chunk C --prefix P`` profiles one chunk extension of a chunked
admission instead: a P-token prompt (a page multiple) is served first, so
its pages are in the prefix cache; then a prompt of those P tokens plus
2C more is admitted under a C-token budget, so its first program is the
C-token extension that streams the P cached tokens from the pool ("seed"
mode; "replace" at P = 0). That program is replayed ``--rounds`` times
and timed with CUDA events, then traced once more by kernel.

``--spec`` profiles one speculative verify round beside one
``--steps``-step decode round, on an engine with speculative decoding
on: every slot holds a ``--prompt-len`` prompt and K = S - 1 drafts
(``measure_verify``). Both captured programs are replayed ``--rounds``
times and timed with CUDA events (the slot state put back after), then
traced once each; it prints each round's device ms, device ms per
emitted slot-position (S per slot for the verify round, one per step for
the decode round: the break-even tokens per verify slot-step is their
ratio), kernels per round, the int4 matmul by path, and the gathered
attention's share of the verify round (one layer's gather, in-place
rows and attention at the round's shapes, replayed alone from a CUDA
graph, times the layers).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate


def _profile():
    """A torch.profiler session over host and device activity."""
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def _device_events(prof) -> list:
    """The device-side events of a trace (kernels, copies, sets); the host
    operators that launched them would count the same time twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _kernel_times(events) -> dict[str, tuple[float, int]]:
    """Device activity by name: (microseconds, count)."""
    out: dict[str, tuple[float, int]] = {}
    for e in events:
        us, n = out.get(e.name, (0.0, 0))
        out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return out


# Device time of the port's own kernels, by kernel function name
# (csrc/paged_attention.cu's split and merge passes; csrc/int4_matmul.cu's
# paths "tc", "gemv", "tile" and "wg"). Every __global__ function of
# csrc/ is named here.
_OURS = {"paged_attention": ("paged_decode_split_kernel",
                             "paged_decode_merge_kernel"),
         "int4_matmul": ("int4_mma_kernel", "int4_gemv_kernel",
                         "int4_matmul_kernel", "int4_wgmma_kernel")}
_INT4_PATHS = {"tc": "int4_mma_kernel", "gemv": "int4_gemv_kernel",
               "tile": "int4_matmul_kernel", "wg": "int4_wgmma_kernel"}


def _busy_us(events) -> float:
    """Microseconds in which at least one device activity ran: the union
    of their intervals. Below the sum of their durations by whatever ran
    at once (a programmatic dependent launch starts before its
    predecessor ends)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _ours_us(kernels: dict[str, tuple[float, int]]) -> dict[str, float]:
    return {k: sum(us for name, (us, _) in kernels.items()
                   if any(sym in name for sym in syms))
            for k, syms in _OURS.items()}


def _card(cuda: bool) -> str:
    if not cuda:
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def measure_prefill(engine, bucket: int, rounds: int, seed: int = 0,
                    trace: str = "", traced: bool = True) -> dict:
    """Host-clock mean of ``rounds`` admissions of a full ``bucket``
    prompt asking for one token (after a warm-up), and, when ``traced``,
    the device time of one more, traced, by kernel (no device fields
    otherwise). ``engine`` is idle and not started; ``bucket`` is one of
    its prefill buckets."""
    from ..engine import SamplingParams
    from ..ops.int4_matmul import int4_matmul

    cuda = engine.device.type == "cuda"
    rng = np.random.default_rng(seed)

    def one_prefill() -> float:
        """Host-clock seconds of one prefill of a full bucket (the step
        ends reading its first token back, so the device is done)."""
        ids = [1] + list(rng.integers(3, 259, bucket - 1))
        stream = engine.submit(ids, SamplingParams(max_tokens=1, top_k=1,
                                                   ignore_eos=True))
        t0 = time.perf_counter()
        engine._step()
        took = time.perf_counter() - t0
        engine._step()   # releases the finished slot
        if len(stream.token_ids) != 1:
            raise RuntimeError("the prefill produced no first token")
        return took

    one_prefill()   # warm-up
    prefills0 = engine.stats["prefills"]
    wall = [one_prefill() for _ in range(rounds)]
    prefill_ms = sum(wall) / len(wall) * 1e3
    if not traced:
        return {"card": _card(cuda), "cuda_graphs": engine._graphs_on,
                "prefill_bucket": bucket, "prefill_ms": prefill_ms}
    launches0 = int4_matmul.launches
    int4_matmul.launches_by_path = dict.fromkeys(
        int4_matmul.launches_by_path, 0)
    with _profile() as prof:
        traced_ms = one_prefill() * 1e3
    by_path = dict(int4_matmul.launches_by_path)
    if engine.stats["prefills"] - prefills0 != rounds + 1:
        raise RuntimeError("a prefill was not counted")
    if trace:
        prof.export_chrome_trace(trace)
    events = _device_events(prof)
    kernels = _kernel_times(events)
    device_us = sum(us for us, _ in kernels.values())
    busy_us = _busy_us(events)
    int4_us = {p: sum(us for name, (us, _) in kernels.items() if sym in name)
               for p, sym in _INT4_PATHS.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "card": _card(cuda), "cuda_graphs": engine._graphs_on,
        "prefill_bucket": bucket, "prefill_ms": prefill_ms,
        "traced_prefill_ms": traced_ms, "device_ms": device_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / prefill_ms,
        "int4_launches": int4_matmul.launches - launches0,
        "int4_ms_by_path": {p: us / 1e3 for p, us in int4_us.items()},
        "int4_launches_by_path": by_path,
        "top_device_ops": [{"name": name[:120], "ms": us / 1e3, "count": n}
                           for name, (us, n) in top]}


def measure_tail(engine, rows: int, greedy: bool, fused: bool,
                 tile: Optional[int] = None, reps: int = 20,
                 traced: bool = False, seed: int = 0) -> dict:
    """One decode step's sampling tail alone, on the engine's current slot
    state and random hidden rows: the fused tail over ``rows`` rows of
    ``act_idx`` (``tile``: the sampler tile, default the engine's) or the
    materialized tail (every row). On the card ``reps`` tails are
    captured in one CUDA graph and a replay is timed with CUDA events
    (``traced``: one more replay under the profiler, by kernel); on the
    CPU the host clock times eager calls. The engine must be idle; the
    tails write no engine state but ``act_idx``."""
    from ..engine import graphs

    cuda = engine.device.type == "cuda"
    B, D = engine.cfg.max_slots, engine.model_cfg.hidden_size
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    h = torch.randn((B, D), generator=gen, device=engine.device).to(
        engine._dtype)
    act = np.full((B,), B, np.int32)
    act[:rows] = np.arange(rows)
    engine._host_to_device(engine._state["act_idx"], act)
    saved = engine._sampler_tile
    engine._sampler_tile = tile or saved

    def tails():
        for _ in range(reps):
            if fused:
                engine._fused_tail(h, greedy, rows)
            else:
                engine._materialized_tail(h, greedy)

    out = {"rows": rows if fused else B, "greedy": greedy, "fused": fused,
           "tile": engine._sampler_tile if fused else None}
    try:
        with torch.no_grad():
            if not cuda:
                tails()
                t0 = time.perf_counter()
                tails()
                out["ms"] = (time.perf_counter() - t0) * 1e3 / reps
                return out
            before = graphs.launch_counts()
            program = graphs.capture(
                tails, device=engine.device,
                stream=torch.cuda.Stream(engine.device),
                pool=torch.cuda.graph_pool_handle(),
                generators=() if greedy else (engine._round_gen,))
            graphs.set_launch_counts(before)
            program.graph.replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            program.graph.replay()
            end.record()
            end.synchronize()
            out["ms"] = start.elapsed_time(end) / reps
            out["int4_launches"] = program.launches.get(
                "int4_matmul", 0) / reps
            if traced:
                with _profile() as prof:
                    program.graph.replay()
                    torch.cuda.synchronize()
                events = _device_events(prof)
                kernels = _kernel_times(events)
                out["kernels_per_step"] = sum(
                    n for _, n in kernels.values()) / reps
                out["busy_ms"] = _busy_us(events) / 1e3 / reps
                out["copy_kernels"] = sorted(
                    name[:80] for name in kernels
                    if "copy" in name.lower() or "memcpy" in name.lower())
                out["top_kernels"] = [
                    {"name": name[:90], "ms_per_step": us / 1e3 / reps,
                     "per_step": n / reps}
                    for name, (us, n) in sorted(
                        kernels.items(), key=lambda kv: -kv[1][0])[:6]]
            return out
    finally:
        engine._sampler_tile = saved


def tail_table(engine, tiles=()) -> list[dict]:
    """``measure_tail`` untraced: the fused tail at the engine's slots and
    at 1 row and the materialized tail, greedy and sampled; then the
    fused tail at each of ``tiles`` (all rows, sampled)."""
    B = engine.cfg.max_slots
    runs = [measure_tail(engine, rows, greedy, fused)
            for fused in (True, False) for greedy in (True, False)
            for rows in ((B, 1) if fused else (B,))]
    runs += [measure_tail(engine, B, False, True, tile=t) for t in tiles]
    return runs


def profile_prefill(args) -> int:
    """The ``--prefill BUCKET`` mode (see the module docstring)."""
    from ..engine import EngineConfig
    from ..serving.model_server import build_services

    bucket = args.prefill
    # The bucket is the engine's only one, and its budget admits the
    # whole prompt in one program (a measured budget would chunk it).
    ecfg = EngineConfig(max_slots=1, max_input_length=bucket,
                        max_output_length=1, kv_pool_tokens=None,
                        prefill_buckets=(bucket,),
                        sched_round_budget_tokens=bucket,
                        kv_quant=args.kv_quant, cuda_graphs=not args.eager)
    if bucket % ecfg.page_size:
        raise SystemExit(f"--prefill {bucket} is not a prefill bucket: "
                         f"use a multiple of the page size {ecfg.page_size}")
    engine, model_name = build_services(args.model, engine_cfg=ecfg,
                                        seed=args.seed, device=args.device,
                                        quantization=args.quantization)
    out = measure_prefill(engine, bucket, args.rounds, args.seed, args.trace)
    engine.stop()

    mode = (f"{args.quantization or 'bf16'} weights, "
            f"{args.kv_quant or 'bf16'} KV, "
            f"{'graphs' if out['cuda_graphs'] else 'eager'}")
    print(f"{model_name} [{mode}] on {out['card']}: one prefill of {bucket} "
          f"tokens")
    print(f"prefill {out['prefill_ms']:.2f} ms (host clock, mean of "
          f"{args.rounds}); traced {out['traced_prefill_ms']:.2f} ms "
          f"(profiler on), device {out['device_ms']:.2f} ms (busy "
          f"{out['device_busy_ms']:.2f} ms = {out['device_busy_share']:.1%} "
          f"of an untraced prefill)")
    print(f"  int4_matmul: {sum(out['int4_ms_by_path'].values()):.2f} ms "
          f"over {out['int4_launches']} launches; by path (ms) "
          f"{out['int4_ms_by_path']}, launches {out['int4_launches_by_path']}")
    for op in out["top_device_ops"]:
        print(f"  {op['ms']:9.2f} ms  {op['count']:6d}x  {op['name'][:90]}")
    print(json.dumps({"model": model_name, "quantization": args.quantization,
                      "kv_quant": args.kv_quant, **out}))
    return 0


def measure_chunk(engine, chunk: int, prefix: int, rounds: int,
                  seed: int = 0, trace: str = "") -> dict:
    """Device time of one chunk-extension program of ``chunk`` tokens
    after a ``prefix``-token cached prefix (the ``--chunk`` mode): CUDA
    events around ``rounds`` replays, then one more traced by kernel.
    ``engine`` is idle, not started, with one slot, ``chunk`` as its only
    bucket and a ``chunk``-token round budget."""
    from ..engine import SamplingParams
    from ..ops.int4_matmul import int4_matmul

    cuda = engine.device.type == "cuda"
    if engine._buckets != (chunk,) or prefix % engine.cfg.page_size:
        raise ValueError("the engine's only bucket must be the chunk and "
                         "the prefix a page multiple")
    rng = np.random.default_rng(seed)
    ids = [1] + list(rng.integers(3, 259, prefix + 2 * chunk - 1))
    sp = SamplingParams(max_tokens=1, top_k=1, ignore_eos=True)
    if prefix:
        warm = engine.submit(ids[:prefix], sp)
        for _ in range(4 * (prefix // chunk + 2)):
            engine._step()
        if len(warm.token_ids) != 1 or engine.stats["prefix_cache_pages"] \
                < prefix // engine.cfg.page_size:
            raise RuntimeError("the prefix was not served and cached")
    stream = engine.submit(ids, sp)
    engine._step()                   # admission: the first extension
    req = next(iter(engine._slots.values()))
    if req.pf_pos != prefix + chunk or req.prefill_done:
        raise RuntimeError(f"the first program prefilled up to {req.pf_pos}"
                           f", not one {chunk}-token chunk after {prefix}")
    mode = "seed" if prefix else "replace"
    program = engine._extend_graphs.get((chunk, mode))

    def run():
        if program is not None:
            program.replay()
        else:
            engine._chunk_extend_body(chunk, mode)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    run()
    sync()
    t0 = time.perf_counter()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    for _ in range(rounds):
        run()
    if cuda:
        end.record()
    sync()
    chunk_ms = (start.elapsed_time(end) if cuda
                else (time.perf_counter() - t0) * 1e3) / rounds
    int4_matmul.launches_by_path = dict.fromkeys(
        int4_matmul.launches_by_path, 0)
    with _profile() as prof:
        run()
        sync()
    by_path = dict(int4_matmul.launches_by_path)
    if trace:
        prof.export_chrome_trace(trace)
    stream.cancel()
    for _ in range(4):
        engine._step()
    events = _device_events(prof)
    kernels = _kernel_times(events)
    int4_us = {p: sum(us for name, (us, _) in kernels.items() if sym in name)
               for p, sym in _INT4_PATHS.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "card": _card(cuda), "cuda_graphs": program is not None,
        "chunk": chunk, "prefix": prefix, "mode": mode,
        "chunk_ms": chunk_ms,
        "device_ms": sum(us for us, _ in kernels.values()) / 1e3,
        "device_busy_ms": _busy_us(events) / 1e3,
        "int4_ms_by_path": {p: us / 1e3 for p, us in int4_us.items()},
        "int4_launches_by_path": by_path,
        "top_device_ops": [{"name": name[:120], "ms": us / 1e3, "count": n}
                           for name, (us, n) in top]}


def profile_chunk(args) -> int:
    """The ``--chunk C --prefix P`` mode (see the module docstring)."""
    from ..engine import EngineConfig
    from ..serving.model_server import build_services

    C, P = args.chunk, args.prefix
    ecfg = EngineConfig(max_slots=1, max_input_length=P + 2 * C,
                        max_output_length=1, prefill_buckets=(C,),
                        max_prefill_bucket=C, kv_pool_tokens=None,
                        kv_quant=args.kv_quant, cuda_graphs=not args.eager,
                        sched_round_budget_tokens=C,
                        sched_prefill_chunk_tokens=C)
    engine, model_name = build_services(args.model, engine_cfg=ecfg,
                                        seed=args.seed, device=args.device,
                                        quantization=args.quantization)
    out = measure_chunk(engine, C, P, args.rounds, args.seed, args.trace)
    engine.stop()
    mode = (f"{args.quantization or 'bf16'} weights, "
            f"{args.kv_quant or 'bf16'} KV, "
            f"{'graphs' if out['cuda_graphs'] else 'eager'}")
    print(f"{model_name} [{mode}] on {out['card']}: one {C}-token chunk "
          f"extension ({out['mode']}) after a {P}-token cached prefix")
    clock = "CUDA events" if out["card"] != "cpu" else "host clock"
    print(f"chunk {out['chunk_ms']:.3f} ms ({clock}, mean of "
          f"{args.rounds} runs); traced device {out['device_ms']:.3f} ms "
          f"(busy {out['device_busy_ms']:.3f} ms)")
    print(f"  int4_matmul by path (ms) {out['int4_ms_by_path']}, launches "
          f"{out['int4_launches_by_path']}")
    for op in out["top_device_ops"]:
        print(f"  {op['ms']:9.3f} ms  {op['count']:6d}x  {op['name'][:90]}")
    print(json.dumps({"model": model_name, "quantization": args.quantization,
                      "kv_quant": args.kv_quant, **out}))
    return 0


def measure_verify(engine, prompt_len: int, rounds: int, seed: int = 0,
                   trace: str = "", traced: bool = True) -> dict:
    """Device time of one verify round and of one decode round of
    ``steps_per_round`` steps on the idle, unstarted spec ``engine``
    (the ``--spec`` mode): every slot admitted with a ``prompt_len``
    prompt, then S - 1 random drafts staged in every slot; each program
    replayed ``rounds`` times under CUDA events (the host clock on the
    CPU), the slot state restored after, then each traced once (kernels
    per round, int4 launches by path). The gathered attention's share is
    one layer's window gather, in-place rows and ``gqa_attention`` at the
    round's shapes, timed alone, times the layers, over the verify
    round's time (on the card replayed from a CUDA graph, as the round
    runs it). ``traced`` False skips the traces (a profiler session
    changes how the card runs graphs for the rest of the process)."""
    from ..engine import SamplingParams
    from ..models import llama
    from ..ops.attention import gqa_attention
    from ..ops.int4_matmul import int4_matmul

    if engine._spec is None:
        raise ValueError("the engine has speculative decoding off")
    cuda = engine.device.type == "cuda"
    B, S, page = engine.cfg.max_slots, engine._spec_S, engine.cfg.page_size
    steps = engine.cfg.steps_per_round
    rng = np.random.default_rng(seed)
    V = engine.model_cfg.vocab_size
    streams = [engine.submit([1] + list(rng.integers(3, min(V, 259),
                                                     prompt_len - 1)),
                             SamplingParams(max_tokens=engine.cfg
                                            .max_output_length,
                                            top_k=1, ignore_eos=True))
               for _ in range(B)]
    # Admission under an unbounded budget (put back after), so the slots
    # arm within a few steps and none runs out of tokens meanwhile.
    with engine.pinned_round_budget(1 << 20):
        for _ in range(8 * B):
            if all(s.token_ids for s in streams):
                break
            engine._step()
    members = engine._armed()
    if len(members) != B:
        raise RuntimeError(f"{len(members)} of {B} slots armed")
    st = engine._state
    engine._stage_act_idx(members)
    drafts = rng.integers(3, min(V, 259), (B, st["drafts"].shape[1]))
    engine._host_to_device(st["drafts"], drafts.astype(np.int32))
    engine._host_to_device(st["n_draft"], np.full((B,), S - 1, np.int32))
    need = max(min(r.proj_pos + S, r.extent) + 1 for r in members.values())
    pages = min(-(-need // page), engine._pmax)
    window = next(w for w in engine._windows if w >= pages)
    saved = {k: st[k].clone() for k in engine._SLOT_KEYS}

    def restore():
        for k, v in saved.items():
            st[k].copy_(v)

    def verify():
        engine._replay(engine._verify_graphs, engine._verify_body, window,
                       True, B)

    def decode():
        engine._replay(engine._round_graphs, engine._round_body, steps,
                       True, B)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn) -> float:
        fn()
        restore()
        sync()
        total = 0.0
        for _ in range(rounds):
            t0 = time.perf_counter()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            fn()
            if cuda:
                end.record()
            sync()
            total += (start.elapsed_time(end) if cuda
                      else (time.perf_counter() - t0) * 1e3)
            restore()
        return total / rounds

    verify_ms, decode_ms = timed(verify), timed(decode)
    # One layer's gathered attention at the verify round's shapes.
    m = engine.model_cfg
    cache = st["cache"]
    quant = llama.kv_cache_quantized(cache)
    dt = engine._dtype
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    q = torch.randn((B, S, m.num_heads, m.head_dim), generator=gen,
                    device=engine.device).to(dt)
    kv = torch.randn((B, S, m.num_kv_heads, m.head_dim), generator=gen,
                     device=engine.device).to(dt)
    positions = st["pos"][:, None] + torch.arange(
        S, dtype=torch.int32, device=engine.device)[None, :]
    table = torch.nn.functional.pad(st["table"][:, :window],
                                    (0, -(-S // page)))
    rows = torch.arange(B, device=engine.device)[:, None]

    def attention():
        ks = cache["ks"][0] if quant else None
        vs = cache["vs"][0] if quant else None
        kg = llama._gathered_window(cache["k"][0], ks, table, m, dt)
        vg = llama._gathered_window(cache["v"][0], vs, table, m, dt)
        kg[rows, positions.long()] = kv
        vg[rows, positions.long()] = kv
        gqa_attention(q, kg, vg, positions, positions[:, 0] + S)

    with torch.no_grad():
        run_attention = attention
        if cuda:
            # Replayed from a CUDA graph, as in the captured round: issued
            # one op at a time it would time the host's launches.
            side = torch.cuda.Stream(engine.device)
            side.wait_stream(torch.cuda.current_stream(engine.device))
            with torch.cuda.stream(side):
                attention()
            torch.cuda.current_stream(engine.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                attention()
            run_attention = graph.replay
        attention_ms = timed(run_attention) * m.num_layers
    out = {"card": _card(cuda), "window_pages": window, "S": S,
           "slots": B, "steps": steps, "verify_ms": verify_ms,
           "decode_round_ms": decode_ms,
           "verify_ms_per_position": verify_ms / (B * S),
           "decode_ms_per_position": decode_ms / (B * steps),
           "break_even_tokens_per_slot_step":
               (verify_ms / B) / (decode_ms / (B * steps)),
           "gathered_attention_ms": attention_ms,
           "gathered_attention_share": attention_ms / verify_ms}
    for name, fn in ((("verify", verify), ("decode", decode)) if traced
                     else ()):
        int4_matmul.launches_by_path = dict.fromkeys(
            int4_matmul.launches_by_path, 0)
        with _profile() as prof:
            fn()
            sync()
        restore()
        if trace:
            prof.export_chrome_trace(f"{trace}.{name}.json")
        events = _device_events(prof)
        kernels = _kernel_times(events)
        out[name + "_traced"] = {
            "device_ms": sum(us for us, _ in kernels.values()) / 1e3,
            "busy_ms": _busy_us(events) / 1e3,
            "kernels": len(events),
            "int4_launches_by_path": dict(int4_matmul.launches_by_path),
            "top_device_ops": [
                {"name": k[:120], "ms": us / 1e3, "count": n}
                for k, (us, n) in sorted(kernels.items(),
                                         key=lambda kv: -kv[1][0])[:8]]}
    for s in streams:
        s.cancel()
    for _ in range(4):
        engine._step()
    return out


def profile_spec(args) -> int:
    """The ``--spec`` mode (see the module docstring)."""
    from ..engine import EngineConfig
    from ..serving.model_server import build_services

    ecfg = EngineConfig(max_slots=args.slots,
                        max_input_length=max(args.prompt_len, 128),
                        max_output_length=64, steps_per_round=args.steps,
                        kv_pool_tokens=None, kv_quant=args.kv_quant,
                        cuda_graphs=not args.eager, spec_decode=True)
    engine, model_name = build_services(args.model, engine_cfg=ecfg,
                                        seed=args.seed, device=args.device,
                                        quantization=args.quantization)
    out = measure_verify(engine, args.prompt_len, args.rounds, args.seed,
                         args.trace)
    engine.stop()
    mode = (f"{args.quantization or 'bf16'} weights, "
            f"{args.kv_quant or 'bf16'} KV")
    print(f"{model_name} [{mode}] on {out['card']}: {out['slots']} slots, "
          f"~{args.prompt_len}-token contexts, window {out['window_pages']} "
          f"pages")
    print(f"verify round (S = {out['S']}): {out['verify_ms']:.3f} ms; "
          f"{out['steps']}-step decode round: {out['decode_round_ms']:.3f} "
          f"ms; per slot-position {out['verify_ms_per_position']:.4f} vs "
          f"{out['decode_ms_per_position']:.4f} ms; a verify round pays "
          f"off above {out['break_even_tokens_per_slot_step']:.2f} tokens "
          f"per slot")
    print(f"gathered attention: {out['gathered_attention_ms']:.3f} ms "
          f"({out['gathered_attention_share']:.1%} of the verify round)")
    for name in ("verify", "decode"):
        t = out[name + "_traced"]
        print(f"traced {name}: device {t['device_ms']:.3f} ms (busy "
              f"{t['busy_ms']:.3f}) over {t['kernels']} kernels; int4 "
              f"{t['int4_launches_by_path']}")
        for op in t["top_device_ops"]:
            print(f"  {op['ms']:9.3f} ms  {op['count']:6d}x  "
                  f"{op['name'][:90]}")
    print(json.dumps({"model": model_name, "quantization": args.quantization,
                      "kv_quant": args.kv_quant, **out}))
    return 0


def main(argv=None) -> int:
    from ..engine import EngineConfig
    from ..ops.quant import MODES
    from ..serving.model_server import build_services

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama-2-7b-chat")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default="",
                    help="write the traced round's chrome trace here")
    ap.add_argument("--quantization", default="", choices=["", *MODES])
    ap.add_argument("--kv-quant", default="", choices=["", "int8"])
    ap.add_argument("--prefill", type=int, default=0, metavar="BUCKET",
                    help="profile one prefill of this bucket instead of "
                         "decode rounds")
    ap.add_argument("--chunk", type=int, default=0, metavar="C",
                    help="profile one C-token chunk extension instead")
    ap.add_argument("--prefix", type=int, default=0, metavar="P",
                    help="with --chunk: the cached prefix it follows "
                         "(a page multiple)")
    ap.add_argument("--dispatch-depth", default="2",
                    help="decode rounds in flight (2: the harvest worker "
                         "reads rounds back beside the serve loop; 1: each "
                         "round read back in line); a comma-separated "
                         "list (2,1,2,1) measures each in turn on one "
                         "engine")
    ap.add_argument("--eager", action="store_true",
                    help="build the engine with cuda_graphs=False: every "
                         "operation issued from the host")
    ap.add_argument("--materialized-tail", action="store_true",
                    help="build the engine with fused_tail=False: (B, V) "
                         "logits and a full sort each step (the oracle)")
    ap.add_argument("--tail-tiles", default="",
                    help="comma-separated sampler tiles to time the fused "
                         "tail at (all rows, sampled), e.g. 4000,8000,16000")
    ap.add_argument("--spec", action="store_true",
                    help="profile one speculative verify round beside a "
                         "decode round instead")
    args = ap.parse_args(argv)
    if args.spec:
        return profile_spec(args)
    if args.prefill:
        return profile_prefill(args)
    if args.chunk:
        return profile_chunk(args)

    n_new = (args.rounds + 3) * args.steps + 1
    ecfg = EngineConfig(max_slots=args.slots,
                        max_input_length=max(args.prompt_len, 128),
                        max_output_length=n_new, steps_per_round=args.steps,
                        kv_pool_tokens=None, kv_quant=args.kv_quant,
                        cuda_graphs=not args.eager,
                        fused_tail=not args.materialized_tail)
    engine, model_name = build_services(args.model, engine_cfg=ecfg,
                                        seed=args.seed, device=args.device,
                                        quantization=args.quantization)
    depths = [int(d) for d in args.dispatch_depth.split(",")]
    # With several depths, each is timed untraced in turn (so all of them
    # in the same profiler regime), then the first is traced.
    runs = [measure_decode(engine, args.slots, args.prompt_len, args.rounds,
                           args.seed, dispatch_depth=d, traced=False)
            for d in (depths if len(depths) > 1 else [])]
    tiles = [int(t) for t in args.tail_tiles.split(",") if t]
    # The tail alone, untraced; then the decode rounds (traced last).
    tails = tail_table(engine, tiles)
    out = measure_decode(engine, args.slots, args.prompt_len, args.rounds,
                         args.seed, args.trace, depths[0])
    traced_tail = measure_tail(engine, args.slots, False,
                               engine.cfg.fused_tail, traced=True)
    engine.stop()
    for r in runs:
        share = out["device_busy_ms_per_step"] / r["step_ms"]
        print(f"dispatch depth {r['dispatch_depth']} (peak "
              f"{r['dispatch_depth_peak']}): decode step "
              f"{r['step_ms']:.3f} ms (host clock), busy share "
              f"{share:.1%}; serve thread "
              f"{r['serve_ms_per_step']:.3f} ms/step, harvest wait "
              f"{r['harvest_wait_ms_per_step']:.3f} and delivery "
              f"{r['harvest_emit_ms_per_step']:.3f} ms/step")

    mode = (f"{args.quantization or 'bf16'} weights, "
            f"{args.kv_quant or 'bf16'} KV, "
            f"{'graphs' if out['cuda_graphs'] else 'eager'}, "
            f"{'fused' if engine.cfg.fused_tail else 'materialized'} tail")
    print(f"{model_name} [{mode}] on {out['card']}: {args.slots} slots, "
          f"context ~{out['context']} tokens, {args.steps} steps per round, "
          f"dispatch depth {out['dispatch_depth']} (peak "
          f"{out['dispatch_depth_peak']})")
    print(f"host per step: serve thread {out['serve_ms_per_step']:.3f} ms, "
          f"harvest wait {out['harvest_wait_ms_per_step']:.3f} ms and "
          f"delivery {out['harvest_emit_ms_per_step']:.3f} ms")
    print(f"decode step {out['step_ms']:.2f} ms (host clock) vs byte bound "
          f"{out['step_bound_ms']:.2f} ms ({out['step_bytes'] / 1e9:.2f} "
          f"GB/step); {args.slots * 1e3 / out['step_ms']:.1f} tok/s aggregate")
    print(f"traced round: {out['traced_round_ms']:.1f} ms wall (profiler "
          f"on), device {out['device_ms_per_step']:.2f} ms/step over "
          f"{out['traced_steps']} steps (busy "
          f"{out['device_busy_ms_per_step']:.2f} ms/step), busy share of an "
          f"untraced step {out['device_busy_share']:.1%}")
    for k, ms in out["kernel_ms_per_step"].items():
        print(f"  {k}: {ms:.2f} ms/step over {out['kernel_launches'][k]} "
              f"launches" + (f" {out['int4_launches_by_path']}"
                             if k == "int4_matmul" else ""))
    for op in out["top_device_ops"]:
        print(f"  {op['ms']:9.2f} ms  {op['count']:6d}x  {op['name'][:90]}")
    for t in tails:
        print(f"sampler: {'fused' if t['fused'] else 'materialized'} tail, "
              f"{t['rows']} rows, {'greedy' if t['greedy'] else 'sampled'}"
              + (f", tile {t['tile']}" if t["fused"] else "")
              + f": {t['ms']:.4f} ms/step")
    if "busy_ms" in traced_tail:
        rest = out["device_busy_ms_per_step"] - traced_tail["busy_ms"]
        print(f"sampler (traced, this engine's tail, sampled): busy "
              f"{traced_tail['busy_ms']:.4f} ms/step over "
              f"{traced_tail['kernels_per_step']:.0f} kernels; the rest of "
              f"the step {rest:.3f} ms; copy kernels "
              f"{traced_tail['copy_kernels'] or 'none'}")
    print(json.dumps({"model": model_name, "quantization": args.quantization,
                      "kv_quant": args.kv_quant, "slots": args.slots,
                      "steps_per_round": args.steps, **out,
                      "untraced": runs, "sampler": tails,
                      "sampler_traced": traced_tail}))
    return 0


def measure_decode(engine, slots: int, prompt_len: int, rounds: int,
                   seed: int = 0, trace: str = "",
                   dispatch_depth: int = 0, traced: bool = True) -> dict:
    """Fill ``slots`` slots of the idle, unstarted ``engine`` with
    ``prompt_len``-token greedy prompts, run an admitting step and a warm
    round, time ``rounds`` decode rounds with the host clock (from the
    first dispatch until the last round's tokens are delivered), then,
    when ``traced``, trace one more round and attribute its device time
    by kernel (no device fields otherwise). The serve loop's
    step is driven on this thread; with ``dispatch_depth`` (default: the
    engine's) above 1 the harvest worker runs beside it and up to that
    many rounds are in flight, with 1 each round is read back on this
    thread. The engine's
    ``max_output_length`` must cover ``(rounds + 3) * steps_per_round +
    1`` tokens."""
    from ..engine import SamplingParams
    from ..engine.scheduler import TokenBudgetScheduler
    from ..models import llama

    cuda = engine.device.type == "cuda"
    steps_per_round = engine.cfg.steps_per_round
    depth = dispatch_depth or engine.cfg.dispatch_depth

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def drive(n_rounds: int) -> float:
        """Dispatch ``n_rounds`` decode rounds through the serve loop's
        step and return once every one is harvested; returns the seconds
        spent inside the steps (the serve thread's own work)."""
        target = engine.stats["decode_rounds"] + n_rounds
        deadline = time.monotonic() + 600
        in_step = 0.0
        while (engine.stats["decode_rounds"] < target
               or engine.stats["dispatch_queue_depth"]):
            if time.monotonic() > deadline:
                raise RuntimeError("decode rounds did not finish in 600 s")
            engine._wake.clear()
            did = False
            if engine.stats["decode_rounds"] < target:
                t = time.perf_counter()
                did = engine._step()
                in_step += time.perf_counter() - t
            if not did:
                engine._wake.wait(0.05)
        engine._alive()
        return in_step

    n_new = (rounds + 3) * steps_per_round + 1
    rng = np.random.default_rng(seed)
    streams = [engine.submit([1] + list(rng.integers(3, 259, prompt_len - 1)),
                             SamplingParams(max_tokens=n_new, top_k=1,
                                            ignore_eos=True))
               for _ in range(slots)]
    # One step admits every slot (each prompt one bucket: the admission
    # plans under a budget that holds them all, so no slot decodes while
    # another is still admitted); the second is a warm decode-only round.
    page = engine.cfg.page_size
    planner = engine._sched
    engine._sched = TokenBudgetScheduler(
        planner.cost, page_size=page, steps_per_round=steps_per_round,
        round_budget_tokens=slots * -(-prompt_len // page) * page,
        max_one_shot_tokens=engine._buckets[-1])
    try:
        engine._step()
    finally:
        engine._sched = planner
    engine._step()
    if len(engine._armed()) != slots:
        raise RuntimeError(f"{len(engine._armed())} of {slots} slots armed")
    if depth > 1:
        engine._start_harvest(depth)
    with engine._stats_lock:      # the peak of this measurement only
        engine._stats["dispatch_depth_peak"] = 0
    steps0 = engine.stats["decode_steps"]
    h0 = engine.stats
    sync()
    t0 = time.perf_counter()
    in_step = drive(rounds)
    sync()
    wall = time.perf_counter() - t0
    h1 = engine.stats
    steps = engine.stats["decode_steps"] - steps0
    step_ms = wall / steps * 1e3
    # Host work per step: the serve thread inside its steps (planning,
    # replays, copies; with depth 1 the harvest too), and the harvest's
    # wait for each round's copy and its token delivery.
    host = {"serve_ms_per_step": in_step * 1e3 / steps,
            **{f"{k}_per_step": (h1[k] - h0[k]) / steps
               for k in ("harvest_wait_ms", "harvest_emit_ms")}}
    out = {"card": _card(cuda), "cuda_graphs": engine._graphs_on,
           "dispatch_depth": depth,
           "dispatch_depth_peak": engine.stats["dispatch_depth_peak"],
           "context": prompt_len + (rounds + 2) * steps_per_round,
           "step_ms": step_ms, **host}
    if traced:
        out.update(_trace_round(engine, drive, sync, steps0 + steps, trace))
        out["device_busy_share"] = out["device_busy_ms_per_step"] / step_ms
    for s in streams:      # leave the engine idle for its next user
        s.cancel()
    deadline = time.monotonic() + 60
    while engine._slots and time.monotonic() < deadline:
        engine._wake.clear()
        if not engine._step():
            engine._wake.wait(0.05)
    engine._stop_harvest()
    if engine._slots:
        raise RuntimeError("cancelled requests still hold slots")
    param_bytes = sum(t.numel() * t.element_size()
                      for t in llama.param_tensors(engine.params))
    # Weights are read once per step (the embedding table only for the B
    # rows looked up); each slot's live KV once.
    step_bytes = (param_bytes - engine.params["embed"].numel()
                  * engine.params["embed"].element_size()
                  + slots * out["context"] * engine._kv_bytes_per_token())
    out["step_bytes"] = step_bytes
    out["step_bound_ms"] = step_bytes / HBM_BYTES_PER_S * 1e3
    return out


def measure_arrival_ttft(engine, dispatch_depth: int, decoders: int = 4,
                         context: int = 512, prompt_len: int = 128,
                         arrivals: int = 6, max_delay_s: float = 0.06,
                         seed: int = 0) -> dict:
    """The time to first token of ``arrivals`` ``prompt_len``-token
    requests that arrive, one after another at random moments, while
    ``decoders`` greedy streams with ``context``-token prompts decode, at
    ``dispatch_depth`` (untraced). The serve loop's step is driven on
    this thread as the serve thread drives it; the requests are
    submitted from another. Each prompt is new random ids (no prefix
    hit). ``engine`` is idle and not started; its ``max_output_length``
    must outlast the arrivals (each waits up to ``max_delay_s``, then for
    its first token)."""
    from ..engine import SamplingParams

    rng = np.random.default_rng(seed)
    greedy = dict(top_k=1, ignore_eos=True)
    n_out = engine.cfg.max_output_length
    streams = [engine.submit([1] + list(rng.integers(3, 259, context - 1)),
                             SamplingParams(max_tokens=n_out, **greedy))
               for _ in range(decoders)]
    prompts = [[1] + list(rng.integers(3, 259, prompt_len - 1))
               for _ in range(arrivals)]
    delays = rng.uniform(0.0, max_delay_s, arrivals)
    deadline = time.monotonic() + 600

    def loop(until) -> None:
        while not until():
            if time.monotonic() > deadline:
                raise RuntimeError("the arrival measurement ran out of time")
            engine._wake.clear()
            if not engine._step():
                engine._wake.wait(0.05)
        engine._alive()

    loop(lambda: min(len(s.token_ids) for s in streams) >= 2)
    if dispatch_depth > 1:
        engine._start_harvest(dispatch_depth)
    arrived, done = [], threading.Event()

    def submitter():
        try:
            for ids, delay in zip(prompts, delays):
                time.sleep(delay)
                s = engine.submit(ids, SamplingParams(max_tokens=1, **greedy))
                arrived.append(s)
                while (s.first_token_time is None and s.finish_reason is None
                       and time.monotonic() < deadline):
                    time.sleep(0.0005)
        finally:
            done.set()

    worker = threading.Thread(target=submitter, daemon=True)
    worker.start()
    loop(done.is_set)
    worker.join()
    ttft = [s.ttft_ms for s in arrived]
    short = min(len(s.token_ids) for s in streams) >= n_out
    for s in streams:
        s.cancel()
    loop(lambda: not engine._slots)
    engine._stop_harvest()
    if len(ttft) != arrivals or None in ttft or short:
        raise RuntimeError("an arrival got no first token, or a decoding "
                           "stream ended before the arrivals did")
    return {"dispatch_depth": dispatch_depth, "decoders": decoders,
            "context": context, "prompt_len": prompt_len, "ttft_ms": ttft}


def _trace_round(engine, drive, sync, steps0: int, trace: str) -> dict:
    """Trace one more decode round of ``measure_decode`` and attribute its
    device time by kernel."""
    from ..ops.int4_matmul import int4_matmul
    from ..ops.paged_attention import paged_attention_decode

    paged_attention_decode.launches = 0
    paged_attention_decode.int8_launches = 0
    int4_matmul.launches = 0
    int4_matmul.launches_by_path = dict.fromkeys(
        int4_matmul.launches_by_path, 0)
    with _profile() as prof:
        t1 = time.perf_counter()
        drive(1)
        sync()
        traced_s = time.perf_counter() - t1
    traced_steps = engine.stats["decode_steps"] - steps0
    launches = {"paged_attention": paged_attention_decode.launches
                + paged_attention_decode.int8_launches,
                "int4_matmul": int4_matmul.launches}
    int4_by_path = dict(int4_matmul.launches_by_path)
    if trace:
        prof.export_chrome_trace(trace)
    events = _device_events(prof)
    kernels = _kernel_times(events)
    device_us = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    ours_us = _ours_us(kernels)
    # The profiler slows an eager host several-fold, so the traced round's
    # own busy share understates the device's; its busy device time per
    # step over the untraced step time is the estimate that holds for
    # serving.
    n = max(traced_steps, 1)
    busy_ms_step = _busy_us(events) / 1e3 / n
    return {
        "traced_round_ms": traced_s * 1e3, "traced_steps": traced_steps,
        "device_ms_per_step": device_us / 1e3 / n,
        "device_busy_ms_per_step": busy_ms_step,
        "kernels_per_step": sum(c for _, c in kernels.values()) / n,
        "kernel_ms_per_step": {k: us / 1e3 / n for k, us in ours_us.items()},
        "kernel_launches": launches,
        "int4_launches_by_path": int4_by_path,
        "top_device_ops": [{"name": name[:120], "ms": us / 1e3, "count": n}
                           for name, (us, n) in top]}


if __name__ == "__main__":
    sys.exit(main())
