"""Where a decode step's (or a prefill's) time goes, on the card.

    python -m generativeaiexamples_tpu_torch.tools.profile_decode \\
        [--model llama-2-7b-chat] [--slots 8] [--prompt-len 512] \\
        [--steps 8] [--rounds 4] [--trace decode_trace.json] \\
        [--quantization int4_awq] [--kv-quant int8] [--prefill BUCKET] \\
        [--eager]

Builds the port's engine (random bf16 weights from ``--seed``, quantized
on the device with ``--quantization``, over a ``--kv-quant`` pool), fills
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

On the card the engine replays the rounds and admissions it captured as
CUDA graphs at construction, and the profiler attributes each replayed
kernel by name; ``--eager`` builds the engine with
``EngineConfig(cuda_graphs=False)``, which issues every operation from the
host as before. ``measure_decode`` and ``measure_prefill`` take an engine
that exists already (``chip_smoke.py`` calls them).

``--prefill BUCKET`` profiles one prefill instead: a prompt of BUCKET
tokens (a prefill bucket, so no row is padding) asking for one token,
admitted by one ``_step`` (prefill, KV insert, first token to the host).
After a warm-up it times ``--rounds`` such prefills with the host clock,
traces one more, and prints the prefill time, the device's busy share
of it and its device time by kernel (the int4 matmul by path).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate


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
                    trace: str = "") -> dict:
    """Host-clock mean of ``rounds`` admissions of a full ``bucket``
    prompt asking for one token (after a warm-up), and the device time
    of one more, traced, by kernel. ``engine`` is idle and not started;
    ``bucket`` is one of its prefill buckets."""
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
    launches0 = int4_matmul.launches
    int4_matmul.launches_by_path = dict.fromkeys(
        int4_matmul.launches_by_path, 0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
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


def profile_prefill(args) -> int:
    """The ``--prefill BUCKET`` mode (see the module docstring)."""
    from ..engine import EngineConfig
    from ..serving.model_server import build_services

    bucket = args.prefill
    ecfg = EngineConfig(max_slots=1, max_input_length=bucket,
                        max_output_length=1, kv_pool_tokens=None,
                        kv_quant=args.kv_quant, cuda_graphs=not args.eager)
    if bucket not in ecfg.prefill_buckets:
        raise SystemExit(f"--prefill {bucket} is not a prefill bucket "
                         f"{ecfg.prefill_buckets}")
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
    ap.add_argument("--eager", action="store_true",
                    help="build the engine with cuda_graphs=False: every "
                         "operation issued from the host")
    args = ap.parse_args(argv)
    if args.prefill:
        return profile_prefill(args)

    n_new = (args.rounds + 3) * args.steps + 1
    ecfg = EngineConfig(max_slots=args.slots,
                        max_input_length=max(args.prompt_len, 128),
                        max_output_length=n_new, steps_per_round=args.steps,
                        kv_pool_tokens=None, kv_quant=args.kv_quant,
                        cuda_graphs=not args.eager)
    engine, model_name = build_services(args.model, engine_cfg=ecfg,
                                        seed=args.seed, device=args.device,
                                        quantization=args.quantization)
    out = measure_decode(engine, args.slots, args.prompt_len, args.rounds,
                         args.seed, args.trace)
    engine.stop()

    mode = (f"{args.quantization or 'bf16'} weights, "
            f"{args.kv_quant or 'bf16'} KV, "
            f"{'graphs' if out['cuda_graphs'] else 'eager'}")
    print(f"{model_name} [{mode}] on {out['card']}: {args.slots} slots, "
          f"context ~{out['context']} tokens, {args.steps} steps per round")
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
    print(json.dumps({"model": model_name, "quantization": args.quantization,
                      "kv_quant": args.kv_quant, "slots": args.slots,
                      "steps_per_round": args.steps, **out}))
    return 0


def measure_decode(engine, slots: int, prompt_len: int, rounds: int,
                   seed: int = 0, trace: str = "") -> dict:
    """Fill ``slots`` slots of the idle, unstarted ``engine`` with
    ``prompt_len``-token greedy prompts, run an admitting step and a warm
    round, time ``rounds`` decode rounds with the host clock (each ends in
    its tokens' read-back), then trace one more round and attribute its
    device time by kernel. The engine's ``max_output_length`` must cover
    ``(rounds + 3) * steps_per_round + 1`` tokens."""
    from ..engine import SamplingParams
    from ..models import llama
    from ..ops.int4_matmul import int4_matmul
    from ..ops.paged_attention import paged_attention_decode

    cuda = engine.device.type == "cuda"
    steps_per_round = engine.cfg.steps_per_round

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n_new = (rounds + 3) * steps_per_round + 1
    rng = np.random.default_rng(seed)
    streams = [engine.submit([1] + list(rng.integers(3, 259, prompt_len - 1)),
                             SamplingParams(max_tokens=n_new, top_k=1,
                                            ignore_eos=True))
               for _ in range(slots)]
    # First step admits every slot (prefill) and runs a round; the
    # second is a warm decode-only round.
    engine._step()
    engine._step()
    if engine.stats["active_slots"] != slots:
        raise RuntimeError(f"{engine.stats['active_slots']} of {slots} "
                           f"slots admitted")
    steps0 = engine.stats["decode_steps"]
    sync()
    t0 = time.perf_counter()
    for _ in range(rounds):
        engine._step()
    sync()
    wall = time.perf_counter() - t0
    steps = engine.stats["decode_steps"] - steps0
    step_ms = wall / steps * 1e3

    paged_attention_decode.launches = 0
    paged_attention_decode.int8_launches = 0
    int4_matmul.launches = 0
    int4_matmul.launches_by_path = dict.fromkeys(
        int4_matmul.launches_by_path, 0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        engine._step()
        sync()
        traced_s = time.perf_counter() - t1
    traced_steps = engine.stats["decode_steps"] - steps0 - steps
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

    param_bytes = sum(t.numel() * t.element_size()
                      for t in llama.param_tensors(engine.params))
    kv_token = engine._kv_bytes_per_token()
    ctx = prompt_len + (rounds + 2) * steps_per_round
    # Weights are read once per step (the embedding table only for the B
    # rows looked up); each slot's live KV once.
    step_bytes = (param_bytes - engine.params["embed"].numel()
                  * engine.params["embed"].element_size()
                  + slots * ctx * kv_token)
    for s in streams:      # leave the engine idle for its next user
        s.cancel()
    for _ in range(3):
        engine._step()
    if engine._slots:
        raise RuntimeError("cancelled requests still hold slots")
    return {
        "card": _card(cuda), "cuda_graphs": engine._graphs_on,
        "context": ctx, "step_ms": step_ms,
        "step_bytes": step_bytes,
        "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
        "traced_round_ms": traced_s * 1e3, "traced_steps": traced_steps,
        "device_ms_per_step": device_us / 1e3 / n,
        "device_busy_ms_per_step": busy_ms_step,
        "device_busy_share": busy_ms_step / step_ms,
        "kernel_ms_per_step": {k: us / 1e3 / n for k, us in ours_us.items()},
        "kernel_launches": launches,
        "int4_launches_by_path": int4_by_path,
        "top_device_ops": [{"name": name[:120], "ms": us / 1e3, "count": n}
                           for name, (us, n) in top]}


if __name__ == "__main__":
    sys.exit(main())
