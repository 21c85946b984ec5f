"""Where a decode step's (or a prefill's) time goes, on the card.

    python -m generativeaiexamples_tpu_torch.tools.profile_decode \\
        [--model llama-2-7b-chat] [--slots 8] [--prompt-len 512] \\
        [--steps 8] [--rounds 4] [--trace decode_trace.json] \\
        [--quantization int4_awq] [--kv-quant int8] [--prefill BUCKET]

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


def _kernel_times(prof) -> dict[str, tuple[float, int]]:
    """Device activity of a trace by name: (microseconds, count). Only the
    device-side events count (kernels, copies, sets); the host operators
    that launched them would count the same time twice."""
    from torch.autograd import DeviceType
    out: dict[str, tuple[float, int]] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
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


def profile_prefill(args) -> int:
    """The ``--prefill BUCKET`` mode (see the module docstring)."""
    from ..engine import EngineConfig, SamplingParams
    from ..ops.int4_matmul import int4_matmul
    from ..serving.model_server import build_services

    bucket = args.prefill
    ecfg = EngineConfig(max_slots=1, max_input_length=bucket,
                        max_output_length=1, kv_pool_tokens=None,
                        kv_quant=args.kv_quant)
    if bucket not in ecfg.prefill_buckets:
        raise SystemExit(f"--prefill {bucket} is not a prefill bucket "
                         f"{ecfg.prefill_buckets}")
    engine, model_name = build_services(args.model, engine_cfg=ecfg,
                                        seed=args.seed, device=args.device,
                                        quantization=args.quantization)
    cuda = engine.device.type == "cuda"
    rng = np.random.default_rng(args.seed)

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
    wall = [one_prefill() for _ in range(args.rounds)]
    prefill_ms = sum(wall) / len(wall) * 1e3
    int4_matmul.launches = 0
    int4_matmul.launches_by_path = dict.fromkeys(
        int4_matmul.launches_by_path, 0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced_ms = one_prefill() * 1e3
    by_path = dict(int4_matmul.launches_by_path)
    if engine.stats["prefills"] - prefills0 != args.rounds + 1:
        raise RuntimeError("a prefill was not counted")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    kernels = _kernel_times(prof)
    device_us = sum(us for us, _ in kernels.values())
    int4_us = {p: sum(us for name, (us, _) in kernels.items() if sym in name)
               for p, sym in _INT4_PATHS.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    card = _card(cuda)
    engine.stop()

    mode = (f"{args.quantization or 'bf16'} weights, "
            f"{args.kv_quant or 'bf16'} KV")
    print(f"{model_name} [{mode}] on {card}: one prefill of {bucket} tokens")
    print(f"prefill {prefill_ms:.2f} ms (host clock, mean of {args.rounds}); "
          f"traced {traced_ms:.2f} ms (profiler on), device "
          f"{device_us / 1e3:.2f} ms = {device_us / 1e3 / prefill_ms:.1%} "
          f"of an untraced prefill")
    print(f"  int4_matmul: {sum(int4_us.values()) / 1e3:.2f} ms over "
          f"{int4_matmul.launches} launches; by path (ms) "
          f"{ {p: us / 1e3 for p, us in int4_us.items()} }, launches "
          f"{by_path}")
    for name, (us, n) in top:
        print(f"  {us / 1e3:9.2f} ms  {n:6d}x  {name[:90]}")
    print(json.dumps({
        "model": model_name, "quantization": args.quantization,
        "kv_quant": args.kv_quant, "card": card, "prefill_bucket": bucket,
        "prefill_ms": prefill_ms, "traced_prefill_ms": traced_ms,
        "device_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e3 / prefill_ms,
        "int4_ms_by_path": {p: us / 1e3 for p, us in int4_us.items()},
        "int4_launches_by_path": by_path,
        "top_device_ops": [{"name": name[:120], "ms": us / 1e3, "count": n}
                           for name, (us, n) in top]}))
    return 0


def main(argv=None) -> int:
    from ..engine import EngineConfig, SamplingParams
    from ..models import llama
    from ..ops.int4_matmul import int4_matmul
    from ..ops.paged_attention import paged_attention_decode
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
    args = ap.parse_args(argv)
    if args.prefill:
        return profile_prefill(args)

    n_new = (args.rounds + 3) * args.steps + 1
    ecfg = EngineConfig(max_slots=args.slots,
                        max_input_length=max(args.prompt_len, 128),
                        max_output_length=n_new, steps_per_round=args.steps,
                        kv_pool_tokens=None, kv_quant=args.kv_quant)
    engine, model_name = build_services(args.model, engine_cfg=ecfg,
                                        seed=args.seed, device=args.device,
                                        quantization=args.quantization)
    cuda = engine.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    mcfg = engine.model_cfg
    rng = np.random.default_rng(args.seed)
    for _ in range(args.slots):
        ids = [1] + list(rng.integers(3, 259, args.prompt_len - 1))
        engine.submit(ids, SamplingParams(max_tokens=n_new, top_k=1,
                                          ignore_eos=True))
    # First step admits every slot (prefill) and runs a round; the
    # second is a warm decode-only round.
    engine._step()
    engine._step()
    if engine.stats["active_slots"] != args.slots:
        raise RuntimeError(f"{engine.stats['active_slots']} of {args.slots} "
                           f"slots admitted")
    steps0 = engine.stats["decode_steps"]
    sync()
    t0 = time.perf_counter()
    for _ in range(args.rounds):
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
    if args.trace:
        prof.export_chrome_trace(args.trace)
    kernels = _kernel_times(prof)
    device_us = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    ours_us = _ours_us(kernels)
    # The profiler slows the host several-fold, so the traced round's own
    # busy share understates the device's; its device time per step over
    # the untraced step time is the estimate that holds for serving.
    busy_ms_step = device_us / 1e3 / max(traced_steps, 1)

    param_bytes = sum(t.numel() * t.element_size()
                      for t in llama.param_tensors(engine.params))
    kv_token = engine._kv_bytes_per_token()
    ctx = args.prompt_len + (args.rounds + 2) * args.steps
    # Weights are read once per step (the embedding table only for the B
    # rows looked up); each slot's live KV once.
    step_bytes = (param_bytes - engine.params["embed"].numel()
                  * engine.params["embed"].element_size()
                  + args.slots * ctx * kv_token)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    card = _card(cuda)
    engine.stop()

    mode = (f"{args.quantization or 'bf16'} weights, "
            f"{args.kv_quant or 'bf16'} KV")
    print(f"{model_name} [{mode}] on {card}: {args.slots} slots, context "
          f"~{ctx} tokens, {args.steps} steps per round")
    print(f"decode step {step_ms:.2f} ms (host clock over {steps} steps) vs "
          f"byte bound {bound_ms:.2f} ms ({step_bytes / 1e9:.2f} GB/step); "
          f"{args.slots * 1e3 / step_ms:.1f} tok/s aggregate")
    print(f"traced round: {traced_s * 1e3:.1f} ms wall (profiler on), "
          f"device {device_us / 1e3:.1f} ms over {traced_steps} steps = "
          f"{busy_ms_step:.2f} ms/step, busy share of an untraced step "
          f"{busy_ms_step / step_ms:.1%}")
    for k, us in ours_us.items():
        print(f"  {k}: {us / 1e3 / max(traced_steps, 1):.2f} ms/step over "
              f"{launches[k]} launches"
              + (f" {int4_by_path}" if k == "int4_matmul" else ""))
    for name, (us, n) in top:
        print(f"  {us / 1e3:9.2f} ms  {n:6d}x  {name[:90]}")
    print(json.dumps({
        "model": model_name, "quantization": args.quantization,
        "kv_quant": args.kv_quant, "card": card, "slots": args.slots,
        "context": ctx,
        "steps_per_round": args.steps, "step_ms": step_ms,
        "step_bound_ms": bound_ms, "traced_round_ms": traced_s * 1e3,
        "traced_steps": traced_steps,
        "device_ms_per_step": busy_ms_step,
        "device_busy_share": busy_ms_step / step_ms,
        "kernel_ms_per_step": {k: us / 1e3 / max(traced_steps, 1)
                               for k, us in ours_us.items()},
        "kernel_launches": launches,
        "int4_launches_by_path": int4_by_path,
        "top_device_ops": [{"name": name[:120], "ms": us / 1e3, "count": n}
                           for name, (us, n) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
