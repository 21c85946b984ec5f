"""Where a decode step's time goes, on the card.

    python -m generativeaiexamples_tpu_torch.tools.profile_decode \\
        [--model llama-2-7b-chat] [--slots 8] [--prompt-len 512] \\
        [--steps 8] [--rounds 4] [--trace decode_trace.json]

Builds the port's engine (random bf16 weights from ``--seed``), fills
every slot with a ``--prompt-len`` prompt, and drives the serve loop's
``_step`` on this thread: after a warm-up round it times ``--rounds``
decode rounds of ``--steps`` steps with the host clock (each round ends
in a device->host read of its tokens), then traces one more round with
``torch.profiler`` and attributes its device time by kernel. Prints the
step time beside its weight-and-KV byte bound, the device's busy share
of the traced round, and the top kernels; the last line is one JSON
object. Runs on the card; ``--device cpu`` rehearses the tool itself
at a small ``--model`` (its times are then CPU times, not the card's).
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


def main(argv=None) -> int:
    from ..engine import EngineConfig, SamplingParams
    from ..ops.paged_attention import paged_attention_decode
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
    args = ap.parse_args(argv)

    n_new = (args.rounds + 3) * args.steps + 1
    ecfg = EngineConfig(max_slots=args.slots,
                        max_input_length=max(args.prompt_len, 128),
                        max_output_length=n_new, steps_per_round=args.steps,
                        kv_pool_tokens=None)
    engine, model_name = build_services(args.model, engine_cfg=ecfg,
                                  seed=args.seed, device=args.device)
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        engine._step()
        sync()
        traced_s = time.perf_counter() - t1
    traced_steps = engine.stats["decode_steps"] - steps0 - steps
    launches = paged_attention_decode.launches
    if args.trace:
        prof.export_chrome_trace(args.trace)
    kernels = _kernel_times(prof)
    device_us = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    paged_us = sum(us for name, (us, _) in kernels.items()
                   if "paged_decode" in name)
    # The profiler slows the host several-fold, so the traced round's own
    # busy share understates the device's; its device time per step over
    # the untraced step time is the estimate that holds for serving.
    busy_ms_step = device_us / 1e3 / max(traced_steps, 1)

    param_bytes = sum(t.numel() * t.element_size() for t in
                      [engine.params["embed"], engine.params.get("lm_head"),
                       *engine.params["layers"].values()]
                      if t is not None)
    kv_token = (2 * mcfg.num_layers * mcfg.num_kv_heads * mcfg.head_dim
                * engine.params["embed"].element_size())
    ctx = args.prompt_len + (args.rounds + 2) * args.steps
    # Weights are read once per step (the embedding table only for the B
    # rows looked up); each slot's live KV once.
    step_bytes = (param_bytes - engine.params["embed"].numel()
                  * engine.params["embed"].element_size()
                  + args.slots * ctx * kv_token)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() if cuda else "cpu"
    engine.stop()

    print(f"{model_name} on {card}: {args.slots} slots, context ~{ctx} tokens, "
          f"{args.steps} steps per round")
    print(f"decode step {step_ms:.2f} ms (host clock over {steps} steps) vs "
          f"byte bound {bound_ms:.2f} ms ({step_bytes / 1e9:.2f} GB/step); "
          f"{args.slots * 1e3 / step_ms:.1f} tok/s aggregate")
    print(f"traced round: {traced_s * 1e3:.1f} ms wall (profiler on), "
          f"device {device_us / 1e3:.1f} ms over {traced_steps} steps = "
          f"{busy_ms_step:.2f} ms/step, busy share of an untraced step "
          f"{busy_ms_step / step_ms:.1%}; paged kernel "
          f"{paged_us / 1e3 / max(traced_steps, 1):.2f} ms/step over "
          f"{launches} launches")
    for name, (us, n) in top:
        print(f"  {us / 1e3:9.2f} ms  {n:6d}x  {name[:90]}")
    print(json.dumps({
        "model": model_name, "card": card, "slots": args.slots, "context": ctx,
        "steps_per_round": args.steps, "step_ms": step_ms,
        "step_bound_ms": bound_ms, "traced_round_ms": traced_s * 1e3,
        "traced_steps": traced_steps,
        "device_ms_per_step": busy_ms_step,
        "device_busy_share": busy_ms_step / step_ms,
        "paged_kernel_ms_per_step": paged_us / 1e3 / max(traced_steps, 1),
        "paged_kernel_launches": launches,
        "top_device_ops": [{"name": name[:120], "ms": us / 1e3, "count": n}
                           for name, (us, n) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
