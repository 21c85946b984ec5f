"""CUDA graphs of the engine's device programs, and the launch counts they
carry.

The reference compiles one program per decode-round rung and one
prefill-and-insert program per admission, and donates the engine state to
both (``engine/engine.py`` ``make_round`` with its ``_round_fn`` cache, and
``prefill_insert``). The port keeps that state in static buffers which each
program updates in place; on the card ``Engine`` captures each program once
into a CUDA graph (``capture``) and afterwards only replays it. On the CPU
the same bodies run eagerly.

The kernels count their launches on the host, in their wrappers
(``ops/paged_attention.py``, ``ops/int4_matmul.py``). A replay runs no
wrapper, so each ``Program`` keeps the counts that its capture added and
adds them again on every replay; the capture itself launches nothing, so
its counts are taken back.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops.int4_matmul import int4_matmul
from ..ops.paged_attention import paged_attention_decode

LaunchCounts = dict[str, int]


def launch_counts() -> LaunchCounts:
    """The kernels' launch counters now: #1 and #2 by pool kind, #3 in
    all and by path (``int4_matmul/<path>``)."""
    out = {"paged_attention_decode": paged_attention_decode.launches,
           "paged_attention_decode_int8":
               paged_attention_decode.int8_launches,
           "int4_matmul": int4_matmul.launches}
    for path, n in int4_matmul.launches_by_path.items():
        out[f"int4_matmul/{path}"] = n
    return out


def set_launch_counts(counts: LaunchCounts) -> None:
    """Set the counters to ``counts`` (keys as ``launch_counts`` gives)."""
    paged_attention_decode.launches = counts["paged_attention_decode"]
    paged_attention_decode.int8_launches = counts[
        "paged_attention_decode_int8"]
    int4_matmul.launches = counts["int4_matmul"]
    for key, n in counts.items():
        if key.startswith("int4_matmul/"):
            int4_matmul.launches_by_path[key.split("/", 1)[1]] = n


def count_delta(before: LaunchCounts, after: LaunchCounts) -> LaunchCounts:
    """What a stretch of work added to each counter (zeros dropped)."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def add_launch_counts(delta: LaunchCounts, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters."""
    now = launch_counts()
    set_launch_counts({k: n + times * delta.get(k, 0)
                       for k, n in now.items()})


def round_rungs(steps_per_round: int) -> tuple[int, ...]:
    """Every step count ``rung_for`` can pick, largest first: the halving
    ladder from ``steps_per_round`` down to 1 (8 -> 8, 4, 2, 1; 6 -> 6, 3,
    1). One decode-round program is captured per rung."""
    rungs = [steps_per_round]
    while rungs[-1] > 1:
        rungs.append(rungs[-1] // 2)
    return tuple(rungs)


def rung_for(steps_per_round: int, need: int) -> int:
    """The round length for slots that need at most ``need`` more steps:
    halve ``steps_per_round`` while the half still covers ``need``."""
    steps = steps_per_round
    while steps // 2 >= need:
        steps //= 2
    return steps


class Program:
    """A captured device program: replaying it runs the graph on the
    current stream and adds the capture's launch counts."""

    def __init__(self, graph, launches: LaunchCounts):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        add_launch_counts(self.launches)


def capture(body: Callable[[], None], *, device: torch.device,
            stream: torch.cuda.Stream, pool,
            generators: Sequence[torch.Generator] = ()) -> Program:
    """Capture ``body`` (which updates static buffers in place and
    returns nothing) into a CUDA graph.

    ``body`` first runs once eagerly on ``stream``: state that PyTorch and
    the kernel wrappers make at first use and key by stream (cuBLAS's
    workspace, the int4 GEMV's split-K scratch) is then made there, in
    the ordinary allocator, and the capture, on the same stream, finds it.
    Those launches are real and count. The capture draws its memory from
    ``pool``, which every program of one engine shares: they replay one
    at a time on one stream, and none leaves a live tensor in the pool.
    ``generators`` are the generators ``body`` draws from; each is
    registered with the graph, so a replay continues its stream (and
    ``manual_seed`` before a replay restarts it). A failed capture
    raises."""
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        body()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = launch_counts()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        body()
    after = launch_counts()
    set_launch_counts(before)
    current.wait_stream(stream)
    return Program(graph, count_delta(before, after))
