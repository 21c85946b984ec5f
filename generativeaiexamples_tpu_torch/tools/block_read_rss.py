"""What a tensor-parallel rank's read of one block costs in host memory.

    python -m generativeaiexamples_tpu_torch.tools.block_read_rss \\
        [--tp 4] [--rank 1]

Writes two tensors of Llama-2-70B's shapes to a safetensors file in a
temporary directory: a column-parallel GPTQ ``qweight`` (1024, 28672)
int32 and a row-parallel weight in HF layout (8192, 28672) bf16. For
each, a rank's block of every row (columns ``[rank, rank + 1) / tp``) is
read once through the memory map (``safetensors.iter_file``, the block
made contiguous) and once span by span (``safetensors.iter_stored``),
and the growth of this process's resident memory (``/proc/self/statm``)
is printed beside the block's bytes and the whole tensor's. Host only;
the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..models.safetensors import iter_file, iter_stored, save_file

SHAPES = {"qweight": ((1024, 28672), torch.int32),
          "w_down": ((8192, 28672), torch.bfloat16)}


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _read_block(read, path: str, name: str, tp: int, rank: int) -> dict:
    """The resident growth of one read of ``name``'s block, with every
    map and buffer of the read let go before it returns."""
    before = _rss()
    t = next(t for key, t in read(path) if key == name)
    n = t.shape[1] // tp
    block = t[:, rank * n:(rank + 1) * n].contiguous()
    return {"growth": _rss() - before,
            "block_bytes": block.numel() * block.element_size(),
            "tensor_bytes": t.numel() * t.dtype.itemsize}


def measure(path: str, name: str, tp: int, rank: int) -> dict:
    mapped = _read_block(iter_file, path, name, tp, rank)
    spans = _read_block(iter_stored, path, name, tp, rank)
    return {"block_bytes": mapped["block_bytes"],
            "tensor_bytes": mapped["tensor_bytes"],
            "memory_map": mapped["growth"], "span_reads": spans["growth"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--rank", type=int, default=1)
    args = ap.parse_args(argv)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "blocks.safetensors")
        save_file({k: torch.ones(s, dtype=dt) for k, (s, dt)
                   in SHAPES.items()}, path)
        for name in SHAPES:
            res[name] = measure(path, name, args.tp, args.rank)
            r = res[name]
            print(f"{name}: block {r['block_bytes']} B of "
                  f"{r['tensor_bytes']} B; resident growth through the "
                  f"memory map {r['memory_map']} B, span by span "
                  f"{r['span_reads']} B")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
