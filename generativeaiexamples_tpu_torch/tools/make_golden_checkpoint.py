"""Train and export the golden-tiny checkpoint — port of the reference's
root ``tools/make_golden_checkpoint.py``.

Trains the ``golden-tiny`` geometry (32k sentencepiece vocabulary) on a
directory of markdown (the repository's ``docs/*.md``) with the port's
``training.make_train_step`` and ``torch.optim.AdamW`` (optax's adamw:
weight decay 1e-4), then exports an HF-format checkpoint (fp16
safetensors through the port's own writer, ``config.json``,
``tokenizer.model``) that ``models/import_hf.py`` and ``build_services(
model_path=...)`` load. The defaults are the reference's: 300 steps,
batch 16, sequence 128, lr 3e-3, batches drawn from numpy's generator
seeded 0. The weights start from ``llama.init_params`` seeded 0 on the
device (the reference's ``jax.random`` stream differs, so the two tools
train different, equally valid checkpoints).

Usage::

    python -m generativeaiexamples_tpu_torch.tools.make_golden_checkpoint \\
        --corpus docs --tokenizer tests/fixtures/golden_tiny/tokenizer.model \\
        [--steps 300] [--device cuda] [--out DIR]

``--tokenizer`` is golden-tiny's 32k sentencepiece model. Without
``--out`` it writes into a new temporary directory and prints its path.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

def load_corpus(tokenizer, docs_dir: str) -> np.ndarray:
    """Every ``*.md`` of ``docs_dir`` in name order, tokenized and
    concatenated."""
    ids: list[int] = []
    for path in sorted(glob.glob(os.path.join(docs_dir, "*.md"))):
        with open(path) as f:
            ids.extend(int(i) for i in tokenizer.encode(f.read()))
    return np.asarray(ids, np.int32)


def hf_tensors(params, cfg) -> dict[str, torch.Tensor]:
    """The parameter tree as HF llama tensors in fp16: the inverse of
    ``models/import_hf.py``'s key map (projections transposed back to
    (out, in), per-layer names)."""
    out: dict[str, torch.Tensor] = {}

    def put(name, t, transpose=False):
        t = t.detach().to(torch.float16)
        out[name] = (t.T if transpose else t).contiguous()

    put("model.embed_tokens.weight", params["embed"])
    put("model.norm.weight", params["final_norm"])
    put("lm_head.weight", params["lm_head"], transpose=True)
    lp = params["layers"]
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        put(pre + "input_layernorm.weight", lp["attn_norm"][i])
        put(pre + "post_attention_layernorm.weight", lp["mlp_norm"][i])
        put(pre + "self_attn.q_proj.weight", lp["wq"][i], transpose=True)
        put(pre + "self_attn.k_proj.weight", lp["wk"][i], transpose=True)
        put(pre + "self_attn.v_proj.weight", lp["wv"][i], transpose=True)
        put(pre + "self_attn.o_proj.weight", lp["wo"][i], transpose=True)
        put(pre + "mlp.gate_proj.weight", lp["w_gate"][i], transpose=True)
        put(pre + "mlp.up_proj.weight", lp["w_up"][i], transpose=True)
        put(pre + "mlp.down_proj.weight", lp["w_down"][i], transpose=True)
    return out


def export_hf(params, cfg, out_dir: str, tokenizer_path: str) -> None:
    """Write ``params`` as an HF llama checkpoint into ``out_dir``."""
    from ..models.safetensors import save_file

    os.makedirs(out_dir, exist_ok=True)
    save_file(hf_tensors(params, cfg),
              os.path.join(out_dir, "model.safetensors"), {"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "tie_word_embeddings": False,
            "_golden_tiny": True,
        }, f, indent=2)
    shutil.copy(tokenizer_path, os.path.join(out_dir, "tokenizer.model"))


def train(docs_dir: str, tokenizer_path: str, steps: int = 300,
          batch: int = 16, seq: int = 128, lr: float = 3e-3,
          device="cuda", seed: int = 0,
          log=print) -> tuple[dict, list[float]]:
    """Train golden-tiny from ``llama.init_params(seed)`` in float32 on
    ``device`` over ``docs_dir``'s markdown; returns (params, per-step
    losses)."""
    from ..models import llama
    from ..models.configs import get_model_config
    from ..models.tokenizer import get_tokenizer
    from ..training import make_train_step, trainable
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    cfg = get_model_config("golden-tiny")
    corpus = load_corpus(get_tokenizer(tokenizer_path), docs_dir)
    log(f"corpus: {len(corpus)} tokens")
    params = llama.init_params(cfg, seed, dtype=torch.float32, device=dev)
    optimizer = torch.optim.AdamW(trainable(params), lr=lr,
                                  weight_decay=1e-4)
    step = make_train_step(cfg, optimizer)
    rng = np.random.default_rng(seed)
    mask = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    losses = []
    for i in range(steps):
        starts = rng.integers(0, len(corpus) - seq - 1, size=batch)
        rows = np.stack([corpus[s:s + seq + 1] for s in starts])
        rows_t = torch.from_numpy(rows).to(dev)
        loss = step(params, {"tokens": rows_t[:, :-1],
                             "targets": rows_t[:, 1:], "mask": mask})
        losses.append(float(loss))
        if i % 50 == 0 or i == steps - 1:
            log(f"step {i}: loss {losses[-1]:.3f}")
    for t in trainable(params):
        t.requires_grad_(False)
    return params, losses


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m generativeaiexamples_tpu_torch.tools."
             "make_golden_checkpoint",
        description="train golden-tiny on a markdown corpus and export it")
    parser.add_argument("--corpus", required=True,
                        help="directory whose *.md files are the corpus")
    parser.add_argument("--tokenizer", required=True,
                        help="golden-tiny's sentencepiece tokenizer.model")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None,
                        help="output directory (default: a new temporary "
                             "one)")
    args = parser.parse_args(argv)

    from ..models.configs import get_model_config

    out = args.out or tempfile.mkdtemp(prefix="golden_tiny_")
    t0 = time.monotonic()
    params, losses = train(args.corpus, args.tokenizer, args.steps,
                           args.batch, args.seq, args.lr, args.device)
    export_hf(params, get_model_config("golden-tiny"), out, args.tokenizer)
    size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"exported {out} ({size / 1e6:.1f} MB), final loss "
          f"{losses[-1]:.3f} ({time.monotonic() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
