"""Checkpoint import: HF safetensors, HF ``pytorch_model*.bin`` and Meta
``consolidated.*.pth`` directories -> the port's parameter tree.

A port of the reference's ``models/import_hf.py``. The names, the
transposes (every projection stored input-major, ``(D, out)``) and Meta's
RoPE row order are the reference's. Where the weights go differs: the
reference widens every tensor to a float32 numpy array and stacks the
layers on the host; here each leaf is allocated once on the target device
in the engine's dtype, and each checkpoint tensor is copied there as it
is read (its raw bytes to the device, then the transpose and the cast
there), so host memory holds about one tensor at a time (a 7B checkpoint
would take ~27 GB of float32 host arrays the other way).

Quantized (GPTQ, AWQ) checkpoints go to ``models/import_quantized.py``
and NeMo archives to ``models/import_nemo.py``, as the reference's
``load_checkpoint`` sends them; a directory with no recognized files
raises ``UnsupportedFormatError``. The format is read with the port's own
safetensors reader (``models/safetensors.py``); no ``safetensors`` or
``transformers`` package is needed. HF and Meta names are llama-2's, and
HF's also Mixtral's (``block_sparse_moe.gate`` -> ``router``,
``block_sparse_moe.experts.{e}.w1/w3/w2`` -> the ``w_gate``/``w_up``/
``w_down`` expert stacks); a GPT-Next checkpoint comes as a ``.nemo``
archive.
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import Any, Callable, Iterator, Optional, Union

import torch

from ..utils.device import resolve_device
from ..utils.errors import ConfigError, ModelLoadError, UnsupportedFormatError
from . import llama
from .configs import LlamaConfig
from .convert import _expected_shapes, layer_keys
from .safetensors import iter_file, tensor_names

_HF_LAYER_KEYS = {
    "input_layernorm.weight": ("attn_norm", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}

# Meta/fairscale names (consolidated.*.pth): (leaf, transform). "q"/"k"
# rows also need the interleaved -> half-split RoPE permutation of
# ``_unpermute_rope`` to match ``ops/rope.py``'s HF convention.
_META_LAYER_KEYS = {
    "attention_norm.weight": ("attn_norm", "plain"),
    "ffn_norm.weight": ("mlp_norm", "plain"),
    "attention.wq.weight": ("wq", "q"),
    "attention.wk.weight": ("wk", "k"),
    "attention.wv.weight": ("wv", "T"),
    "attention.wo.weight": ("wo", "T"),
    "feed_forward.w1.weight": ("w_gate", "T"),
    "feed_forward.w2.weight": ("w_down", "T"),
    "feed_forward.w3.weight": ("w_up", "T"),
}

# Mixtral's router and expert tensors (``block_sparse_moe.*``): w1 is the
# gate, w3 the up and w2 the down projection, stacked [layer][expert].
_HF_MOE_GATE = "block_sparse_moe.gate.weight"
_MOE_EXPERT_RE = re.compile(
    r"block_sparse_moe\.experts\.(\d+)\.w([123])\.weight$")
_MOE_W_TO_NAME = {"1": "w_gate", "3": "w_up", "2": "w_down"}

def _unpermute_rope(w: torch.Tensor, n_heads: int,
                    head_dim: int) -> torch.Tensor:
    """Meta stores q/k rows in interleaved RoPE pair order; HF (and
    ``ops/rope.py``) uses the half-split layout. The permutation HF's
    ``convert_llama_weights_to_hf`` applies."""
    out_dim, in_dim = w.shape
    return (w.reshape(n_heads, head_dim // 2, 2, in_dim)
             .permute(0, 2, 1, 3)
             .reshape(out_dim, in_dim))


def sniff_quantized_format(path: str) -> str:
    """'gptq' | 'awq' | '' by tensor NAMES only, no tensor read (the
    reference's ``import_quantized.sniff_quantized_format``): safetensors
    names come from the header; ``.pt``/``.bin`` archives are zip files
    whose pickle carries the state-dict keys as raw strings."""
    if os.path.isdir(path):
        files = [os.path.join(path, n) for n in sorted(os.listdir(path))
                 if n.endswith((".safetensors", ".pt", ".bin"))]
    else:
        files = [path] if os.path.isfile(path) else []
    for f in files:
        try:
            if f.endswith(".safetensors"):
                for key in tensor_names(f):
                    if key.endswith(".qweight"):
                        return "gptq"
                    if key.endswith("weight_quantizer._amax"):
                        return "awq"
                continue
            with zipfile.ZipFile(f) as z:
                pkl = next((n for n in z.namelist()
                            if n.endswith("data.pkl")), None)
                if pkl is None:
                    continue
                blob = z.read(pkl)
            if b".qweight" in blob:
                return "gptq"
            if b"weight_quantizer._amax" in blob:
                return "awq"
        except Exception:  # noqa: BLE001 - unreadable: not ours to claim
            continue
    return ""


def detect_checkpoint_format(path: str) -> str:
    """Sniff a checkpoint directory by its files: 'safetensors',
    'pytorch_bin', 'meta_pth', 'nemo', 'gptq' or 'awq'."""
    if not os.path.isdir(path):
        raise ModelLoadError(f"checkpoint directory {path!r} does not exist")
    names = os.listdir(path)
    if any(n.endswith(".nemo") for n in names):
        return "nemo"
    if any(n.endswith((".safetensors", ".pt", ".bin")) for n in names):
        qfmt = sniff_quantized_format(path)
        if qfmt:
            return qfmt
    if any(n.endswith(".safetensors") for n in names):
        return "safetensors"
    if any(re.match(r"pytorch_model.*\.bin$", n) for n in names):
        return "pytorch_bin"
    if any(n.endswith((".pth", ".pt")) for n in names):
        return "meta_pth"
    raise UnsupportedFormatError(
        f"no recognized checkpoint files in {path}: {sorted(names)[:10]}")


def _iter_safetensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors"):
            yield from iter_file(os.path.join(path, fname))


def _iter_torch_bin(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    for fname in sorted(os.listdir(path)):
        if re.match(r"pytorch_model.*\.bin$", fname):
            sd = torch.load(os.path.join(path, fname), map_location="cpu",
                            weights_only=True, mmap=True)
            yield from sd.items()


# Fairscale TP shard axis per Meta tensor (None = replicated): the concat
# dims HF's convert_llama_weights_to_hf uses when merging consolidated
# shards. Column-parallel weights shard dim 0, row-parallel dim 1,
# ParallelEmbedding the embedding dim.
_META_SHARD_DIM = {
    "tok_embeddings.weight": 1,
    "output.weight": 0,
    "norm.weight": None,
    "attention_norm.weight": None,
    "ffn_norm.weight": None,
    "attention.wq.weight": 0,
    "attention.wk.weight": 0,
    "attention.wv.weight": 0,
    "attention.wo.weight": 1,
    "feed_forward.w1.weight": 0,
    "feed_forward.w2.weight": 1,
    "feed_forward.w3.weight": 0,
}


def _meta_shard_dim(key: str) -> Optional[int]:
    suffix = re.sub(r"^layers\.\d+\.", "", key)
    if suffix not in _META_SHARD_DIM:
        raise UnsupportedFormatError(
            f"unknown Meta checkpoint tensor {key!r}: cannot determine its "
            f"fairscale shard axis")
    return _META_SHARD_DIM[suffix]


def _iter_meta_pth(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Meta/fairscale checkpoints: merge the consolidated.*.pth TP shards
    (every shard holds the same names, split along per-tensor axes). The
    shards are memory-mapped, so only the tensor being merged is
    resident; a single-file checkpoint passes through."""
    files = sorted(f for f in os.listdir(path) if f.endswith((".pth", ".pt")))
    shards = [torch.load(os.path.join(path, f), map_location="cpu",
                         weights_only=True, mmap=True) for f in files]
    for key in shards[0]:
        if key == "rope.freqs":  # a precomputed buffer, not a weight
            continue
        parts = [s[key] for s in shards]
        dim = _meta_shard_dim(key) if len(parts) > 1 else None
        yield key, parts[0] if dim is None else torch.cat(parts, dim=dim)


# The formats read through ``params_from_named_tensors``, and the reader
# of each (GPTQ, AWQ and NeMo have importers of their own).
LOADABLE_FORMATS: dict[str, Callable[[str], Iterator[tuple[str, Any]]]] = {
    "safetensors": _iter_safetensors,
    "pytorch_bin": _iter_torch_bin,
    "meta_pth": _iter_meta_pth,
}


def _leaf_spec(key: str, cfg: LlamaConfig
               ) -> Optional[tuple[str, Union[None, int, tuple[int, int]],
                                   str]]:
    """(leaf, index, transform) for one checkpoint name, or None for a
    tensor that carries no weight (rotary buffers). The index is None for
    a top-level leaf, the layer for a layer leaf, and (layer, expert) for
    a Mixtral expert's matrix."""
    key = key.removeprefix("model.")
    if key in ("embed_tokens.weight", "tok_embeddings.weight"):
        return "embed", None, "plain"
    if key == "norm.weight":
        return "final_norm", None, "plain"
    if key in ("lm_head.weight", "output.weight"):
        return "lm_head", None, "T"
    m = re.match(r"layers\.(\d+)\.(.+)$", key)
    if not m:
        return None
    idx, rest = int(m.group(1)), m.group(2)
    if idx >= cfg.num_layers:
        raise ConfigError(f"{key}: layer {idx} is past the config's "
                          f"{cfg.num_layers} layers")
    if rest in _HF_LAYER_KEYS:
        name, transpose = _HF_LAYER_KEYS[rest]
        return name, idx, "T" if transpose else "plain"
    if rest in _META_LAYER_KEYS:
        name, kind = _META_LAYER_KEYS[rest]
        return name, idx, kind
    if rest.startswith("block_sparse_moe.") and not cfg.num_experts:
        raise ConfigError(f"{key}: a mixture-of-experts tensor, and the "
                          f"config has no experts")
    if rest == _HF_MOE_GATE:
        return "router", idx, "T"
    em = _MOE_EXPERT_RE.match(rest)
    if em:
        e = int(em.group(1))
        if e >= cfg.num_experts:
            raise ConfigError(f"{key}: expert {e} is past the config's "
                              f"{cfg.num_experts} experts")
        return _MOE_W_TO_NAME[em.group(2)], (idx, e), "T"
    if rest.startswith("block_sparse_moe."):
        raise ConfigError(f"{key}: an unknown mixture-of-experts tensor")
    return None


def params_from_named_tensors(
        tensors: Iterator[tuple[str, Any]], cfg: LlamaConfig,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda") -> llama.Params:
    """Assemble the port's parameter tree from HF- or Meta-named tensors
    (with or without a leading ``model.``). Every leaf is allocated on
    ``device`` in ``dtype`` up front, at the shape ``cfg`` gives it, and
    each tensor is moved to the device in its own dtype and then
    transposed and cast into its slot there. A tensor whose shape does
    not fit the config raises ``ConfigError``; a missing one
    ``ModelLoadError``."""
    llama.check_supported(cfg)
    dev = resolve_device(device)
    shapes = _expected_shapes(cfg)
    shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
    out: dict[str, torch.Tensor] = {}
    filled: dict[str, set] = {}
    for key, raw in tensors:
        spec = _leaf_spec(key, cfg)
        if spec is None:
            continue
        name, idx, kind = spec
        flat = name if idx is None else f"layers/{name}"
        if flat not in shapes or (isinstance(idx, tuple)
                                  != (len(shapes[flat]) == 4)):
            raise ConfigError(f"{key}: the config's "
                              f"{'MoE' if cfg.num_experts else cfg.mlp} "
                              f"MLP has no such {flat}")
        n_idx = 0 if idx is None else 1 if isinstance(idx, int) else 2
        want = shapes[flat][n_idx:]
        t = raw.detach().to(dev)
        if kind == "q":
            t = _unpermute_rope(t, cfg.num_heads, cfg.head_dim)
        elif kind == "k":
            t = _unpermute_rope(t, cfg.num_kv_heads, cfg.head_dim)
        if kind != "plain":
            t = t.T
        if tuple(t.shape) != want:
            raise ConfigError(f"{key}: shape {tuple(raw.shape)} does not "
                              f"give the {want} that {flat} takes for "
                              f"this config")
        if flat not in out:
            out[flat] = torch.empty(shapes[flat], dtype=dtype, device=dev)
        (out[flat] if idx is None else out[flat][idx]).copy_(t)
        filled.setdefault(flat, set()).add(idx)
        del t
    # A layer leaf needs every layer, an expert stack every (layer,
    # expert) pair.
    missing = [k for k in shapes if k != "lm_head" and not (
        k in filled and (not k.startswith("layers/")
                         or len(filled[k]) == cfg.num_layers * (
                             cfg.num_experts if len(shapes[k]) == 4
                             else 1)))]
    if "lm_head" not in out and not cfg.tie_word_embeddings:
        missing.append("lm_head")
    if missing:
        raise ModelLoadError(f"incomplete checkpoint: no (or not every "
                             f"layer's) {sorted(missing)}")
    params: llama.Params = {
        "embed": out["embed"],
        "layers": {k: out[f"layers/{k}"] for k in layer_keys(cfg)},
        "final_norm": out["final_norm"],
    }
    if "lm_head" in out:
        params["lm_head"] = out["lm_head"]
    return params


def load_checkpoint(path: str, cfg: LlamaConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Union[str, torch.device] = "cuda"
                    ) -> llama.Params:
    """Load a checkpoint directory (its format sniffed) onto ``device`` in
    ``dtype``: GPTQ and AWQ through ``import_quantized`` (group-wise int4
    leaves), a ``.nemo`` archive through ``import_nemo``, the rest by
    name through ``params_from_named_tensors``."""
    fmt = detect_checkpoint_format(path)
    if fmt in ("gptq", "awq"):
        from .import_quantized import load_quantized_checkpoint
        return load_quantized_checkpoint(path, cfg, dtype, device, fmt=fmt)
    if fmt == "nemo":
        from .import_nemo import load_nemo_checkpoint
        return load_nemo_checkpoint(path, cfg, dtype, device)
    return params_from_named_tensors(LOADABLE_FORMATS[fmt](path), cfg,
                                     dtype, device)


def params_from_hf_model(model: Any, cfg: LlamaConfig,
                         dtype: torch.dtype = torch.float32,
                         device: Union[str, torch.device] = "cuda"
                         ) -> llama.Params:
    """Convert an in-memory ``transformers`` Llama model."""
    return params_from_named_tensors(iter(model.state_dict().items()), cfg,
                                     dtype, device)
