"""NeMo ``.nemo`` checkpoint import (a port of the reference's
``models/import_nemo.py``).

A ``.nemo`` file is a tar archive holding ``model_config.yaml`` and
``model_weights.ckpt`` (a torch state dict in megatron naming). The
config is read for its layer count, which must match the target config;
the state dict is read straight from the archive member (no extraction)
with ``torch.load(weights_only=True)`` and mapped onto the port's tree,
each leaf allocated once on the device in the engine's dtype. Megatron's
two fusions are undone:

- ``self_attention.query_key_value.weight``: per KV-head group the rows
  [q x g, k, v], de-interleaved into wq/wk/wv (GQA-aware);
- ``mlp.dense_h_to_4h.weight``: [gate; up] rows for swiglu, split; taken
  whole as ``w_up`` for GPT-Next's squared-ReLU MLP.

GPT-Next checkpoints carry layernorm1p offsets (``*_layernorm.bias``)
and, where the config says, projection biases. NeMo's rotary embedding
uses HF's rotate-half layout, so no RoPE permutation applies.

The config is read by ``read_flat_yaml``, a reader of the top-level
``key: scalar`` lines that the importer checks, not by PyYAML: PyYAML is
not guaranteed to be installed where the port runs, and its YAML 1.1
reads ``1e-5`` as a string, so the geometry would depend on the machine.
"""

from __future__ import annotations

import os
import tarfile
from typing import Any, Union

import torch

from ..utils.device import resolve_device
from ..utils.errors import ConfigError, ModelLoadError
from .configs import LlamaConfig
from .convert import _expected_shapes, layer_keys
from .llama import Params

_PREFIX = "model.language_model."


def find_nemo(path: str) -> str:
    """The ``.nemo`` archive at ``path`` (a file, or the first one in a
    directory)."""
    if os.path.isfile(path) and path.endswith(".nemo"):
        return path
    if os.path.isdir(path):
        for n in sorted(os.listdir(path)):
            if n.endswith(".nemo"):
                return os.path.join(path, n)
    raise ModelLoadError(f"no .nemo archive at {path}")


def _scalar(text: str) -> Any:
    """A YAML plain or quoted scalar: null, bool, int, float or string."""
    text = text.strip()
    if not text or text in ("~", "null", "Null", "NULL"):
        return None
    if text[0] in "'\"" and text[-1] == text[0] and len(text) >= 2:
        return text[1:-1]
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def read_flat_yaml(text: str) -> dict:
    """The top-level ``key: scalar`` entries of a YAML document (nested
    blocks and lists are skipped; comments dropped): the scalar keys the
    importer checks. Numbers read as YAML 1.2 does (``1e-5`` is a
    float)."""
    out: dict = {}
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line[0] in " \t-":
            continue                      # nested block or list item
        key, sep, value = line.partition(":")
        if not sep:
            continue
        value = value.split(" #", 1)[0]
        if value.strip() in ("", "|", ">"):
            continue                      # a nested block starts here
        out[key.strip()] = _scalar(value)
    return out


def _members(tar: tarfile.TarFile, nemo_path: str) -> tuple[str, str]:
    names = tar.getnames()
    cfg_name = next((n for n in names
                     if n.endswith("model_config.yaml")), None)
    ckpt_name = next((n for n in names
                      if n.endswith(("model_weights.ckpt",
                                     "model_weights.pt"))), None)
    if cfg_name is None or ckpt_name is None:
        raise ModelLoadError(
            f"{nemo_path}: expected model_config.yaml + "
            f"model_weights.ckpt in archive (found {names[:8]})")
    return cfg_name, ckpt_name


def read_archive_config(nemo_path: str) -> dict:
    """model_config.yaml's mapping, without reading the weights."""
    with tarfile.open(nemo_path) as tar:
        cfg_name, _ = _members(tar, nemo_path)
        with tar.extractfile(cfg_name) as f:  # type: ignore[union-attr]
            return read_flat_yaml(f.read().decode("utf-8"))


def read_archive(nemo_path: str) -> tuple[dict, dict[str, torch.Tensor]]:
    """(model_config.yaml's mapping, the state dict on the CPU)."""
    with tarfile.open(nemo_path) as tar:
        cfg_name, ckpt_name = _members(tar, nemo_path)
        with tar.extractfile(cfg_name) as f:  # type: ignore[union-attr]
            config = read_flat_yaml(f.read().decode("utf-8"))
        with tar.extractfile(ckpt_name) as f:  # type: ignore[union-attr]
            state = torch.load(f, map_location="cpu", weights_only=True)
    return config, state


def _split_qkv(fused: torch.Tensor, cfg: LlamaConfig
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Megatron fused QKV (rows [q x g, k, v] per KV group) -> q, k, v in
    the port's (in, out) orientation."""
    D = fused.shape[1]
    hd, KV = cfg.head_dim, cfg.num_kv_heads
    g = cfg.num_heads // KV
    if fused.shape[0] != KV * (g + 2) * hd:
        raise ModelLoadError(f"query_key_value has {fused.shape[0]} rows; "
                             f"the config needs {KV * (g + 2) * hd}")
    grouped = fused.reshape(KV, (g + 2) * hd, D)
    q = grouped[:, :g * hd].reshape(KV * g * hd, D)
    k = grouped[:, g * hd:(g + 1) * hd].reshape(KV * hd, D)
    v = grouped[:, (g + 1) * hd:].reshape(KV * hd, D)
    return q.T, k.T, v.T


def load_nemo_checkpoint(path: str, cfg: LlamaConfig,
                         dtype: torch.dtype = torch.bfloat16,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Params:
    """A ``.nemo`` archive (or a directory holding one) as the port's
    parameter tree on ``device`` in ``dtype``. A ``num_layers`` in
    ``model_config.yaml`` other than the config's, a missing tensor or a
    shape the config does not give raise ``ModelLoadError``."""
    if cfg.num_experts:
        # The reference's NeMo importer is dense-only too.
        raise ConfigError(f"{path}: a mixture-of-experts geometry "
                          f"({cfg.num_experts} experts) has no NeMo "
                          f"import; load an HF checkpoint")
    nemo_path = find_nemo(path)
    config, tensors = read_archive(nemo_path)
    declared = config.get("num_layers")
    if declared is not None and int(declared) != cfg.num_layers:
        raise ModelLoadError(
            f"{nemo_path}: model_config.yaml num_layers={declared} but "
            f"target config has {cfg.num_layers}")
    dev = resolve_device(device)

    def get(name: str) -> torch.Tensor:
        for key in (_PREFIX + name, "model." + name, name):
            if key in tensors:
                return tensors[key]
        raise ModelLoadError(f"{nemo_path}: missing tensor {name!r}")

    shapes = _expected_shapes(cfg)
    out: dict[str, torch.Tensor] = {}

    def put(flat: str, idx, t: torch.Tensor) -> None:
        want = shapes[flat][1:] if idx is not None else shapes[flat]
        if tuple(t.shape) != want:
            raise ModelLoadError(f"{nemo_path}: {flat} gets shape "
                                 f"{tuple(t.shape)}, the config needs {want}")
        if flat not in out:
            out[flat] = torch.empty(shapes[flat], dtype=dtype, device=dev)
        (out[flat] if idx is None else out[flat][idx]).copy_(t.to(dev))

    F = cfg.intermediate_size
    gptnext = cfg.mlp == "squared_relu"
    for i in range(cfg.num_layers):
        base = f"encoder.layers.{i}."
        put("layers/attn_norm", i, get(base + "input_layernorm.weight"))
        put("layers/mlp_norm", i,
            get(base + "post_attention_layernorm.weight"))
        if cfg.norm == "layernorm1p":
            put("layers/attn_norm_b", i, get(base + "input_layernorm.bias"))
            put("layers/mlp_norm_b", i,
                get(base + "post_attention_layernorm.bias"))
        q, k, v = _split_qkv(
            get(base + "self_attention.query_key_value.weight"), cfg)
        put("layers/wq", i, q)
        put("layers/wk", i, k)
        put("layers/wv", i, v)
        put("layers/wo", i, get(base + "self_attention.dense.weight").T)
        if cfg.attn_bias:
            bq, bk, bv = _split_qkv(
                get(base + "self_attention.query_key_value.bias")[:, None],
                cfg)
            put("layers/bq", i, bq[0])
            put("layers/bk", i, bk[0])
            put("layers/bv", i, bv[0])
            put("layers/bo", i, get(base + "self_attention.dense.bias"))
        fused_mlp = get(base + "mlp.dense_h_to_4h.weight")
        want_rows, kind = (F, "squared-relu") if gptnext else (
            2 * F, "swiglu-fused")
        if fused_mlp.shape[0] != want_rows:
            raise ModelLoadError(
                f"{nemo_path}: expected {kind} dense_h_to_4h with "
                f"{want_rows} rows, got {fused_mlp.shape[0]}")
        if gptnext:
            put("layers/w_up", i, fused_mlp.T)
        else:
            put("layers/w_gate", i, fused_mlp[:F].T)
            put("layers/w_up", i, fused_mlp[F:].T)
        put("layers/w_down", i, get(base + "mlp.dense_4h_to_h.weight").T)
        if cfg.mlp_bias and gptnext:
            put("layers/b_up", i, get(base + "mlp.dense_h_to_4h.bias"))
            put("layers/b_down", i, get(base + "mlp.dense_4h_to_h.bias"))
    put("embed", None, get("embedding.word_embeddings.weight"))
    put("final_norm", None, get("encoder.final_layernorm.weight"))
    if cfg.norm == "layernorm1p":
        put("final_norm_b", None, get("encoder.final_layernorm.bias"))
    if "lm_head" in shapes:
        put("lm_head", None, get("output_layer.weight").T)
    del tensors
    params: Params = {
        "embed": out["embed"],
        "layers": {k: out[f"layers/{k}"] for k in layer_keys(cfg)},
        "final_norm": out["final_norm"],
    }
    for name in ("final_norm_b", "lm_head"):
        if name in out:
            params[name] = out[name]
    return params
