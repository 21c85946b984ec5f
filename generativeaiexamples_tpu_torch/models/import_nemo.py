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

The weights are read lazily: ``open_archive`` parses the state dict's
pickle with a restricted unpickler (tensors, storages and ordered dicts
only, as ``weights_only`` allows) that records where each tensor's bytes
lie in the archive member's zip, and a tensor's storage is read when the
importer takes it. So the host holds one leaf at a time, and under a
mesh each leaf is cut to the rank's block before it goes to the device:
a rank's peak host memory is one leaf, its device memory its shard.

The config is read by ``read_flat_yaml``, a reader of the top-level
``key: scalar`` lines that the importer checks, not by PyYAML: PyYAML is
not guaranteed to be installed where the port runs, and its YAML 1.1
reads ``1e-5`` as a string, so the geometry would depend on the machine.
"""

from __future__ import annotations

import collections
import contextlib
import os
import pickle
import tarfile
import zipfile
from typing import Any, Iterator, Optional, Union

import torch

from ..parallel.mesh import Mesh
from ..parallel.sharding import block_index, shard_shape
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


class _LazyTensor:
    """A tensor of an archived state dict whose bytes are read from the
    zip when ``load`` is called."""

    def __init__(self, read, key: str, dtype: torch.dtype, offset: int,
                 size: tuple, stride: tuple):
        self._read, self._key, self.dtype = read, key, dtype
        self._offset, self.shape = offset, torch.Size(size)
        self._stride = tuple(stride)

    def load(self) -> torch.Tensor:
        raw = self._read(self._key)
        flat = (torch.frombuffer(bytearray(raw), dtype=self.dtype) if raw
                else torch.empty((0,), dtype=self.dtype))
        return torch.as_strided(flat, self.shape, self._stride,
                                self._offset)


# torch's legacy storage classes, by the name a pickle gives them.
_STORAGE_DTYPES = {
    "FloatStorage": torch.float32, "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16, "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64, "IntStorage": torch.int32,
    "ShortStorage": torch.int16, "CharStorage": torch.int8,
    "ByteStorage": torch.uint8, "BoolStorage": torch.bool,
}


class _StateUnpickler(pickle.Unpickler):
    """The state dict's pickle with every tensor left unread: storages
    become (key, dtype) and tensors ``_LazyTensor``; any other class is
    refused, as ``torch.load(weights_only=True)`` refuses it."""

    def __init__(self, f, read):
        super().__init__(f)
        self._read = read

    def find_class(self, module: str, name: str):
        if (module, name) == ("torch._utils", "_rebuild_tensor_v2"):
            return self._rebuild
        if (module, name) == ("collections", "OrderedDict"):
            return collections.OrderedDict
        if module == "torch" and name in _STORAGE_DTYPES:
            return _STORAGE_DTYPES[name]
        raise pickle.UnpicklingError(f"{module}.{name} is not read from a "
                                     f"checkpoint")

    def persistent_load(self, pid):
        _, dtype, key, _location, _numel = pid
        return key, dtype

    def _rebuild(self, storage, offset, size, stride, *_):
        key, dtype = storage
        return _LazyTensor(self._read, key, dtype, offset, size, stride)


@contextlib.contextmanager
def open_archive(nemo_path: str) -> Iterator[tuple[dict, dict]]:
    """(model_config.yaml's mapping, the state dict with each tensor a
    ``_LazyTensor``) while the archive stays open. A weights member in
    torch's older non-zip format is read whole (``torch.load``)."""
    with tarfile.open(nemo_path) as tar:
        cfg_name, ckpt_name = _members(tar, nemo_path)
        with tar.extractfile(cfg_name) as f:  # type: ignore[union-attr]
            config = read_flat_yaml(f.read().decode("utf-8"))
        with tar.extractfile(ckpt_name) as f:  # type: ignore[union-attr]
            if not zipfile.is_zipfile(f):
                f.seek(0)
                yield config, torch.load(f, map_location="cpu",
                                         weights_only=True)
                return
            with zipfile.ZipFile(f) as zf:
                pkl = next(n for n in zf.namelist()
                           if n.endswith("data.pkl"))
                root = pkl[:-len("data.pkl")]
                with zf.open(pkl) as pf:
                    state = _StateUnpickler(
                        pf, lambda key: zf.read(f"{root}data/{key}")).load()
                yield config, state


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
                         device: Union[str, torch.device] = "cuda",
                         mesh: Optional[Mesh] = None) -> Params:
    """A ``.nemo`` archive (or a directory holding one) as the port's
    parameter tree on ``device`` in ``dtype``, read leaf by leaf
    (``open_archive``). A ``num_layers`` in ``model_config.yaml`` other
    than the config's, a missing tensor or a shape the config does not
    give raise ``ModelLoadError``. ``mesh``: this rank's shard only, each
    leaf cut on the host to its block (``shard_params``' bit for bit)."""
    if cfg.num_experts:
        # The reference's NeMo importer is dense-only too.
        raise ConfigError(f"{path}: a mixture-of-experts geometry "
                          f"({cfg.num_experts} experts) has no NeMo "
                          f"import; load an HF checkpoint")
    nemo_path = find_nemo(path)
    with open_archive(nemo_path) as (config, tensors):
        return _assemble(nemo_path, config, tensors, cfg, dtype,
                         resolve_device(device), mesh)


def _assemble(nemo_path: str, config: dict, tensors: dict,
              cfg: LlamaConfig, dtype: torch.dtype, dev: torch.device,
              mesh: Optional[Mesh]) -> Params:
    """``load_nemo_checkpoint``'s body over an open archive's state."""
    from .import_hf import leaf_specs
    declared = config.get("num_layers")
    if declared is not None and int(declared) != cfg.num_layers:
        raise ModelLoadError(
            f"{nemo_path}: model_config.yaml num_layers={declared} but "
            f"target config has {cfg.num_layers}")

    def get(name: str) -> torch.Tensor:
        for key in (_PREFIX + name, "model." + name, name):
            if key in tensors:
                t = tensors[key]
                return t.load() if isinstance(t, _LazyTensor) else t
        raise ModelLoadError(f"{nemo_path}: missing tensor {name!r}")

    shapes = _expected_shapes(cfg)
    specs = leaf_specs(cfg, mesh)
    out: dict[str, torch.Tensor] = {}

    def put(flat: str, idx, t: torch.Tensor) -> None:
        n_idx = 0 if idx is None else 1
        want = shapes[flat][n_idx:]
        if tuple(t.shape) != want:
            raise ModelLoadError(f"{nemo_path}: {flat} gets shape "
                                 f"{tuple(t.shape)}, the config needs {want}")
        spec = specs.get(flat, ())
        if flat not in out:
            out[flat] = torch.empty(shard_shape(shapes[flat], spec, mesh),
                                    dtype=dtype, device=dev)
        block = t[block_index(want, spec[n_idx:], mesh)]
        (out[flat] if idx is None else out[flat][idx]).copy_(block.to(dev))

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
    params: Params = {
        "embed": out["embed"],
        "layers": {k: out[f"layers/{k}"] for k in layer_keys(cfg)},
        "final_norm": out["final_norm"],
    }
    for name in ("final_norm_b", "lm_head"):
        if name in out:
            params[name] = out[name]
    return params
