"""Converted-weight cache, keyed by the checkpoint's content (a port of the
reference's ``models/weight_cache.py``, same API).

Loading a checkpoint is real work on every server start: parsing,
renaming, transposing, casting and, when asked, quantizing. The cache
keeps the FINAL served tree (after quantization) under an identity the
model server builds from the model name, dtype, quantization mode and the
checkpoint directory's content hash (``name-dtype-quant-hash``; under
tensor parallelism each rank keeps its own shard under
``name-dtype-quant-tp{N}-r{rank}-hash``), so a restart reads the tensors
straight back and skips the conversion.

Layout: ``$GAIE_WEIGHT_CACHE_DIR`` (default
``~/.cache/generativeaiexamples_tpu_torch/weights``)
``/<identity>-torch/tree/``: the tree flattened to ``/``-joined names
(``layers/wq/q4``) in the port's safetensors format
(``models/safetensors.py`` ``save_sharded``). The ``-torch`` suffix keeps
a cache directory shared with the reference from ever handing one
framework the other's entry. A save is written to a temporary directory
and renamed into place, so a crashed save is never read. Disable with
``GAIE_WEIGHT_CACHE=0``. Every tensor round-trips bit-equal (quantized
leaves keep their int8 and float32 bytes).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Any, Callable, Optional, Union

import torch

from .safetensors import INDEX_NAME, iter_file, save_sharded

logger = logging.getLogger("tpu-rag.weight_cache")

# The framework tag of every entry's directory name.
FRAMEWORK = "torch"
# Bytes per cache file (a 7B tree is about 4 files).
_SHARD_BYTES = 4 << 30


def enabled() -> bool:
    return os.environ.get("GAIE_WEIGHT_CACHE", "1") != "0"


def cache_root() -> str:
    return os.environ.get(
        "GAIE_WEIGHT_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "generativeaiexamples_tpu_torch", "weights"))


def _entry(identity: str) -> str:
    return f"{identity.replace('/', '_')}-{FRAMEWORK}"


def _tree_dir(identity: str) -> str:
    return os.path.join(cache_root(), _entry(identity), "tree")


def flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """A nested dict of tensors -> ``{"a/b/c": tensor}``."""
    out: dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = v
    return out


def unflatten(flat: dict[str, torch.Tensor]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for name, t in flat.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def load(identity: str, device: Union[str, torch.device] = "cpu"
         ) -> Optional[Any]:
    """The cached tree for this identity on ``device``, or None (absent,
    disabled, or unreadable: an unreadable entry is dropped so the next
    save can replace it)."""
    if not enabled():
        return None
    path = _tree_dir(identity)
    if not os.path.isfile(os.path.join(path, INDEX_NAME)):
        return None
    try:
        flat: dict[str, torch.Tensor] = {}
        for fname in sorted(os.listdir(path)):
            if fname.endswith(".safetensors"):
                for name, t in iter_file(os.path.join(path, fname)):
                    flat[name] = t.to(device)
        params = unflatten(flat)
        logger.info("weights loaded from cache %s", path)
        return params
    except Exception:  # noqa: BLE001 - the cache must never block serving
        logger.exception("weight cache at %s unreadable; dropping it", path)
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        return None


def save(identity: str, params: Any,
         prune_prefix: Optional[str] = None) -> bool:
    """Best-effort write; True when the tree landed.

    ``prune_prefix``: after a successful save, sibling entries whose
    identity is this prefix and a content hash (same model, dtype,
    quantization and rank, an OLD hash) are deleted: a converted tree is
    gigabytes, and without eviction every checkpoint update would leave
    a copy behind. An entry of another topology (``...-tp4-r1-hash``
    beside ``...-hash``) is not this prefix's and stays."""
    if not enabled():
        return False
    entry = os.path.join(cache_root(), _entry(identity))
    try:
        os.makedirs(cache_root(), exist_ok=True)
        flat = flatten(params)
        total = sum(t.numel() * t.element_size() for t in flat.values())
        tmp = tempfile.mkdtemp(prefix=".saving-", dir=cache_root())
        try:
            save_sharded(flat, os.path.join(tmp, "tree"),
                         shards=max(1, -(-total // _SHARD_BYTES)),
                         prefix="weights")
            shutil.rmtree(entry, ignore_errors=True)
            os.replace(tmp, entry)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        logger.info("weights cached at %s", entry)
    except Exception:  # noqa: BLE001 - the cache must never block serving
        logger.exception("weight cache save failed for %s", identity)
        return False
    if prune_prefix:
        keep = os.path.basename(entry)
        prefix = prune_prefix.replace("/", "_")
        suffix = f"-{FRAMEWORK}"
        try:
            for name in os.listdir(cache_root()):
                if (name.startswith(prefix) and name != keep
                        and name.endswith(suffix)
                        and "-" not in name[len(prefix):-len(suffix)]):
                    shutil.rmtree(os.path.join(cache_root(), name),
                                  ignore_errors=True)
                    logger.info("pruned stale weight cache %s", name)
        except OSError:
            pass
    return True


def cached_or_convert(identity: str, convert: Callable[[], Any],
                      prune_prefix: Optional[str] = None,
                      device: Union[str, torch.device] = "cpu"
                      ) -> tuple[Any, bool]:
    """(params, from_cache): the cached tree on ``device``, or
    ``convert()``'s, cached. ``convert`` must return the FINAL served tree
    (after quantization): the identity names the quantization mode, so a
    cached int4 tree is never served as raw."""
    params = load(identity, device)
    if params is not None:
        return params, True
    params = convert()
    save(identity, params, prune_prefix=prune_prefix)
    return params, False
