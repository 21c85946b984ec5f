"""LoRA fine-tuning: low-rank adapters over the stacked parameter tree —
port of the reference's ``lora.py``.

Adapters are a separate small tree: for each target key ``{"a": (L, K,
r), "b": (L, r, N)}``, with ``b`` zero so step 0 is exactly the base
model. The loss merges ``W + (alpha/r) * a @ b`` on the fly and the
optimizer steps only the adapters; the base stays frozen and may stay
quantized (int8 or int4, QLoRA-style): ``dequantize`` runs inside the
merge for a target, and an int4 leaf that is not a target keeps its
kernel in the forward (``ops/quant.py`` ``_int4``) with the input
gradient of ``ops/int4_matmul.py`` ``int4_matmul_grad`` in the backward.

The frozen base never requires grad and never holds a ``.grad``. The
merge runs target by target, so its float32 transients are one target's
(2.1 GB for a 7B ``wq``).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence, Union

import torch

from .models import llama
from .models.configs import LlamaConfig
from .models.convert import _to_tensor
from .ops.quant import dequantize, is_quantized
from .training import Batch, forward_loss

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")

LoraParams = dict[str, dict[str, torch.Tensor]]


def _weight_shape(w: Any) -> tuple[int, ...]:
    if is_quantized(w):
        q = w["q4"] if "q4" in w else w["q"]
        K = q.shape[-2] * 2 if "q4" in w else q.shape[-2]
        return (*q.shape[:-2], K, q.shape[-1])
    return tuple(w.shape)


def _device(w: Any) -> torch.device:
    return (w["q4"] if "q4" in w else w["q"]).device if is_quantized(w) \
        else w.device


def init_lora(cfg: LlamaConfig, base_params: llama.Params,
              generator: Union[torch.Generator, int] = 0, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS,
              dtype: torch.dtype = torch.float32) -> LoraParams:
    """Zero-delta init, the standard LoRA one: a ~ N(0, 1/K), b = 0, on
    each target's device, requiring grad. ``generator`` is a
    ``torch.Generator`` (or a seed for a CPU one); ``a`` is drawn in
    float32 on its device, target after target (the reference's
    ``jax.random`` stream differs: carry its adapters with
    ``lora_from_numpy`` to compare)."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    lora: LoraParams = {}
    for name in targets:
        if name not in base_params["layers"]:
            raise KeyError(f"unknown LoRA target {name!r}")
        w = base_params["layers"][name]
        shape = _weight_shape(w)
        if len(shape) != 3:
            raise ValueError(f"LoRA target {name!r} must be stacked "
                             f"(L, K, N); got shape {shape}")
        L, K, N = shape
        a = torch.randn((L, K, rank), generator=generator,
                        device=generator.device, dtype=torch.float32)
        dev = _device(w)
        lora[name] = {
            "a": (a * K ** -0.5).to(device=dev, dtype=dtype
                                    ).requires_grad_(True),
            "b": torch.zeros((L, rank, N), dtype=dtype,
                             device=dev).requires_grad_(True),
        }
    return lora


def lora_from_numpy(tree: Mapping[str, Mapping[str, Any]],
                    device: Union[str, torch.device] = "cuda",
                    dtype: torch.dtype = torch.float32) -> LoraParams:
    """Adapters given as numpy arrays (the reference's ``init_lora`` tree,
    ``{target: {"a", "b"}}``; bf16 arrays carried as ``models/convert.py``
    carries them) -> the port's in ``dtype`` on ``device``, requiring
    grad."""
    dev = torch.device(device)
    out: LoraParams = {}
    for name, ab in tree.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(f"adapter {name!r} must hold 'a' and 'b'; got "
                             f"{sorted(ab)}")
        a, b = (_to_tensor(ab[k], dev, dtype) for k in ("a", "b"))
        if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
                or a.shape[2] != b.shape[1]:
            raise ValueError(f"adapter {name!r}: a {tuple(a.shape)} and b "
                             f"{tuple(b.shape)} are not (L, K, r), (L, r, N)")
        out[name] = {"a": a.requires_grad_(True), "b": b.requires_grad_(True)}
    return out


def lora_parameters(lora: LoraParams) -> list[torch.Tensor]:
    """The adapters' tensors, for the optimizer."""
    return [lora[name][k] for name in sorted(lora) for k in ("a", "b")]


def merge_lora(base_params: llama.Params, lora: LoraParams,
               alpha: float = 16.0, dtype: Optional[torch.dtype] = None
               ) -> llama.Params:
    """Effective parameters: ``W + (alpha/r) * a @ b`` per target, summed
    in float32 and cast to ``W``'s dtype, as the reference merges. A
    quantized base leaf dequantizes to the adapters' dtype for the merge
    (so a QLoRA merge gives float32 leaves by default). ``dtype`` casts
    every merged leaf instead: the serving cast, since an engine runs one
    dtype (``merge_lora(base, lora, dtype=torch.bfloat16)`` beside a bf16
    base). Differentiable in the adapters; the base is only read."""
    layers = dict(base_params["layers"])
    for name, ab in lora.items():
        w = layers[name]
        scale = alpha / ab["a"].shape[-1]
        if is_quantized(w):
            w = dequantize(w, ab["a"].dtype)
        delta = torch.einsum("lkr,lrn->lkn", ab["a"].float(),
                             ab["b"].float()) * scale
        layers[name] = (w.float() + delta).to(dtype or w.dtype)
        del w, delta
    return {**base_params, "layers": layers}


def _check_frozen(base_params: llama.Params) -> None:
    if any(t.requires_grad for t in llama.param_tensors(base_params)):
        raise ValueError("the LoRA base must be frozen: a base leaf "
                         "requires grad")


def make_lora_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer,
                         alpha: float = 16.0,
                         dtype: Optional[torch.dtype] = None
                         ) -> Callable[[LoraParams, llama.Params, Batch],
                                       torch.Tensor]:
    """``(lora, base_params, batch) -> loss``: one optimizer step on the
    adapters (``optimizer`` built over ``lora_parameters(lora)``), which
    are updated in place. The loss merges the targets (``merge_lora``
    with ``dtype``; the default keeps the reference's dtypes) and runs
    the full-sequence forward with ``sum(mask)`` valid keys per row, as
    the reference's LoRA loss does. The base must not require grad."""

    def train_step(lora: LoraParams, base_params: llama.Params,
                   batch: Batch) -> torch.Tensor:
        _check_frozen(base_params)
        optimizer.zero_grad(set_to_none=True)
        params = merge_lora(base_params, lora, alpha, dtype=dtype)
        loss = forward_loss(params, cfg, batch)
        del params
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
