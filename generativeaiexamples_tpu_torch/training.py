"""Training step for fine-tuning — port of the reference's ``training.py``.

The reference's step is a jit-compiled ``(params, opt_state, batch) ->
(params, opt_state, loss)`` over optax. Here autograd differentiates the
port's own forward (``models/llama.py`` ``apply`` on its no-cache path)
and a ``torch.optim`` optimizer updates the parameters in place, so the
step is ``(params, batch) -> loss``. The optimizer is built by the caller
over ``trainable(params)``; to match ``optax.adamw(lr)`` pass
``torch.optim.AdamW(..., weight_decay=1e-4)`` (torch's default decay is
1e-2, optax's 1e-4; both use eps 1e-8, betas (0.9, 0.999) and decoupled
decay on every leaf), and ``optax.adam(lr)`` is ``torch.optim.Adam(...,
lr)``. Moments live in the parameters' dtype, as optax keeps them.

Stacked ``(L, ...)`` leaves are split into per-layer views with
``unbind`` before the forward, so each layer's gradient lands in one
stacked gradient at the end (slicing with ``[i]`` would give every layer
a zero-filled gradient of the whole stack). Training over a mesh (the
reference's dp/tp shardings and its pp GPipe schedule) waits for the
port's ``parallel/`` (ROADMAP.md A12): a ``mesh`` raises ``ConfigError``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .models import llama
from .models.configs import LlamaConfig
from .utils.errors import ConfigError

Batch = dict[str, torch.Tensor]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Masked mean token cross-entropy in float32: ``sum(nll * mask) /
    max(sum(mask), 1)``. logits (B, S, V), targets and mask (B, S)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    maskf = mask.float()
    return (nll * maskf).sum() / maskf.sum().clamp_min(1.0)


def trainable(params: Any) -> list[torch.Tensor]:
    """Every raw floating-point leaf of a parameter tree, marked to
    require grad, for the optimizer. Quantized dict leaves (int weights
    and their scales) are frozen and left out."""
    out: list[torch.Tensor] = []
    for name in sorted(params):
        leaf = params[name]
        if name == "layers":
            out.extend(trainable(leaf))
        elif isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            out.append(leaf.requires_grad_(True))
    return out


def _per_layer(params: llama.Params) -> llama.Params:
    """``params`` with every stacked raw leaf that carries a gradient split
    into per-layer views by ``unbind`` (``llama.layer_params`` indexes a
    list as it does a tensor)."""
    layers = {k: (list(v.unbind(0)) if isinstance(v, torch.Tensor)
                  and v.requires_grad else v)
              for k, v in params["layers"].items()}
    return {**params, "layers": layers}


def forward_loss(params: llama.Params, cfg: LlamaConfig, batch: Batch,
                 length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The loss of ``batch`` = {"tokens", "targets", "mask"} (B, S) under
    ``params``: a full-sequence causal forward with ``length`` (B,) valid
    keys per row (default ``sum(mask)``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    if length is None:
        length = batch["mask"].sum(dim=-1)
    logits, _ = llama.apply(_per_layer(params), cfg, tokens, positions,
                            kv_valid_len=length)
    return cross_entropy_loss(logits, batch["targets"], batch["mask"])


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer,
                    mesh=None, n_microbatches: int = 2
                    ) -> Callable[[llama.Params, Batch], torch.Tensor]:
    """Build a ``(params, batch) -> loss`` step that updates ``params`` in
    place through ``optimizer`` (built over ``trainable(params)``).

    ``batch`` = {"tokens": (B, S), "targets": (B, S), "mask": (B, S)} plus
    an optional ``"length"`` (B,). ``mask`` is the LOSS mask; attention
    validity defaults to ``sum(mask)`` (right-padded plain-LM batches), so
    an SFT batch that masks prompt tokens out of the loss passes the true
    per-row token count as ``length``. Returns the step's loss (float32,
    detached). ``mesh`` (and ``n_microbatches``, the pp schedule's) is
    not ported: a mesh raises ``ConfigError``."""
    if mesh is not None:
        raise ConfigError("training over a mesh (dp/tp shardings, the pp "
                          "GPipe schedule) is not ported yet (ROADMAP.md "
                          "A12)")

    def train_step(params: llama.Params, batch: Batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = forward_loss(params, cfg, batch, batch.get("length"))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
