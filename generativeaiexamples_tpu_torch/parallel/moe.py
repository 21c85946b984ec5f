"""Sparse mixture-of-experts: top-k routing with capacity-bounded dispatch
(port of the reference's ``parallel/moe.py``).

The reference wrote this layer in plain ``jnp`` (XLA, no Pallas kernel),
so it is plain PyTorch here: the routing is a handful of small integer
ops, and each expert's SwiGLU is a batched library product over the
``(E, C, D)`` capacity buffers.

- **Static shapes.** Each expert processes a fixed-capacity buffer of
  ``C = expert_capacity(T, E, k, capacity_factor)`` rows; a claim past an
  expert's capacity is dropped (its combine weight is zero). ``C``
  depends only on the row count, so one captured CUDA graph serves every
  call of a shape: nothing here reads a device value on the host.
- **Rows are not independent.** Every row of a call claims expert slots
  in token order, so padding rows and inactive decode slots take
  capacity from live rows, exactly as in the reference.
- **Deterministic dispatch and combine.** The scatter sends each kept
  claim to its unique ``(expert, slot)`` row and every dropped claim to
  one trash row past the buffer, so no kept row is ever written twice;
  the combine gathers each claim's row and sums a token's ``k`` claims in
  claim order, with no atomics, so graph replays give the same bits.

Under tensor parallelism (``sparse_moe_ffn(..., mesh=)``) every rank
holds F/tp columns of each expert's ``w_gate``/``w_up`` and the matching
rows of ``w_down`` (``parallel/sharding.py``); routing is replicated
(the same float32 router logits on every rank), each rank's combine is a
partial sum, and one all-reduce completes it: what the reference
computes under GSPMD with the same specs.

Under expert parallelism (``ep_sparse_moe_ffn``, ``sparse_moe_ffn`` on a
mesh with ep > 1) every rank holds ``E/ep`` experts (its ep block of the
stacks, F/tp columns of each). x is replicated over ep, so every rank
routes the same rows and dispatches them locally into the same ``(E, C,
D)`` buffers, runs only its own experts (``ep_expert_ffn``), and its
combine keeps only its own experts' claims; one all-reduce over the
``ep x tp`` ranks completes the sum. The reference's GSPMD lowering moves
the buffers with an all-to-all instead; with x already on every rank no
all-to-all is needed, and the result is the same sum (in another order).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..models.configs import LlamaConfig
from ..utils.errors import ShardingError
from .comm import all_reduce_
from .mesh import Mesh


def expert_capacity(n_tokens: int, n_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Per-expert token slots; static given the (padded) token count.
    The reference's expression, float floor division of a negative
    included: ``ceil(T * k * cf / E)``, at least 1."""
    return max(1, int(-(-n_tokens * k * capacity_factor // n_experts)))


def topk_lowest_index_first(logits: torch.Tensor, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    ties broken towards the lower index (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none among ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(router_logits: torch.Tensor, k: int, capacity: int):
    """Top-k routing with in-expert slot assignment.

    router_logits: (T, E). Returns flat (T*k,) tensors, token-major:
      expert  - chosen expert id per claim (int64)
      slot    - position inside that expert's capacity buffer, clipped to
                ``capacity - 1`` (int64)
      weight  - softmaxed router weight (float32)
      keep    - False where the expert's capacity was already full
    Earlier tokens claim slots first (deterministic, order-based
    priority)."""
    T, E = router_logits.shape
    w, idx = topk_lowest_index_first(router_logits, k)           # (T, k)
    w = torch.softmax(w.float(), dim=-1)
    expert = idx.reshape(-1)                                     # (T*k,)
    experts = torch.arange(E, device=expert.device)
    claims = (expert[:, None] == experts[None, :]).long()         # (T*k, E)
    pos = torch.cumsum(claims, dim=0) - 1                        # claim rank
    slot = torch.gather(pos, 1, expert[:, None])[:, 0]
    keep = slot < capacity
    return expert, slot.clamp(0, capacity - 1), w.reshape(-1), keep


def _dispatch(x_flat: torch.Tensor, expert: torch.Tensor,
              slot: torch.Tensor, keep: torch.Tensor, n_experts: int,
              capacity: int) -> torch.Tensor:
    """(T, D) tokens -> (E, C, D) expert buffers. Kept claims land on
    their unique rows; dropped ones on a trash row past the buffer (the
    reference adds them as zeros onto the clipped slot, which leaves the
    same values)."""
    T, D = x_flat.shape
    k = expert.shape[0] // T
    n_rows = n_experts * capacity
    dest = torch.where(keep, expert * capacity + slot,
                       torch.full_like(expert, n_rows))
    buf = x_flat.new_zeros((n_rows + 1, D))
    buf.index_copy_(0, dest, x_flat[:, None].expand(T, k, D).reshape(T * k, D))
    return buf[:n_rows].view(n_experts, capacity, D)


def _combine(expert_out: torch.Tensor, expert: torch.Tensor,
             slot: torch.Tensor, weight: torch.Tensor, keep: torch.Tensor,
             n_tokens: int) -> torch.Tensor:
    """(E, C, D) expert outputs -> (T, D) weighted token outputs. A
    dropped claim's weight is zero. Claims are token-major, so the sum
    over a token's ``k`` claims is the reference's scatter-add in its
    order (bit-equal for k = 2)."""
    E, C, D = expert_out.shape
    k = expert.shape[0] // n_tokens
    y = expert_out.reshape(E * C, D).index_select(0, expert * C + slot)
    w = (weight * keep).to(y.dtype)[:, None]
    return (y * w).view(n_tokens, k, D).sum(dim=1)


def _expert_ffn(expert_in: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU on (E, C, D) with stacked (E, D, F) weights."""
    gate = torch.nn.functional.silu(torch.bmm(expert_in, w_gate))
    up = torch.bmm(expert_in, w_up)
    return torch.bmm(gate * up, w_down)


def expert_block(cfg: LlamaConfig, mesh: Optional[Mesh]) -> tuple[int, int]:
    """(first expert, count) of this rank's ep block: all ``E`` experts
    without expert parallelism. ``E % ep`` must be 0."""
    E = cfg.num_experts
    ep = mesh.shape.get("ep", 1) if mesh is not None else 1
    if ep == 1:
        return 0, E
    if E % ep:
        raise ShardingError(f"num_experts={E} does not split over ep={ep}")
    n = E // ep
    return mesh.coords["ep"] * n, n


def _route(x_flat: torch.Tensor, lp: dict[str, Any], cfg: LlamaConfig):
    """Float32 router logits, capacity and top-k claims of (T, D) rows."""
    T = x_flat.shape[0]
    logits = x_flat.float() @ lp["router"].float()
    C = expert_capacity(T, cfg.num_experts, cfg.num_experts_per_tok,
                        cfg.moe_capacity_factor)
    return C, route_topk(logits, cfg.num_experts_per_tok, C)


def sparse_moe_ffn(x: torch.Tensor, lp: dict[str, Any],
                   cfg: LlamaConfig,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sparse MoE layer: (B, S, D) -> (B, S, D), top-k experts per token.
    The router logits are float32 (the reference's), the experts run in
    the activations' dtype. ``mesh``: ``lp``'s experts are this rank's
    shard (its ep block, F/tp columns) and the combined rows are
    all-reduced (``ep_sparse_moe_ffn`` under ep > 1)."""
    if mesh is not None and mesh.shape.get("ep", 1) > 1:
        return ep_sparse_moe_ffn(mesh, x, lp, cfg)
    B, S, D = x.shape
    T = B * S
    x_flat = x.reshape(T, D)
    C, (expert, slot, weight, keep) = _route(x_flat, lp, cfg)
    expert_in = _dispatch(x_flat, expert, slot, keep, cfg.num_experts, C)
    expert_out = _expert_ffn(expert_in, lp["w_gate"], lp["w_up"],
                             lp["w_down"])
    out = _combine(expert_out, expert, slot, weight, keep, T)
    return all_reduce_(out, mesh).reshape(B, S, D)


def ep_expert_ffn(mesh: Mesh, expert_in: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """This rank's experts' SwiGLU (the reference's ``ep_expert_ffn``,
    one device's block of it): ``expert_in`` (E/ep, C, D) holds the
    buffers of this rank's ep block of experts, the weights its shards
    ((E/ep, D, F/tp), (E/ep, F/tp, D)); the row-parallel down product is
    summed over tp. Returns (E/ep, C, D)."""
    return all_reduce_(_expert_ffn(expert_in, w_gate, w_up, w_down), mesh)


def ep_sparse_moe_ffn(mesh: Mesh, x: torch.Tensor, lp: dict[str, Any],
                      cfg: LlamaConfig) -> torch.Tensor:
    """``sparse_moe_ffn`` with the experts over ``ep`` (the reference's
    ``ep_sparse_moe_ffn``; module docstring): routing and dispatch of
    every row on every rank, this rank's experts only, the combine of
    their claims, one all-reduce over ``ep x tp``."""
    B, S, D = x.shape
    T = B * S
    x_flat = x.reshape(T, D)
    C, (expert, slot, weight, keep) = _route(x_flat, lp, cfg)
    e0, n = expert_block(cfg, mesh)
    mine = (expert >= e0) & (expert < e0 + n)
    # Only this rank's experts' buffers are filled: another expert's
    # claim goes to the trash row, as a dropped claim does.
    expert_in = _dispatch(x_flat, (expert - e0).clamp(0, n - 1), slot,
                          keep & mine, n, C)
    expert_out = _expert_ffn(expert_in, lp["w_gate"], lp["w_up"],
                             lp["w_down"])
    out = _combine(expert_out, (expert - e0).clamp(0, n - 1), slot, weight,
                   keep & mine, T)
    return all_reduce_(out, mesh, "moe").reshape(B, S, D)
