"""Ring attention: sequence-parallel exact attention for long context —
port of the reference's ``parallel/ring_attention.py``.

Q, K and V are sharded contiguously along the sequence over the mesh's
``sp`` ranks: ring rank ``r`` holds positions ``[r * Sk, (r + 1) * Sk)``.
Each of the ``sp`` steps attends the local queries to the K/V block held
and passes the block to the next sp rank (``comm.ring_pass``, NCCL
point-to-point; the reference's ``ppermute``), the pass for step ``s +
1`` issued before step ``s``'s products so the transfer overlaps them.
Blocks combine under the online softmax (running max, sum and float32
accumulator), so the result is exact: it equals dense ``gqa_attention``
to float tolerance.

- **Causality by absolute position.** Each query row carries its
  absolute position; a visiting block knows its global key offset from
  the ring step, so cross-shard masking needs no extra communication. A
  fully masked visiting block contributes exactly zero (masked
  probabilities are zeroed, not ``exp(NEG - NEG)``).
- **The last block is consumed without a trailing rotation.**
- **Products on the storage dtype.** q.k and p.v run on storage-dtype
  operands with float32 results (``models/llama.py`` ``_dot_f32``); p is
  cast to the compute dtype before p.v, as the port's prefix attention
  does (the reference's p.v is float32; in float32 the two are one).
- **Query tiles.** The reference updates the whole block at once; at the
  card's long-context shape (32 kv heads, 8192 local queries against an
  8192-row block) that is 8.6 GB of float32 scores a layer, twice that
  with p. Queries go through in tiles of ``q_tile`` rows (1024: about
  1 GB of scores), each tile's softmax state its own.

The block update is plain PyTorch (the reference's is plain ``jnp``:
no Pallas kernel), cuBLAS for the two products.
"""

from __future__ import annotations

import torch

from .comm import ring_pass
from .mesh import Mesh

NEG_INF = -1e30

# Query rows per block update (module docstring).
Q_TILE = 1024


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` on storage-dtype operands with a float32 result
    (``models/llama.py`` ``_dot_f32``)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def block_update(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 qk: torch.Tensor, q_pos: torch.Tensor, kb: torch.Tensor,
                 vb: torch.Tensor, k0: int, causal: bool, scale: float
                 ) -> None:
    """One online-softmax update of a query tile against one visiting
    block, in place. qk: (B*KV, G*tq, hd) queries grouped by kv head;
    q_pos: (B, tq) int absolute positions; kb/vb: (B*KV, Sk, hd); k0: the
    block's first key position; acc (B*KV, G*tq, hd), m and l (B*KV,
    G*tq) float32."""
    BK, GT, hd = qk.shape
    B, tq = q_pos.shape
    Sk = kb.shape[1]
    G = GT // tq
    s = _dot_f32(qk, kb.transpose(1, 2)).mul_(scale)        # (BK, G*tq, Sk)
    # Rows are (batch, kv head, group, query): the mask broadcasts over
    # the kv heads and the group.
    rows = s.view(B, BK // B, G, tq, Sk)
    if causal:
        keys = k0 + torch.arange(Sk, device=qk.device, dtype=q_pos.dtype)
        dead = (keys[None, None, :] > q_pos[:, :, None])[:, None, None]
        rows.masked_fill_(dead, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = s.sub_(m_new[..., None]).exp_()
    if causal:
        rows.masked_fill_(dead, 0.0)
    l.mul_(alpha).add_(p.sum(dim=-1))
    acc.mul_(alpha[..., None]).add_(_dot_f32(p.to(vb.dtype), vb))
    m.copy_(m_new)


def ring_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_positions: torch.Tensor, *, mesh: Mesh,
                       causal: bool = True, q_tile: int = Q_TILE
                       ) -> torch.Tensor:
    """Exact GQA over sequence-sharded Q/K/V (the reference's
    ``ring_gqa_attention``). Every sp rank of ``mesh`` calls it with its
    own shard.

    q:           (B, Sq, H, hd)  local query shard
    k, v:        (B, Sk, KV, hd) local K/V shard (rotates around the ring)
    q_positions: (B, Sq) int     ABSOLUTE positions of the local queries

    Shards are position-contiguous: sp rank ``r`` holds keys ``[r * Sk,
    (r + 1) * Sk)``. Returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    n = mesh.shape["sp"]
    my = mesh.coords["sp"]
    scale = 1.0 / (hd ** 0.5)
    # (B, S, KV, hd) -> (B*KV, S, hd): one batched product per kv head.
    kb = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd).contiguous()
    vb = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd).contiguous()
    tiles = []
    for t0 in range(0, Sq, q_tile):
        tq = min(q_tile, Sq - t0)
        # (B, tq, KV, G, hd) -> (B*KV, G*tq, hd), G-major as the
        # reference's "bkgst" layout.
        qk = q[:, t0:t0 + tq].reshape(B, tq, KV, G, hd).permute(
            0, 2, 3, 1, 4).reshape(B * KV, G * tq, hd)
        acc = torch.zeros((B * KV, G * tq, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B * KV, G * tq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B * KV, G * tq), dtype=torch.float32,
                        device=q.device)
        tiles.append((t0, tq, qk, acc, m, l))
    for step in range(n):
        last = step == n - 1
        if not last:
            # The next block's pass first: the products below do not
            # depend on it.
            kn, vn = torch.empty_like(kb), torch.empty_like(vb)
            reqs = ring_pass([kb, vb], [kn, vn], mesh)
        # After ``step`` rotations the block held came from rank my - step.
        k0 = ((my - step) % n) * Sk
        for t0, tq, qk, acc, m, l in tiles:
            block_update(acc, m, l, qk, q_positions[:, t0:t0 + tq], kb, vb,
                         k0, causal, scale)
        if not last:
            for r in reqs:
                r.wait()
            kb, vb = kn, vn
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    for t0, tq, qk, acc, m, l in tiles:
        o = acc / torch.clamp(l[..., None], min=1e-30)       # (BK, G*tq, hd)
        out[:, t0:t0 + tq] = o.reshape(B, KV, G, tq, hd).permute(
            0, 3, 1, 2, 4).reshape(B, tq, H, hd).to(q.dtype)
    return out
