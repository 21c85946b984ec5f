"""Paged GQA decode attention + KV append: the Hopper kernel's wrapper and
its plain PyTorch version.

``paged_attention_decode`` replaces the reference's Pallas kernel
(``generativeaiexamples_tpu/ops/paged_attention.py``
``paged_attention_decode``). On a CUDA tensor it launches the hand-written
kernel in ``csrc/paged_attention.cu`` (built at first use by
``kernels/build.py``) or raises; it takes the plain version only for CPU
tensors. ``paged_attention_decode_plain`` mirrors the reference's
``paged_attention_decode_reference`` plus the append; the CPU tests use
it, and the card check compares the kernel with it.

The pools are updated IN PLACE (the reference aliased them through the
pallas_call and threaded them through its layer scan carry).
"""

from __future__ import annotations

import ctypes

import torch

NEG = -1e30

# Kernel gate on Hopper (the TPU gate of 128-aligned head_dim/page is a
# Mosaic tiling rule and does not apply): G query heads per kv head live
# in registers (G <= 8), each lane holds up to 8 head-dim elements
# (hd <= 256), GQA needs H % KV == 0.
MAX_GROUP = 8
MAX_HEAD_DIM = 256
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_fn = None


def kernel_supported(page: int, num_heads: int, num_kv_heads: int,
                     head_dim: int) -> bool:
    """Whether the Hopper kernel accepts this geometry."""
    return (page >= 1 and num_kv_heads > 0
            and num_heads % num_kv_heads == 0
            and 1 <= num_heads // num_kv_heads <= MAX_GROUP
            and 1 <= head_dim <= MAX_HEAD_DIM)


def _check_args(q, pool_k, pool_v, block_table, lengths, cur_k, cur_v,
                write_page, write_offset, layer) -> None:
    """Shape/dtype/device checks shared by both paths."""
    if q.dim() != 3 or pool_k.dim() != 5:
        raise ValueError(f"q must be (B, H, hd) and pools (L, N, KV, page, "
                         f"hd); got {tuple(q.shape)}, {tuple(pool_k.shape)}")
    B, H, hd = q.shape
    L, N, KV, page, hd_p = pool_k.shape
    if hd_p != hd or pool_v.shape != pool_k.shape:
        raise ValueError(f"pool shapes {tuple(pool_k.shape)}/"
                         f"{tuple(pool_v.shape)} do not match q head_dim {hd}")
    if KV < 1 or H % KV:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {KV}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be (B={B}, W); got "
                         f"{tuple(block_table.shape)}")
    for name, t in (("lengths", lengths), ("write_page", write_page),
                    ("write_offset", write_offset)):
        if t.shape != (B,):
            raise ValueError(f"{name} must be ({B},); got {tuple(t.shape)}")
    for name, t in (("cur_k", cur_k), ("cur_v", cur_v)):
        if t.shape != (B, KV, hd):
            raise ValueError(f"{name} must be ({B}, {KV}, {hd}); got "
                             f"{tuple(t.shape)}")
        if t.dtype != pool_k.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != pool dtype "
                             f"{pool_k.dtype}")
    if pool_v.dtype != pool_k.dtype:
        raise ValueError("pool_k and pool_v dtypes differ")
    devs = {t.device for t in (q, pool_k, pool_v, block_table, lengths,
                               cur_k, cur_v, write_page, write_offset)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must share one device; got {devs}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")


def _check_kernel_args(q, pool_k, pool_v, block_table, lengths, cur_k,
                       cur_v, write_page, write_offset) -> None:
    """What the CUDA kernel additionally requires; raises otherwise."""
    B, H, hd = q.shape
    _, _, KV, page, _ = pool_k.shape
    if not kernel_supported(page, H, KV, hd):
        raise ValueError(
            f"geometry H={H} KV={KV} hd={hd} page={page} is outside the "
            f"kernel gate (H % KV == 0, H/KV <= {MAX_GROUP}, "
            f"hd <= {MAX_HEAD_DIM}, page >= 1)")
    if q.dtype not in _KERNEL_DTYPES or q.dtype != pool_k.dtype:
        raise ValueError(f"kernel takes bfloat16 or float32 q and pools of "
                         f"one dtype; got q {q.dtype}, pool {pool_k.dtype}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("cur_k", cur_k), ("cur_v", cur_v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("block_table", block_table), ("lengths", lengths),
                    ("write_page", write_page),
                    ("write_offset", write_offset)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32; got {t.dtype}")
    if block_table.stride(1) != 1:
        raise ValueError("block_table rows must be contiguous (a column "
                         "slice of a wider table is fine)")
    for name, t in (("lengths", lengths), ("write_page", write_page),
                    ("write_offset", write_offset)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel():
    """The C entry point, built and loaded at first use."""
    global _fn
    if _fn is None:
        from ..kernels import build
        fn = build.load("paged_attention").paged_attention_decode
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 7 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_attention_decode(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, cur_k: torch.Tensor,
                           cur_v: torch.Tensor, write_page: torch.Tensor,
                           write_offset: torch.Tensor,
                           layer: int) -> torch.Tensor:
    """GQA decode attention + KV append over a paged pool, one query token
    per slot.

    q:            (B, H, hd)            current token's queries
    pool_k/v:     (L, N, KV, page, hd)  shared page pool, all layers;
                                        updated in place
    block_table:  (B, W) int32          physical page of each logical page
                                        (rows may be a column slice)
    lengths:      (B,) int32            cached tokens per slot (the current
                                        token is NOT in the pool)
    cur_k/cur_v:  (B, KV, hd)           current token's K/V, pool dtype
    write_page:   (B,) int32            physical page for the new row
                                        (page 0 = trash, inactive slots)
    write_offset: (B,) int32            row within that page
    layer:        int                   which layer to read and write
    Returns the attention output (B, H, hd) in q's dtype, scaled by
    1/sqrt(hd). CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise)."""
    _check_args(q, pool_k, pool_v, block_table, lengths, cur_k, cur_v,
                write_page, write_offset, layer)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(
            q, pool_k, pool_v, block_table, lengths, cur_k, cur_v,
            write_page, write_offset, layer)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel_args(q, pool_k, pool_v, block_table, lengths, cur_k,
                       cur_v, write_page, write_offset)
    B, H, hd = q.shape
    _, N, KV, page, _ = pool_k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), block_table.data_ptr(),
            block_table.stride(0), lengths.data_ptr(), cur_k.data_ptr(),
            cur_v.data_ptr(), write_page.data_ptr(), write_offset.data_ptr(),
            out.data_ptr(), B, KV, H // KV, hd, N, page, int(layer),
            hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_decode kernel launch failed "
                           f"with CUDA error {err}")
    paged_attention_decode.launches += 1
    return out


# Kernel launches since the count was last set to 0 (CPU calls don't count).
paged_attention_decode.launches = 0


def paged_attention_decode_plain(q, pool_k, pool_v, block_table, lengths,
                                 cur_k, cur_v, write_page, write_offset,
                                 layer: int) -> torch.Tensor:
    """Plain PyTorch version: the reference oracle's gather formulation
    (identical masking/softmax semantics, float32 math) followed by the
    in-place append of the current row."""
    B, H, hd = q.shape
    _, _, KV, page, _ = pool_k.shape
    W = block_table.shape[1]
    G = H // KV
    scale = hd ** -0.5
    tbl = block_table.long()
    kg = pool_k[layer][tbl].transpose(2, 3).reshape(B, W * page, KV, hd)
    vg = pool_v[layer][tbl].transpose(2, 3).reshape(B, W * page, KV, hd)
    qg = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, kg.float()) * scale
    tpos = torch.arange(W * page, device=q.device)[None, None, None, :]
    scores = torch.where(tpos < lengths[:, None, None, None], scores,
                         torch.full_like(scores, NEG))
    s_cur = torch.einsum("bkgd,bkd->bkg", qg, cur_k.float()) * scale
    probs = torch.softmax(torch.cat([scores, s_cur[..., None]], dim=-1),
                          dim=-1)
    vg_all = torch.cat([vg.float(), cur_v.float()[:, None]], dim=1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, vg_all)
    # The append lands after the reads (the row at `lengths` is masked
    # above anyway); inactive slots all write the trash page 0.
    pool_k[layer, write_page.long(), :, write_offset.long()] = cur_k
    pool_v[layer, write_page.long(), :, write_offset.long()] = cur_v
    return out.reshape(B, H, hd).to(q.dtype)
