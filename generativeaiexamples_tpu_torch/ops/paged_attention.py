"""Paged GQA decode attention + KV append: the Hopper kernel's wrapper and
its plain PyTorch versions.

``paged_attention_decode`` replaces the reference's Pallas kernels
(``generativeaiexamples_tpu/ops/paged_attention.py``
``paged_attention_decode`` and, when the scale pools are given,
``_paged_attention_decode_quant``). On a CUDA tensor it launches the
hand-written kernels in ``csrc/paged_attention.cu`` (built at first use
by ``kernels/build.py``) or raises: a split pass over S splits of R rows
of each slot (``split_plan``, from static shapes) into an fp32 scratch,
then a merge pass that folds the current token in and appends it. It
takes a plain version only for CPU tensors.
``paged_attention_decode_plain`` mirrors the reference's
``paged_attention_decode_reference`` plus the append;
``paged_attention_decode_quant_plain`` runs the same attention over
windows dequantized by ``kv_quant.dequantize_rows`` (the reference's
``_gathered_window``) and appends ``kv_quant.quantize_rows`` of the
current row. The CPU tests use them, and the card check compares the
kernel with them.

The pools are updated IN PLACE (the reference aliased them through the
pallas_call and threaded them through its layer scan carry).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .kv_quant import SCALE_DTYPE, dequantize_rows, quantize_rows

NEG = -1e30

# Kernel gate on Hopper (the TPU gate of 128-aligned head_dim/page is a
# Mosaic tiling rule and does not apply): G query heads per kv head live
# in registers (G <= 8), a row spreads over at most 32 lanes of up to 8
# elements (16 for int8 rows at G = 1), so hd <= 256; GQA needs
# H % KV == 0. Any page >= 1 and any hd in range: a row that is not a
# multiple of 16 bytes takes narrower loads. The int8-pool path has the
# same gate.
MAX_GROUP = 8
MAX_HEAD_DIM = 256
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# Split plan: a split is at least MIN_SPLIT_ROWS rows (whole pages), and
# the split pass's grid holds at most about MAX_SPLIT_BLOCKS blocks.
MIN_SPLIT_ROWS = 256
MAX_SPLIT_BLOCKS = 16384

_fns: dict[str, object] = {}


def kernel_supported(page: int, num_heads: int, num_kv_heads: int,
                     head_dim: int) -> bool:
    """Whether the Hopper kernel accepts this geometry."""
    return (page >= 1 and num_kv_heads > 0
            and num_heads % num_kv_heads == 0
            and 1 <= num_heads // num_kv_heads <= MAX_GROUP
            and 1 <= head_dim <= MAX_HEAD_DIM)


def split_plan(width: int, page: int, batch: int,
               kv_heads: int) -> tuple[int, int]:
    """(R, S): rows per split and split count of the kernel's split pass,
    from static shapes only (the block table's width in pages, the page
    size, slots, kv heads), never from ``lengths``, so a launch needs no
    host read. R is a multiple of ``page`` and at least MIN_SPLIT_ROWS;
    it grows past that only to keep S * batch * kv_heads near
    MAX_SPLIT_BLOCKS. S = ceil(width * page / R) >= 1, so the S splits
    cover every row the table can address."""
    max_splits = max(1, MAX_SPLIT_BLOCKS // max(1, batch * kv_heads))
    pages = max(-(-MIN_SPLIT_ROWS // page), -(-width // max_splits), 1)
    rows = pages * page
    return rows, max(1, -(-width * page // rows))


def _check_args(q, pool_k, pool_v, block_table, lengths, cur_k, cur_v,
                write_page, write_offset, layer, pool_ks, pool_vs) -> None:
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
    if pool_v.dtype != pool_k.dtype:
        raise ValueError("pool_k and pool_v dtypes differ")
    quant = pool_ks is not None
    if quant != (pool_vs is not None):
        raise ValueError("pass both scale pools (pool_ks, pool_vs) or none")
    if not quant and pool_k.dtype == torch.int8:
        raise ValueError("int8 pools need their scale pools")
    # Under int8 pools the current K/V come in q's dtype (the append
    # quantizes them); otherwise in the pool dtype.
    cur_dtype = q.dtype if quant else pool_k.dtype
    for name, t in (("cur_k", cur_k), ("cur_v", cur_v)):
        if t.shape != (B, KV, hd):
            raise ValueError(f"{name} must be ({B}, {KV}, {hd}); got "
                             f"{tuple(t.shape)}")
        if t.dtype != cur_dtype:
            raise ValueError(f"{name} dtype {t.dtype} != {cur_dtype}")
    tensors = [q, pool_k, pool_v, block_table, lengths, cur_k, cur_v,
               write_page, write_offset]
    if quant:
        if pool_k.dtype != torch.int8:
            raise ValueError(f"scale pools need int8 pools; got "
                             f"{pool_k.dtype}")
        for name, t in (("pool_ks", pool_ks), ("pool_vs", pool_vs)):
            if t.shape != (L, N, KV, page) or t.dtype != SCALE_DTYPE:
                raise ValueError(f"{name} must be {SCALE_DTYPE} "
                                 f"{(L, N, KV, page)}; got {t.dtype} "
                                 f"{tuple(t.shape)}")
        tensors += [pool_ks, pool_vs]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"all tensors must share one device; got {devs}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")


def _check_kernel_args(q, pool_k, pool_v, block_table, lengths, cur_k,
                       cur_v, write_page, write_offset, pool_ks,
                       pool_vs) -> None:
    """What the CUDA kernel additionally requires; raises otherwise."""
    B, H, hd = q.shape
    _, _, KV, page, _ = pool_k.shape
    if not kernel_supported(page, H, KV, hd):
        raise ValueError(
            f"geometry H={H} KV={KV} hd={hd} page={page} is outside the "
            f"kernel gate (H % KV == 0, H/KV <= {MAX_GROUP}, "
            f"hd <= {MAX_HEAD_DIM}, page >= 1)")
    quant = pool_ks is not None
    if q.dtype not in _KERNEL_DTYPES or not (quant or q.dtype == pool_k.dtype):
        raise ValueError(f"kernel takes bfloat16 or float32 q and pools of "
                         f"q's dtype or int8; got q {q.dtype}, pool "
                         f"{pool_k.dtype}")
    named = [("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
             ("cur_k", cur_k), ("cur_v", cur_v), ("lengths", lengths),
             ("write_page", write_page), ("write_offset", write_offset)]
    if quant:
        named += [("pool_ks", pool_ks), ("pool_vs", pool_vs)]
    for name, t in named:
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


def _kernel(quant: bool):
    """The C entry point (full-precision or int8 pools), built and loaded
    at first use."""
    name = "paged_attention_decode_int8" if quant else "paged_attention_decode"
    fn = _fns.get(name)
    if fn is None:
        from ..kernels import build
        fn = getattr(build.load("paged_attention"), name)
        n_pools = 4 if quant else 2
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (1 + n_pools + 1)
                       + [ctypes.c_longlong] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 9 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def paged_attention_decode(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, cur_k: torch.Tensor,
                           cur_v: torch.Tensor, write_page: torch.Tensor,
                           write_offset: torch.Tensor, layer: int, *,
                           pool_ks: Optional[torch.Tensor] = None,
                           pool_vs: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """GQA decode attention + KV append over a paged pool, one query token
    per slot.

    q:            (B, H, hd)            current token's queries
    pool_k/v:     (L, N, KV, page, hd)  shared page pool, all layers;
                                        updated in place
    block_table:  (B, W) int32          physical page of each logical page
                                        (rows may be a column slice)
    lengths:      (B,) int32            cached tokens per slot (the current
                                        token is NOT in the pool)
    cur_k/cur_v:  (B, KV, hd)           current token's K/V: pool dtype, or
                                        q's dtype under int8 pools (the
                                        append quantizes them)
    write_page:   (B,) int32            physical page for the new row
                                        (page 0 = trash, inactive slots)
    write_offset: (B,) int32            row within that page
    layer:        int                   which layer to read and write
    pool_ks/vs:   (L, N, KV, page) bf16 OPTIONAL per-row scales: their
                                        presence switches to int8 pools
                                        (``ops/kv_quant.py``); the append
                                        writes the new row's scale
    Returns the attention output (B, H, hd) in q's dtype, scaled by
    1/sqrt(hd). CPU tensors take a plain version; CUDA tensors launch
    the kernels (or raise). One call counts one launch, whatever number
    of CUDA kernels it starts: the int8 path in
    ``paged_attention_decode.int8_launches``, the other in ``.launches``."""
    _check_args(q, pool_k, pool_v, block_table, lengths, cur_k, cur_v,
                write_page, write_offset, layer, pool_ks, pool_vs)
    quant = pool_ks is not None
    if q.device.type == "cpu":
        if quant:
            return paged_attention_decode_quant_plain(
                q, pool_k, pool_v, block_table, lengths, cur_k, cur_v,
                write_page, write_offset, layer, pool_ks=pool_ks,
                pool_vs=pool_vs)
        return paged_attention_decode_plain(
            q, pool_k, pool_v, block_table, lengths, cur_k, cur_v,
            write_page, write_offset, layer)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel_args(q, pool_k, pool_v, block_table, lengths, cur_k,
                       cur_v, write_page, write_offset, pool_ks, pool_vs)
    B, H, hd = q.shape
    _, N, KV, page, _ = pool_k.shape
    G = H // KV
    rows, splits = split_plan(block_table.shape[1], page, B, KV)
    out = torch.empty_like(q)
    # Per call, from the current stream's caching allocator: another
    # stream never gets it, and a later call on this stream reuses it only
    # after this call's kernels in stream order.
    scratch = torch.empty(B * splits * KV * G * (hd + 2),
                          dtype=torch.float32, device=q.device)
    pools = [pool_k.data_ptr(), pool_v.data_ptr()]
    if quant:
        pools += [pool_ks.data_ptr(), pool_vs.data_ptr()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(quant)(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), *pools,
            block_table.data_ptr(), block_table.stride(0),
            lengths.data_ptr(), cur_k.data_ptr(), cur_v.data_ptr(),
            write_page.data_ptr(), write_offset.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, KV, G, hd, N, page, int(layer), rows,
            splits, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_decode kernel launch failed "
                           f"with CUDA error {err}")
    if quant:
        paged_attention_decode.int8_launches += 1
    else:
        paged_attention_decode.launches += 1
    return out


# Kernel launches since the counts were last set to 0, full-precision and
# int8 pools apart (CPU calls don't count).
paged_attention_decode.launches = 0
paged_attention_decode.int8_launches = 0


def _attend_plain(q, kg, vg, lengths, cur_k, cur_v) -> torch.Tensor:
    """The reference oracle's gather formulation over float32 windows
    kg/vg (B, W, KV, page, hd): masking, softmax with the current token
    folded in, float32 math. Returns (B, H, hd) float32."""
    B, H, hd = q.shape
    _, W, KV, page, _ = kg.shape
    G = H // KV
    scale = hd ** -0.5
    kg = kg.transpose(2, 3).reshape(B, W * page, KV, hd)
    vg = vg.transpose(2, 3).reshape(B, W * page, KV, hd)
    qg = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, kg) * scale
    tpos = torch.arange(W * page, device=q.device)[None, None, None, :]
    scores = torch.where(tpos < lengths[:, None, None, None], scores,
                         torch.full_like(scores, NEG))
    s_cur = torch.einsum("bkgd,bkd->bkg", qg, cur_k.float()) * scale
    probs = torch.softmax(torch.cat([scores, s_cur[..., None]], dim=-1),
                          dim=-1)
    vg_all = torch.cat([vg, cur_v.float()[:, None]], dim=1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, vg_all)
    return out.reshape(B, H, hd)


def paged_attention_decode_plain(q, pool_k, pool_v, block_table, lengths,
                                 cur_k, cur_v, write_page, write_offset,
                                 layer: int) -> torch.Tensor:
    """Plain PyTorch version over full-precision pools: the reference
    oracle's gather formulation followed by the in-place append of the
    current row."""
    tbl = block_table.long()
    out = _attend_plain(q, pool_k[layer][tbl].float(),
                        pool_v[layer][tbl].float(), lengths, cur_k, cur_v)
    # The append lands after the reads (the row at `lengths` is masked
    # above anyway); inactive slots all write the trash page 0.
    pool_k[layer, write_page.long(), :, write_offset.long()] = cur_k
    pool_v[layer, write_page.long(), :, write_offset.long()] = cur_v
    return out.to(q.dtype)


def paged_attention_decode_quant_plain(q, pool_k, pool_v, block_table,
                                       lengths, cur_k, cur_v, write_page,
                                       write_offset, layer: int, *,
                                       pool_ks: torch.Tensor,
                                       pool_vs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version over int8 pools: the same attention over
    windows dequantized to float32 by ``dequantize_rows`` (the current
    token folds in unquantized), then the append of ``quantize_rows`` of
    cur_k/cur_v and their scales at (layer, write_page, :, write_offset).
    No other pool or scale byte changes."""
    tbl = block_table.long()
    kg = dequantize_rows(pool_k[layer][tbl], pool_ks[layer][tbl],
                         torch.float32)
    vg = dequantize_rows(pool_v[layer][tbl], pool_vs[layer][tbl],
                         torch.float32)
    out = _attend_plain(q, kg, vg, lengths, cur_k, cur_v)
    wp, off = write_page.long(), write_offset.long()
    for pool, scales, cur in ((pool_k, pool_ks, cur_k),
                              (pool_v, pool_vs, cur_v)):
        rows, s = quantize_rows(cur)
        pool[layer, wp, :, off] = rows
        scales[layer, wp, :, off] = s
    return out.to(q.dtype)
