"""Packed-int4 matmul: the Hopper kernel's wrapper and its plain PyTorch
version.

``int4_matmul`` replaces the reference's Pallas kernel
(``generativeaiexamples_tpu/ops/int4_matmul.py`` ``int4_matmul``): it
computes ``x @ unpack(q4) * scale`` without materializing the unpacked
weight. On a CUDA tensor it launches one of the four paths of
``csrc/int4_matmul.cu`` (built at first use by ``kernels/build.py``), the
one ``_path`` names from the shape and x's dtype, or raises; it takes the
plain version only for CPU tensors. The paths:

- ``"tc"``: decode (M <= 8) with bfloat16 x, on tensor cores;
- ``"gemv"``: decode with float32 x (or a bf16 shape the tensor-core
  path refuses), split-K fp32 on CUDA cores;
- ``"wg"``: prefill (M > 8) with bfloat16 x, on warpgroup tensor cores
  (wgmma, TMA-fed);
- ``"tile"``: everything else (float32 x at M > 8, or a bf16 shape the
  tensor-core paths refuse), a tiled fp32 product.

GPTQ's zero points (``gbias``, (G, N) float32 beside grouped scales) add
``sum_g (sum_{k in g} x[m, k]) * gbias[g, n]``; the tensor-core paths
("tc", "wg") add it per stage inside the kernel, and the float32 paths
("gemv", "tile") refuse it with ``ConfigError`` (the engine refuses such
a leaf on the card unless it lands on a tensor-core path).

Each launch adds one to ``int4_matmul.launches`` and to its path's entry
of ``int4_matmul.launches_by_path`` (and a launch with ``gbias`` to
``int4_matmul.gbias_launches``).

Under autograd (QLoRA: a frozen int4 base under trainable adapters)
``int4_matmul_grad`` runs the same forward inside a
``torch.autograd.Function`` whose backward gives ``dx`` only (the weights
are frozen): ``dy @ (unpack(q4) * scale [+ gbias per group])^T``. The
reference has no backward kernel (XLA differentiates its
``_grouped_matmul``), so on the card the backward dequantizes the weight
into a bf16 transient and runs one cuBLAS product with float32
accumulation (``int4_matmul_dx``, counted in
``int4_matmul.backward_launches``). ``int4_matmul_plain`` unpacks the
nibbles and computes what ``ops/quant.py``'s XLA-style branches compute:
a float32 dot with the per-channel scale after it, or per-group float32
partial dots times their scales (``_grouped_matmul``). Every path sums in
float32 too (the tensor-core paths multiply bf16 x by weights that are
exact in bf16), so the kernel is held to the plain version, not to the
reference kernel's bf16 rounding of each dequantized weight.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.errors import ConfigError

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_INT32_MAX = 2 ** 31 - 1
# Path codes of the C entry point.
_PATHS = {"tc": 0, "gemv": 1, "tile": 2, "wg": 3}
# The "gemv" path's split-K scratch (csrc/int4_matmul.cu): up to 16 fp32
# partials of an (M <= 8, N) output, and one counter per 128-column tile.
# The kernel leaves the counters at 0. (The "tc" path reduces within a
# thread-block cluster and needs none.)
_MAX_SPLIT, _DECODE_MAX_M, _GEMV_COLS = 16, 8, 128
# The tensor-core paths' groups ("tc", "wg"): a multiple of this many
# reduction rows (their 128-row stages then lie in one group each).
_TC_GROUP = 128

_fn = None
# (device, stream handle) -> (workspace, counters).
_scratch: dict[tuple[torch.device, int],
               tuple[torch.Tensor, torch.Tensor]] = {}


def _gemv_scratch(device: torch.device, stream: int, N: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The stream's (workspace, counters), grown to fit N columns.
    Launches on one stream are ordered, so one pair per (device, stream)
    serves them all; launches on two streams may overlap, and each gets
    its own pair, since the kernel's last-block reduction and counter
    reset assume no other launch uses the pair meanwhile. PyTorch takes
    its streams from a fixed pool, so the pairs are few."""
    floats = _MAX_SPLIT * _DECODE_MAX_M * N
    tiles = -(-N // _GEMV_COLS)
    ws, counters = _scratch.get((device, stream), (None, None))
    if ws is None or ws.numel() < floats or counters.numel() < tiles:
        ws = torch.empty(max(floats, 0 if ws is None else ws.numel()),
                         dtype=torch.float32, device=device)
        counters = torch.zeros(max(tiles, 0 if counters is None
                                   else counters.numel()),
                               dtype=torch.int32, device=device)
        _scratch[(device, stream)] = (ws, counters)
    return ws, counters


def supported(K: int, N: int, group_size: int = 0) -> bool:
    """Whether the Hopper kernel accepts this geometry: an even reduction
    dim (nibble pairs) and, for grouped scales, a group size that divides
    it. The TPU gate ``K % 256 == 0 and N % 128 == 0`` is a Mosaic tiling
    rule and does not apply."""
    if K < 2 or K % 2 or N < 1:
        return False
    return group_size == 0 or (group_size > 0 and K % group_size == 0)


def _path(M: int, K: int, N: int, group: int, x_dtype: torch.dtype) -> str:
    """The kernel path for an (M, K) x (K, N) product with scales per
    ``group`` reduction rows (``group == K``: per channel). bf16 x goes to
    the tensor cores when k16 steps tile K (``K % 16 == 0``), 16-byte
    copies tile a q4 row (``N % 16 == 0``) and the scales are per channel
    or per groups of a multiple of 128 rows: ``"tc"`` for decode shapes
    (M <= 8), ``"wg"`` above. Other decode shapes go to the fp32 GEMV
    (float32 x keeps full precision: tensor cores would round it to TF32),
    which needs ``N % 4 == 0`` and an even group; the rest to the tiled
    path, which takes any shape."""
    on_tc = tensor_cores(K, N, group, x_dtype)
    if M > _DECODE_MAX_M:
        return "wg" if on_tc else "tile"
    if on_tc:
        return "tc"
    if N % 4 == 0 and group % 2 == 0:
        return "gemv"
    return "tile"


def tensor_cores(K: int, N: int, group: int, x_dtype: torch.dtype) -> bool:
    """Whether ``_path`` sends this geometry to a tensor-core path ("tc"
    at M <= 8, "wg" above) at every M: the paths that apply ``gbias``."""
    return (x_dtype == torch.bfloat16 and K % 16 == 0 and N % 16 == 0
            and (group == K or group % _TC_GROUP == 0))


def _check_args(x, q4, scale, out_dtype) -> None:
    if q4.dim() != 2 or q4.dtype != torch.int8:
        raise ValueError(f"q4 must be (K/2, N) int8; got {tuple(q4.shape)} "
                         f"{q4.dtype}")
    K2, N = q4.shape
    if x.dim() < 1 or x.shape[-1] != 2 * K2:
        raise ValueError(f"x {tuple(x.shape)} does not match q4 "
                         f"{tuple(q4.shape)} (K = 2 * K/2)")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32; got {scale.dtype}")
    if scale.dim() == 1:
        if scale.shape[0] != N:
            raise ValueError(f"per-channel scale {tuple(scale.shape)} != "
                             f"({N},)")
    elif scale.dim() == 2:
        G = scale.shape[0]
        if scale.shape[1] != N or G < 1 or (2 * K2) % G:
            raise ValueError(f"group scale {tuple(scale.shape)} does not "
                             f"divide K = {2 * K2} into groups of N = {N}")
    else:
        raise ValueError(f"scale must be (N,) or (G, N); got "
                         f"{tuple(scale.shape)}")
    if out_dtype is not None and out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"out_dtype must be bfloat16 or float32; got "
                         f"{out_dtype}")
    if len({x.device, q4.device, scale.device}) != 1:
        raise ValueError("x, q4 and scale must share one device")


def _strides(q4: torch.Tensor, scale: torch.Tensor, path: str
             ) -> tuple[int, int]:
    """The row strides the C entry point takes: q4's in bytes, a (G, N)
    scale's in floats (N for a per-channel scale). Columns must be
    packed; the tensor-core paths load 16-byte pieces of each row, so
    there both strides must keep rows 16-byte aligned, and the "gemv"
    path loads 4-byte words of q4. A sliced operand outside that raises
    (a whole weight's shape is the C entry point's to refuse): the
    wrapper never copies a weight."""
    N = q4.shape[1]
    if q4.stride(1) != 1 or scale.stride(-1) != 1:
        raise ValueError("q4 and scale need packed columns (stride 1); got "
                         f"strides {q4.stride()} and {scale.stride()}")
    ldq = q4.stride(0) if q4.shape[0] > 1 else N
    lds = scale.stride(0) if scale.dim() == 2 and scale.shape[0] > 1 else N
    align = {"tc": 16, "wg": 16, "gemv": 4}.get(path, 1)
    if (ldq != N and ldq % align) or (align == 16 and lds != N
                                        and lds % 4):
        raise ValueError(f"the {path!r} path needs q4 rows {align}-byte "
                         f"aligned (row stride {ldq}) and, on tensor cores, "
                         f"scale rows 16-byte aligned (row stride {lds})")
    return ldq, lds


def _kernel():
    """The C entry point, built and loaded at first use."""
    global _fn
    if _fn is None:
        from ..kernels import build
        fn = build.load("int4_matmul").int4_matmul
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                       + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_gbias(gbias: torch.Tensor, scale: torch.Tensor) -> None:
    """GPTQ zero points sit beside grouped scales: the same (G, N) float32
    shape, device and row stride (a vocab slice of both is read at the
    scales' stride)."""
    if scale.dim() != 2:
        raise ValueError("gbias needs grouped (G, N) scales")
    if (gbias.shape != scale.shape or gbias.dtype != torch.float32
            or gbias.device != scale.device):
        raise ValueError(f"gbias {tuple(gbias.shape)} {gbias.dtype} must "
                         f"match the float32 scales {tuple(scale.shape)}")
    if gbias.stride(-1) != 1 or (scale.shape[0] > 1
                                 and gbias.stride(0) != scale.stride(0)):
        raise ValueError(f"gbias strides {gbias.stride()} differ from the "
                         f"scales' {scale.stride()}")


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor, *,
                gbias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ unpack(q4) * scale`` without materializing the unpacked
    weight.

    x:         (..., K) bfloat16 or float32 activations
    q4:        (K/2, N) int8 nibble pairs (``ops/quant.py`` packing:
               row 2r in the low nibble, row 2r+1 in the high one)
    scale:     (N,) per-output-channel, or (G, N) per group of K/G
               reduction rows (AWQ), float32
    gbias:     optional (G, N) float32 GPTQ zero points beside grouped
               scales: adds ``sum_g (sum_{k in g} x[m, k]) * gbias[g, n]``
    q4 and a (G, N) scale (and gbias) may be column slices of wider
    tensors (an lm_head vocab tile): their rows are read in place at
    their stride, never copied. A stride the launched path cannot take
    raises.
    out_dtype: bfloat16 or float32 (default: x's dtype)
    Returns (..., N). CPU tensors take the plain version; CUDA tensors
    launch the kernel path ``_path`` names (or raise). Only the
    tensor-core paths apply ``gbias``: on "gemv" or "tile" it raises
    ``ConfigError``."""
    _check_args(x, q4, scale, out_dtype)
    if gbias is not None:
        _check_gbias(gbias, scale)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scale, gbias=gbias,
                                 out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    K2, N = q4.shape
    K = 2 * K2
    G = scale.shape[0] if scale.dim() == 2 else 1
    if not supported(K, N, K // G if scale.dim() == 2 else 0):
        raise ValueError(f"geometry K={K} N={N} groups={G} is outside the "
                         f"kernel gate (even K, a group dividing K)")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes bfloat16 or float32 x; got {x.dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out_dtype = out_dtype or x.dtype
    # The kernel indexes with 32-bit offsets.
    if max(M * K, K2 * N, M * N, G * N) > _INT32_MAX:
        raise ValueError(f"M={M} K={K} N={N} overflows the kernel's 32-bit "
                         f"offsets")
    path = _path(M, K, N, K // G, x.dtype)
    if gbias is not None and path not in ("tc", "wg"):
        raise ConfigError(f"GPTQ zero points (gbias) run on the tensor-core "
                          f"paths only (bfloat16 x, K and N multiples of 16, "
                          f"groups of a multiple of {_TC_GROUP}); this call "
                          f"takes {path!r}")
    ldq, lds = _strides(q4, scale, path)
    if path != "tile":
        # The "gemv" path loads q4 as 4-byte words; the tensor-core paths
        # copy 16-byte pieces of q4, x and the scales ("wg" by TMA, which
        # needs 16-byte aligned tensors). x is realigned; a weight or its
        # scales are not copied.
        on_tc = path in ("tc", "wg")
        align = 16 if on_tc else 4
        if q4.data_ptr() % align or (on_tc and (
                scale.data_ptr() % 16 or (gbias is not None
                                          and gbias.data_ptr() % 16))):
            raise ValueError(f"the {path!r} path needs q4 (and, on tensor "
                             f"cores, the scales) on a {align}-byte "
                             f"boundary")
        if x2.data_ptr() % 16:
            x2 = x2.clone()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            ws = counters = None
            if path == "gemv":
                ws, counters = _gemv_scratch(x.device, stream, N)
            err = _kernel()(
                _PATHS[path], _KERNEL_DTYPES[x.dtype],
                _KERNEL_DTYPES[out_dtype], x2.data_ptr(), q4.data_ptr(),
                scale.data_ptr(),
                gbias.data_ptr() if gbias is not None else None,
                out.data_ptr(),
                ws.data_ptr() if ws is not None else None,
                ws.numel() if ws is not None else 0,
                counters.data_ptr() if counters is not None else None,
                counters.numel() if counters is not None else 0,
                M, K, N, K // G, ldq, lds, stream)
        if err != 0:
            raise RuntimeError(f"int4_matmul {path!r} path launch failed "
                               f"with CUDA error {err}")
        int4_matmul.launches += 1
        int4_matmul.launches_by_path[path] += 1
        if gbias is not None:
            int4_matmul.gbias_launches += 1
    return out.reshape(*lead, N)


# Kernel launches since the count was last set to 0, in all, by path and
# with zero points, and backward products on the card (CPU calls don't
# count).
int4_matmul.launches = 0
int4_matmul.launches_by_path = {path: 0 for path in _PATHS}
int4_matmul.gbias_launches = 0
int4_matmul.backward_launches = 0


def int4_matmul_dx(dy: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                   *, gbias: Optional[torch.Tensor] = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The input gradient of ``int4_matmul``: ``dy (..., N) @ W^T`` with W
    = ``unpack(q4) * scale`` (+ the group's ``gbias``), in ``dtype``
    (x's). No AWQ ``pre_scale`` is folded in: that multiplies the inputs
    before the kernel, and autograd differentiates it there. For bf16
    ``dy`` on the card W is dequantized into a bf16 transient (``q *
    scale`` rounded once; the stated bf16 tolerances of the checks cover
    it) and one cuBLAS product sums in float32 with a float32 result;
    otherwise W is float32 and so is the product. Counted in
    ``int4_matmul.backward_launches`` on the card."""
    from .quant import _mm_f32, dequantize
    if dy.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dy.device}")
    leaf = {"q4": q4, "gscale" if scale.dim() == 2 else "scale": scale}
    if gbias is not None:
        leaf["gbias"] = gbias
    d2 = dy.reshape(-1, q4.shape[1])
    if dy.is_cuda and dy.dtype == torch.bfloat16:
        dx = _mm_f32(d2, dequantize(leaf, torch.bfloat16).T)
    else:
        dx = d2.float() @ dequantize(leaf, torch.float32).T
    if dy.is_cuda:
        int4_matmul.backward_launches += 1
    return dx.to(dtype).reshape(*dy.shape[:-1], 2 * q4.shape[0])


class _Int4MatmulFn(torch.autograd.Function):
    """``int4_matmul`` with a backward for ``x``; q4, scale and gbias are
    frozen and get no gradient."""

    @staticmethod
    def forward(ctx, x, q4, scale, gbias, out_dtype):
        ctx.save_for_backward(q4, scale, gbias)
        ctx.x_dtype = x.dtype
        return int4_matmul(x, q4, scale, gbias=gbias, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        q4, scale, gbias = ctx.saved_tensors
        dx = int4_matmul_dx(dy, q4, scale, gbias=gbias, dtype=ctx.x_dtype)
        return dx, None, None, None, None


def int4_matmul_grad(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                     *, gbias: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """``int4_matmul`` that autograd differentiates with respect to ``x``
    (the forward is the same call: the kernel on the card, the plain
    version on the CPU). The weight leaves must not require grad: a
    quantized base is frozen."""
    if any(t is not None and t.requires_grad for t in (q4, scale, gbias)):
        raise ValueError("int4 weights are frozen: q4, scale and gbias must "
                         "not require grad")
    return _Int4MatmulFn.apply(x, q4, scale, gbias, out_dtype)


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                      *, gbias: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Plain PyTorch version: unpack, then a float32 dot with the
    per-channel scale after it, or per-group float32 partial dots times
    their scales plus the zero-point term (``quant._grouped_matmul``)."""
    from .quant import _dot_f32, _grouped_matmul, _unpack4
    q = _unpack4(q4)
    if scale.dim() == 2:
        w = {"gscale": scale}
        if gbias is not None:
            w["gbias"] = gbias
        return _grouped_matmul(x, q, w, out_dtype=out_dtype)
    return (_dot_f32(x, q) * scale).to(out_dtype or x.dtype)
