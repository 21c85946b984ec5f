"""Pre-quantized checkpoint import: GPTQ and AWQ -> the port's group-wise
int4 leaves (a port of the reference's ``models/import_quantized.py``).

Both formats land in ``ops/quant.py``'s leaf layout, stacked over the
layers:

  GPTQ: w[k,n] = (u[k,n] - 1 - uz[g,n]) * s[g,n]   (int32-packed qweight,
        qzeros, fp16 scales)
        -> {"q4": u - 8 packed, "gscale": s, "gbias": (7 - uz) * s}
  AWQ:  y = (x * pre_s) @ W, W (out, in) in fp16 with per-group
        ``weight_quantizer._amax`` and ``input_quantizer._pre_quant_scale``
        -> {"q4": round(W^T / (amax / 8)) in [-8, 7], "gscale": amax / 8,
            "pre_scale": pre_s}

The arithmetic is the reference's, done with torch on the target device
one projection at a time (float32 division and half-to-even rounding, as
numpy does them), so both frameworks make the same bytes. Files are read
with the port's safetensors reader (``models/safetensors.py``) or, for
``.pt``/``.bin``, ``torch.load(weights_only=True, mmap=True)``; a
safetensors tensor is read block by block (``StoredTensor``). A GPTQ
checkpoint with a non-trivial ``g_idx`` (act-order) is refused with
``ModelLoadError``: honouring it needs a per-column group gather that
neither runtime implements.

Under tensor parallelism (``mesh``) a rank reads its block of each
projection's tensors in their stored layouts: an N block on whole int32
words of ``qzeros``, a K block on whole packed ``qweight`` words and
whole groups (else ``ConfigError`` naming the dims: llama-2-7b's F/4 =
2752 rows are not whole groups of 128). GPTQ's ``qweight`` becomes the
port's nibbles without an unpack (``gptq_q4``), a slab of rows at a
time, so a rank's device peak stays near its shard.
"""

from __future__ import annotations

import os
import re
from typing import Any, Iterator, Optional, Union

import torch

from ..parallel.mesh import Mesh
from ..parallel.sharding import block_index
from ..utils.device import resolve_device
from ..utils.errors import ConfigError, ModelLoadError
from .configs import LlamaConfig
from .llama import Params, projection_keys
from .safetensors import StoredTensor, iter_stored

# HF projection name -> the port's stacked key.
_PROJ_KEYS = {
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    "mlp.gate_proj": "w_gate",
    "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
}
_LAYER_RE = re.compile(r"layers\.(\d+)\.(.+)$")
# Packed qweight rows converted per slab (a slab of a 70B shard's w_down
# is 128 x 8192 words, 4 MiB).
_SLAB_ROWS = 128
# lm_head rows transposed per slab (2048 rows of 8192 bf16 are 32 MiB).
_HEAD_ROWS = 2048


def _iter_tensors(path: str) -> Iterator[tuple[str, Any]]:
    """(name, tensor) of every ``.safetensors``/``.pt``/``.bin`` file of a
    directory (or of one such file): a ``StoredTensor`` of a safetensors
    file, a memory-mapped tensor of the others."""
    if os.path.isdir(path):
        files = [os.path.join(path, n) for n in sorted(os.listdir(path))
                 if n.endswith((".safetensors", ".pt", ".bin"))]
    else:
        files = [path]
    if not files:
        raise ModelLoadError(f"no checkpoint tensors under {path}")
    for f in files:
        if f.endswith(".safetensors"):
            yield from iter_stored(f)
        else:
            yield from torch.load(f, map_location="cpu", weights_only=True,
                                  mmap=True).items()


def _whole(t: Any) -> torch.Tensor:
    """A tensor of ``_iter_tensors`` as a torch tensor (a stored one
    read whole)."""
    return t.read() if isinstance(t, StoredTensor) else t


def _unpack_nibbles(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """int32-packed uint4 -> uint8 (0..15), ``dim`` expanded by 8 (value j
    at bits 4j, the reference's order)."""
    p = packed.to(torch.int32)
    parts = [((p >> (4 * j)) & 0xF).to(torch.uint8) for j in range(8)]
    out = torch.stack(parts, dim=dim + 1)
    shape = list(p.shape)
    shape[dim] *= 8
    return out.reshape(shape)


def _pack_q4(q: torch.Tensor) -> torch.Tensor:
    """Signed int4 (K, N) int8 -> packed (K/2, N), even k in the low
    nibble (``ops/quant.py``'s layout)."""
    return (q[0::2] & 0x0F) | (q[1::2] << 4)


# XOR with this flips every nibble's top bit: u -> (u - 8) & 0xF.
_NIBBLE_SIGN = -0x77777778           # 0x88888888 as int32


def gptq_q4(qweight: torch.Tensor) -> torch.Tensor:
    """GPTQ's int32-packed uint4 ``qweight`` (K/8, N) -> the port's packed
    signed int4 (K/2, N) of ``q = u - 8``, without unpacking: a word holds
    k = 8r..8r+7 at bits 4j, so its byte m is the pair (8r + 2m, 8r + 2m +
    1) in ``_pack_q4``'s nibble order once each nibble's top bit flips
    (``(u - 8) & 0xF == u ^ 8``)."""
    w = (qweight.to(torch.int32) ^ _NIBBLE_SIGN).contiguous()
    n8, N = w.shape
    return (w.view(torch.uint8).view(n8, N, 4).permute(0, 2, 1)
            .reshape(n8 * 4, N).view(torch.int8))


def gptq_leaf(qweight: torch.Tensor, qzeros: torch.Tensor,
              scales: torch.Tensor) -> dict[str, torch.Tensor]:
    """One GPTQ triple -> ``{"q4", "gscale", "gbias"}`` on its device."""
    uz = _unpack_nibbles(qzeros, 1)                     # (G, N)
    s = scales.float()
    return {"q4": gptq_q4(qweight), "gscale": s,
            "gbias": (7.0 - uz.float()) * s}


def awq_leaf(weight: torch.Tensor, amax: torch.Tensor,
             pre_scale: torch.Tensor) -> dict[str, torch.Tensor]:
    """One AMMO-AWQ projection (weight (out, in)) -> ``{"q4", "gscale",
    "pre_scale"}`` on its device."""
    wT = weight.float().T                               # (K, N)
    K, N = wT.shape
    G = amax.numel() // N
    s = (amax.float().reshape(N, G).T / 8.0).clamp_min(1e-12)  # (G, N)
    q = torch.clamp(torch.round(wT / s.repeat_interleave(K // G, dim=0)),
                    -8, 7).to(torch.int8)
    return {"q4": _pack_q4(q), "gscale": s,
            "pre_scale": pre_scale.float().reshape(-1)}


def _check_g_idx(raw: dict[str, torch.Tensor]) -> None:
    for key in (k for k in raw if k.endswith(".g_idx")):
        g = raw[key].long()
        group = g.numel() // (int(g.max()) + 1) if g.numel() else 1
        want = torch.arange(g.numel()) // max(group, 1)
        if not torch.equal(g.cpu(), want):
            raise ModelLoadError(
                "GPTQ checkpoint uses act-order (non-trivial g_idx); "
                "reorder it with sequential groups before importing")


def _quant_block(fmt: str, t: dict, spec: tuple, mesh: Optional[Mesh],
                 name: str) -> dict:
    """This rank's block of one projection's checkpoint tensors, cut in
    their own layouts before anything is read (``t``: the projection's
    tensors by suffix; ``spec``: the port's (K, N) spec of the weight).
    An N block must fall on whole int32 words of the packed ``qzeros``;
    a K block on whole packed ``qweight`` words and whole groups, else
    ``ConfigError`` names the dims."""
    if fmt == "gptq":
        qw, qz, sc = t["qweight"], t["qzeros"], t["scales"]
        K, N, G = qw.shape[0] * 8, qw.shape[1], sc.shape[0]
    else:
        w = t["weight"]
        N, K = w.shape
        amax = _whole(t["weight_quantizer._amax"])
        G = amax.numel() // N
        amax = amax.reshape(N, G)
    kb, nb = block_index((K, N), spec, mesh)
    k0, k1, _ = kb.indices(K)
    n0, n1, _ = nb.indices(N)
    group = K // max(G, 1)
    if (k0, k1) != (0, K) and (k0 % group or (k1 - k0) % group
                               or k0 % 8):
        raise ConfigError(
            f"{name}: each rank's {k1 - k0} of K={K} rows are not a whole "
            f"number of the checkpoint's {group}-row groups; serve it at "
            f"another tp or requantize with a group that divides "
            f"{k1 - k0}")
    gb = slice(k0 // group, k1 // group)
    if fmt == "gptq":
        if (n0, n1) != (0, N) and (n0 % 8 or n1 % 8):
            raise ConfigError(f"{name}: each rank's N block [{n0}, {n1}) "
                              f"of {N} is not whole int32 words of qzeros")
        return {"qweight": qw[k0 // 8:k1 // 8, n0:n1],
                "qzeros": qz[gb, n0 // 8:n1 // 8], "scales": sc[gb, n0:n1]}
    return {"weight": w[n0:n1, k0:k1], "amax": amax[n0:n1, gb],
            "pre_scale": _whole(t["input_quantizer._pre_quant_scale"]
                                ).reshape(-1)[k0:k1]}


def load_quantized_checkpoint(path: str, cfg: LlamaConfig,
                              dtype: torch.dtype = torch.bfloat16,
                              device: Union[str, torch.device] = "cuda",
                              fmt: str = "",
                              mesh: Optional[Mesh] = None) -> Params:
    """A GPTQ or AWQ checkpoint as the port's parameter tree on
    ``device``: group-wise int4 leaves (int8 ``q4``, float32 scales)
    stacked over the layers; embeddings, norms and lm_head in ``dtype``.
    ``fmt`` ("gptq" or "awq") skips the sniffing when the caller already
    did it. Each stacked leaf is allocated once on the device and every
    layer's leaf converted there and copied into it. ``mesh``: this
    rank's shard only (``quantized_leaf_specs`` of each weight's spec),
    each tensor's block cut from the memory map before it is read; equal
    bit for bit to ``shard_params`` of the whole tree."""
    if cfg.num_experts:
        # The reference's GPTQ/AWQ importer is dense-only too.
        raise ConfigError(f"{path}: a mixture-of-experts geometry "
                          f"({cfg.num_experts} experts) has no GPTQ/AWQ "
                          f"import; load an HF checkpoint")
    from .import_hf import leaf_specs, sniff_quantized_format
    fmt = fmt or sniff_quantized_format(path)
    if fmt not in ("gptq", "awq"):
        raise ModelLoadError(f"{path}: neither GPTQ (.qweight) nor AWQ "
                             "(weight_quantizer._amax) tensors found")
    dev = resolve_device(device)
    L = cfg.num_layers
    specs = leaf_specs(cfg, mesh)
    wanted = set(projection_keys(cfg))
    stacks: dict[str, dict] = {}
    done: dict[str, set] = {k: set() for k in _PROJ_KEYS.values()
                            if k in wanted}
    norms: dict[str, Optional[torch.Tensor]] = {"attn_norm": None,
                                                "mlp_norm": None}
    norm_done: dict[str, set] = {k: set() for k in norms}
    top: dict[str, torch.Tensor] = {}

    def place(leaf: dict, ours: str, idx: int) -> None:
        if ours not in stacks:
            stacks[ours] = {k: torch.empty((L, *v.shape), dtype=v.dtype,
                                           device=dev)
                            for k, v in leaf.items()}
        for k, v in leaf.items():
            stacks[ours][k][idx].copy_(v)
        done[ours].add(idx)

    def place_gptq(b: dict, ours: str, idx: int) -> None:
        """A GPTQ block into its stack, ``qweight`` a slab of rows at a
        time: the device holds the tree and one slab's copies."""
        qw = b["qweight"]
        uz = _unpack_nibbles(b["qzeros"].to(dev), 1)
        s = b["scales"].to(dev).float()
        head = {"gscale": s, "gbias": (7.0 - uz.float()) * s}
        if ours not in stacks:
            stacks[ours] = {"q4": torch.empty(
                (L, 4 * qw.shape[0], qw.shape[1]), dtype=torch.int8,
                device=dev), **{k: torch.empty((L, *v.shape), dtype=v.dtype,
                                               device=dev)
                                for k, v in head.items()}}
        for k, v in head.items():
            stacks[ours][k][idx].copy_(v)
        q4 = stacks[ours]["q4"][idx]
        for r0 in range(0, qw.shape[0], _SLAB_ROWS):
            r1 = min(r0 + _SLAB_ROWS, qw.shape[0])
            q4[4 * r0:4 * r1].copy_(gptq_q4(qw[r0:r1].to(dev)))
        done[ours].add(idx)

    names = (("qweight", "qzeros", "scales") if fmt == "gptq" else
             ("weight", "weight_quantizer._amax",
              "input_quantizer._pre_quant_scale"))
    # Every block leaves for the device as soon as it is read. A
    # projection's tensors wait here (unread) until all of them were
    # seen: they may straddle two files.
    waiting: dict[tuple, dict] = {}
    D = cfg.hidden_size
    for key, t in _iter_tensors(path):
        key = key.removeprefix("model.")
        if key.endswith(".g_idx"):
            _check_g_idx({key: _whole(t)})
            continue
        if key == "embed_tokens.weight":
            top["embed"] = t[block_index(tuple(t.shape),
                                         specs.get("embed", ()), mesh)
                             ].to(device=dev, dtype=dtype)
        elif key == "norm.weight":
            top["final_norm"] = _whole(t).to(device=dev, dtype=dtype)
        elif key == "lm_head.weight":
            # Into a (D, V) leaf straight from the (V, D) rows, a slab of
            # rows at a time: no transposed copy of the whole on the
            # device or the host beside it.
            rows = t[block_index((D, t.shape[0]), specs.get("lm_head", ()),
                                 mesh)[::-1]]
            head = top["lm_head"] = torch.empty((D, rows.shape[0]),
                                                dtype=dtype, device=dev)
            for r0 in range(0, rows.shape[0], _HEAD_ROWS):
                head[:, r0:r0 + _HEAD_ROWS].copy_(
                    rows[r0:r0 + _HEAD_ROWS].T)
            del rows
        m = _LAYER_RE.match(key)
        if not m:
            continue
        idx, rest = int(m.group(1)), m.group(2)
        if idx >= L:
            raise ModelLoadError(f"{key}: layer {idx} is past the config's "
                                 f"{L} layers")
        for suffix, ours in (("input_layernorm.weight", "attn_norm"),
                             ("post_attention_layernorm.weight",
                              "mlp_norm")):
            if rest == suffix:
                if norms[ours] is None:
                    norms[ours] = torch.empty((L, D), dtype=dtype,
                                              device=dev)
                norms[ours][idx].copy_(_whole(t))
                norm_done[ours].add(idx)
        proj = next((p for p in _PROJ_KEYS if rest.startswith(p + ".")),
                    None)
        if proj is None or _PROJ_KEYS[proj] not in done:
            continue
        ours, name = _PROJ_KEYS[proj], rest[len(proj) + 1:]
        if name not in names:
            continue
        base = f"layers.{idx}.{proj}"
        group = waiting.setdefault((base, ours, idx), {})
        group[name] = t
        if len(group) < len(names):
            continue
        del waiting[(base, ours, idx)]
        b = _quant_block(fmt, group, specs.get(f"layers/{ours}",
                                               (None,) * 3)[1:],
                         mesh, f"{base} ({ours})")
        if fmt == "gptq":
            place_gptq(b, ours, idx)
        else:
            on = {k: v.to(dev) for k, v in b.items()}
            place(awq_leaf(on["weight"], on["amax"], on["pre_scale"]),
                  ours, idx)
            del on
        del b, group
    if waiting:
        (base, _, _), group = next(iter(waiting.items()))
        raise ModelLoadError(f"incomplete quantized checkpoint: {base} has "
                             f"no {sorted(set(names) - set(group))}")

    missing = [f"{k}[{i}]" for k, got in {**done, **norm_done}.items()
               for i in range(L) if i not in got]
    if missing or "embed" not in top or "final_norm" not in top:
        raise ModelLoadError(
            f"incomplete quantized checkpoint ({sorted(missing)[:5]}...)")
    layers: dict = dict(stacks)
    layers.update(norms)
    params: Params = {
        "embed": top["embed"],
        "layers": {k: layers[k] for k in ("attn_norm", "mlp_norm",
                                          *projection_keys(cfg))},
        "final_norm": top["final_norm"],
    }
    if "lm_head" in top:
        params["lm_head"] = top["lm_head"]
    elif not cfg.tie_word_embeddings:
        raise ModelLoadError("quantized checkpoint has no lm_head and the "
                             "config does not tie embeddings")
    return params
