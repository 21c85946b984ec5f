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
``.pt``/``.bin``, ``torch.load(weights_only=True, mmap=True)``. A GPTQ
checkpoint with a non-trivial ``g_idx`` (act-order) is refused with
``ModelLoadError``: honouring it needs a per-column group gather that
neither runtime implements.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, Union

import torch

from ..utils.device import resolve_device
from ..utils.errors import ConfigError, ModelLoadError
from .configs import LlamaConfig
from .llama import Params, projection_keys
from .safetensors import iter_file

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


def _iter_tensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, tensor) of every ``.safetensors``/``.pt``/``.bin`` file of a
    directory (or of one such file), memory-mapped."""
    if os.path.isdir(path):
        files = [os.path.join(path, n) for n in sorted(os.listdir(path))
                 if n.endswith((".safetensors", ".pt", ".bin"))]
    else:
        files = [path]
    if not files:
        raise ModelLoadError(f"no checkpoint tensors under {path}")
    for f in files:
        if f.endswith(".safetensors"):
            yield from iter_file(f)
        else:
            yield from torch.load(f, map_location="cpu", weights_only=True,
                                  mmap=True).items()


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


def gptq_leaf(qweight: torch.Tensor, qzeros: torch.Tensor,
              scales: torch.Tensor) -> dict[str, torch.Tensor]:
    """One GPTQ triple -> ``{"q4", "gscale", "gbias"}`` on its device."""
    u = _unpack_nibbles(qweight, 0)                     # (K, N) 0..15
    q = u.to(torch.int8) - 8
    uz = _unpack_nibbles(qzeros, 1)                     # (G, N)
    s = scales.float()
    return {"q4": _pack_q4(q), "gscale": s,
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


def load_quantized_checkpoint(path: str, cfg: LlamaConfig,
                              dtype: torch.dtype = torch.bfloat16,
                              device: Union[str, torch.device] = "cuda",
                              fmt: str = "") -> Params:
    """A GPTQ or AWQ checkpoint as the port's parameter tree on
    ``device``: group-wise int4 leaves (int8 ``q4``, float32 scales)
    stacked over the layers; embeddings, norms and lm_head in ``dtype``.
    ``fmt`` ("gptq" or "awq") skips the sniffing when the caller already
    did it."""
    if cfg.num_experts:
        # The reference's GPTQ/AWQ importer is dense-only too.
        raise ConfigError(f"{path}: a mixture-of-experts geometry "
                          f"({cfg.num_experts} experts) has no GPTQ/AWQ "
                          f"import; load an HF checkpoint")
    from .import_hf import sniff_quantized_format
    fmt = fmt or sniff_quantized_format(path)
    if fmt not in ("gptq", "awq"):
        raise ModelLoadError(f"{path}: neither GPTQ (.qweight) nor AWQ "
                             "(weight_quantizer._amax) tensors found")
    dev = resolve_device(device)
    L = cfg.num_layers
    raw = {key.removeprefix("model."): t for key, t in _iter_tensors(path)}
    _check_g_idx(raw)
    wanted = set(projection_keys(cfg))
    layer_acc: dict[str, list] = {ours: [None] * L
                                  for ours in _PROJ_KEYS.values()
                                  if ours in wanted}
    norms: dict[str, list] = {"attn_norm": [None] * L,
                              "mlp_norm": [None] * L}
    top: dict[str, torch.Tensor] = {}

    def on_dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(dev)

    for key, t in raw.items():
        if key == "embed_tokens.weight":
            top["embed"] = t
        elif key == "norm.weight":
            top["final_norm"] = t
        elif key == "lm_head.weight":
            top["lm_head"] = t.T
        m = _LAYER_RE.match(key)
        if not m:
            continue
        idx, rest = int(m.group(1)), m.group(2)
        if idx >= L:
            raise ModelLoadError(f"{key}: layer {idx} is past the config's "
                                 f"{L} layers")
        if rest == "input_layernorm.weight":
            norms["attn_norm"][idx] = t
            continue
        if rest == "post_attention_layernorm.weight":
            norms["mlp_norm"][idx] = t
            continue
        for proj, ours in _PROJ_KEYS.items():
            if not rest.startswith(proj + ".") or ours not in layer_acc:
                continue
            base = f"layers.{idx}.{proj}"
            try:
                if fmt == "gptq" and rest == f"{proj}.qweight":
                    layer_acc[ours][idx] = gptq_leaf(
                        on_dev(t), on_dev(raw[f"{base}.qzeros"]),
                        on_dev(raw[f"{base}.scales"]))
                elif fmt == "awq" and rest == f"{proj}.weight":
                    layer_acc[ours][idx] = awq_leaf(
                        on_dev(t),
                        on_dev(raw[f"{base}.weight_quantizer._amax"]),
                        on_dev(raw[f"{base}.input_quantizer."
                                   "_pre_quant_scale"]))
            except KeyError as exc:
                raise ModelLoadError(f"incomplete quantized checkpoint: "
                                     f"{base} has no {exc}") from None
            break

    missing = [f"{k}[{i}]" for k, v in {**layer_acc, **norms}.items()
               for i, x in enumerate(v) if x is None]
    if missing or "embed" not in top or "final_norm" not in top:
        raise ModelLoadError(
            f"incomplete quantized checkpoint ({sorted(missing)[:5]}...)")

    def stack(parts: list, to_dtype=None) -> torch.Tensor:
        out = torch.empty((L, *parts[0].shape),
                          dtype=to_dtype or parts[0].dtype, device=dev)
        for i, p in enumerate(parts):
            out[i].copy_(p)
        return out

    layers: dict = {name: {k: stack([d[k] for d in acc]) for k in acc[0]}
                    for name, acc in layer_acc.items()}
    layers["attn_norm"] = stack(norms["attn_norm"], dtype)
    layers["mlp_norm"] = stack(norms["mlp_norm"], dtype)
    params: Params = {
        "embed": top["embed"].to(device=dev, dtype=dtype),
        "layers": {k: layers[k] for k in ("attn_norm", "mlp_norm",
                                          *projection_keys(cfg))},
        "final_norm": top["final_norm"].to(device=dev, dtype=dtype),
    }
    if "lm_head" in top:
        params["lm_head"] = top["lm_head"].to(device=dev,
                                              dtype=dtype).contiguous()
    elif not cfg.tie_word_embeddings:
        raise ModelLoadError("quantized checkpoint has no lm_head and the "
                             "config does not tie embeddings")
    return params
