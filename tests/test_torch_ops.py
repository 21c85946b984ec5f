"""The port's plain ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks as
numpy arrays; everything runs in float32. Tolerance: atol 1e-5 (both sides
compute in float32; only the summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import attention as jattn
from generativeaiexamples_tpu.ops import rmsnorm as jrms
from generativeaiexamples_tpu.ops import rope as jrope
from generativeaiexamples_tpu.ops import sampling as jsamp
from generativeaiexamples_tpu_torch.ops import attention as tattn
from generativeaiexamples_tpu_torch.ops import rmsnorm as trms
from generativeaiexamples_tpu_torch.ops import rope as trope
from generativeaiexamples_tpu_torch.ops import sampling as tsamp

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


def test_rmsnorm_matches_jax():
    rng = _rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    out = trms.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    ref = jrms.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    _close(out, ref)


@pytest.mark.parametrize("theta,scaling", [(10000.0, 1.0),
                                           (1_000_000.0, 2.0)])
def test_rope_matches_jax(theta, scaling):
    rng = _rng(1)
    B, S, H, KV, hd = 2, 7, 4, 2, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = (np.arange(S)[None, :] + np.array([[0], [300]])).astype(np.int32)
    tf = trope.rope_frequencies(hd, theta, scaling)
    jf = jrope.rope_frequencies(hd, theta, scaling)
    _close(tf, jf, atol=1e-7)
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(pos), tf)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(pos), jf)
    # angles reach ~300 rad: float32 cos/sin of large arguments differ by
    # a few ulps of the argument between libraries.
    _close(tq, jq, atol=1e-4)
    _close(tk, jk, atol=1e-4)


@pytest.mark.parametrize("T,valid,causal", [
    (64, [64, 40], True),       # dense path
    (48, None, False),          # dense, no masks
    (1024, [1000, 700], True),  # chunked path (T > 512, chunk 512)
    (768, [600, 768], True),    # chunked path, chunk 256
])
def test_gqa_attention_matches_jax(T, valid, causal):
    rng = _rng(2)
    B, S, H, KV, hd = 2, 4, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    last = np.asarray(valid if valid is not None else [T, T])
    pos = (last[:, None] - S + np.arange(S)[None, :]).astype(np.int32)
    vl = None if valid is None else np.asarray(valid, np.int32)
    out = tattn.gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), None if vl is None else torch.from_numpy(vl),
        causal=causal)
    ref = jattn.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        None if vl is None else jnp.asarray(vl), causal=causal)
    _close(out, ref)


def test_gqa_chunked_matches_dense():
    """The chunked online softmax against the dense path of the port
    itself at a small chunk, including a fully masked key block."""
    rng = _rng(3)
    B, S, H, KV, hd, T = 1, 3, 4, 4, 8, 384
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, KV, hd)).astype(np.float32))
    pos = torch.tensor([[90, 91, 92]], dtype=torch.int32)
    vl = torch.tensor([93], dtype=torch.int32)
    dense = tattn._gqa_dense(q, k, v, pos, vl, causal=True)
    chunked = tattn._gqa_chunked(q, k, v, pos, vl, causal=True, chunk=128)
    _close(chunked, dense)


def test_mask_bitfields_match_jax():
    rng = _rng(4)
    V = 259 + 5                        # not a multiple of 32
    mask = rng.random((3, V)) < 0.3
    tw = tsamp.pack_mask(torch.from_numpy(mask))
    jw = jsamp.pack_mask(jnp.asarray(mask))
    assert tsamp.mask_words(V) == jsamp.mask_words(V) == tw.shape[-1]
    np.testing.assert_array_equal(tw.numpy(),
                                  np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tsamp.pack_mask_np(mask),
                                  jsamp.pack_mask_np(mask).astype(np.int64))
    np.testing.assert_array_equal(tsamp.unpack_mask(tw, V).numpy(), mask)
    tokens = np.array([0, 263, 31], np.int32)
    on = np.array([True, True, False])
    ts = tsamp.set_token_bits(tw, torch.from_numpy(tokens),
                              torch.from_numpy(on))
    js = jsamp.set_token_bits(jw, jnp.asarray(tokens), jnp.asarray(on))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))


def test_seen_mask_and_repetition_penalty_match_jax():
    rng = _rng(5)
    B, T, V = 3, 12, 50
    hist = rng.integers(0, V, (B, T)).astype(np.int32)
    vlen = np.array([12, 5, 0], np.int32)
    ts = tsamp.seen_mask(torch.from_numpy(hist), torch.from_numpy(vlen), V)
    js = jsamp.seen_mask(jnp.asarray(hist), jnp.asarray(vlen), V)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    logits = rng.standard_normal((B, V)).astype(np.float32)
    pen = np.array([1.3, 1.0, 0.7], np.float32)
    tp = tsamp.apply_repetition_penalty(torch.from_numpy(logits), ts,
                                        torch.from_numpy(pen))
    jp = jsamp.apply_repetition_penalty(jnp.asarray(logits), js,
                                        jnp.asarray(pen))
    _close(tp, jp)


def test_sample_greedy_rows_are_argmax():
    rng = _rng(6)
    B, V = 4, 100
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    toks = tsamp.sample(logits, torch.tensor([1.0, 0.7, 0.0, 2.0]),
                        torch.tensor([1, 1, 5, 1], dtype=torch.int32),
                        torch.tensor([0.9, 0.0, 0.5, 1.0]), gen)
    np.testing.assert_array_equal(toks.numpy(),
                                  logits.argmax(-1).numpy().astype(np.int32))


def test_sample_respects_top_k():
    """Sampled rows only draw from their top-k logits."""
    rng = _rng(7)
    B, V, k = 64, 40, 3
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    toks = tsamp.sample(logits, torch.full((B,), 1.5),
                        torch.full((B,), k, dtype=torch.int32),
                        torch.zeros(B), gen)
    topk = logits.topk(k, dim=-1).indices
    assert bool((topk == toks[:, None].long()).any(-1).all())
