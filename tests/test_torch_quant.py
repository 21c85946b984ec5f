"""The port's weight and KV quantization (``ops/quant.py``,
``ops/kv_quant.py``, ``ops/int4_matmul.py``) against the JAX package's,
on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
Quantization is compared bit for bit: both round half to even and divide
in float32. Products are compared in float32 at rtol 1e-5, atol 1e-5
(the same integer weights and scales on both sides; only the summation
order differs). ``int4_matmul_plain`` is held to the JAX kernel in
interpret mode at the JAX package's own cases and tolerances: per
channel rtol 1e-5, atol 1e-4; grouped float32 rtol 1e-4, atol 1e-5. With
bf16 activations the grouped product is held to JAX ``quant.matmul``
(not to the reference kernel, which rounds each dequantized weight
through bf16) at rtol 1e-2: both sum in float32, and one bf16 ulp of the
rounded output is 2^-8 relative.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import int4_matmul as jint4
from generativeaiexamples_tpu.ops import kv_quant as jkv
from generativeaiexamples_tpu.ops import quant as jq
from generativeaiexamples_tpu_torch.engine.engine import Engine, EngineConfig
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.ops import int4_matmul as tint4
from generativeaiexamples_tpu_torch.ops import kv_quant as tkv
from generativeaiexamples_tpu_torch.ops import quant as tq
from generativeaiexamples_tpu_torch.utils.errors import ConfigError


def _np(t):
    """torch tensor -> numpy, bf16 as its raw 16-bit words."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _eq(t, j):
    np.testing.assert_array_equal(_np(t), _jnp_bits(j))


def _rows_with_ties(seed=0):
    """Random rows plus a zero row and rows whose values land exactly on
    .5 after the divide: amax 127 gives scale 1.0 (exact in bf16), amax
    63.5 gives scale 0.5."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 3, 32)).astype(np.float32) * 3
    x[0, 0] = 0.0
    x[0, 1] = 0.0
    x[0, 1, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -2.5]
    x[0, 2] = 0.0
    x[0, 2, :4] = [63.5, 1.25, -0.75, 0.25]
    return x


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_rows_bit_equal(dtype):
    x = _rows_with_ties()
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    tqr, ts = tkv.quantize_rows(tx)
    jqr, js = jkv.quantize_rows(jx)
    assert tqr.dtype == torch.int8 and ts.dtype == torch.bfloat16
    _eq(tqr, jqr)
    _eq(ts, js)
    # The ties rounded half to even, and a zero row quantizes to zeros.
    assert tqr[0, 1, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -2]
    assert not tqr[0, 0].any()
    for out in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if out == torch.float32 else jnp.bfloat16
        _eq(tkv.dequantize_rows(tqr, ts, out),
            jkv.dequantize_rows(jqr, js, jdt))


def _weights(K, N, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((*lead, K, N)) * 0.05).astype(np.float32)
    # A zero column (scale clamps to 1e-12) and a column with .5 ties
    # (absmax 7 gives scale 1.0: 2.5 -> 2, -3.5 -> -4).
    w[..., :, 0] = 0.0
    w[..., :, 1] = 0.0
    w[..., :4, 1] = [7.0, 2.5, -3.5, 0.5]
    return w


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_tensor_bit_equal(bits):
    w = _weights(64, 48, lead=(2,))
    t = tq.quantize_tensor(torch.from_numpy(w), bits)
    j = jq.quantize_tensor(jnp.asarray(w), bits)
    assert set(t) == set(j)
    for k in t:
        _eq(t[k], j[k])


@pytest.mark.parametrize("group", [32, 64])
def test_quantize_tensor_grouped_bit_equal(group):
    w = _weights(128, 40, seed=1)
    t = tq.quantize_tensor_grouped(torch.from_numpy(w), group)
    j = jq.quantize_tensor_grouped(jnp.asarray(w), group)
    assert set(t) == set(j) == {"q4", "gscale"}
    for k in t:
        _eq(t[k], j[k])
    for dt in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
        _eq(tq.dequantize(t, dt), jq.dequantize(j, jdt))


def test_unpack4_every_byte():
    """All 256 byte values: the low nibble sign-extended, the high one an
    arithmetic shift."""
    q4 = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    _eq(tq._unpack4(torch.from_numpy(q4)), jq._unpack4(jnp.asarray(q4)))


def _jax_tiny_params(seed):
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    jp = jllama.init_params(JCFG, jax.random.key(seed), dtype=jnp.float32)
    return jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("mode,group", [("int8", 128), ("int4", 128),
                                        ("int4_awq", 32)])
def test_quantize_params_bit_equal(mode, group):
    """Every projection and the lm_head, stacked (L, K, N) layer weights
    quantized one layer at a time; LLAMA_TINY's F = 352 takes group 32."""
    from generativeaiexamples_tpu_torch.models.convert import \
        params_from_numpy
    tree = _jax_tiny_params(5)
    tp = params_from_numpy(tree, "cpu", torch.float32, cfg=LLAMA_TINY)
    tquant = tq.quantize_params(tp, mode, group_size=group)
    jquant = jq.quantize_params(jax.tree.map(jnp.asarray, tree), mode,
                                group_size=group)
    for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        t, j = tquant["layers"][key], jquant["layers"][key]
        assert set(t) == set(j)
        for leaf in t:
            _eq(t[leaf], j[leaf])
    for leaf in tquant["lm_head"]:
        _eq(tquant["lm_head"][leaf], jquant["lm_head"][leaf])
    assert tq.weight_mode(tquant["layers"]["wq"]) == mode
    _eq(tquant["embed"], jquant["embed"])
    with pytest.raises(ValueError):
        tq.quantize_params(tp, "int2")


def _leaf(kind, K, N, seed=2):
    """A quantized leaf of both packages from the same numpy weight:
    int8, int4, grouped int4 with AWQ pre_scale, grouped int4 with GPTQ
    gbias."""
    w = jnp.asarray(_weights(K, N, seed=seed))
    rng = np.random.default_rng(seed + 10)
    if kind == "int8":
        j = jq.quantize_tensor(w, 8)
    elif kind == "int4":
        j = jq.quantize_tensor(w, 4)
    else:
        j = dict(jq.quantize_tensor_grouped(w, 32))
        if kind == "awq":
            j["pre_scale"] = jnp.asarray(
                rng.uniform(0.5, 2.0, (K,)).astype(np.float32))
        else:
            j["gbias"] = jnp.asarray(
                (rng.standard_normal(j["gscale"].shape) * 0.01
                 ).astype(np.float32))
    t = {k: torch.from_numpy(np.array(v)) for k, v in j.items()}
    return t, j


KINDS = ["int8", "int4", "awq", "gptq"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lead", [(5,), (2, 3), (1,)])
def test_matmul_matches_jax(kind, lead):
    K, N = 96, 40
    t, j = _leaf(kind, K, N)
    x = np.random.default_rng(3).standard_normal((*lead, K)).astype(
        np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    out = tq.matmul(tx, t)
    assert out.dtype == torch.float32 and out.shape == (*lead, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(jq.matmul(jx, j)),
                               rtol=1e-5, atol=1e-5)
    out32 = tq.matmul_f32(tx, t)
    np.testing.assert_allclose(out32.numpy(),
                               np.asarray(jq.matmul_f32(jx, j)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_matmul_bf16_matches_jax(kind):
    K, N = 96, 40
    t, j = _leaf(kind, K, N)
    x = np.random.default_rng(4).standard_normal((6, K)).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    out = tq.matmul(tx, t)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jq.matmul(jx, j), np.float32),
                               rtol=1e-2, atol=1e-3)
    out32 = tq.matmul_f32(tx, t)
    assert out32.dtype == torch.float32
    np.testing.assert_allclose(out32.numpy(),
                               np.asarray(jq.matmul_f32(jx, j)),
                               rtol=1e-5, atol=1e-5)


def _case(K, N, M, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.05
    x = rng.normal(size=(M, K)).astype(np.float32)
    return w, x


@pytest.mark.parametrize("K,N,M", [
    (256, 384, 8), (512, 256, 3), (256, 128, 33), (768, 640, 16),
    (256, 384, 1),
])
def test_int4_plain_per_channel_matches_pallas(K, N, M):
    w, x = _case(K, N, M)
    j = jq.quantize_tensor(jnp.asarray(w), bits=4)
    ref = jint4.int4_matmul(jnp.asarray(x), j["q4"], j["scale"],
                            interpret=True, out_dtype=jnp.float32)
    got = tint4.int4_matmul(torch.from_numpy(x),
                            torch.from_numpy(np.array(j["q4"])),
                            torch.from_numpy(np.array(j["scale"])),
                            out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("K,N,M,gs", [
    (256, 384, 8, 128), (512, 256, 9, 256), (1024, 128, 4, 512),
    (256, 384, 1, 128),
])
def test_int4_plain_grouped_matches_pallas(K, N, M, gs):
    w, x = _case(K, N, M, seed=1)
    j = jq.quantize_tensor_grouped(jnp.asarray(w), group_size=gs)
    ref = jint4.int4_matmul(jnp.asarray(x), j["q4"], j["gscale"],
                            interpret=True)
    got = tint4.int4_matmul_plain(torch.from_numpy(x),
                                  torch.from_numpy(np.array(j["q4"])),
                                  torch.from_numpy(np.array(j["gscale"])))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=1e-4, atol=1e-5)


def test_int4_leading_dims_and_out_dtype():
    w, x = _case(256, 128, 6)
    t = tq.quantize_tensor(torch.from_numpy(w), bits=4)
    x3 = torch.from_numpy(x).reshape(2, 3, 256)
    got = tint4.int4_matmul(x3, t["q4"], t["scale"], out_dtype=torch.float32)
    assert got.shape == (2, 3, 128) and got.dtype == torch.float32
    flat = tint4.int4_matmul(torch.from_numpy(x), t["q4"], t["scale"])
    torch.testing.assert_close(got.reshape(6, 128), flat, rtol=1e-6, atol=0)
    xb = x3.to(torch.bfloat16)
    assert tint4.int4_matmul(xb, t["q4"], t["scale"]).dtype == torch.bfloat16


def test_int4_cpu_calls_do_not_count_and_bad_args_raise():
    w, x = _case(64, 32, 2)
    t = tq.quantize_tensor_grouped(torch.from_numpy(w), 32)
    xt = torch.from_numpy(x)
    before = tint4.int4_matmul.launches
    tint4.int4_matmul(xt, t["q4"], t["gscale"])
    assert tint4.int4_matmul.launches == before
    bad = {
        "K mismatch": (xt[:, :32], t["q4"], t["gscale"]),
        "scale dtype": (xt, t["q4"], t["gscale"].double()),
        "group does not divide K": (xt, t["q4"], t["gscale"][:1].repeat(3, 1)),
        "q4 dtype": (xt, t["q4"].to(torch.int16), t["gscale"]),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            tint4.int4_matmul(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        tint4.int4_matmul(*(a.to("meta") for a in (xt, t["q4"],
                                                   t["gscale"])))


def test_int4_cpu_calls_count_in_no_path():
    """CPU calls of every shape that a card would send down each path
    ("tc", "gemv", "wg", "tile") count in none of them."""
    w, x = _case(256, 64, 16)
    t = tq.quantize_tensor_grouped(torch.from_numpy(w), 128)
    before = dict(tint4.int4_matmul.launches_by_path)
    assert set(before) == {"tc", "gemv", "tile", "wg"}
    seen = set()
    for M in (8, 16):
        for xt in (torch.from_numpy(x[:M]),
                   torch.from_numpy(x[:M]).to(torch.bfloat16)):
            seen.add(tint4._path(M, 256, 64, 128, xt.dtype))
            tint4.int4_matmul(xt, t["q4"], t["gscale"])
    assert seen == set(before)
    assert tint4.int4_matmul.launches_by_path == before


@pytest.mark.parametrize("M,K,N,group,x_dtype,want", [
    # Decode with bf16 x: tensor cores, per channel (group = K) or grouped.
    (1, 4096, 11008, 128, torch.bfloat16, "tc"),
    (8, 4096, 11008, 128, torch.bfloat16, "tc"),
    (8, 11008, 4096, 11008, torch.bfloat16, "tc"),
    (1, 4096, 32000, 4096, torch.bfloat16, "tc"),
    (3, 4096, 4096, 256, torch.bfloat16, "tc"),
    # Decode with float32 x: the fp32 GEMV, whatever the scales.
    (1, 4096, 11008, 128, torch.float32, "gemv"),
    (8, 4096, 11008, 4096, torch.float32, "gemv"),
    # Prefill (M > 8) with bf16 x: warpgroup tensor cores, per channel or
    # grouped, from the smallest M to the engine's largest default bucket.
    (9, 4096, 11008, 128, torch.bfloat16, "wg"),
    (9, 4096, 4096, 4096, torch.bfloat16, "wg"),
    (128, 4096, 4096, 128, torch.bfloat16, "wg"),
    (1024, 4096, 11008, 128, torch.bfloat16, "wg"),
    (1024, 11008, 4096, 11008, torch.bfloat16, "wg"),
    (3072, 11008, 4096, 128, torch.bfloat16, "wg"),
    # Prefill with float32 x: the tiled path keeps full fp32.
    (9, 4096, 4096, 4096, torch.float32, "tile"),
    (1024, 11008, 4096, 11008, torch.float32, "tile"),
    (3072, 4096, 11008, 128, torch.float32, "tile"),
    # bf16 prefill shapes the tensor-core gate refuses: the tiled path.
    (128, 250, 96, 250, torch.bfloat16, "tile"),   # K % 16 != 0
    (128, 4096, 4100, 128, torch.bfloat16, "tile"),  # N % 16 != 0
    (128, 4096, 4096, 64, torch.bfloat16, "tile"),   # group % 128 != 0
    (9, 352, 128, 32, torch.bfloat16, "tile"),     # group % 128 != 0
    # Shapes the tensor-core gate refuses go where they are taken.
    (8, 250, 96, 250, torch.bfloat16, "gemv"),    # K % 16 != 0
    (8, 384, 96, 8, torch.bfloat16, "gemv"),      # group % 16 != 0
    (8, 352, 128, 32, torch.bfloat16, "gemv"),    # group % 128 != 0
    (8, 4096, 4096, 64, torch.bfloat16, "gemv"),  # group % 128 != 0
    (8, 4096, 4100, 128, torch.bfloat16, "gemv"),  # N % 16 != 0
    (8, 256, 130, 128, torch.bfloat16, "tile"),   # N % 4 != 0
    (8, 96, 96, 3, torch.bfloat16, "tile"),       # odd group, K % 16 == 0
    (8, 96, 96, 3, torch.float32, "tile"),        # odd group
])
def test_int4_path_choice(M, K, N, group, x_dtype, want):
    assert tint4._path(M, K, N, group, x_dtype) == want


def test_int4_hopper_gate():
    assert tint4.supported(4096, 4096, 128)
    assert tint4.supported(11008, 4096, 128)      # w_down: G = 86
    assert tint4.supported(4096, 32000, 128)      # lm_head: N = 32000
    assert tint4.supported(352, 128, 32)          # not a Mosaic tiling
    assert tint4.supported(4096, 100)             # N not a lane multiple
    assert not tint4.supported(4095, 128)         # odd K
    assert not tint4.supported(384, 128, 256)     # group does not divide K
    assert not tint4.supported(256, 0)


def test_gbias_refused_on_cuda():
    """GPTQ zero points run on the int4 kernel's tensor-core paths only:
    an engine on the card takes a GPTQ leaf whose products land there
    (bf16 activations, groups of a multiple of 128, K and N multiples of
    16, the lm_head at the sampler tile too) and refuses, before
    allocating its pool, one that would not, as it refuses a geometry
    outside the int4 gate."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import GPTNEXT_TINY
    params = tq.quantize_params(
        llama.init_params(LLAMA_TINY, seed=0, dtype=torch.float32),
        "int4_awq", group_size=32)
    gate = SimpleNamespace(model_cfg=LLAMA_TINY,
                           cfg=EngineConfig(page_size=16), params=params,
                           _dtype=torch.bfloat16, _sampler_tile=512)
    Engine._check_kernel_geometry(gate)             # passes as made
    # Groups of 32 would take the float32 paths, which have no zero-point
    # term.
    params["layers"]["w_up"]["gbias"] = torch.zeros_like(
        params["layers"]["w_up"]["gscale"])
    with pytest.raises(ConfigError, match="gbias"):
        Engine._check_kernel_geometry(gate)
    # Groups of 128 on a bf16 engine: taken, layers and head alike.
    gq = tq.quantize_params(
        llama.init_params(GPTNEXT_TINY, seed=0, dtype=torch.float32),
        "int4_awq", group_size=128)
    for leaf in [*gq["layers"].values(), gq["lm_head"]]:
        if tq.is_quantized(leaf):
            leaf["gbias"] = torch.zeros_like(leaf["gscale"])
    gate = SimpleNamespace(model_cfg=GPTNEXT_TINY,
                           cfg=EngineConfig(page_size=16), params=gq,
                           _dtype=torch.bfloat16, _sampler_tile=256)
    Engine._check_kernel_geometry(gate)
    assert tint4.tensor_cores(256, 512, 128, torch.bfloat16)
    # ... but not on a float32 engine (its products take "gemv"/"tile"),
    # nor with a head tile that is not a multiple of 16.
    gate._dtype = torch.float32
    with pytest.raises(ConfigError, match="gbias"):
        Engine._check_kernel_geometry(gate)
    assert not tint4.tensor_cores(256, 512, 128, torch.float32)
    gate._dtype, gate._sampler_tile = torch.bfloat16, 8
    with pytest.raises(ConfigError, match="gbias"):
        Engine._check_kernel_geometry(gate)
    # A geometry outside the int4 gate (here K = 0) is refused too.
    gate.params = {"layers": {"w_up": {
        "q4": torch.zeros((1, 0, 8), dtype=torch.int8),
        "scale": torch.ones((1, 8))}}}
    with pytest.raises(ConfigError, match="int4 kernel"):
        Engine._check_kernel_geometry(gate)
