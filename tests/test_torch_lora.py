"""The port's LoRA/QLoRA (``lora.py``) and the int4 product's backward
against the JAX package, on the CPU.

One numpy tree drawn by the JAX package's ``init_params`` at the
``llama-tiny`` geometry (float32) and the JAX ``init_lora`` adapters
(carried across with ``lora_from_numpy``: the two frameworks' random
streams differ) drive both packages. Tolerances: the merge float32
atol 1e-6 (one float32 sum on each side); losses over 8 Adam steps and
the first step's gradients rtol 1e-4 (float32 forward and backward on
both sides, two layers of summation-order noise); parameters are not
compared elementwise after many steps, since Adam's first step maps a
near-zero gradient to +-lr whatever its size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativeaiexamples_tpu import lora as jlora
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu_torch import lora as tlora
from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
from generativeaiexamples_tpu_torch.ops import quant as tquant
from generativeaiexamples_tpu_torch.utils.errors import ConfigError

CFG = LLAMA_TINY
GROUP = 32          # llama-tiny's F = 352 takes int4 groups of 32
STEPS = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def base():
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    assert vars(JCFG) == vars(CFG)
    return jllama.init_params(JCFG, jax.random.key(0), dtype=jnp.float32)


def _jax_base(jp, mode: str):
    """The JAX base tree for ``mode``: raw, a ``quantize_params`` mode, or
    grouped int4 with AWQ's ``pre_scale`` ("awq") or GPTQ's zero points
    ("gptq") drawn from numpy."""
    if mode == "raw":
        return jp
    if mode in ("int8", "int4", "int4_awq"):
        return jquant.quantize_params(jp, mode, GROUP)
    q = jquant.quantize_params(jp, "int4_awq", GROUP)
    rng = np.random.default_rng(5)
    layers = dict(q["layers"])
    for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        leaf = dict(layers[key])
        if mode == "awq":
            K = leaf["q4"].shape[-2] * 2
            leaf["pre_scale"] = jnp.asarray(rng.uniform(
                0.5, 1.5, (CFG.num_layers, K)), jnp.float32)
        else:
            leaf["gbias"] = jnp.asarray(0.01 * rng.standard_normal(
                leaf["gscale"].shape), jnp.float32)
        layers[key] = leaf
    return {**q, "layers": layers}


def _adapters(jbase, rank=4, seed=1, b_scale=0.0):
    """JAX ``init_lora`` adapters, with ``b`` drawn from numpy when
    ``b_scale`` is set (a zero ``b`` merges to the base exactly)."""
    ad = _np(jlora.init_lora(CFG, jbase, jax.random.key(seed), rank=rank))
    if b_scale:
        rng = np.random.default_rng(seed)
        ad = {k: {"a": v["a"], "b": (b_scale * rng.standard_normal(
            v["b"].shape)).astype(np.float32)} for k, v in ad.items()}
    return ad


def _batch(seed, B=4, S=16):
    toks = np.random.default_rng(seed).integers(3, CFG.vocab_size,
                                                (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_loss(cfg, alpha=16.0):
    def loss_fn(lora, base_params, batch):
        params = jlora.merge_lora(base_params, lora, alpha)
        B, S = batch["tokens"].shape
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
        logits, _ = jllama.apply(params, cfg, batch["tokens"], positions,
                                 kv_valid_len=jnp.sum(batch["mask"], -1))
        from generativeaiexamples_tpu.training import cross_entropy_loss
        return cross_entropy_loss(logits, batch["targets"], batch["mask"])
    return loss_fn


@pytest.mark.parametrize("mode", ["raw", "int8", "int4", "int4_awq", "awq",
                                  "gptq"])
def test_merge_matches_jax(base, mode):
    jbase = _jax_base(base, mode)
    ad = _adapters(jbase, b_scale=0.05)
    jm = _np(jlora.merge_lora(jbase, jax.tree.map(jnp.asarray, ad)))
    tbase = params_from_numpy(_np(jbase), "cpu", torch.float32, cfg=CFG)
    tm = tlora.merge_lora(tbase, tlora.lora_from_numpy(ad, "cpu"))
    for key in tlora.DEFAULT_TARGETS:
        got = tm["layers"][key].detach()
        assert got.dtype == torch.float32 and not tquant.is_quantized(got)
        np.testing.assert_allclose(got.numpy(), jm["layers"][key],
                                   rtol=0, atol=1e-6)
    # Leaves that are not targets are the base's own objects.
    assert tm["layers"]["w_up"] is tbase["layers"]["w_up"]


def test_merge_casts_to_the_serving_dtype(base):
    tbase = params_from_numpy(_np(base), "cpu", torch.bfloat16, cfg=CFG)
    q = tquant.quantize_params(tbase, "int4_awq", GROUP)
    ad = tlora.lora_from_numpy(_adapters(base, b_scale=0.05), "cpu")
    assert tlora.merge_lora(q, ad)["layers"]["wq"].dtype == torch.float32
    merged = tlora.merge_lora(q, ad, dtype=torch.bfloat16)
    assert merged["layers"]["wq"].dtype == torch.bfloat16
    # A bf16 raw base keeps its dtype without the argument.
    assert tlora.merge_lora(tbase, ad)["layers"]["wo"].dtype == torch.bfloat16


def test_zero_init_is_identity(base):
    tbase = params_from_numpy(_np(base), "cpu", torch.float32, cfg=CFG)
    lora = tlora.init_lora(CFG, tbase, torch.Generator().manual_seed(1),
                           rank=4)
    assert all(ab["b"].abs().max() == 0 for ab in lora.values())
    assert lora["wq"]["a"].shape == (CFG.num_layers, CFG.hidden_size, 4)
    toks = torch.tensor([[1, 2, 3]])
    pos = torch.arange(3, dtype=torch.int32)[None]
    with torch.no_grad():
        a, _ = tllama.apply(tbase, CFG, toks, pos)
        b, _ = tllama.apply(tlora.merge_lora(tbase, lora), CFG, toks, pos)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["raw", "int8", "int4_awq", "gptq"])
def test_lora_steps_match_optax_adam(base, mode):
    """8 Adam(1e-2) steps on the adapters over a frozen base: per-step
    losses and the first step's gradients equal optax's; the base's bits
    never move; every ``b`` moved."""
    jbase = _jax_base(base, mode)
    ad = _adapters(jbase)
    batch = _batch(2)
    # JAX: the reference's step, and its first gradients.
    opt = optax.adam(1e-2)
    jl = jax.tree.map(jnp.asarray, ad)
    state = opt.init(jl)
    step = jax.jit(jlora.make_lora_train_step(CFG, opt))
    jgrads = _np(jax.grad(_jax_loss(CFG))(jl, jbase, _jb(batch)))
    jlosses = []
    for _ in range(STEPS):
        jl, state, loss = step(jl, state, jbase, _jb(batch))
        jlosses.append(float(loss))
    # The port.
    tbase = params_from_numpy(_np(jbase), "cpu", torch.float32, cfg=CFG)
    before = [t.clone() for t in tllama.param_tensors(tbase)]
    tl = tlora.lora_from_numpy(ad, "cpu")
    optim = torch.optim.Adam(tlora.lora_parameters(tl), lr=1e-2)
    tstep = tlora.make_lora_train_step(CFG, optim)
    tlosses = []
    for i in range(STEPS):
        tlosses.append(float(tstep(tl, tbase, _tb(batch))))
        if i == 0:
            for key, ab in tl.items():
                for k in ("a", "b"):
                    np.testing.assert_allclose(
                        ab[k].grad.numpy(), jgrads[key][k], rtol=1e-4,
                        atol=1e-4 * np.abs(jgrads[key][k]).max())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0] - 0.01, tlosses
    for a, b in zip(before, tllama.param_tensors(tbase)):
        assert torch.equal(a, b) and b.grad is None and not b.requires_grad
    assert all(float(ab["b"].detach().abs().max()) > 0 for ab in tl.values())


def test_lora_refuses_a_base_that_requires_grad(base):
    tbase = params_from_numpy(_np(base), "cpu", torch.float32, cfg=CFG)
    tl = tlora.lora_from_numpy(_adapters(base), "cpu")
    step = tlora.make_lora_train_step(
        CFG, torch.optim.Adam(tlora.lora_parameters(tl), lr=1e-2))
    tbase["layers"]["wq"].requires_grad_(True)
    with pytest.raises(ValueError, match="frozen"):
        step(tl, tbase, _tb(_batch(3)))


def test_unknown_target_rejected(base):
    tbase = params_from_numpy(_np(base), "cpu", torch.float32, cfg=CFG)
    with pytest.raises(KeyError):
        tlora.init_lora(CFG, tbase, 1, targets=("nonesuch",))
    with pytest.raises(ValueError):
        tlora.lora_from_numpy({"wq": {"a": np.zeros((2, 4, 2))}}, "cpu")


# ---------------------------------------------------- the int4 backward

def _int4_leaf(kind, K=64, N=48, G=4, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    if kind == "channel":
        return tquant.quantize_tensor(w, 4)
    leaf = tquant.quantize_tensor_grouped(w, K // G)
    if kind == "pre_scale":
        leaf["pre_scale"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, K).astype(np.float32))
    if kind == "gbias":
        leaf["gbias"] = torch.from_numpy(
            0.05 * rng.standard_normal((G, N)).astype(np.float32))
    return leaf


@pytest.mark.parametrize("kind", ["channel", "group", "pre_scale", "gbias"])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_int4_backward_matches_autograd_through_the_plain_version(
        kind, out_dtype):
    """``int4_matmul_grad``'s dx (through ``quant._int4``, which applies
    AWQ's pre_scale outside the Function) equals autograd through the
    plain version's own ops; forward outputs equal."""
    leaf = _int4_leaf(kind)
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, 5, 48)).astype(np.float32))
    scale = leaf.get("gscale", leaf.get("scale"))

    x1 = x0.clone().requires_grad_(True)
    xin = x1 * leaf["pre_scale"] if "pre_scale" in leaf else x1
    y1 = ti4.int4_matmul_grad(xin, leaf["q4"], scale,
                              gbias=leaf.get("gbias"), out_dtype=out_dtype)
    y1.backward(dy)

    x2 = x0.clone().requires_grad_(True)
    xin = x2 * leaf["pre_scale"] if "pre_scale" in leaf else x2
    y2 = ti4.int4_matmul_plain(xin, leaf["q4"], scale,
                               gbias=leaf.get("gbias"), out_dtype=out_dtype)
    y2.backward(dy)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-5, atol=1e-5)


def test_quant_int4_takes_the_function_only_under_autograd(monkeypatch):
    leaf = _int4_leaf("pre_scale")
    calls = []
    real = ti4._Int4MatmulFn.apply
    monkeypatch.setattr(ti4._Int4MatmulFn, "apply",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(2, 64)
    with torch.no_grad():
        tquant.matmul(x.requires_grad_(True), leaf)
    tquant.matmul(x.detach(), leaf)
    assert calls == []
    y = tquant.matmul(x.detach().requires_grad_(True), leaf)
    assert calls == [1] and y.grad_fn is not None
    # The AWQ multiply is differentiated once, outside the Function.
    x3 = x.detach().requires_grad_(True)
    tquant.matmul(x3, leaf).sum().backward()
    w = tquant.dequantize({"q4": leaf["q4"], "gscale": leaf["gscale"]},
                          torch.float32)
    want = (torch.ones(2, 48) @ w.T) * leaf["pre_scale"]
    torch.testing.assert_close(x3.grad, want, rtol=1e-5, atol=1e-5)


def test_int4_weights_must_be_frozen():
    leaf = _int4_leaf("group")
    with pytest.raises(ValueError, match="frozen"):
        ti4.int4_matmul_grad(torch.randn(2, 64, requires_grad=True),
                             leaf["q4"],
                             leaf["gscale"].clone().requires_grad_(True))


# ------------------------------------------------ serving a tuned tree

def _engine(params, dtype):
    return Engine(params, CFG, ByteTokenizer(), EngineConfig(
        max_slots=2, max_input_length=128, max_output_length=32,
        prefill_buckets=(32, 128), dtype=dtype, page_size=16,
        kv_pool_tokens=None, steps_per_round=4), device="cpu")


def test_engine_refuses_mixed_float_leaves(base):
    tbase = params_from_numpy(_np(base), "cpu", torch.bfloat16, cfg=CFG)
    q = tquant.quantize_params(tbase, "int4_awq", GROUP)
    ad = tlora.lora_from_numpy(_adapters(base, b_scale=0.05), "cpu")
    with torch.no_grad():
        mixed = tlora.merge_lora(q, ad)      # float32 wq..wo beside bf16
    with pytest.raises(ConfigError, match="layers/wq"):
        _engine(mixed, "bfloat16")
    with torch.no_grad():
        cast = tlora.merge_lora(q, ad, dtype=torch.bfloat16)
    engine = _engine(cast, "bfloat16")
    engine.close()


def test_notebook_09_end_to_end():
    """Notebook 09 through the port: rank-8 adapters over a random
    float32 llama-tiny, Adam 1e-2 for 10 steps on a random batch, merge,
    serve the merged tree on an engine: 12 greedy tokens equal to a
    greedy loop over the full forward of the merged weights."""
    base_p = tllama.init_params(CFG, 0, dtype=torch.float32)
    lora = tlora.init_lora(CFG, base_p, torch.Generator().manual_seed(1),
                           rank=8)
    optim = torch.optim.Adam(tlora.lora_parameters(lora), lr=1e-2)
    step = tlora.make_lora_train_step(CFG, optim)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        3, CFG.vocab_size, (8, 33)).astype(np.int64))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": torch.ones((8, 32), dtype=torch.int32)}
    losses = [float(step(lora, base_p, batch)) for _ in range(10)]
    assert losses[-1] < losses[0] - 0.01, losses
    with torch.no_grad():
        tuned = tlora.merge_lora(base_p, lora)
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    engine = _engine(tuned, "float32")
    tok = ByteTokenizer()
    try:
        engine.start()
        stream = engine.submit(tok.encode("tuned model says"),
                               SamplingParams(max_tokens=12, top_k=1,
                                              ignore_eos=True))
        stream.text()
        got = stream.token_ids
    finally:
        engine.stop()
        engine.close()
    ids = tok.encode("tuned model says")
    with torch.no_grad():
        for _ in range(12):
            t = torch.tensor([ids])
            pos = torch.arange(len(ids), dtype=torch.int32)[None]
            logits, _ = tllama.apply(tuned, CFG, t, pos)
            ids.append(int(logits[0, -1].argmax()))
    assert got == ids[-12:]


def test_matmul_f32_backward_matches_the_float32_product():
    """The logits product's autograd wrapper (``quant._MatmulF32Fn``; on
    the card ``torch.mm(..., out_dtype=)`` has no derivative): float32
    dx and dW cast to the operands' dtypes, equal to autograd through
    the widened product (bf16 operands; bf16 gradients, rtol 1e-2)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((6, 5, 32), generator=g).to(torch.bfloat16)
    w = (torch.randn((32, 40), generator=g) / 6).to(torch.bfloat16)
    dy = torch.randn((30, 40), generator=g)
    x1, w1 = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = tquant._MatmulF32Fn.apply(x1.reshape(-1, 32), w1)
    assert y.dtype == torch.float32
    y.backward(dy)
    xf = x.float().requires_grad_(True)
    wf = w.float().requires_grad_(True)
    (xf.reshape(-1, 32) @ wf).backward(dy)
    assert x1.grad.dtype == w1.grad.dtype == torch.bfloat16
    torch.testing.assert_close(y, xf.reshape(-1, 32).detach() @ wf.detach())
    torch.testing.assert_close(x1.grad.float(), xf.grad, rtol=1e-2,
                               atol=1e-2)
    torch.testing.assert_close(w1.grad.float(), wf.grad, rtol=1e-2,
                               atol=1e-2)


def test_qlora_over_a_bf16_base_needs_the_merge_dtype(base):
    """The reference's default merge over a bf16 int4 base gives float32
    wq..wo beside bf16 activations, which neither package runs (JAX's
    layer scan refuses the float32 carry, torch's matmul the mixed
    operands); merged in the base's dtype (``dtype=torch.bfloat16``) the
    port's QLoRA step runs and its loss falls."""
    jb16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), base)
    jq = jquant.quantize_params(jb16, "int4_awq", GROUP)
    ad = _adapters(jq, b_scale=0.05)
    batch = _batch(6)
    with pytest.raises(TypeError):
        jax.value_and_grad(_jax_loss(CFG))(jax.tree.map(jnp.asarray, ad),
                                           jq, _jb(batch))
    tq = params_from_numpy(_np(jq), "cpu", torch.bfloat16, cfg=CFG)
    for dtype in (None, torch.bfloat16):
        tl = tlora.lora_from_numpy(ad, "cpu")
        step = tlora.make_lora_train_step(
            CFG, torch.optim.Adam(tlora.lora_parameters(tl), lr=1e-2),
            dtype=dtype)
        if dtype is None:
            with pytest.raises(RuntimeError):
                step(tl, tq, _tb(batch))
            continue
        losses = [float(step(tl, tq, _tb(batch))) for _ in range(4)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
