"""The port's converted-weight cache (``models/weight_cache.py``), in the
reference's scenarios (``tests/test_weight_cache.py``), on the CPU:
bit-equal round trips of the served tree (quantized leaves included), the
load-or-convert gate the model server uses, the ``GAIE_WEIGHT_CACHE`` and
``GAIE_SKIP_HASH`` switches, corrupt-entry recovery and pruning. The
trees are the JAX package's ``init_params`` draws carried into the port,
and the server test serves the committed golden-tiny checkpoint; equal
means bit-equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JTINY
from generativeaiexamples_tpu_torch.models import weight_cache
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.ops.quant import quantize_params

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_tiny")


@pytest.fixture(autouse=True)
def cache_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("GAIE_WEIGHT_CACHE_DIR", str(tmp_path / "wc"))
    monkeypatch.delenv("GAIE_WEIGHT_CACHE", raising=False)
    monkeypatch.delenv("GAIE_SKIP_HASH", raising=False)


def _params(seed, dtype=torch.bfloat16):
    tree = jax.tree.map(np.asarray, jllama.init_params(
        JTINY, jax.random.key(seed), dtype=jnp.float32))
    return params_from_numpy(tree, "cpu", dtype, cfg=LLAMA_TINY)


def _tree_equal(a, b):
    fa, fb = weight_cache.flatten(a), weight_cache.flatten(b)
    assert set(fa) == set(fb)
    for name, t in fa.items():
        assert fb[name].dtype == t.dtype, name
        assert tuple(fb[name].shape) == tuple(t.shape), name
        assert torch.equal(fb[name], t), name


@pytest.mark.parametrize("mode", ["int8", "int4", "int4_awq"])
def test_round_trip_preserves_quantized_tree(mode):
    """The cached tree comes back bit-identical, int8 q/q4 leaves and
    their float32 scales included (a dtype drift would change served
    numerics)."""
    params = quantize_params(_params(0), mode=mode, group_size=32)
    assert weight_cache.save("tiny-q-test", params)
    restored = weight_cache.load("tiny-q-test")
    assert restored is not None
    _tree_equal(params, restored)


def test_gptq_leaves_round_trip_bit_equal():
    """A GPTQ leaf (q4, gscale, gbias) and AWQ's pre_scale survive."""
    g = torch.Generator().manual_seed(0)
    leaf = {"q4": torch.randint(-128, 128, (2, 8, 16), generator=g,
                                dtype=torch.int8),
            "gscale": torch.rand((2, 2, 16), generator=g),
            "gbias": torch.randn((2, 2, 16), generator=g),
            "pre_scale": torch.rand((2, 16), generator=g)}
    params = {"embed": torch.randn(4, 3, generator=g).to(torch.bfloat16),
              "layers": {"wq": leaf}}
    assert weight_cache.save("gptq-test", params)
    _tree_equal(params, weight_cache.load("gptq-test"))


def test_cached_or_convert_converts_once():
    params = _params(1, torch.float32)
    calls = []

    def convert():
        calls.append(1)
        return params

    first, from_cache = weight_cache.cached_or_convert("ident-a", convert)
    assert not from_cache and len(calls) == 1
    second, from_cache = weight_cache.cached_or_convert("ident-a", convert)
    assert from_cache and len(calls) == 1
    _tree_equal(first, second)
    # A different identity converts again: the content hash keeps an
    # edited checkpoint from masquerading as the old one.
    _, from_cache = weight_cache.cached_or_convert("ident-b", convert)
    assert not from_cache and len(calls) == 2


def test_disabled_by_env(monkeypatch):
    monkeypatch.setenv("GAIE_WEIGHT_CACHE", "0")
    params = {"w": torch.ones((2, 2))}
    assert not weight_cache.save("off", params)
    assert weight_cache.load("off") is None
    calls = []
    weight_cache.cached_or_convert("off", lambda: calls.append(1) or params)
    weight_cache.cached_or_convert("off", lambda: calls.append(1) or params)
    assert len(calls) == 2


def test_corrupt_cache_is_dropped_and_reconverted():
    params = {"w": torch.arange(4.0)}
    assert weight_cache.save("corrupt", params)
    for root, _, files in os.walk(weight_cache._tree_dir("corrupt")):
        for f in files:
            with open(os.path.join(root, f), "wb") as fh:
                fh.write(b"garbage")
    assert weight_cache.load("corrupt") is None
    assert not os.path.exists(os.path.dirname(
        weight_cache._tree_dir("corrupt")))
    _, from_cache = weight_cache.cached_or_convert("corrupt", lambda: params)
    assert not from_cache
    assert weight_cache.load("corrupt") is not None


def test_entries_are_the_ports_own(tmp_path):
    """Entries are named ``<identity>-torch`` under the root: the
    reference's entry for the same identity in a shared
    ``GAIE_WEIGHT_CACHE_DIR`` (``<identity>/tree``) is never read, and a
    half-written save (a leftover temporary directory) is not an entry."""
    root = weight_cache.cache_root()
    os.makedirs(os.path.join(root, "shared-id", "tree"))
    assert weight_cache.load("shared-id") is None
    assert weight_cache.save("shared-id", {"w": torch.ones(2)})
    assert sorted(os.listdir(root)) == ["shared-id", "shared-id-torch"]
    assert weight_cache.load("shared-id") is not None
    os.makedirs(os.path.join(root, ".saving-x", "tree"))
    assert weight_cache.load(".saving-x") is None


def test_save_prunes_stale_hash_siblings():
    """A new content hash evicts the old identity's tree."""
    params = {"w": torch.ones((2,))}
    assert weight_cache.save("m-bf16-raw-aaa", params,
                             prune_prefix="m-bf16-raw-")
    assert weight_cache.save("m-bf16-raw-bbb", params,
                             prune_prefix="m-bf16-raw-")
    assert weight_cache.load("m-bf16-raw-aaa") is None   # evicted
    assert weight_cache.load("m-bf16-raw-bbb") is not None
    # Other model/quant prefixes are untouched.
    assert weight_cache.save("m-bf16-int8-ccc", params,
                             prune_prefix="m-bf16-int8-")
    assert weight_cache.load("m-bf16-raw-bbb") is not None


def _boot(**kw):
    from generativeaiexamples_tpu_torch.engine import (EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.serving.model_server import \
        build_services
    engine, _ = build_services(
        "golden-tiny", model_path=GOLDEN, device="cpu", **kw,
        engine_cfg=EngineConfig(max_slots=2, max_input_length=64,
                                max_output_length=16, prefill_buckets=(64,),
                                page_size=16, dtype="float32",
                                kv_pool_tokens=None))
    with engine:
        out = engine.submit(engine.tokenizer.encode("cache test"),
                            SamplingParams(max_tokens=6, top_k=1,
                                           ignore_eos=True))
        out.text()
    params = weight_cache.flatten(engine.params)
    engine.close()
    return out.token_ids, params


@pytest.mark.parametrize("quantization", ["", "int4"])
def test_build_services_caches_converted_checkpoint(monkeypatch,
                                                     quantization):
    """First boot converts (and quantizes) the checkpoint and caches the
    served tree under name-dtype-quant-hash; the second loads it from the
    cache (no conversion) with bit-equal leaves and the same greedy
    tokens."""
    from generativeaiexamples_tpu_torch.serving import model_server
    calls = []
    real = model_server.load_checkpoint
    monkeypatch.setattr(model_server, "load_checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    first, p1 = _boot(quantization=quantization)
    assert len(calls) == 1 and not model_server.last_load["from_cache"]
    ident = model_server.last_load["identity"]
    digest = model_server.fast_hash_dir(GOLDEN)[:12]
    assert ident == f"golden-tiny-float32-{quantization or 'raw'}-{digest}"
    second, p2 = _boot(quantization=quantization)
    assert len(calls) == 1, "second boot re-converted despite the cache"
    assert model_server.last_load["from_cache"]
    assert first == second
    assert set(p1) == set(p2)
    for name in p1:
        assert p1[name].dtype == p2[name].dtype and torch.equal(
            p1[name], p2[name]), name


def test_skip_hash_bypasses_weight_cache(monkeypatch):
    """GAIE_SKIP_HASH drops the content hash from the identity, so the
    cache is not consulted (a swapped checkpoint at the same path would
    otherwise serve stale weights) nor written."""
    from generativeaiexamples_tpu_torch.serving import model_server
    monkeypatch.setenv("GAIE_SKIP_HASH", "1")
    calls = []
    real = model_server.load_checkpoint
    monkeypatch.setattr(model_server, "load_checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for _ in range(2):
        _boot()
    assert len(calls) == 2, "weight cache served despite GAIE_SKIP_HASH"
    assert model_server.last_load["identity"] is None
    assert not os.path.isdir(weight_cache.cache_root()) or not os.listdir(
        weight_cache.cache_root())


def test_cache_off_skips_the_hash(monkeypatch):
    """With ``GAIE_WEIGHT_CACHE=0`` the content hash names nothing, so
    ``build_services`` neither hashes the directory nor writes an
    entry."""
    from generativeaiexamples_tpu_torch.serving import model_server
    monkeypatch.setenv("GAIE_WEIGHT_CACHE", "0")

    def no_hash(path, *a, **k):
        raise AssertionError(f"hashed {path} with the cache off")
    monkeypatch.setattr(model_server, "fast_hash_dir", no_hash)
    _boot()
    assert model_server.last_load["identity"] is None
    assert not model_server.last_load["from_cache"]
    assert not os.path.isdir(weight_cache.cache_root())
