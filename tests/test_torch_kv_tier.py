"""The port's host KV tier (``engine/kv_tier.py`` and the engine's
offload, priced restore, suspend and resume) against the JAX package on
the CPU.

- The host store (LRU by bytes, chain match) and the blob format: round
  trips, truncation, CRC corruption, v1 blobs, and blobs byte-identical to
  the reference's writer for float32, bfloat16 and int8 sections, read
  back by either implementation.
- The engine: evict -> offload -> restore at page boundaries k*page +- 1
  gives the cold run's greedy tokens and puts back the offloaded pages
  bit for bit; a restore priced above recompute is skipped and counted;
  injected faults on restore and offload fall back to recompute and to
  dropping; a blob of another geometry or a malformed one is refused; the
  tier off changes nothing; int8 pools round-trip their scale pools; a
  session suspended on one engine resumes on another, across the two
  implementations in both directions, with the same continuation.

Greedy tokens are exact; pool bytes are compared bit for bit.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.engine import kv_tier
from generativeaiexamples_tpu_torch.engine.kv_tier import (
    BLOB_MAGIC_V1, BlockRecord, HostPageStore, from_blob, to_blob)
from generativeaiexamples_tpu_torch.engine.prefix_cache import hash_blocks
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.utils import faults
from generativeaiexamples_tpu_torch.utils.errors import EngineError

from generativeaiexamples_tpu.engine import kv_tier as jtier

PAGE = 16
CFG_KW = dict(vocab_size=259 + 5, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              max_position_embeddings=256)
CFG = LlamaConfig(**CFG_KW)
# The reference test's engine: a 96-token pool (6 pages), each request
# holding 3.
ENGINE_KW = dict(max_slots=2, max_input_length=64, max_output_length=16,
                 prefill_buckets=(32, 64), page_size=PAGE, dtype="float32",
                 kv_pool_tokens=96, steps_per_round=4)
SP = SamplingParams(max_tokens=4, top_k=1, ignore_eos=True)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """The tier and calibration come from the config here; no fault plan
    outlives a test."""
    for name in ("KV_HOST_POOL_TOKENS", "ENGINE_SPEC_DECODE",
                 "SCHED_PROFILE_JSON"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SCHED_ONLINE_CALIB", "0")
    yield
    faults.clear()


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's copy)."""
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    jparams = jllama.init_params(JL(**CFG_KW), jax.random.key(31),
                                 dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu", torch.float32, cfg=CFG)


def _build(params, host_tokens, **kw):
    return Engine(params[1], CFG, ByteTokenizer(), EngineConfig(
        **{**ENGINE_KW, "kv_host_pool_tokens": host_tokens, **kw}),
        device="cpu")


def _jax_build(params, host_tokens, **kw):
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    return JEngine(params[0], JL(**CFG_KW), JTok(), JConfig(
        **{**ENGINE_KW, "kv_host_pool_tokens": host_tokens, **kw}))


def _prompt(seed, n):
    return [(seed * 31 + i * 7) % 250 + 3 for i in range(n)]


def _serve(eng, prompt, sp=SP):
    """One request through the engine's loop by hand (each step reads its
    outputs back); returns the stream once its slot is retired."""
    stream = eng.submit(prompt, sp)
    for _ in range(200):
        if stream.finish_reason is not None and not eng._slots:
            return stream
        eng._step()
    raise AssertionError("request did not finish")


def _churn(eng, seeds, n=32):
    """Distinct prompts that push earlier prefixes out of the pool."""
    for s in seeds:
        assert _serve(eng, _prompt(s, n)).finish_reason == "length"


def _greedy_reference(params, prompt_ids, n_steps):
    ids = list(prompt_ids)
    with torch.no_grad():
        for _ in range(n_steps):
            logits, _ = llama.apply(params[1], CFG, torch.tensor([ids]),
                                    torch.arange(len(ids))[None])
            ids.append(int(logits[0, -1].argmax()))
    return ids[len(prompt_ids):]


def _pages_of(eng, hashes):
    """The pool bytes of each cached block, by hash."""
    cache = eng._state["cache"]
    out = {}
    for h in hashes:
        pg = eng._prefix_cache.page_of(h)
        if pg is not None:
            out[h] = {k: v[:, pg].clone() for k, v in cache.items()}
    return out


# ------------------------------------------------------------ unit level


def test_host_store_lru_capacity_and_chain_match():
    # each record: one (2, 2) float32 leaf = 16 bytes; cap = 2 records
    store = HostPageStore(capacity_bytes=32)
    recs = [BlockRecord(bytes([i]) * 16, None,
                        {"k": torch.full((2, 2), float(i))})
            for i in range(3)]
    assert store.put(recs[0]) and store.put(recs[1])
    assert store.nbytes == 32
    assert store.get(recs[0].hash) is not None   # refresh 0's recency
    store.put(recs[2])                            # evicts 1 (LRU)
    assert store.has(recs[0].hash) and store.has(recs[2].hash)
    assert not store.has(recs[1].hash)
    assert store.offload_evictions == 1
    assert store.pages == 2 and store.nbytes == 32
    assert store.match_chain([recs[0].hash, recs[2].hash]) == 2
    assert store.match_chain([recs[1].hash, recs[0].hash]) == 0
    assert store.match_chain([recs[0].hash, recs[1].hash,
                              recs[2].hash]) == 1
    assert store.pop(recs[0].hash) is not None
    assert store.nbytes == 16
    huge = BlockRecord(b"h" * 16, None, {"k": torch.zeros(100)})
    assert not store.put(huge)
    assert not HostPageStore(0).put(recs[0])


def _records(dtype_names=("float32",)):
    rng = np.random.default_rng(0)
    out = []
    for i, parent in enumerate((None, b"a" * 16)):
        arrays = {}
        for name in dtype_names:
            vals = rng.normal(size=(2, 3, 4)).astype(np.float32)
            if name == "int8":
                arrays["k"] = torch.from_numpy(
                    rng.integers(-127, 128, (2, 3, 4)).astype(np.int8))
            elif name == "bfloat16":
                arrays["ks"] = torch.from_numpy(vals).to(torch.bfloat16)
            else:
                arrays["v"] = torch.from_numpy(vals)
        out.append(BlockRecord(bytes([97 + i]) * 16, parent, arrays))
    return out


def _to_reference(rec):
    """A port record as the reference's (numpy, bf16 through ml_dtypes)."""
    import ml_dtypes
    arrays = {}
    for name, t in rec.arrays.items():
        if t.dtype == torch.bfloat16:
            arrays[name] = t.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)
        else:
            arrays[name] = t.numpy()
    return jtier.BlockRecord(rec.hash, rec.parent, arrays)


def test_blob_round_trip_truncation_and_corruption():
    recs = _records(("float32", "bfloat16", "int8"))
    meta = {"page_size": PAGE, "kv_quant": "", "dtype": "float32"}
    blob = to_blob(recs, meta)
    meta2, recs2 = from_blob(blob)
    assert meta2 == meta
    assert [r.hash for r in recs2] == [r.hash for r in recs]
    assert recs2[1].parent == b"a" * 16 and recs2[0].parent is None
    for a, b in zip(recs, recs2):
        for name in a.arrays:
            assert a.arrays[name].dtype == b.arrays[name].dtype
            assert torch.equal(a.arrays[name], b.arrays[name])
    with pytest.raises(ValueError, match="truncated"):
        from_blob(blob[:-10])
    with pytest.raises(ValueError, match="magic"):
        from_blob(b"junk" + blob)
    flipped = bytearray(blob)
    flipped[-3] ^= 0x10
    with pytest.raises(ValueError, match="CRC"):
        from_blob(bytes(flipped))
    # A v1 blob (no checksums) still parses.
    head_len = int.from_bytes(blob[8:16], "little")
    import json
    header = json.loads(blob[16:16 + head_len])
    for b in header["blocks"]:
        for spec in b["arrays"].values():
            del spec["crc32"]
    head = json.dumps(header).encode()
    v1 = (BLOB_MAGIC_V1 + len(head).to_bytes(8, "little") + head
          + blob[16 + head_len:])
    _, recs1 = from_blob(v1)
    assert torch.equal(recs1[1].arrays["ks"], recs[1].arrays["ks"])


def test_blobs_are_byte_compatible_with_the_reference():
    """The port's writer gives the reference writer's bytes for float32,
    bfloat16 and int8 sections, and each reads the other's blob."""
    import ml_dtypes
    recs = _records(("float32", "bfloat16", "int8"))
    meta = {"page_size": PAGE, "kv_quant": "int8", "dtype": "bfloat16"}
    mine = to_blob(recs, meta)
    ref = jtier.to_blob([_to_reference(r) for r in recs], meta)
    assert mine == ref
    _, back = jtier.from_blob(mine)
    assert back[0].arrays["ks"].dtype == np.dtype(ml_dtypes.bfloat16)
    for a, b in zip(recs, back):
        for name, t in a.arrays.items():
            assert np.array_equal(_to_reference(a).arrays[name].view(
                np.uint8), np.asarray(b.arrays[name]).view(np.uint8))
    _, mine_back = from_blob(ref)
    for a, b in zip(recs, mine_back):
        for name in a.arrays:
            assert torch.equal(a.arrays[name], b.arrays[name])


def test_tier_compatibility_keys():
    tier = kv_tier.KVTier(page_size=PAGE, host_pool_tokens=64,
                          bytes_per_token=8,
                          meta={"kv_quant": "", "num_layers": 2,
                                "num_kv_heads": 2, "head_dim": 16,
                                "dtype": "float32"})
    assert tier.compatible(dict(tier.meta))
    assert not tier.compatible(dict(tier.meta, head_dim=32))
    assert tier.store.capacity_bytes == 64 * 8
    ref = jtier.KVTier(page_size=PAGE, host_pool_tokens=64,
                       bytes_per_token=8, meta=dict(tier.meta))
    assert ref.meta == tier.meta


# ------------------------------------------------------------ engine level


@pytest.mark.parametrize("n_tokens", [PAGE - 1, PAGE + 1, 2 * PAGE - 1,
                                      2 * PAGE, 2 * PAGE + 1])
def test_offload_restore_parity_at_page_boundaries(params, n_tokens):
    """evict -> offload -> restore gives the cold run's tokens at k*page
    +- 1 (a full-cover chain restores one block short), and the restored
    pages hold the offloaded bytes exactly."""
    eng = _build(params, host_tokens=4096)
    target = _prompt(1, n_tokens)
    hashes = hash_blocks(target, PAGE)
    cold = _serve(eng, target)
    before = _pages_of(eng, hashes)
    _churn(eng, seeds=(50, 51, 52))       # pushes the target out
    if hashes:
        assert eng.stats["kv_tier_offload_pages"] >= len(hashes)
        assert not _pages_of(eng, hashes)
    warm = _serve(eng, target)
    stats = eng.stats
    ref = _greedy_reference(params, target, 4)
    assert cold.token_ids == warm.token_ids == ref
    expect = (n_tokens - 1) // PAGE
    assert stats["kv_tier_restore_pages"] == expect
    if expect:
        assert stats["kv_tier_restore_hits"] == 1
        assert stats["kv_restore_hit_rate"] > 0
        after = _pages_of(eng, hashes[:expect])
        assert len(after) == expect
        for h in after:
            for name, t in after[h].items():
                assert torch.equal(t, before[h][name]), name
    cached = eng._prefix_cache.cached_pages
    assert len(eng._free_pages) + cached == eng._n_pages - 1


def test_offload_rides_the_harvest_thread(params):
    """With the serve loop and the harvest thread running, offloads land
    in the host store and a later turn restores them."""
    eng = _build(params, host_tokens=4096)
    target = _prompt(1, 2 * PAGE + 1)
    with eng:
        cold = eng.submit(target, SP)
        cold.text()
        for s in (50, 51, 52):
            eng.submit(_prompt(s, 32), SP).text()
        deadline = time.monotonic() + 30
        while eng.stats["kv_tier_offload_pages"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        warm = eng.submit(target, SP)
        warm.text()
    assert warm.token_ids == cold.token_ids
    assert eng.stats["kv_tier_restore_pages"] == 2


def test_pricing_skips_expensive_restore(params):
    """A model pricing H2D above recompute re-prefills, says so in
    kv_restore_skipped_cost, and gives the same tokens."""
    eng = _build(params, host_tokens=4096)
    eng._sched._static_cost = eng._sched.cost.__class__(
        prefill_ms_per_token=1e-4, h2d_ms_per_page=1e9)
    target = _prompt(2, 2 * PAGE + 1)
    cold = _serve(eng, target)
    _churn(eng, seeds=(60, 61, 62))
    warm = _serve(eng, target)
    stats = eng.stats
    assert stats["kv_restore_skipped_cost"] >= 1
    assert stats["kv_tier_restore_pages"] == 0
    assert warm.token_ids == cold.token_ids


def test_chaos_restore_fail_falls_back_to_recompute(params):
    eng = _build(params, host_tokens=4096)
    target = _prompt(3, 2 * PAGE + 1)
    cold = _serve(eng, target)
    _churn(eng, seeds=(70, 71, 72))
    faults.set_plan("kv.restore=fail")
    try:
        warm = _serve(eng, target)
        fired = faults.fired("kv.restore")
    finally:
        faults.clear()
    assert fired >= 1
    assert warm.finish_reason == "length"
    assert warm.token_ids == cold.token_ids
    assert eng.stats["kv_tier_restore_pages"] == 0


def test_chaos_offload_fail_drops_pages_untiered(params):
    eng = _build(params, host_tokens=4096)
    faults.set_plan("kv.offload=fail")
    try:
        _churn(eng, seeds=(80, 81, 82, 83))
    finally:
        faults.clear()
    stats = eng.stats
    assert stats["prefix_cache_evicted_pages"] > 0
    assert stats["kv_tier_offload_pages"] == 0


def test_suspend_resume_round_trip_across_engines(params):
    """Suspend on engine A, resume on engine B: B's next turn restores the
    chain (no recompute of it) and continues as the cold run."""
    a = _build(params, host_tokens=4096)
    history = _prompt(5, 3 * PAGE + 5)
    cold = _serve(a, history)
    cached_before = a._prefix_cache.cached_pages
    free_before = len(a._free_pages)
    blob = a.suspend_session(history)
    assert blob is not None
    assert a._prefix_cache.cached_pages == cached_before - 3
    assert len(a._free_pages) == free_before + 3
    assert a.stats["kv_tier_suspended_blocks"] == 3
    assert a.suspend_session(_prompt(99, 40)) is None
    b = _build(params, host_tokens=4096)
    assert b.resume_session(blob) == 3
    warm = _serve(b, history)
    stats = b.stats
    assert stats["kv_tier_resumed_blocks"] == 3
    assert stats["kv_tier_restore_pages"] == 3
    assert warm.token_ids == cold.token_ids \
        == _greedy_reference(params, history, 4)


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32", "int8"])
def test_blobs_resume_across_the_two_implementations(params, kv_quant):
    """A session suspended by the JAX engine resumes on the port's engine
    (and the reverse) with the continuation of an unbroken run on the
    resuming side, restored rather than recomputed."""
    history = _prompt(6, 3 * PAGE + 5)
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    jsp = JParams(max_tokens=4, top_k=1, ignore_eos=True)
    # JAX -> port
    jeng = _jax_build(params, 4096, kv_quant=kv_quant)
    with jeng:
        jcold = jeng.submit(history, jsp)
        jcold.text()
        jblob = jeng.suspend_session(history)
    port_cold = _serve(_build(params, 4096, kv_quant=kv_quant), history)
    port = _build(params, 4096, kv_quant=kv_quant)
    assert port.resume_session(jblob) == 3
    warm = _serve(port, history)
    assert port.stats["kv_tier_restore_pages"] == 3
    assert warm.token_ids == port_cold.token_ids
    if not kv_quant:
        assert warm.token_ids == jcold.token_ids
    # port -> JAX
    blob = port.suspend_session(history)
    assert blob is not None
    jeng2 = _jax_build(params, 4096, kv_quant=kv_quant)
    assert jeng2.resume_session(blob) == 3
    with jeng2:
        jwarm = jeng2.submit(history, jsp)
        jwarm.text()
        jstats = jeng2.stats
    assert jstats["kv_tier_restore_pages"] == 3
    assert jwarm.token_ids == jcold.token_ids


def test_reset_fails_pending_control_ops(params):
    """A control operation queued when the engine resets fails its caller
    at once and never runs."""
    import threading
    eng = _build(params, host_tokens=4096)
    box, done, ran = {}, threading.Event(), []
    eng._control.put((lambda: ran.append(1), done, box))
    eng.reset()
    assert done.is_set()
    assert isinstance(box.get("error"), EngineError)
    assert not ran and eng._control.empty()
    # The rebuilt engine serves.
    assert _serve(eng, _prompt(8, 20)).finish_reason == "length"


def test_resume_rejects_geometry_mismatch(params):
    eng = _build(params, host_tokens=4096)
    history = _prompt(6, 2 * PAGE)
    _serve(eng, history)
    blob = eng.suspend_session(history)
    meta, recs = from_blob(blob)
    with pytest.raises(EngineError, match="geometry"):
        eng.resume_session(to_blob(recs, dict(meta, page_size=999)))
    with pytest.raises(EngineError, match="blob"):
        eng.resume_session(b"not a blob at all")
    assert eng.stats["kv_restore_corrupt"] == 1


def test_tier_disabled_preserves_untiered_behavior(params):
    eng = _build(params, host_tokens=0)
    assert eng._kv_tier is None
    target = _prompt(7, 2 * PAGE + 1)
    cold = _serve(eng, target)
    _churn(eng, seeds=(90, 91, 92))
    warm = _serve(eng, target)
    stats = eng.stats
    assert stats["prefix_cache_evicted_pages"] > 0
    for key in ("kv_tier_offload_pages", "kv_tier_restore_pages",
                "kv_tier_restore_hits", "kv_restore_skipped_cost",
                "kv_tier_host_pages"):
        assert stats[key] == 0, key
    assert warm.token_ids == cold.token_ids \
        == _greedy_reference(params, target, 4)
    with pytest.raises(EngineError, match="disabled"):
        eng.suspend_session(target)


def test_env_beats_the_config_field(params, monkeypatch):
    monkeypatch.setenv("KV_HOST_POOL_TOKENS", "0")
    assert _build(params, host_tokens=4096)._kv_tier is None
    monkeypatch.setenv("KV_HOST_POOL_TOKENS", "512")
    eng = _build(params, host_tokens=None)
    assert eng._kv_tier.host_pool_tokens == 512


def test_int8_kv_offload_restore_serves(params):
    """An int8 pool's four leaves (codes and scale pools) offload and
    restore bit for bit, and the warm turn serves."""
    eng = _build(params, host_tokens=4096, kv_quant="int8")
    target = _prompt(9, 2 * PAGE + 1)
    hashes = hash_blocks(target, PAGE)
    cold = _serve(eng, target)
    before = _pages_of(eng, hashes)
    assert set(next(iter(before.values()))) == {"k", "v", "ks", "vs"}
    _churn(eng, seeds=(95, 96, 97))
    warm = _serve(eng, target)
    assert eng.stats["kv_tier_restore_pages"] == 2
    for h, leaves in _pages_of(eng, hashes).items():
        for name, t in leaves.items():
            assert torch.equal(t, before[h][name])
    assert warm.finish_reason == "length" and len(warm.token_ids) == 4
    assert warm.token_ids[:2] == cold.token_ids[:2]


def test_tier_io_copies_no_host_value_to_the_device(params):
    """Offloads and restores on the serve loop read no device value and
    copy no host value into device state synchronously."""
    from test_torch_harvest import _HostToDevice
    eng = _build(params, host_tokens=4096)
    target = _prompt(1, 2 * PAGE + 1)
    _serve(eng, target)
    with _HostToDevice() as mode:
        _churn(eng, seeds=(50, 51, 52))
        _serve(eng, target)
    assert eng.stats["kv_tier_offload_pages"] > 0
    assert eng.stats["kv_tier_restore_pages"] == 2
    assert mode.seen == [], mode.seen
