"""The bodies the port's engine captures as CUDA graphs, run eagerly on the
CPU: static state written in place, device-side inputs only, state equal
to the JAX engine's after the same admissions and round, and the launch
counts a replay adds.

The JAX engine is driven through its own compiled programs
(``_prefill_insert`` and ``_round_fn``) with the slots and pages the port
chose, so both sides write the same pages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams, graphs)
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul
from generativeaiexamples_tpu_torch.ops.paged_attention import \
    paged_attention_decode

CFG = LLAMA_TINY
PAGE = 16
ENGINE_KW = dict(max_slots=4, max_input_length=64, max_output_length=32,
                 prefill_buckets=(16, 32, 64), dtype="float32", max_queue=64,
                 page_size=PAGE)
SLOT_FIELDS = ("table", "pos", "last_token", "active", "remaining",
               "eos_ok", "temp", "top_k", "top_p", "rep_pen", "seen",
               "banned", "bad_seq", "bad_len", "recent")


@pytest.fixture(scope="module")
def jax_params():
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    return jllama.init_params(JCFG, jax.random.key(11), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu",
                             torch.float32, cfg=CFG)


def _engine(torch_params, **kw):
    return Engine(torch_params, CFG, ByteTokenizer(),
                  EngineConfig(**ENGINE_KW, **kw), device="cpu")


@pytest.fixture(scope="module")
def jax_engines(jax_params):
    """One JAX engine per pool kind, never started; each case resets its
    state."""
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    return {kv: JEngine(jax_params, JCFG, JTok(),
                        JConfig(**ENGINE_KW, kv_quant=kv, prefix_cache=False))
            for kv in ("", "int8")}


def _tensors(tree, prefix=""):
    """(name, tensor) of every tensor in a nested state dict."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _tensors(value, f"{prefix}{name}.")
        else:
            yield prefix + name, value


def _greedy(n):
    return SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)


def _prompt(n, salt=0):
    return [1] + [3 + (7 * i + salt) % 250 for i in range(n - 1)]


def test_state_keeps_its_addresses_across_admissions_and_rounds(
        torch_params):
    """Every state tensor, the pools and the admission inputs included,
    is written in place: a captured program's addresses stay valid."""
    engine = _engine(torch_params, kv_quant="int8")
    before = {n: t.data_ptr() for n, t in _tensors(engine._state)}
    streams = [engine.submit(_prompt(n, n), _greedy(m))
               for n, m in ((15, 5), (17, 3), (30, 9))]
    for _ in range(12):
        engine._step()
    assert all(s.finish_reason == "length" for s in streams)
    engine.submit(_prompt(5), _greedy(20))
    engine._step()
    engine.stop()
    after = {n: t.data_ptr() for n, t in _tensors(engine._state)}
    assert after == before
    assert {"cache.k", "cache.ks", "round_tokens", "admit.i32"} <= set(before)


class _HostSyncs(TorchDispatchMode):
    """Records the operations that read a device value on the host or
    copy a host value to the device: illegal while a CUDA graph captures
    (``.item()``/``int()``, ``nonzero``, boolean-mask indexing,
    ``torch.tensor``)."""

    BAD = ("_local_scalar_dense", "nonzero", "masked_select", "lift_fresh",
           "is_nonzero", "unique", "repeat_interleave")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(b in name for b in self.BAD) or (
                "index" in name and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for a in args if isinstance(a, (list, tuple))
                    for i in a)):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32-pool",
                                                        "int8-pool"])
def test_bodies_make_no_host_read_or_copy(torch_params, kv_quant):
    """The admission and decode-round bodies, greedy and sampled, do
    nothing a CUDA graph cannot capture: every per-request value is read
    on the device."""
    engine = _engine(torch_params, kv_quant=kv_quant)
    req_params = SamplingParams(max_tokens=8, temperature=0.7, top_k=20,
                                top_p=0.9, repetition_penalty=1.1,
                                ignore_eos=True, bad_words=["ab"])
    engine.submit(_prompt(20), req_params)
    engine._step()                    # stages a real request's inputs
    for greedy in (True, False):
        for bucket in engine._buckets[1:]:      # those that hold 20 tokens
            with _HostSyncs() as mode:
                engine._admit_body(bucket, greedy)
            assert mode.seen == [], (bucket, greedy)
        with _HostSyncs() as mode:
            engine._round_body(2, greedy)
        assert mode.seen == [], greedy


def _jax_admit_and_round(jeng, reqs, steps):
    """The JAX engine's admission and round programs on the port's slots
    and pages; returns the round's (steps, B) tokens."""
    B = jeng.cfg.max_slots
    for req in reqs:
        sp = req.params
        total = len(req.prompt_ids)
        bucket = jeng._bucket_for(total)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :total] = req.prompt_ids
        row = np.zeros((jeng._pmax,), np.int32)
        row[:len(req.pages)] = req.pages
        banned, bad_seq, bad_len = jeng._render_bad_words([], [])
        jeng._state, _ = jeng._prefill_insert(
            jeng._state, jeng.params, jnp.asarray(tokens), jnp.int32(total),
            jnp.int32(req.slot), jnp.asarray(row),
            jnp.float32(sp.temperature), jnp.int32(sp.top_k),
            jnp.float32(sp.top_p), jnp.float32(sp.repetition_penalty),
            jnp.asarray(banned), jnp.asarray(bad_seq), jnp.asarray(bad_len),
            jax.random.key(0), jnp.int32(req.eff_max - 1),
            jnp.bool_(not sp.ignore_eos), True)
    ba = jeng._ba_for(len(reqs)) if jeng._fused_tail else B
    act = np.full((ba,), B, np.int32)
    act[:len(reqs)] = sorted(r.slot for r in reqs)
    jeng._state, toks = jeng._round_fn(jeng._pmax, steps, True, ba)(
        jeng.params, jeng._state, jax.random.key(1), jnp.asarray(act))
    return np.asarray(toks)


@pytest.mark.parametrize("lengths", [(PAGE - 1, PAGE), (PAGE, PAGE + 1),
                                     (PAGE + 1, PAGE - 1)],
                         ids=["p-1,p", "p,p+1", "p+1,p-1"])
@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32-pool",
                                                        "int8-pool"])
def test_pools_and_slots_match_jax_engine(torch_params, jax_engines,
                                          lengths, kv_quant):
    """Two admissions (prompts of page-1, page and page+1 tokens) and one
    8-step round: every pool page but the trash page 0 and every slot
    field equal the JAX engine's after the same programs on the same
    slots and pages. float32 pool: atol 1e-5 (the two frameworks' float32
    forwards differ in summation order); int8 pool: rows and scales
    exact. Page 0 is left out: it takes the writes of inactive slots and
    of bucket overhang, several rows to one place in no fixed order, and
    no live slot reads it."""
    engine = _engine(torch_params, kv_quant=kv_quant)
    reqs = []
    for i, n in enumerate(lengths):
        engine.submit(_prompt(n, i), _greedy(12))
    engine._step()                   # both admissions, then one round
    reqs = sorted(engine._slots.values(), key=lambda r: -r.slot)
    assert len(reqs) == 2 and engine.stats["decode_steps"] == 8
    jeng = jax_engines[kv_quant]
    jeng._state = jeng._init_device_state()
    jtoks = _jax_admit_and_round(jeng, reqs, 8)
    np.testing.assert_array_equal(
        engine._state["round_tokens"].numpy(), jtoks)
    ours, theirs = engine._state["cache"], jeng._state["cache"]
    assert set(ours) == set(theirs)
    for name in ours:
        got = ours[name][:, 1:]
        want = np.asarray(theirs[name][:, 1:].astype(jnp.float32))
        if kv_quant:
            np.testing.assert_array_equal(got.float().numpy(), want,
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5, err_msg=name)
    for name in SLOT_FIELDS:
        want = np.asarray(jeng._state[name])
        got = engine._state[name].numpy()
        np.testing.assert_array_equal(got.astype(np.int64) if name in (
            "seen", "banned") else got, want.astype(np.int64) if name in (
            "seen", "banned") else want, err_msg=name)


def test_two_admissions_in_one_step_get_their_own_first_token(
        torch_params):
    """Each admission leaves its first token in its slot's last_token, so
    two admissions of one serve-loop iteration each emit their own: the
    same tokens as when each request runs alone."""
    alone = []
    for n in (9, 23):
        engine = _engine(torch_params)
        s = engine.submit(_prompt(n, n), _greedy(1))
        engine._step()
        alone.append(s.token_ids)
    engine = _engine(torch_params)
    both = [engine.submit(_prompt(n, n), _greedy(1)) for n in (9, 23)]
    engine._step()
    assert engine.stats["prefills"] == 2
    assert [s.token_ids for s in both] == alone
    assert alone[0] != alone[1]


@pytest.mark.parametrize("steps_per_round,ladder", [
    (8, (8, 4, 2, 1)), (6, (6, 3, 1)), (1, (1,))])
def test_round_rungs_cover_every_dispatch(steps_per_round, ladder):
    """One program per rung: whatever a round needs, ``rung_for`` picks a
    captured rung, the shortest that covers the need (or the longest)."""
    assert graphs.round_rungs(steps_per_round) == ladder
    for need in range(1, 3 * steps_per_round + 2):
        steps = graphs.rung_for(steps_per_round, need)
        assert steps in ladder
        assert steps >= min(need, steps_per_round)
        assert all(r < need for r in ladder if r < steps)


def test_replay_adds_the_capture_launch_counts():
    """A capture's counts are taken back (it launched nothing) and kept;
    each replay adds them again, in total and by int4 path."""
    saved = graphs.launch_counts()
    try:
        graphs.set_launch_counts(dict.fromkeys(saved, 0))
        before = graphs.launch_counts()
        paged_attention_decode.int8_launches += 32
        int4_matmul.launches += 225
        int4_matmul.launches_by_path["tc"] += 225
        delta = graphs.count_delta(before, graphs.launch_counts())
        assert delta == {"paged_attention_decode_int8": 32,
                         "int4_matmul": 225, "int4_matmul/tc": 225}
        graphs.set_launch_counts(before)
        assert graphs.launch_counts() == before

        replays = []
        program = graphs.Program(
            type("G", (), {"replay": lambda self: replays.append(1)})(),
            delta)
        for _ in range(3):
            program.replay()
        assert len(replays) == 3
        now = graphs.launch_counts()
        assert now["paged_attention_decode_int8"] == 96
        assert now["int4_matmul"] == 675
        assert int4_matmul.launches_by_path == {"tc": 675, "gemv": 0,
                                                "tile": 0, "wg": 0}
        assert now["paged_attention_decode"] == 0
        graphs.add_launch_counts({"int4_matmul/wg": 224}, times=2)
        assert int4_matmul.launches_by_path["wg"] == 448
    finally:
        graphs.set_launch_counts(saved)


def test_cpu_engine_runs_the_bodies_eagerly(torch_params):
    """On the CPU nothing is captured, whatever ``cuda_graphs`` says."""
    for flag in (True, False):
        engine = _engine(torch_params, cuda_graphs=flag)
        assert not engine._graphs_on
        assert engine._round_graphs == {} and engine._admit_graphs == {}
        assert engine.graph_pool_bytes == 0


def test_busy_time_is_the_union_of_device_intervals():
    """``profile_decode``'s busy time counts a stretch in which two device
    activities overlap (a programmatic dependent launch starting under its
    predecessor) once; the summed durations count it twice."""
    from types import SimpleNamespace

    from generativeaiexamples_tpu_torch.tools.profile_decode import (
        _busy_us, _kernel_times)

    def ev(name, a, b):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(
            start=a, end=b, elapsed_us=lambda: b - a))

    events = [ev("k", 0, 10), ev("merge", 8, 12), ev("k", 20, 25),
              ev("copy", 21, 22)]
    assert _busy_us(events) == 17
    assert _kernel_times(events) == {"k": (15, 2), "merge": (4, 1),
                                     "copy": (1, 1)}
    assert _busy_us([]) == 0
