"""The online cost calibrator (``engine/scheduler.py`` ``OnlineCalibrator``,
``TokenBudgetScheduler.recalibrate``) and the engine's feed, against the
JAX package on the CPU.

The calibrator's blended model equals the reference's on the same
observations (float64 host arithmetic, compared exactly); the budget moves
only when unpinned; the engine folds pure rounds' device time into it
(host-clock estimates on the CPU; CUDA events on the card) and a moved
chunk cap still runs every chunk as a captured bucket's program."""

import math

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.engine.scheduler import (
    OnlineCalibrator, StepCostModel, TokenBudgetScheduler,
    derive_round_budget, online_calib_enabled)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

from generativeaiexamples_tpu.engine import scheduler as jsched

PAGE = 16


def test_online_calib_env_gate(monkeypatch):
    for raw, want in (("", True), ("0", False), ("1", True),
                      ("false", False), ("off", False), ("yes", True)):
        monkeypatch.setenv("SCHED_ONLINE_CALIB", raw)
        assert online_calib_enabled() is want
        assert jsched.online_calib_enabled() is want
    monkeypatch.delenv("SCHED_ONLINE_CALIB")
    assert online_calib_enabled()


def test_calibrator_blends_toward_measurement():
    prior = StepCostModel(decode_step_ms=100.0, prefill_ms_per_token=10.0)
    cal = OnlineCalibrator(prior, warmup=2)
    assert cal.current() is prior
    for _ in range(50):
        cal.observe_decode(4, 8.0)             # measured 2 ms/step
        cal.observe_prefill(100, 10.0)         # measured 0.1 ms/token
    cur = cal.current()
    assert cur.decode_step_ms == pytest.approx(2.0, rel=0.1)
    assert cur.prefill_ms_per_token == pytest.approx(0.1, rel=0.1)
    assert cur.source.endswith("+online")
    version = cal.version
    cal.observe_decode(0, 5.0)                 # junk is ignored
    cal.observe_prefill(10, -1.0)
    cal.observe_verify(8, float("nan"))
    assert cal.version == version


def test_calibrator_equals_the_reference_on_the_same_observations():
    rng = np.random.default_rng(0)
    prior = dict(decode_step_ms=3.0, prefill_ms_per_token=0.2,
                 verify_ms_per_token=0.05, h2d_ms_per_page=0.01,
                 d2h_ms_per_page=0.02)
    mine = OnlineCalibrator(StepCostModel(**prior), alpha=0.3, warmup=3)
    ref = jsched.OnlineCalibrator(jsched.StepCostModel(**prior), alpha=0.3,
                                  warmup=3)
    kinds = ("decode", "prefill", "verify", "h2d", "d2h")
    for i in range(60):
        kind = kinds[int(rng.integers(0, 5))]
        n, ms = int(rng.integers(1, 64)), float(rng.random() * 20)
        getattr(mine, "observe_" + kind)(n, ms)
        getattr(ref, "observe_" + kind)(n, ms)
        a, b = mine.current(), ref.current()
        for field in prior:
            assert getattr(a, field) == getattr(b, field), (i, field)
        assert mine.version == ref.version


def test_pricing_matches_the_reference():
    for kw in (dict(), dict(verify_ms_per_token=0.3,
                            prefill_ms_per_token=0.1),
               dict(h2d_ms_per_page=2.0, prefill_ms_per_token=0.1),
               dict(h2d_ms_per_page=0.5, prefill_ms_per_token=0.1)):
        mine, ref = StepCostModel(**kw), jsched.StepCostModel(**kw)
        for n in (0, 1, 7, 64):
            assert mine.verify_cost_tokens(n) == ref.verify_cost_tokens(n)
            assert mine.restore_ms(n) == ref.restore_ms(n)
            assert mine.restore_cheaper(n, PAGE) == \
                ref.restore_cheaper(n, PAGE)


def test_scheduler_recalibrate_moves_unpinned_budget_only():
    prior = StepCostModel(decode_step_ms=100.0, prefill_ms_per_token=0.01)
    cal = OnlineCalibrator(prior, warmup=1)
    sched = TokenBudgetScheduler(prior, page_size=PAGE, steps_per_round=4,
                                 calibrator=cal, max_one_shot_tokens=96)
    big = sched.round_budget_tokens
    assert big == derive_round_budget(prior, 4, PAGE)
    assert not sched.recalibrate()             # no new evidence yet
    for _ in range(50):
        cal.observe_decode(4, 8.0)             # really 2 ms/step
        cal.observe_prefill(16, 2.0)           # really 0.125 ms/token
    assert sched.recalibrate()
    assert sched.round_budget_tokens < big
    assert sched.round_budget_tokens == derive_round_budget(cal.current(), 4,
                                                           PAGE)
    # The chunk cap follows, clamped to the largest one-shot bucket.
    assert sched.chunk_tokens == min(sched.round_budget_tokens, 96)
    pinned = TokenBudgetScheduler(prior, page_size=PAGE, steps_per_round=4,
                                  round_budget_tokens=48, calibrator=cal)
    cal.observe_decode(4, 8.0)
    assert not pinned.recalibrate()
    assert pinned.round_budget_tokens == 48
    # The reference's scheduler makes the same moves.
    jcal = jsched.OnlineCalibrator(jsched.StepCostModel(
        decode_step_ms=100.0, prefill_ms_per_token=0.01), warmup=1)
    jsch = jsched.TokenBudgetScheduler(jcal.prior, page_size=PAGE,
                                       steps_per_round=4, calibrator=jcal,
                                       max_one_shot_tokens=96)
    for _ in range(50):
        jcal.observe_decode(4, 8.0)
        jcal.observe_prefill(16, 2.0)
    assert jsch.recalibrate()
    assert (jsch.round_budget_tokens, jsch.chunk_tokens) == \
        (sched.round_budget_tokens, sched.chunk_tokens)


def test_pinned_budget_holds_then_lets_go():
    """``pinned_budget`` holds the budget where it stands (or at a given
    value) through new evidence, and afterwards the calibrator moves it
    again."""
    prior = StepCostModel(decode_step_ms=100.0, prefill_ms_per_token=0.01)
    cal = OnlineCalibrator(prior, warmup=1)
    sched = TokenBudgetScheduler(prior, page_size=PAGE, steps_per_round=4,
                                 calibrator=cal)
    big = sched.round_budget_tokens
    with sched.pinned_budget() as held:
        assert held == big
        for _ in range(50):
            cal.observe_decode(4, 8.0)
            cal.observe_prefill(16, 2.0)
        assert not sched.recalibrate() and sched.round_budget_tokens == big
        with sched.pinned_budget(1) as low:
            assert low == PAGE == sched.round_budget_tokens
        assert sched.round_budget_tokens == big
    assert sched.recalibrate() and sched.round_budget_tokens < big


def _engine(monkeypatch, calib: str, **kw):
    monkeypatch.setenv("SCHED_ONLINE_CALIB", calib)
    params = llama.init_params(LLAMA_TINY, seed=5, dtype=torch.float32)
    return Engine(params, LLAMA_TINY, ByteTokenizer(), EngineConfig(**{
        **dict(max_slots=2, max_input_length=96, max_output_length=24,
               prefill_buckets=(16, 32, 64, 96), page_size=PAGE,
               dtype="float32", kv_pool_tokens=None, steps_per_round=4),
        **kw}), device="cpu")


def _drive(engine, streams, limit=500):
    for _ in range(limit):
        if all(s.finish_reason is not None for s in streams) \
                and not engine._slots:
            return streams
        engine._step()
    raise AssertionError("requests did not finish")


def test_engine_feeds_pure_rounds_and_recalibrates(monkeypatch):
    """Served rounds reach the calibrator by kind (mixed rounds feed
    nothing), each budget move is counted, and the budget is the one the
    blended model derives."""
    eng = _engine(monkeypatch, "1")
    seen = []
    real = eng._calib._observe

    def spy(key, value):
        seen.append(key)
        real(key, value)
    eng._calib._observe = spy
    sp = SamplingParams(max_tokens=20, top_k=1, ignore_eos=True)
    first = eng.submit([(7 * i) % 200 + 4 for i in range(70)], sp)
    for _ in range(3):
        eng._step()
    # A second prompt admitted beside the decoding one: a mixed round.
    _drive(eng, [first, eng.submit([(3 * i) % 200 + 4 for i in range(40)],
                                   sp)])
    assert {"decode_step_ms", "prefill_ms_per_token"} <= set(seen)
    mine = [r for r in eng.rounds.records()
            if r.engine_tag == eng.engine_tag and r.done and r.device_ms > 0]
    decode = sum(1 for r in mine
                 if r.kind == "decode" and not r.prefill_tokens)
    prefill = sum(1 for r in mine if r.kind == "prefill")
    assert any(r.kind == "mixed" for r in mine)
    assert (seen.count("decode_step_ms"), seen.count("prefill_ms_per_token"),
            len(seen)) == (decode, prefill, decode + prefill)
    stats = eng.stats
    eng._step()
    assert stats["sched_budget_recalibrations"] >= 1
    assert eng._sched.round_budget_tokens == derive_round_budget(
        eng._sched.cost, 4, PAGE)
    assert eng.stats["sched_round_budget_tokens"] == \
        eng._sched.round_budget_tokens


def test_calibration_off_and_pinned_budgets_never_move(monkeypatch):
    off = _engine(monkeypatch, "0")
    assert off._calib is None
    pinned = _engine(monkeypatch, "1", sched_round_budget_tokens=48)
    for eng in (off, pinned):
        budget = eng._sched.round_budget_tokens
        _drive(eng, [eng.submit(list(range(4, 60)), SamplingParams(
            max_tokens=12, top_k=1, ignore_eos=True))])
        assert eng._sched.round_budget_tokens == budget
        assert eng.stats["sched_budget_recalibrations"] == 0


def test_a_recalibrated_chunk_cap_runs_captured_buckets(monkeypatch):
    """Whatever cap the calibrator sets, every chunk runs as the program
    of the smallest bucket holding it, so no program is missing in the
    middle of serving."""
    eng = _engine(monkeypatch, "1")
    calls = []
    real = eng._replay

    def record(table, body, *key):
        calls.append((table is eng._extend_graphs
                      or table is eng._final_graphs
                      or table is eng._admit_graphs, key))
        real(table, body, *key)
    eng._replay = record
    # Evidence that makes the budget (and cap) 48 tokens: not a bucket.
    for _ in range(20):
        eng._calib.observe_decode(4, 4.0 * 4)
        eng._calib.observe_prefill(1, 4 * 4.0 / 48.5)
    assert eng._sched.recalibrate()
    assert eng._sched.chunk_tokens == 48
    assert 48 not in eng._buckets
    # A long prompt beside a decoding stream goes in chunks of the cap.
    sp = SamplingParams(max_tokens=20, top_k=1, ignore_eos=True)
    short = eng.submit([5, 6, 7], sp)
    eng._step()
    eng._step()
    _drive(eng, [short, eng.submit([(5 * i) % 200 + 4 for i in range(90)],
                                   sp)])
    chunk_keys = [key for is_chunk, key in calls if is_chunk]
    assert len(chunk_keys) >= 2
    assert all(key[0] in eng._buckets for key in chunk_keys)


def test_round_device_time_reads_events_only_once_done():
    """On the card a round's device time is the CUDA events' elapsed time,
    read only after ``query`` says the end event completed (``query``
    never waits); a round with no events on the card feeds nothing."""
    class Ev:
        def __init__(self, done, ms=0.0):
            self.done, self.ms = done, ms

        def query(self):
            return self.done

        def elapsed_time(self, end):
            assert end.done, "elapsed_time before the end event completed"
            return end.ms

    class Rec:
        device_events = None
        device_ms = 3.5

    eng = Engine.__new__(Engine)
    eng.device = torch.device("cpu")
    rec = Rec()
    assert eng._round_device_ms(rec) == 3.5
    eng.device = torch.device("cuda")
    assert eng._round_device_ms(rec) == 0.0
    rec.device_events = (Ev(True), Ev(False, 2.0))
    assert eng._round_device_ms(rec) == 0.0
    rec.device_events = (Ev(True), Ev(True, 2.0))
    assert eng._round_device_ms(rec) == 2.0
    assert math.isfinite(eng._round_device_ms(rec))
