"""The port's token-budget scheduler (``engine/scheduler.py``) against the
JAX package's on the CPU: the same plans over generated inputs, the same
budget derivation, and the engine's use of it (the prior it plans with,
decode-only rounds as before, and no profile file read)."""

import builtins
import glob
import os

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams, graphs)
from generativeaiexamples_tpu_torch.engine.scheduler import (
    PrefillJob, StepCostModel, TokenBudgetScheduler, derive_round_budget)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer


def _jobs(cls, specs, started):
    return [cls(key=(started, i), remaining=r, seq=s, started=started)
            for i, (r, s) in enumerate(specs)]


_job_specs = st.lists(st.tuples(st.integers(1, 5000), st.integers(0, 50)),
                      max_size=6)


@settings(max_examples=300, deadline=None)
@given(budget=st.one_of(st.none(), st.integers(1, 4096)),
       chunk=st.one_of(st.none(), st.integers(1, 4096)),
       page=st.sampled_from([16, 64, 128]),
       steps=st.integers(0, 8), active=st.integers(0, 8),
       inflight=_job_specs, backlog=_job_specs,
       max_new=st.one_of(st.none(), st.integers(0, 8)),
       one_shot=st.one_of(st.none(), st.sampled_from([128, 1024, 3072])),
       rounds=st.integers(1, 3))
def test_plan_round_matches_jax(budget, chunk, page, steps, active, inflight,
                                backlog, max_new, one_shot, rounds):
    """Identical chunks (and budgets, caps and decode prices) for the same
    inputs, over consecutive rounds so the scarcity rotation advances
    alike."""
    from generativeaiexamples_tpu.engine import scheduler as jsched
    kw = dict(page_size=page, steps_per_round=8, round_budget_tokens=budget,
              chunk_tokens=chunk, max_one_shot_tokens=one_shot)
    ours = TokenBudgetScheduler(StepCostModel(), **kw)
    theirs = jsched.TokenBudgetScheduler(jsched.StepCostModel(), **kw)
    assert ours.round_budget_tokens == theirs.round_budget_tokens
    assert ours.chunk_tokens == theirs.chunk_tokens
    for _ in range(rounds):
        a = ours.plan_round(
            decode_steps=steps, active_decodes=active,
            inflight=_jobs(PrefillJob, inflight, True),
            backlog=_jobs(PrefillJob, backlog, False), max_new=max_new)
        b = theirs.plan_round(
            decode_steps=steps, active_decodes=active,
            inflight=_jobs(jsched.PrefillJob, inflight, True),
            backlog=_jobs(jsched.PrefillJob, backlog, False),
            max_new=max_new)
        assert a.chunks == b.chunks
        assert a.decode_cost_tokens == b.decode_cost_tokens


@pytest.mark.parametrize("decode_ms,prefill_ms", [
    (2.0, 0.125), (9.4, 0.0235), (7.2, 0.029), (0.1, 10.0), (30.0, 0.001)])
@pytest.mark.parametrize("page", [16, 128])
def test_budget_derivation_matches_jax(decode_ms, prefill_ms, page):
    from generativeaiexamples_tpu.engine import scheduler as jsched
    ours = StepCostModel(decode_step_ms=decode_ms,
                         prefill_ms_per_token=prefill_ms)
    theirs = jsched.StepCostModel(decode_step_ms=decode_ms,
                                  prefill_ms_per_token=prefill_ms)
    for steps in (1, 4, 8):
        assert derive_round_budget(ours, steps, page) == \
            jsched.derive_round_budget(theirs, steps, page)
    assert ours.prefill_s(1000) == theirs.prefill_s(1000)


@pytest.mark.parametrize("profile", [
    {"full_ms_per_step": 9.0, "slots": 8, "prefill_ms_per_token": 0.02},
    {"full_ms_per_step": 9.0, "slots": 4}, {}])
def test_cost_model_from_profile_matches_jax(profile):
    from generativeaiexamples_tpu.engine import scheduler as jsched
    ours = StepCostModel.from_profile(profile)
    theirs = jsched.StepCostModel.from_profile(profile)
    assert (ours.decode_step_ms, ours.prefill_ms_per_token, ours.slots) == (
        theirs.decode_step_ms, theirs.prefill_ms_per_token, theirs.slots)


def _engine(**kw):
    params = llama.init_params(LLAMA_TINY, seed=1, dtype=torch.float32)
    return Engine(params, LLAMA_TINY, ByteTokenizer(), EngineConfig(
        max_slots=4, max_input_length=64, max_output_length=32,
        prefill_buckets=(16, 64), page_size=16, dtype="float32", **kw),
        device="cpu")


def test_engine_prior_pins_then_defaults():
    """On the CPU the engine plans with the class defaults (8 steps of
    2 ms over 0.125 ms a token: 128 tokens); the config pins win."""
    engine = _engine()
    assert engine._sched.cost == StepCostModel(slots=4)
    assert engine.stats["sched_round_budget_tokens"] == 128
    assert engine._sched.chunk_tokens == 64        # the largest bucket
    pinned = _engine(sched_round_budget_tokens=40,
                     sched_prefill_chunk_tokens=20)
    assert pinned.stats["sched_round_budget_tokens"] == 40
    assert pinned._sched.chunk_tokens == 20


def test_scheduler_reads_no_profile_file(monkeypatch):
    """Building an engine and planning rounds opens, lists and globs no
    file: the reference's ``PROFILE_r*.json`` are TPU measurements."""
    seen = []
    real_open, real_glob, real_listdir = builtins.open, glob.glob, os.listdir

    def spy(real):
        def call(path, *a, **k):
            seen.append(str(path))
            return real(path, *a, **k)
        return call

    monkeypatch.setattr(builtins, "open", spy(real_open))
    monkeypatch.setattr(glob, "glob", spy(real_glob))
    monkeypatch.setattr(os, "listdir", spy(real_listdir))
    engine = _engine()
    s = engine.submit([1] + [5] * 40, SamplingParams(
        max_tokens=3, top_k=1, ignore_eos=True))
    for _ in range(10):
        engine._step()
    assert s.finish_reason == "length"
    assert not [p for p in seen if "PROFILE" in p]
    assert not hasattr(StepCostModel, "load")


def test_decode_only_rounds_follow_the_step_ladder():
    """With nothing to admit, every round is the rung the pre-scheduler
    loop picked for the slots' remaining steps, and the scheduler charges
    only decode."""
    engine = _engine()
    streams = [engine.submit([1] + [7 + i] * 10, SamplingParams(
        max_tokens=m, top_k=1, ignore_eos=True))
        for i, m in enumerate((13, 6, 3))]
    engine._step()                       # admissions only
    assert engine.stats["decode_rounds"] == 0
    rounds = []
    while not all(s.finish_reason for s in streams):
        need = max(r.extent - 1 - r.proj_pos
                   for r in engine._armed().values())
        before = engine.stats["decode_steps"]
        engine._step()
        rounds.append((graphs.rung_for(8, need),
                       engine.stats["decode_steps"] - before))
    assert rounds == [(want, want) for want, _ in rounds]
    assert [n for n, _ in rounds] == [8, 4]
    st = engine.stats
    assert st["sched_prefill_tokens"] == 33
    assert st["sched_interleaved_rounds"] == 0
    assert [len(s.token_ids) for s in streams] == [13, 6, 3]
