"""The port's observability modules (``generativeaiexamples_tpu_torch/obs``,
``utils/logging.py``, ``utils/hbm.py``) held against the reference
package's: the same registry calls render the same Prometheus text, the
same headers give the same request IDs and deadlines, the declared metric
surfaces are equal, the same synthetic history fires the same alerts, and
the recorders build the same records. All host code; exact equality."""

import json

import pytest

from generativeaiexamples_tpu.obs import alerts as ref_alerts
from generativeaiexamples_tpu.obs import flight as ref_flight
from generativeaiexamples_tpu.obs import history as ref_history
from generativeaiexamples_tpu.obs import incidents as ref_incidents
from generativeaiexamples_tpu.obs import metrics as ref_metrics
from generativeaiexamples_tpu.obs import rounds as ref_rounds
from generativeaiexamples_tpu_torch.obs import alerts, flight, history
from generativeaiexamples_tpu_torch.obs import incidents, metrics, rounds
from generativeaiexamples_tpu_torch.obs import tracing
from generativeaiexamples_tpu_torch.utils import hbm
from generativeaiexamples_tpu_torch.utils import logging as port_logging


def _drive_registry(mod):
    """One sequence of registry calls: every metric kind, labels, custom
    buckets, escapes, a histogram's overflow bucket."""
    reg = mod.Registry()
    reg.counter("reqs_total", "requests\nserved").inc()
    reg.counter("reqs_total").inc(2.5)
    g = reg.gauge("depth", 'queue "depth"', labelnames=("engine",))
    g.labels("e0").set(3)
    g.labels(engine='we"ird\\').set(-1.25)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0, 0.01))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    st = reg.histogram("stage_seconds", "by stage", labelnames=("stage",),
                       buckets=mod.STAGE_BUCKETS)
    st.labels("prefill").observe(0.002)
    st.labels(stage="decode").observe(0.3)
    mod.observe_stage("engine_ttft", 0.07, registry=reg)
    timer = mod.RequestTimer("serve_chat", registry=reg)
    return reg, timer


def test_registry_renders_the_references_text():
    ours, _ = _drive_registry(metrics)
    ref, _ = _drive_registry(ref_metrics)
    text = ours.render_prometheus()
    assert text == ref.render_prometheus()
    assert ours.snapshot() == ref.snapshot() and ours.kinds() == ref.kinds()
    assert ref_metrics.lint_prometheus(text) == []
    b = (0.01, 0.1, 1.0)
    assert ours.histogram("lat_seconds", buckets=b).percentile(0.5) == \
        ref.histogram("lat_seconds", buckets=b).percentile(0.5) == 0.1
    with pytest.raises(ValueError, match="already registered"):
        ours.gauge("reqs_total")
    with pytest.raises(ValueError, match="buckets"):
        ours.histogram("lat_seconds", buckets=(1.0,))


def test_engine_stats_mirror_names_and_averages():
    """``record_engine_stats`` publishes every numeric key as an
    ``engine_*`` gauge (booleans and strings skipped) and the stage
    averages, with the reference's names and values."""
    stats = {"requests": 3, "harvest_wait_ms": 12.0, "harvest_rounds": 4,
             "first_readback_ms": 1.5, "first_readbacks": 3, "flag": True,
             "name": "x", "prefix_cache_hit_rate": 0.25}
    snaps = []
    for mod in (metrics, ref_metrics):
        reg = mod.Registry()
        mod.record_engine_stats(stats, registry=reg)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["engine_harvest_wait_ms_avg"] == 3.0
    assert "engine_flag" not in snaps[0] and "engine_name" not in snaps[0]


def test_declared_metric_surfaces_are_the_references():
    assert rounds.ROUND_METRICS == ref_rounds.ROUND_METRICS
    assert rounds.ROUND_TOKEN_BUCKETS == ref_rounds.ROUND_TOKEN_BUCKETS
    assert metrics.PROCESS_METRICS == ref_metrics.PROCESS_METRICS
    assert metrics.ENGINE_STAGE_AVGS == ref_metrics.ENGINE_STAGE_AVGS
    assert metrics.STAGE_BUCKETS == ref_metrics.STAGE_BUCKETS
    assert metrics.TPS_BUCKETS == ref_metrics.TPS_BUCKETS
    reg = metrics.Registry()
    metrics.record_process_stats(registry=reg)
    snap = reg.snapshot()
    assert set(snap) == {n for n, _ in metrics.PROCESS_METRICS}
    assert snap["process_threads"] >= 1 and snap["process_rss_bytes"] > 0


TRACE = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
HEADER_SETS = [
    None, {}, {"X-Request-ID": "client-7"}, {"X-Request-ID": "  padded  "},
    {"X-Request-ID": "x" * 300}, {"X-Request-ID": 'a{b}"c\\d\x07e'},
    {"X-Request-ID": "", "traceparent": TRACE}, {"traceparent": TRACE},
    {"traceparent": "00-short-b7ad6b7169203331-01"}, {"traceparent": "junk"},
    {"X-Request-ID": "{}\"\\"},
    {"X-Deadline-Ms": "250"}, {"X-Deadline-Ms": " 1.5 "},
    {"X-Deadline-Ms": "0"}, {"X-Deadline-Ms": "-4"},
    {"X-Deadline-Ms": "soon"}, {"X-Deadline-Ms": ""},
    {"X-Deadline-Ms": "1e3", "X-Request-ID": "both"},
]


@pytest.mark.parametrize("headers", HEADER_SETS,
                         ids=[str(i) for i in range(len(HEADER_SETS))])
@pytest.mark.parametrize("default_ms", [None, 5000.0])
def test_request_id_and_deadline_adoption(headers, default_ms):
    mint = lambda: "minted"  # noqa: E731
    assert flight.adopt_request_id(headers, mint=mint) == \
        ref_flight.adopt_request_id(headers, mint=mint)
    assert flight.adopt_deadline_ms(headers, default_ms) == \
        ref_flight.adopt_deadline_ms(headers, default_ms)
    assert len(flight.adopt_request_id(headers)) <= 128


def test_flight_recorder_matches_the_reference():
    """The same begin/complete sequence: a duplicate in-flight ID gets
    the same ``#N`` suffix, the same snapshot shape and stage averages."""
    out = []
    for mod in (flight, ref_flight):
        rec = mod.FlightRecorder(completed_cap=4, event_cap=8)
        a = rec.begin("dup", fresh=True)
        b = rec.begin("dup", fresh=True)
        c = rec.begin("dup", fresh=True)
        same = rec.begin("dup")
        a.stage("engine_admit_pickup", 0.004)
        a.annotate(slot=1)
        a.set_deadline(250)
        for i in range(12):
            b.event("decode_round", i)
        rec.complete(a)
        rec.complete(b)
        snap = rec.snapshot(limit=10)
        out.append(([t.request_id for t in (a, b, c, same)],
                    rec.recent_stage_ms("engine_admit_pickup"),
                    {k: (sorted(v[0]) if isinstance(v, list) and v else v)
                     for k, v in snap.items() if k != "completed"},
                    [(sorted(d), d["events_dropped"],
                      {k: v for k, v in d["meta"].items()
                       if k != "duration_ms"})
                     for d in snap["completed"]]))
    assert out[0] == out[1]
    assert out[0][0] == ["dup", "dup#2", "dup#3", "dup"]


def _synthetic_history(hmod, mmod):
    reg = mmod.Registry()
    hist = hmod.MetricHistory(registry=reg, window_s=600, interval_s=1.0)
    return reg, hist


class _Clock:
    """A stand-in for the ``time`` module of a history: samples 40 s
    apart, whatever the machine's speed."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


@pytest.mark.parametrize("server", ["model", "chain", "router"])
def test_the_same_history_fires_the_same_alerts(server, monkeypatch):
    """One synthetic series (cost drift above 1.5, a shed counter that
    climbs then stops, a watchdog gauge that steps, a replica's SLO
    attainment that dips) through each package's history and its default
    rules, sampled 40 s apart: the same transitions at the same ticks,
    and the same /debug/alerts body."""
    runs = []
    for hmod, amod, mmod in ((history, alerts, metrics),
                             (ref_history, ref_alerts, ref_metrics)):
        clock = _Clock()
        monkeypatch.setattr(hmod, "time", clock)
        reg, hist = _synthetic_history(hmod, mmod)
        eng = amod.AlertEngine(hist, registry=reg, server=server)
        drift = reg.gauge("engine_sched_cost_drift_ratio", "drift")
        shed = reg.counter("shed_total", "sheds", labelnames=("reason",))
        stalls = reg.gauge("engine_watchdog_stalls", "stalls")
        slo = reg.gauge("router_slo_attainment", "slo",
                        labelnames=("replica",))
        trace = []
        for t, (d, s, w, a) in enumerate([(1.0, 0, 0, 1.0), (3.0, 5, 0, 0.5),
                                          (3.0, 400, 1, 0.5),
                                          (3.0, 400, 1, 0.5),
                                          (0.9, 400, 1, 1.0)]):
            drift.set(d)
            shed.labels("queue_full").inc(s)
            stalls.set(w)
            slo.labels("r0").set(a)
            clock.t = 1000.0 + 40.0 * t
            hist.sample_once()
            trace.append([(r["rule"], r["state"], r["prev"])
                          for r in eng.tick(now=1000.0 + 40.0 * t)])
        body = eng.snapshot()
        for row in body["rules"]:
            row.pop("since")
            row["evidence"] = sorted(row["evidence"].get("series", {}))
        runs.append((trace, body, reg.snapshot()))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1]
    assert runs[0][2] == runs[1][2]
    assert any(tr for tr in runs[0][0])


def test_history_query_matches_and_inert_stack(tmp_path, monkeypatch):
    monkeypatch.setenv("GAIE_RUN_DIR", str(tmp_path))
    outs = []
    for hmod, mmod in ((history, metrics), (ref_history, ref_metrics)):
        reg, hist = _synthetic_history(hmod, mmod)
        c = reg.counter("x_total", "x")
        for v in (1, 3, 0, 4):
            c.inc(v)
            hist.sample_once()
        q = hist.query(metrics="x_*")
        q.pop("span_s")
        for entry in q["series"].values():
            entry.pop("rate_per_s")
        outs.append(q)
    assert outs[0] == outs[1] and outs[0]["series"]["x_total"]["delta"] == 7
    inert = incidents.ObservabilityStack("model", interval_s=0)
    inert.start()
    assert (inert.alerts is None and inert.store is None
            and inert.history._thread is None)
    assert inert.capture({"kind": "manual"}) is None
    assert not (tmp_path / "incidents").exists()
    live = incidents.ObservabilityStack("model", interval_s=60,
                                        flight=flight.FlightRecorder())
    path = live.capture({"kind": "manual", "rule": None})
    bundle = json.load(open(path))
    ref = ref_incidents.build_bundle(
        server="model", trigger={"kind": "manual", "rule": None},
        history=None, alerts=None, flight=ref_flight.FlightRecorder())
    assert set(bundle) - {"id"} == set(ref)
    assert path.startswith(str(tmp_path))
    assert live.store.list()["count"] == 1


def _drive_rounds(rmod):
    rec = rmod.RoundRecorder(cap=4)
    done = []
    a = rec.begin(engine_tag="e0", budget_tokens=256, decode_steps=8,
                  decode_cost_tokens=16, active_decodes=2,
                  on_complete=done.append)
    a.hbm_bytes = 1000
    rec.complete_part(a, tokens=16, harvest_wait_ms=0.5)   # before seal
    assert not a.done
    rec.seal(a, parts=2, prefill_tokens=128, grants=[("r1", 128)],
             modeled_ms=3.0)
    rec.first_token(a, wait_ms=0.25)
    rec.complete_part(a, harvest_wait_ms=0.1)
    b = rec.begin(engine_tag="e1", kind="prefill")
    rec.discard(b)
    c = rec.begin(engine_tag="e0")
    return rec, a, c, done


def test_round_recorder_matches_the_reference():
    """The same begin/seal/complete_part sequence (a part harvested before
    the seal, a discarded record): the same completion, the same record
    and snapshot shapes, the same metrics."""
    shapes = []
    for rmod in (rounds, ref_rounds):
        rec, a, c, done = _drive_rounds(rmod)
        assert a.done and done == [a] and not c.done
        d = a.to_dict()
        snap = rec.snapshot(limit=10, engine_tag="e0")
        shapes.append((
            {k: sorted(v) if isinstance(v, dict) else v
             for k, v in d.items() if k not in ("started_unix_ms",
                                                "execution")},
            sorted(d["execution"]), [r["round_id"] for r in snap["rounds"]],
            sorted(snap["aggregates"]), snap["retained"],
            a.tokens_emitted, a.first_tokens, a.prefill_tokens))
    assert shapes[0] == shapes[1]
    assert shapes[0][2] == [2, 0]


def test_tracing_is_off_by_default_and_lazy(monkeypatch):
    """With ENABLE_TRACING unset the helpers are no-ops that import no
    OpenTelemetry; ``record_stage`` still feeds the stage histogram."""
    import asyncio
    import sys
    monkeypatch.delenv("ENABLE_TRACING", raising=False)
    tracing.set_enabled(None)
    assert not tracing.enabled() and tracing._get_tracer() is None

    @tracing.instrumented("probe")
    async def handler(request):
        return "ok"

    assert asyncio.run(handler(object())) == "ok"
    with tracing.event_span("probe_stage", size=3) as span:
        assert span is None
    child = metrics._stage_children["probe_stage"]
    assert child.count >= 1
    monkeypatch.setenv("ENABLE_TRACING", "true")
    assert tracing.enabled()
    tracing.set_enabled(False)
    assert not tracing.enabled()
    tracing.set_enabled(None)
    assert "opentelemetry" not in sys.modules or tracing._tracer is None


def test_peak_bandwidth_table(monkeypatch):
    """The card's peak rate by name: H100 SXM (its name says HBM3) and
    PCIe from their public specs; the CPU and unknown cards have none."""
    assert hbm.peak_bw("cpu") == 0.0
    names = {"NVIDIA H100 80GB HBM3": 3.35e12, "NVIDIA H100 SXM5 80GB":
             3.35e12, "NVIDIA H100 PCIe": 2.0e12, "NVIDIA A100-SXM4": 0.0}
    for name, want in names.items():
        monkeypatch.setattr(hbm.torch.cuda, "get_device_name",
                            lambda dev, n=name: n)
        assert hbm.peak_bw("cuda:0") == want, name


def test_structured_log_line_and_pid_file(tmp_path, monkeypatch, caplog):
    import logging
    log = port_logging.get_logger("probe")
    with caplog.at_level(logging.WARNING):
        port_logging.log_event(log, "slow_request", b=1, a={"x": object()})
    event, payload = caplog.records[-1].getMessage().split(" ", 1)
    assert event == "slow_request" and list(json.loads(payload)) == ["a", "b"]
    monkeypatch.setenv("GAIE_RUN_DIR", str(tmp_path))
    path = port_logging.write_pid_file("probe")
    assert path == str(tmp_path / "probe.pid") and open(path).read().isdigit()
    monkeypatch.delenv("GAIE_RUN_DIR")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert port_logging.run_dir().startswith(str(tmp_path))
