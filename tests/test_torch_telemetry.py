"""The port's telemetry planes against the JAX package's, on the same seeded
inputs: the span tracer's events (timestamps aside) and its flight recorder,
the trace schema check, the latency histograms, the health plane's gauges
and verdicts over a metric stream with a planted collapse, the Prometheus
text, the lineage ledger's events (timestamps aside), the overlap meter,
the lock-order checker, and the MFU model's parameter count on bridged tiny
params. All but `telemetry/mfu.py` are copies, so the comparisons are
exact."""

import json
import math
import threading

import numpy as np
import pytest
import torch

from _torch_parity import jax_config, make_params
from nanorlhf_tpu.analysis import lockorder as jlockorder
from nanorlhf_tpu.orchestrator.orchestrator import OverlapMeter as JaxOverlapMeter
from nanorlhf_tpu.telemetry import exporter as jexporter
from nanorlhf_tpu.telemetry import health as jhealth
from nanorlhf_tpu.telemetry import hist as jhist
from nanorlhf_tpu.telemetry import lineage as jlineage
from nanorlhf_tpu.telemetry import mfu as jmfu
from nanorlhf_tpu.telemetry import tracer as jtracer
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.analysis import lockorder
from nanorlhf_tpu_torch.telemetry import exporter, health, hist, lineage, mfu, tracer
from nanorlhf_tpu_torch.telemetry.overlap import OverlapMeter

torch.set_num_threads(1)

# clock-dependent fields of a trace event / ledger record / health event
_TIMES = {"ts", "dur", "pid", "tid", "t", "t_mono", "unix_time", "now_us",
          "trace_epoch_unix", "time"}


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _TIMES}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _json(obj) -> str:
    return json.dumps(_strip(obj), sort_keys=True)


def _drive_tracer(mod, max_events=12):
    tr = mod.SpanTracer(enabled=True, max_events=max_events, ring_len=5)
    with tr.span("train.update", step=1) as args:
        args["rollout_index"] = 3
        with tr.span("trainer.rollout"):
            tr.add_async("rollout.generate", tr.now_us(), 5.0, aid=3,
                         track="rollout", rollout_index=3)
        with tr.span("reward.dispatch", track="reward", rows=np.int64(8)):
            tr.counter("staleness", np.float32(2.0))
        tr.instant("sentinel.trip", verdict="nonfinite", loss=float("nan"))
    tr.add_complete("ckpt.save", 0.0, 3.0, track="ckpt", step=1)
    for i in range(6):  # past max_events: counted as dropped
        tr.counter("queue_depth", i)
    return tr


@pytest.mark.parametrize("enabled", [True, False])
def test_tracer_events_and_blackbox_match_jax(enabled, tmp_path):
    if enabled:
        mine, ref = _drive_tracer(tracer), _drive_tracer(jtracer)
    else:
        mine, ref = tracer.SpanTracer(enabled=False), jtracer.SpanTracer(enabled=False)
        for tr in (mine, ref):
            with tr.span("x") as args:
                assert args == {}
            tr.counter("c", 1)
    ev, jev = mine.trace_events(), ref.trace_events()
    # the process metadata names the package
    assert ev[0]["args"]["name"] == "nanorlhf_tpu_torch"
    assert jev[0]["args"]["name"] == "nanorlhf_tpu"
    assert _strip(ev[1:]) == _strip(jev[1:])
    assert mine.dropped == ref.dropped
    assert (mine.write_trace(str(tmp_path / "p" / "trace.json")) is None) == (not enabled)
    bb = mine.dump_blackbox(str(tmp_path / "p"), 7, "sentinel_trip", extra={"k": 1})
    jbb = ref.dump_blackbox(str(tmp_path / "j"), 7, "sentinel_trip", extra={"k": 1})
    assert (bb is None) == (jbb is None) == (not enabled)
    if enabled:
        assert tracer.validate_trace_file(str(tmp_path / "p" / "trace.json")) == []
        got, want = (json.load(open(p)) for p in (bb, jbb))
        assert _strip(got) == _strip(want)
        assert got["reason"] == "sentinel_trip" and got["step"] == 7


def _trace_cases():
    rng = np.random.default_rng(5)
    cases = [[], "not a list"]
    for _ in range(6):
        evs = []
        for i in range(12):
            ts = float(rng.integers(0, 50))
            ev = {"name": f"s{i}", "ph": str(rng.choice(["X", "X", "i", "b"])),
                  "ts": ts, "pid": 1, "tid": int(rng.integers(0, 2)),
                  "dur": float(rng.integers(0, 30))}
            if rng.random() < 0.1:
                ev.pop(str(rng.choice(["ph", "ts", "pid", "tid"])))
            if rng.random() < 0.1:
                ev["dur"] = float("nan")
            evs.append(ev)
        cases.append(evs)
    return cases


@pytest.mark.parametrize("case", range(8))
def test_trace_schema_check_matches_jax(case):
    events = _trace_cases()[case]
    assert tracer.validate_trace_events(events) == jtracer.validate_trace_events(events)


def _samples(seed, n=400):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(mean=-3.0, sigma=1.5, size=n)
    x[::37] = 0.0
    x[::53] = -1.0          # clamped to 0
    x[::71] = float("nan")  # ignored
    x[::97] = 1e9           # the overflow bucket
    return x.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_match_jax(seed):
    xs = _samples(seed)
    h, jh = hist.StreamingHistogram(), jhist.StreamingHistogram()
    for x in xs:
        h.record(x)
        jh.record(x)
    assert h.state() == jh.state()
    for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert h.cumulative_buckets() == jh.cumulative_buckets()
    assert h.summary() == jh.summary()
    other = [x for x in _samples(seed + 10) if x == x]
    h2, jh2 = hist.StreamingHistogram(), jhist.StreamingHistogram()
    for x in other:
        h2.record(x)
        jh2.record(x)
    assert h.merge(h2).state() == jh.merge(jh2).state()
    assert hist.StreamingHistogram.load(h.state()).state() == h.state()
    finite = [x for x in xs if x == x]
    assert hist.percentiles_from_samples(finite) == jhist.percentiles_from_samples(finite)
    hub, jhub = hist.LatencyHub(), jhist.LatencyHub()
    for i, x in enumerate(finite):
        key = "latency/ttft_s" if i % 3 else "latency/reward_s"
        hub.record(key, x)
        jhub.record(key, x)
    assert hub.snapshot() == jhub.snapshot()
    assert hub.journal() == jhub.journal()
    again = hist.LatencyHub()
    again.restore(jhub.journal())
    assert again.states() == hub.states()


def _metric_stream(seed, n=60, collapse_at=40):
    """A healthy stream, then a reward collapse and an entropy collapse."""
    rng = np.random.default_rng(seed)
    for step in range(1, n + 1):
        bad = step >= collapse_at
        yield step, {
            "eval_objective/rlhf_reward_old": float(
                rng.normal(1.0, 0.05) - (3.0 if bad else 0.0)),
            "policy/entropy_avg_new": float(rng.normal(2.0, 0.05) * (0.1 if bad else 1.0)),
            "objective/kl_rollout_old": float(abs(rng.normal(0.01, 0.002))),
            "perf/recompiles": float(3 if step < 3 else 3 + (step > 50)),
            "loss/policy_avg_new": float("nan") if step == 20 else float(rng.normal()),
        }


@pytest.mark.parametrize("seed", [0, 3])
def test_health_gauges_and_verdicts_match_jax(seed):
    clock = iter(range(10_000))
    jclock = iter(range(10_000))
    hub, jhub = hist.LatencyHub(), jhist.LatencyHub()
    for x in np.random.default_rng(seed).lognormal(0.0, 1.0, 40):
        hub.record("latency/ttft_s", x)     # inside the SLO
        jhub.record("latency/ttft_s", x)
    crit, jcrit = [], []
    mon = health.HealthMonitor(
        health.HealthConfig(rules=health.DEFAULT_RULES + health.SLO_RULES),
        clock=lambda: float(next(clock)), latency=hub,
        blackbox_fn=lambda step, extra: crit.append((step, extra)))
    jmon = jhealth.HealthMonitor(
        jhealth.HealthConfig(rules=jhealth.DEFAULT_RULES + jhealth.SLO_RULES),
        clock=lambda: float(next(jclock)), latency=jhub,
        blackbox_fn=lambda step, extra: jcrit.append((step, extra)))
    verdicts = []
    for step, row in _metric_stream(seed):
        got, want = mon.observe(step, row), jmon.observe(step, row)
        assert got == want, step
        verdicts.append(mon.verdict)
    assert verdicts[-1] == "crit" and verdicts[10] == "ok"
    assert crit == jcrit and crit
    # through JSON: NaN signals compare equal there
    assert _json(mon.events()) == _json(jmon.events())
    assert _json(mon.snapshot()) == _json(jmon.snapshot())
    assert _json(mon.journal()) == _json(jmon.journal())
    again = health.HealthMonitor(health.HealthConfig())
    again.restore(jmon.journal())
    assert again.journal()["trips"] == jmon.journal()["trips"]


def test_prometheus_text_matches_jax():
    rng = np.random.default_rng(2)
    row = {f"m/{i}.x-y": float(v) for i, v in enumerate(rng.normal(size=20))}
    row.update({"perf/mfu": 0.31, "nan/val": float("nan"), "inf/val": float("inf"),
                "lineage/dropped_total{reason=\"keep_filter\"}": 12.0,
                "lineage/dropped_total{reason=\"sentinel_quarantine\"}": 4.0,
                "text": "skipped"})
    text, jtext = exporter.render_prometheus(row), jexporter.render_prometheus(row)
    assert text == jtext
    assert exporter.validate_prometheus_text(text) == []
    hub = hist.LatencyHub()
    for x in _samples(4, 50):
        hub.record("latency/ttft_s", x)
    htext = exporter.render_prometheus_histograms(hub.states())
    assert htext == jexporter.render_prometheus_histograms(hub.states())
    assert exporter.validate_prometheus_text(text + htext) == []
    for bad in ("", "# nonsense\n", "bad metric line\n", "m{a=\"1\"} notanumber\n"):
        assert (exporter.validate_prometheus_text(bad)
                == jexporter.validate_prometheus_text(bad))


def _drive_ledger(mod, path):
    led = mod.LineageLedger(str(path), enabled=True, sample_rate=0.7, ring_len=4,
                            key_path="k")
    led.rows_hint = 8
    for idx in range(6):
        led.lease(idx, worker_id=0, cursor=idx, length=1)
        led.generation(idx, policy_version=idx, worker_id=0, spec=None)
        led.reward(idx, step=idx, scores=[0.5, 1.0], attempt=1 + idx % 2, wall_s=0.1)
        led.drop(idx, "keep_filter", count=4, step=idx)
        if idx == 3:
            led.drop(idx, "sentinel_quarantine", step=idx, dispatched=False)
        else:
            led.outcome(idx, step=idx + 1, policy_version=idx + 1, kept=2,
                        advantage=0.25, scores=[1.0], eos_frac=0.5, staleness=0)
            led.note_sample(idx, step=idx + 1, score=1.0, response_chars=9, kept=True)
    led.drop(None, "stale_drop")
    out = (led.statusz(), led.metric_rows(), led.journal())
    led.close()
    return out


def test_lineage_ledger_matches_jax(tmp_path):
    got = _drive_ledger(lineage, tmp_path / "p")
    want = _drive_ledger(jlineage, tmp_path / "j")
    assert _strip(got) == _strip(want)
    events = list(lineage.read_ledger(str(tmp_path / "p")))
    jevents = list(jlineage.read_ledger(str(tmp_path / "j")))
    assert _strip(events) == _strip(jevents) and events
    assert lineage.drop_histogram(events) == jlineage.drop_histogram(jevents)
    assert _strip(lineage.chains(events)) == _strip(jlineage.chains(jevents))
    resumed = lineage.LineageLedger(str(tmp_path / "p2"), enabled=True)
    resumed.restore(want[2])
    assert resumed.journal() == want[2]
    resumed.close()


def test_overlap_meter_matches_jax():
    rng = np.random.default_rng(9)
    meter, jmeter = OverlapMeter(), JaxOverlapMeter()
    meter._COMPACT_AT = jmeter._COMPACT_AT = 16  # fold the prefix too
    t = 0.0
    for i in range(60):
        g0 = t + rng.random()
        g1 = g0 + rng.random()
        b0 = g1 - rng.random() * 0.5
        b1 = b0 + rng.random()
        for m in (meter, jmeter):
            m.note_gen(g0, g1, track=i % 2)
            m.note_busy(b0, b1)
        t = b1
        assert meter.overlap_fraction() == jmeter.overlap_fraction()
    assert 0.0 < meter.overlap_fraction() < 1.0


def _violation(mod, monkeypatch):
    monkeypatch.setenv("NANORLHF_LOCK_CHECK", "1")
    outer = mod.make_lock("telemetry.lineage")
    inner = mod.make_lock("telemetry.tracer")   # ranked below the lineage lock
    errors = []
    with outer:
        try:
            with inner:
                pass
        except mod.LockOrderViolation as e:
            errors.append(str(e))
    ok = mod.make_lock("telemetry.health")
    with ok:
        with mod.make_lock("telemetry.hist"):
            errors.append(mod.held_locks())
    try:
        mod.make_lock("no.such.lock")
    except mod.LockOrderViolation as e:
        errors.append(str(e))
    cond = mod.make_condition("orchestrator.queue")
    with cond:
        errors.append(mod.held_locks())
    return errors


def test_lock_order_violations_match_jax(monkeypatch):
    assert lockorder.LOCK_ORDER == jlockorder.LOCK_ORDER
    got, want = _violation(lockorder, monkeypatch), _violation(jlockorder, monkeypatch)
    assert got == want and len(got) == 4
    monkeypatch.setenv("NANORLHF_LOCK_CHECK", "0")
    assert isinstance(lockorder.make_lock("telemetry.tracer"), type(threading.Lock()))


@pytest.mark.parametrize("kind", ["qwen_tied", "llama_untied"])
def test_flops_param_count_matches_jax(kind):
    jparams, tparams = make_params(jax_config(kind), seed=2)
    assert "lora" in tparams
    assert mfu.flops_param_count(tparams) == jmfu.flops_param_count(jparams)
    kw = dict(decode_tokens=640.0, prefill_tokens=320.0, score_tokens=96.0,
              train_tokens=48.0)
    assert mfu.update_flops(12345, **kw) == jmfu.update_flops(12345, **kw)


def test_peak_flops_and_recompile_counter(monkeypatch):
    assert mfu.peak_flops_per_chip("cpu") == (mfu.CPU_PEAK_FLOPS, False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert mfu.peak_flops_per_chip(torch.device("cuda", 0)) == (989e12, True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert mfu.peak_flops_per_chip(torch.device("cuda", 0)) == (989e12, False)
    counter = mfu.recompile_counter()
    assert counter is mfu.recompile_counter()
    n, s = counter.count, counter.seconds
    _build._notify_compile("nvcc flash_fwd", 1.5)
    _build._notify_compile("load flash_fwd", 0.25)
    assert counter.count == n + 2 and math.isclose(counter.seconds, s + 1.75)
