"""The host planes on the trainer, the port against the JAX trainer and
against itself, at a tiny size on the CPU.

One pair of runs (module-scoped: the JAX trainer's compiles dominate) of
the same GRPO config — telemetry, lineage, an ephemeral status port, the
latency histograms and the health plane on, rollouts through the
continuous-batching scheduler (page size 4, 4 resident rows), a checkpoint
every update and `update.step:at=2,action=nan` — and three updates: both
trainers roll back once, quarantine rollout 1 and consume rollouts
0, 1, 2, 3. Held equal between them: the rollback count, the quarantine
set and the consumed index sequence, the span names of `trace.json`, the
lineage event kinds of each rollout index, the metric rows' keys (the
exceptions are named below) and the number of TTFT records of the queued
session.

Then the port alone: its status endpoints on an ephemeral port, the
profile window's torch Chrome trace, the traced speculative loop against
the compiled one (and JAX's), and the tensorboard sink."""

import builtins
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (closes_trainers: autouse)
    LORA,
    closes_trainers,
    jax_config,
    left_pad,
    make_params,
    port_config,
)
from nanorlhf_tpu.data import load_prompt_dataset
from nanorlhf_tpu.entrypoints import common as jax_common
from nanorlhf_tpu.entrypoints import grpo as jax_grpo
from nanorlhf_tpu.parallel import MeshConfig as JaxMeshConfig
from nanorlhf_tpu.parallel.mesh import make_mesh
from nanorlhf_tpu.sampler import speculative as jax_spec
from nanorlhf_tpu.telemetry import SpanTracer as JaxSpanTracer
from nanorlhf_tpu.trainer import RLTrainer as JaxRLTrainer
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.sampler import speculative as tspec
from nanorlhf_tpu_torch.telemetry import (
    SpanTracer,
    read_ledger,
    validate_prometheus_text,
    validate_trace_file,
)
from nanorlhf_tpu_torch.trainer.metrics import MetricsLogger
from nanorlhf_tpu_torch.utils.profiling import ProfileWindow, trace_profile

torch.set_num_threads(1)

PAD, EOS = 0, 3
# the config both trainers run (on top of each launcher's GRPO config, cut
# to one card)
KNOBS = dict(sft_model_path="tiny-demo", response_length=6,
             per_device_train_batch_size=2, total_episodes=64, lora_r=4,
             lora_alpha=8, learning_rate=1e-3, telemetry=True, lineage=True,
             status_port=-1, save_steps=1, rollout_page_size=4,
             rollout_decode_rows=4, fault_spec="update.step:at=2,action=nan")
UPDATES = 3
# metric keys one trainer writes and the other does not: none for this
# config (every JAX row has its counterpart in the port's)
METRIC_KEY_EXCEPTIONS: set = set()


def _reward(texts, eos_token):
    return np.asarray([float(len(t) % 7) for t in texts], np.float32)


def _port_run(out):
    cfg = one_card_cut(build_config())
    cfg.output_dir = str(out)
    cfg.train_dataset_name = "synthetic:512"
    for k, v in KNOBS.items():
        setattr(cfg, k, v)
    tr = common.build_trainer(cfg, device="cpu")
    tr.reward_func = _reward
    return tr


def _jax_run(out):
    cfg = jax_grpo.build_config()
    cfg.gradient_accumulation_steps, cfg.num_mini_batches = 2, 2
    cfg.output_dir = str(out)
    cfg.mesh = JaxMeshConfig(1, 1, 1)
    for k, v in KNOBS.items():
        setattr(cfg, k, v)
    mcfg, params, tok = jax_common.resolve_model(cfg.sft_model_path, cfg.seed,
                                                 attention_impl=cfg.attention_impl)
    ds = load_prompt_dataset("synthetic:512", tok, max_prompt_len=256)
    return JaxRLTrainer(cfg, mcfg, tok, params, ds, _reward,
                        mesh=make_mesh(cfg.mesh, devices=jax.devices()[:1]))


def _scrape(port: int) -> dict:
    out = {}
    for ep in ("/metrics", "/healthz", "/statusz"):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{ep}", timeout=10) as r:
            out[ep] = (r.status, r.read().decode())
    return out


def _run(make, out) -> dict:
    tr = make(out)
    try:
        tr.train(num_updates=UPDATES)
        scraped = _scrape(tr.exporter.port)
        ttft = tr.latency.count("latency/ttft_s")
        result = dict(state=dict(tr.state), rollbacks=tr.sentinel.rollbacks,
                      quarantined=set(tr.sentinel.quarantined), scraped=scraped,
                      ttft=ttft, intertoken=tr.latency.count("latency/intertoken_s"),
                      latest=tr.ckpt.latest_step())
    finally:
        tr.close()
    trace = json.load(open(os.path.join(out, "trace.json")))["traceEvents"]
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    result.update(out=str(out), trace=trace, rows=rows,
                  ledger=list(read_ledger(str(out))))
    return result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("planes")
    return _run(_port_run, base / "port"), _run(_jax_run, base / "jax")


def _consumed(run) -> list:
    return [e["args"]["rollout_index"] for e in run["trace"]
            if e["name"] == "train.update"]


def test_rollback_quarantine_and_consumed_indices_match_jax(runs):
    port, ref = runs
    assert port["state"] == ref["state"] == {"episode": 24, "global_step": 3,
                                             "opt_steps": 6, "rollouts": 4}
    assert port["rollbacks"] == ref["rollbacks"] == 1
    assert port["quarantined"] == ref["quarantined"] == {1}
    assert _consumed(port) == _consumed(ref) == [0, 1, 2, 3]
    quarantined = [e["args"].get("quarantined", False) for e in port["trace"]
                   if e["name"] == "train.update"]
    assert quarantined == [False, True, False, False]
    assert port["latest"] == ref["latest"] == 3
    bb = json.load(open(os.path.join(port["out"], "blackbox_2.json")))
    assert bb["reason"] == "sentinel_trip" and bb["extra"]["rollout_index"] == 1


def test_trace_span_names_match_jax(runs):
    port, ref = runs
    assert validate_trace_file(os.path.join(port["out"], "trace.json")) == []

    def names(run):
        return {(e["name"], e["ph"]) for e in run["trace"] if e["ph"] != "M"}

    # the port's checkpoint writer is its own thread with its own span; the
    # JAX manager's orbax write streams inside the library, unspanned
    assert names(port) - names(ref) == {("ckpt.write", "X")}
    assert names(ref) - names(port) == set()
    assert {("trainer.rollout", "X"), ("reward.dispatch", "X"), ("ckpt.save", "X"),
            ("ckpt.restore", "X"), ("sentinel.trip", "i")} <= names(port)


def _kinds(run) -> dict:
    out = {}
    for e in run["ledger"]:
        if e.get("rollout_index") is not None:
            kind = e["type"] + (":" + e["reason"] if e["type"] == "drop" else "")
            out.setdefault(e["rollout_index"], []).append(kind)
    return out


def test_lineage_event_kinds_match_jax(runs):
    port, ref = runs
    kinds = _kinds(port)
    assert kinds == _kinds(ref)
    for idx in (0, 2, 3):
        assert [k for k in kinds[idx] if k != "sample"][-1] == "outcome"
        assert kinds[idx].count("lease") == 1 + 28   # dispatch + mid-loop admissions
    assert kinds[1][-1] == "drop:sentinel_quarantine" and "outcome" not in kinds[1]


def test_metric_row_keys_match_jax(runs):
    port, ref = runs
    rows, jrows = port["rows"], ref["rows"]
    assert [sorted(r) for r in rows if "episode" not in r] == \
        [sorted(r) for r in jrows if "episode" not in r]   # the rollback event
    keys = {k for r in rows if "episode" in r for k in r}
    jkeys = {k for r in jrows if "episode" in r for k in r}
    assert keys ^ jkeys == METRIC_KEY_EXCEPTIONS
    last = [r for r in rows if "episode" in r][-1]
    assert last["resilience/rollbacks"] == 1.0
    assert last["perf/peak_flops_known"] == 0.0 and 0 < last["perf/mfu"]
    assert last["time/rollout_overlap_frac"] == pytest.approx(0.0, abs=0.05)
    assert last["health/verdict"] in (0.0, 1.0, 2.0)


# the rows the paged config adds over the contiguous one
PAGED_ROW_KEYS = {"rollout/page_utilization", "rollout/pages_recycled",
                  "rollout/admitted_midloop", "session/dispatch_events",
                  "session/chunked_admissions", "session/prefill_backlog"}


def test_phase13_row_keys_are_the_pinned_set(runs, tmp_path):
    """`chip_smoke.py` phase 13 holds the card's rows to HOST_ROW_KEYS: the
    port's rows at phase 13's config (contiguous, its planes and fault)
    have exactly those keys, which are the JAX trainer's rows' keys less
    the paged config's own."""
    import chip_smoke

    cfg = one_card_cut(build_config())
    cfg.output_dir = str(tmp_path)
    cfg.train_dataset_name = "synthetic:512"
    for k, v in {**KNOBS, "rollout_page_size": 0, "rollout_decode_rows": 0,
                 **chip_smoke.HOST_KNOBS}.items():
        setattr(cfg, k, v)
    tr = common.build_trainer(cfg, device="cpu")
    tr.reward_func = _reward
    state = tr.train(num_updates=chip_smoke.HOST_UPDATES)
    tr.close()
    assert state["global_step"] == chip_smoke.HOST_UPDATES and tr.profile_window.windows == 1
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    steps = [r for r in rows if "episode" in r]
    assert len(steps) == chip_smoke.HOST_UPDATES
    assert all(set(r) == chip_smoke.HOST_ROW_KEYS for r in steps)
    jkeys = {k for r in runs[1]["rows"] if "episode" in r for k in r}
    assert jkeys - PAGED_ROW_KEYS == chip_smoke.HOST_ROW_KEYS
    assert PAGED_ROW_KEYS <= jkeys


def test_queued_session_ttft_records_match_jax(runs):
    port, ref = runs
    # one per admitted row of the three rollouts the journal keeps (the
    # tripped rollout's records rewind with the checkpoint)
    assert port["ttft"] == ref["ttft"] == 3 * 32
    assert port["intertoken"] > 0 and ref["intertoken"] > 0


def test_status_endpoints_over_loopback(runs):
    port, ref = runs
    for run in runs:
        status, body = run["scraped"]["/metrics"]
        assert status == 200 and validate_prometheus_text(body) == []
        assert 'nanorlhf_latency_ttft_s_bucket{le="+Inf"}' in body
        assert run["scraped"]["/healthz"][0] == 200
        assert json.loads(run["scraped"]["/statusz"][1])["step"] == 3
    sz, jsz = (json.loads(r["scraped"]["/statusz"][1]) for r in runs)
    assert set(sz) <= set(jsz) and {"health", "lineage", "latency", "pages"} <= set(sz)


def test_profile_window_writes_a_torch_chrome_trace(tmp_path):
    win = ProfileWindow(str(tmp_path / "prof"), at_step=2, num_steps=2,
                        trigger_file=str(tmp_path / "PROFILE"))
    x = torch.randn(64, 64)
    for step in range(1, 6):
        win.poll(step)
        torch.mm(x, x)
        if step == 4:
            open(tmp_path / "PROFILE", "w").close()
    win.stop()
    win.stop()
    assert win.windows == 2 and not os.path.exists(tmp_path / "PROFILE")
    assert [os.path.basename(p) for p in win.paths] == ["trace_steps_2-3.json",
                                                        "trace_steps_5-6.json"]
    names = {e.get("name") for e in json.load(open(win.paths[0]))["traceEvents"]}
    assert "aten::mm" in names
    with pytest.raises(RuntimeError):
        with trace_profile(str(tmp_path / "raises")):
            raise RuntimeError("a step that fails")
    assert os.path.isfile(tmp_path / "raises" / "trace.json")


def test_traced_speculative_loop_matches_the_compiled_one_and_jax():
    jcfg = jax_config("qwen_tied")
    jparams, tparams = make_params(jcfg, seed=4)
    rng = np.random.default_rng(3)
    ids = left_pad([rng.integers(4, 128, n).tolist() for n in (5, 3, 7, 2)], 7, PAD)
    kw = dict(max_tokens=10, eos_token_id=EOS, pad_token_id=PAD, spec_k=3,
              greedy=True, lora_scale=LORA.scale)
    tracer, jtracer = SpanTracer(enabled=True), JaxSpanTracer(enabled=True)
    args = (tparams, port_config(jcfg), torch.as_tensor(ids).long(),
            torch.as_tensor(ids != PAD))
    stats, plain_stats, jstats = [], [], []
    traced = tspec.generate_spec(*args, torch.Generator(), tracer=tracer,
                                 spec_stats_out=stats, **kw)
    plain = tspec.generate_spec(*args, torch.Generator(), spec_stats_out=plain_stats, **kw)
    want = jax_spec.generate_spec(jparams, jcfg, jax.numpy.asarray(ids),
                                  jax.numpy.asarray(ids != PAD), jax.random.PRNGKey(0),
                                  tracer=jtracer, spec_stats_out=jstats, **kw)
    np.testing.assert_array_equal(traced.numpy(), plain.numpy())
    np.testing.assert_array_equal(traced.numpy(), np.asarray(want))
    steps = int(stats[0]["verify_steps"])
    assert steps == int(plain_stats[0]["verify_steps"]) == int(np.asarray(jstats[0]["verify_steps"]))

    def spans(tr):
        return [(e["name"], e["args"]["iteration"]) for e in tr.trace_events()
                if e["ph"] == "X"]

    assert spans(tracer) == spans(jtracer) == [
        (n, i) for i in range(steps) for n in ("rollout.draft", "rollout.verify")]


def test_tensorboard_sink_writes_events_or_names_the_missing_package(tmp_path, monkeypatch):
    logger = MetricsLogger(str(tmp_path / "tb_run"), "tensorboard")
    logger.log(1, 8, {"loss/policy_avg_new": 0.5})
    assert logger.latest()["loss/policy_avg_new"] == 0.5
    logger.close()
    logger.close()
    assert os.listdir(tmp_path / "tb_run" / "tb")
    assert os.path.isfile(tmp_path / "tb_run" / "metrics.jsonl")

    real_import = builtins.__import__

    def no_tensorboard(name, *a, **k):
        if name.startswith("torch.utils.tensorboard") or name.startswith("tensorboard"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(ImportError, match="tensorboard"):
        MetricsLogger(str(tmp_path / "none"), "tensorboard")
