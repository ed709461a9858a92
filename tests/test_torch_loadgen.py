"""The port's traffic harness (`nanorlhf_tpu_torch/loadgen/`, copies of the
JAX package's jax-free modules) against the original, on the CPU:

- `sample_requests`, `spec_digest` and `requests_digest` equal JAX's for
  the same specs (both arrival shapes, prefix groups, sampled and greedy
  mixes), and the pinned digest of JAX's own test;
- the open-loop driver in process against the port's `ServingEngine`:
  request conservation, the per-reason shed counters, client-TTFT hub
  rows and lineage events, and the same completed/shed split as JAX's
  driver against JAX's engine on the same spec;
- the driver over HTTP against the port's gateway, and a sweep through
  `run_sweep`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config, make_params, port_config
from nanorlhf_tpu import loadgen as jlg
from nanorlhf_tpu_torch import loadgen as tlg
from nanorlhf_tpu_torch.serving.engine import ServingEngine
from nanorlhf_tpu_torch.serving.gateway import ServingGateway
from nanorlhf_tpu_torch.telemetry.hist import LatencyHub
from nanorlhf_tpu_torch.telemetry.lineage import LineageLedger, read_ledger

torch.set_num_threads(1)

EOS, PAD = 3, 0

SPECS = {
    "default": dict(),
    "bursty": dict(seed=7, n_requests=32, rate_rps=20.0, arrival="bursty"),
    "prefix": dict(seed=5, n_requests=64, rate_rps=50.0, prefix_groups=3,
                   prefix_frac=0.6, prefix_len=4, prompt_len_min=5, prompt_len_max=10),
    "serve": dict(seed=0, n_requests=64, rate_rps=8.0, prompt_len_min=16,
                  prompt_len_max=480, token_lo=4, token_hi=4096, prefix_groups=4,
                  prefix_frac=0.5, prefix_len=384, greedy_frac=0.5, temp_min=0.7,
                  temp_max=0.7, top_p_min=1.0, top_p_max=1.0, max_tokens_min=256,
                  max_tokens_max=256),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_requests_and_digests_match_jax(name):
    tspec, jspec = tlg.WorkloadSpec(**SPECS[name]), jlg.WorkloadSpec(**SPECS[name])
    treqs, jreqs = tlg.sample_requests(tspec), jlg.sample_requests(jspec)
    assert [tuple(r.__dict__.items()) for r in treqs] == \
        [tuple(r.__dict__.items()) for r in jreqs]
    assert tlg.requests_digest(treqs) == jlg.requests_digest(jreqs)
    assert tlg.spec_digest(tspec) == jlg.spec_digest(jspec)


def test_pinned_digest():
    spec = tlg.WorkloadSpec(seed=7, n_requests=32, rate_rps=20.0, arrival="bursty")
    assert tlg.requests_digest(tlg.sample_requests(spec)) == "94ae405ac382b949"
    assert tlg.spec_digest(spec) == "acbbd7d142cfcba1"


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("qwen_tied")
    jparams, tparams = make_params(jcfg, seed=7, lora=False)
    return jcfg, jparams, port_config(jcfg), tparams


DRIVE = dict(seed=1, n_requests=16, rate_rps=500.0, prompt_len_min=4, prompt_len_max=12,
             token_lo=10, token_hi=50, greedy_frac=1.0, prefix_groups=2, prefix_frac=0.5,
             prefix_len=4, max_tokens_min=8, max_tokens_max=8)


def _port_engine(tiny, **kw):
    _, _, cfg, params = tiny
    return ServingEngine(params, cfg, eos_token_id=EOS, pad_token_id=PAD, page_size=4,
                         prompt_len=12, max_new_tokens=8, rows=2, seed=0,
                         slo_warn_ttft_s=1e9, device="cpu", **kw)


def test_driver_open_loop_inprocess(tiny, tmp_path):
    hub = LatencyHub()
    led = LineageLedger(str(tmp_path))
    spec = tlg.WorkloadSpec(**DRIVE)
    eng = _port_engine(tiny, max_queue=2)
    try:
        driver = tlg.TrafficDriver(engine=eng, latency=hub, lineage=led,
                                   stream_timeout_s=120.0)
        summary = driver.run(spec)
    finally:
        eng.close()
    assert summary.offered == 16 and summary.errors == 0
    assert summary.completed + summary.shed == 16 and summary.shed >= 1
    assert set(summary.shed_reasons) <= {"queue_full", "slo_ttft_p95", "engine_abort"}
    assert hub.count("latency/client_ttft_s") == summary.completed
    m = eng.metrics()
    assert m["serving/shed"] == summary.shed
    assert sum(v for k, v in m.items() if k.startswith("serving/shed_total{")) == summary.shed
    assert driver.metrics()["loadgen/offered"] == 16
    evs = list(read_ledger(str(tmp_path)))
    runs = [e for e in evs if e["type"] == "traffic_run"]
    assert len(runs) == 1 and runs[0]["spec_digest"] == tlg.spec_digest(spec)
    assert {e["request_index"] for e in evs if e["type"] == "traffic"} == set(range(16))


def test_driver_completes_what_jax_completes(tiny):
    """With room for every request (no shedding), the port's and JAX's
    engines complete the same requests with the same token counts."""
    from nanorlhf_tpu.serving.engine import ServingEngine as JaxEngine

    jcfg, jparams, _, _ = tiny
    spec = dict(DRIVE, rate_rps=50.0)
    eng = _port_engine(tiny, max_queue=64)
    try:
        got = tlg.TrafficDriver(engine=eng).run(tlg.WorkloadSpec(**spec))
    finally:
        eng.close()
    jeng = JaxEngine(jparams, jcfg, eos_token_id=EOS, pad_token_id=PAD, page_size=4,
                     prompt_len=12, max_new_tokens=8, rows=2, seed=0, max_queue=64,
                     slo_warn_ttft_s=1e9)
    try:
        want = jlg.TrafficDriver(engine=jeng).run(jlg.WorkloadSpec(**spec))
    finally:
        jeng.close()
    assert got.completed == want.completed == 16
    assert [r.tokens for r in got.records] == [r.tokens for r in want.records]


def test_driver_over_http_and_a_sweep(tiny):
    eng = _port_engine(tiny, max_queue=64)
    gw = ServingGateway(eng, port=-1)
    try:
        driver = tlg.TrafficDriver(base_url=f"http://127.0.0.1:{gw.port}")
        points = tlg.run_sweep(driver.run, tlg.WorkloadSpec(**dict(DRIVE, n_requests=6)),
                               [50.0, 200.0])
    finally:
        gw.close()
        eng.close()
    assert [p.completed for p in points] == [6, 6]
    assert all(p.errors == 0 and p.p50_ttft_s is not None for p in points)
    assert "goodput" in tlg.format_table(points)
    assert tlg.points_as_detail(points)["completed"] == [6, 6]


def test_driver_requires_exactly_one_target():
    with pytest.raises(ValueError):
        tlg.TrafficDriver()
    with pytest.raises(ValueError):
        tlg.TrafficDriver(engine=object(), base_url="http://127.0.0.1:1")
