"""The port's serving plane against the JAX package, on the CPU:

- the radix cache: random plan / insert / release / extend_text /
  matched_continuation / eviction sequences through the port's and JAX's
  `RadixCache` give the same plans (page ids, match lengths, COW pairs,
  evictions), the same continuations and the same `snapshot()`; a pool
  too small for the sequence raises in both;
- `suffix_logits` after a mid-page match: against JAX's `suffix_logits`
  and against the port's own full prefill, within 1e-5 (f32: the suffix
  and full routes sum in another order; JAX's own bitwise pin of this
  equivalence is one of ROADMAP's reference caveats), and `copy_page`;
- the gateway cases of JAX's `tests/test_serving.py` over the port's
  engine: generate and prefix reuse, valid Prometheus text, a 429 on the
  SLO, a bad request and a non-loopback bind, prompt-length validation, a
  cancel of a provably active row releasing its pages, a cancel of a
  pending request, the `gw.disconnect` fault;
- an engine whose loop thread dies raises at the next submit and stream.
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config, left_pad, make_params, port_config
from nanorlhf_tpu.core.model import init_paged_kv_cache as jax_init_paged_kv_cache
from nanorlhf_tpu.core.model import prefill as jax_prefill
from nanorlhf_tpu.serving import radix as jradix
from nanorlhf_tpu_torch.core.model import init_paged_kv_cache, prefill
from nanorlhf_tpu_torch.resilience.faults import FaultInjector
from nanorlhf_tpu_torch.serving import radix as tradix
from nanorlhf_tpu_torch.serving.engine import ServingEngine
from nanorlhf_tpu_torch.serving.gateway import ServingGateway
from nanorlhf_tpu_torch.telemetry.exporter import validate_prometheus_text
from nanorlhf_tpu_torch.telemetry.hist import LatencyHub

torch.set_num_threads(1)

EOS, PAD = 3, 0
SUFFIX_TOL = 1e-5


# --------------------------------------------------------------------- #
# the radix cache, op for op against JAX's
# --------------------------------------------------------------------- #

def _plan_tuple(plan):
    return (plan.m, plan.hit_tokens, plan.row_pages.tolist(), plan.cow_src,
            plan.cow_dst, plan.evicted, plan.shared)


def _random_ops(seed, T=12, P=4, n_blocks=5, num_pages=24, steps=60):
    """One random admission sequence: prompts drawn from a few families
    (shared prefixes of several lengths, pad layouts that match and
    differ), rows released at random, generated text extending the tree."""
    rng = np.random.default_rng(seed)
    families = [rng.integers(4, 60, T).tolist() for _ in range(3)]
    ops, live = [], []
    for _ in range(steps):
        if live and (len(live) >= 3 or rng.random() < 0.35):
            i = int(rng.integers(len(live)))
            key = live.pop(i)
            gen = rng.integers(4, 60, int(rng.integers(0, 6))).tolist()
            ops.append(("release", key, gen))
            continue
        fam = families[int(rng.integers(len(families)))]
        n = int(rng.integers(2, T + 1))
        cut = int(rng.integers(0, n + 1))
        toks = fam[:cut] + rng.integers(4, 60, n - cut).tolist()
        row = np.full(T, PAD, np.int64)
        row[T - n:] = toks
        mask = np.zeros(T, bool)
        mask[T - n:] = True
        ops.append(("admit", row, mask))
        live.append(len(ops) - 1)
    return ops, dict(T=T, P=P, n_blocks=n_blocks, num_pages=num_pages)


def _replay(mod, ops, shape):
    """Run `ops` through module `mod`'s RadixCache; returns the trace."""
    T, nb = shape["T"], shape["n_blocks"]
    rc = mod.RadixCache()
    rc.reset(num_pages=shape["num_pages"], page_size=shape["P"])
    rows, keys, trace = {}, {}, []
    for i, op in enumerate(ops):
        if op[0] == "admit":
            _, row, mask = op
            key = mod.prompt_key(row, mask)
            pad = int(T - mask.sum())
            try:
                plan = rc.plan(key, pad_count=pad, n_blocks=nb, prompt_len=T)
            except RuntimeError as e:
                trace.append(("raise", str(e)))
                continue
            except AssertionError as e:     # the tree and pool are broken
                trace.append(("assert", str(e)))
                return trace
            trace.append(("plan", _plan_tuple(plan),
                          rc.matched_continuation(key, 6).tolist()))
            rc.insert(key, plan.row_pages, T)
            rows[i], keys[i] = plan.row_pages, key
        else:
            _, at, gen = op
            if at not in rows:
                continue
            rc.extend_text(keys[at] + tuple(t * 2 + 1 for t in gen))
            trace.append(("release", rc.release(rows.pop(at))))
        trace.append(("snapshot", rc.snapshot(), rc.pool.ref.tolist()))
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_radix_sequences_match_jax(seed):
    ops, shape = _random_ops(seed)
    got, want = _replay(tradix, ops, shape), _replay(jradix, ops, shape)
    assert got == want
    kinds = {t[0] for t in got}
    assert "plan" in kinds and "release" in kinds


def test_radix_sequences_cover_hits_cow_and_eviction():
    """Across the seeds the sequences reach what the cache exists for:
    full-page shares, COW splits, evictions and seeded continuations."""
    seen = dict(shared=0, cow=0, evicted=0, cont=0)
    for seed in range(8):
        ops, shape = _random_ops(seed)
        for t in _replay(tradix, ops, shape):
            if t[0] == "plan":
                seen["shared"] += t[1][6] > 0
                seen["cow"] += t[1][3] is not None
                seen["evicted"] += t[1][5] > 0
                seen["cont"] += len(t[2]) > 0
    assert all(v > 0 for v in seen.values()), seen


def test_small_pool_raises_like_jax():
    ops, shape = _random_ops(3, num_pages=3)
    got, want = _replay(tradix, ops, shape), _replay(jradix, ops, shape)
    assert got == want
    assert any(t[0] == "raise" for t in got)


def test_plan_never_evicts_a_page_it_shares():
    """Under pressure JAX's plan can evict the LRU leaf holding a page it
    is about to share, and then `inc` asserts on the freed page. The port
    references its shared pages (and its COW donor) before evicting: the
    same sequence runs on, equal to JAX's up to JAX's failure, with every
    refcount consistent."""
    ops, shape = _random_ops(3, num_pages=5)
    got, want = _replay(tradix, ops, shape), _replay(jradix, ops, shape)
    assert want[-1][0] == "assert" and "ref of free page" in want[-1][1]
    assert got[:len(want) - 1] == want[:-1]
    assert all(t[0] != "assert" for t in got) and len(got) > len(want)
    for t in got:
        if t[0] == "plan":
            pages = t[1][2]
            assert len(set(pages)) == len(pages) and max(pages) < 5


def test_bucket_len_and_prompt_key_match_jax():
    for n in range(1, 40):
        for cap in (1, 7, 16, 33):
            assert tradix.bucket_len(n, cap) == jradix.bucket_len(n, cap)
    row = np.asarray([0, 0, 5, 6, 7])
    assert tradix.prompt_key(row, row != 0) == jradix.prompt_key(row, row != 0)


def test_pool_refcounts_and_double_unref():
    pool = tradix.RefPagePool(4)
    p = pool.alloc()
    pool.inc(p)
    assert pool.shared_count() == 1 and not pool.unref(p) and pool.unref(p)
    with pytest.raises(AssertionError, match="unref of free page"):
        pool.unref(p)


# --------------------------------------------------------------------- #
# suffix_logits after a mid-page match
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("qwen_tied")
    jparams, tparams = make_params(jcfg, seed=7, lora=False)
    return jcfg, jparams, port_config(jcfg), tparams


def test_suffix_logits_match_jax_and_full_prefill(tiny):
    """A row whose first m = 5 slots (a non-page-aligned match) were
    prefilled, COW-copied to a fresh page, then the suffix [m, Tp) through
    `suffix_logits`: the last real token's logits equal the port's own
    full prefill and JAX's suffix forward within SUFFIX_TOL."""
    jcfg, jparams, cfg, params = tiny
    Tp, P, max_new = 8, 4, 4
    T_max = Tp + max_new
    nb = -(-T_max // P)
    toks = [5, 6, 7, 8, 9, 10]
    ids = left_pad([toks], Tp, PAD)
    mask = ids != PAD
    pad_count, m = Tp - len(toks), 5
    table = np.arange(nb)
    ids_t, mask_t = torch.as_tensor(ids).long(), torch.as_tensor(mask)

    full = init_paged_kv_cache(cfg, nb, P, torch.float32, "cpu")
    want, _ = prefill(params, cfg, ids_t, mask_t, full,
                      page_table=torch.as_tensor(table)[None], page_size=P,
                      logical_len=T_max)

    # prefill [pad, m) into pages 0..; then move page 1 (the straddler,
    # slots 4..7) to a spare page through copy_page, as a COW admission
    caches = init_paged_kv_cache(cfg, nb + 1, P, torch.float32, "cpu")
    pref_mask = (np.arange(Tp) < m) & mask[0]
    pref_ids = np.where(np.arange(Tp) < m, ids[0], PAD)
    prefill(params, cfg, torch.as_tensor(pref_ids)[None].long(),
            torch.as_tensor(pref_mask)[None], caches,
            page_table=torch.as_tensor(table)[None], page_size=P, logical_len=T_max)
    tradix.copy_page(caches, 1, nb)
    assert all(torch.equal(c[:, nb], c[:, 1]) for c in caches)
    row_table = torch.as_tensor(np.r_[0, nb, np.arange(2, nb)])
    s_real = Tp - m
    Sb = tradix.bucket_len(s_real, T_max - m)
    suffix = np.zeros((1, Sb), np.int64)
    suffix[0, :s_real] = toks[m - pad_count:]
    pos = (m - pad_count) + np.arange(Sb)[None]
    km = np.zeros((1, T_max), bool)
    km[0, pad_count:m] = True
    got, _ = tradix.suffix_logits(
        params, cfg, torch.as_tensor(suffix), torch.as_tensor(pos),
        torch.tensor([m]), s_real - 1, torch.as_tensor(km), caches, row_table,
        page_size=P, lora_scale=1.0)
    np.testing.assert_allclose(got.numpy(), want[0].numpy(), rtol=0, atol=SUFFIX_TOL)

    jcaches = jax_init_paged_kv_cache(jcfg, nb, P, jnp.float32)
    jtable = jnp.arange(nb, dtype=jnp.int32)
    _, jcaches = jax_prefill(jparams, jcfg, jnp.asarray(pref_ids[None]),
                             jnp.asarray(pref_mask[None]), jcaches,
                             page_table=jtable[None], page_size=P, logical_len=T_max)
    jgot, _ = jradix.suffix_logits(
        jparams, jcfg, jnp.asarray(suffix, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray([m], jnp.int32), jnp.int32(s_real - 1), jnp.asarray(km), jcaches,
        jtable, page_size=P, lora_scale=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0, atol=SUFFIX_TOL)


# --------------------------------------------------------------------- #
# the engine behind the gateway (JAX's gateway cases)
# --------------------------------------------------------------------- #

def _engine(tiny, **kw):
    _, _, cfg, params = tiny
    for k, v in dict(eos_token_id=EOS, pad_token_id=PAD, page_size=4, prompt_len=12,
                     max_new_tokens=8, rows=2, device="cpu").items():
        kw.setdefault(k, v)
    return ServingEngine(params, cfg, **kw)


@pytest.fixture(scope="module")
def served(tiny):
    hub = LatencyHub(enabled=True)
    eng = _engine(tiny, latency=hub, seed=0)
    gw = ServingGateway(eng, port=-1)
    yield eng, gw, f"http://127.0.0.1:{gw.port}"
    gw.close()
    eng.close()


def _post(base, payload, timeout=120):
    req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _quiesce(eng, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = eng.snapshot()
        if snap["pending"] == 0 and snap["active"] == 0:
            return snap
        time.sleep(0.01)
    raise AssertionError("engine never drained")


def _full_budget_prompt(eng):
    """A prompt whose greedy stream runs the whole budget without EOS."""
    for cand in ([5, 6, 7, 8, 9, 10], [11, 12, 13], [20, 21, 22, 23], [30, 31],
                 [40, 41, 42, 43, 44], [50, 51, 52]):
        req, reason = eng.submit(cand, greedy=True)
        assert reason is None
        toks = list(eng.stream(req))
        if len(toks) == eng.max_new_tokens and toks[-1] != EOS:
            _quiesce(eng)
            return cand
    raise AssertionError("no probe prompt ran the full budget")


def test_gateway_generate_and_prefix_reuse(served):
    eng, _, base = served
    r1 = json.loads(_post(base, {"tokens": [5, 6, 7, 8, 9, 10], "greedy": True}).read())
    assert len(r1["tokens"]) >= 1
    r2 = json.loads(_post(base, {"tokens": [5, 6, 7, 8, 9, 10], "greedy": True}).read())
    assert r2["tokens"] == r1["tokens"]
    assert eng.metrics()["serving/prefix_hit_tokens"] > 0
    resp = _post(base, {"tokens": [5, 6, 7, 8, 9, 10], "greedy": True, "stream": True})
    assert "application/x-ndjson" in resp.headers["Content-Type"]
    lines = [json.loads(ln) for ln in resp.read().decode().splitlines()]
    assert lines[-1]["done"] is True
    assert [ln["token"] for ln in lines[:-1]] == r1["tokens"]


def test_gateway_metrics_prometheus_valid(served):
    _, _, base = served
    # a request of its own: the latency histograms and the prefix cache are
    # read after at least one request, whichever tests ran before
    _post(base, {"tokens": [5, 6, 7, 8, 9, 10], "greedy": True}).read()
    text = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
    assert validate_prometheus_text(text) == []
    assert "nanorlhf_serving_requests" in text
    assert "nanorlhf_pages_shared" in text
    assert "nanorlhf_latency_ttft_s_bucket" in text
    statusz = json.loads(urllib.request.urlopen(base + "/statusz", timeout=30).read())
    assert statusz["prefix_cache"]["nodes"] >= 1
    assert statusz["slo"]["rule"] == "slo_ttft_p95"
    assert statusz["session"]["mode"] == "serving"
    assert urllib.request.urlopen(base + "/healthz", timeout=30).status == 200


def test_gateway_sheds_on_slo_and_answers_429(served):
    eng, _, base = served
    for _ in range(eng._slo_warmup + 4):
        eng._hub.record("latency/ttft_s", eng._slo_warn * 10)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, {"tokens": [1, 2, 3]})
    assert err.value.code == 429
    assert err.value.headers.get("Retry-After") == "5"
    assert json.loads(err.value.read())["reason"] == "slo_ttft_p95"
    m = eng.metrics()
    assert m['serving/shed_total{reason="slo_ttft_p95"}'] >= 1
    assert m['serving/shed_total{reason="queue_full"}'] == 0
    assert sum(v for k, v in m.items() if k.startswith("serving/shed_total{")) \
        == m["serving/shed"]
    req, reason = eng.submit([1, 2, 3])
    assert req is None and reason == "slo_ttft_p95"


def test_gateway_rejects_bad_request_and_nonloopback(served):
    _, _, base = served
    with pytest.raises(ValueError, match="loopback"):
        ServingGateway(object(), port=-1, host="0.0.0.0")
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, {"tokens": "not a list"})
    assert err.value.code == 400


def test_engine_prompt_length_validation(served):
    eng, _, _ = served
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(list(range(eng.prompt_len + 1)))
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit([])


def test_engine_cancel_of_an_active_row_releases_pages(tiny):
    """The loop is held before its first decode chunk while the request is
    cancelled, so the row is provably active when the cancel lands (JAX's
    test races the cancel against the row finishing): one chunk of
    sync_every tokens runs, then the reap frees the row's pages."""
    eng = _engine(tiny, seed=0, sync_every=4)
    try:
        victim = _full_budget_prompt(eng)
        base = eng.snapshot()["counters"]
        gate, step = threading.Event(), eng.session.step

        def held_step():
            gate.wait(30)
            return step()

        eng.session.step = held_step
        req, reason = eng.submit(victim, greedy=True)
        assert reason is None
        it = eng.stream(req)
        next(it)                        # the admission's first token
        eng.cancel(req)                 # the loop waits in its first chunk
        gate.set()
        rest = list(it)
        assert len(rest) == eng.sync_every < eng.max_new_tokens - 1
        snap = _quiesce(eng)
        c = snap["counters"]
        assert c["cancelled"] == base["cancelled"] + 1
        assert c["completed"] == base["completed"]
        assert c["admitted"] == c["completed"] + c["cancelled"]
        radix = snap["prefix_cache"]
        assert radix["free_pages"] + radix["cached_pages"] == snap["num_pages"]
        assert radix["shared_pages"] == 0
        assert int((eng.session.table_np < eng.num_pages).sum()) == 0
        eng.cancel(req)                 # idempotent
        assert eng.snapshot()["counters"]["cancelled"] == c["cancelled"]
        req2, _ = eng.submit(victim, greedy=True)
        assert len(list(eng.stream(req2))) == eng.max_new_tokens
    finally:
        eng.close()


def test_engine_cancel_pending_sheds_disconnect(tiny):
    eng = _engine(tiny, seed=0)
    try:
        victim = _full_budget_prompt(eng)
        base = eng.snapshot()["counters"]
        reqs = [eng.submit(victim, greedy=True)[0] for _ in range(6)]
        eng.cancel(reqs[-1])
        assert list(eng.stream(reqs[-1])) == []
        for r in reqs[:-1]:
            list(eng.stream(r))
        snap = _quiesce(eng)
        assert snap["shed_reasons"]["disconnect"] == 1
        assert snap["counters"]["admitted"] == base["admitted"] + 5
        m = eng.metrics()
        assert m['serving/shed_total{reason="disconnect"}'] == 1
        assert m["serving/cancelled"] == 0
    finally:
        eng.close()


def test_gateway_disconnect_fault_mid_stream(tiny):
    eng = _engine(tiny, seed=0)
    inj = FaultInjector.from_spec("gw.disconnect:every=3,count=4")
    gw = ServingGateway(eng, port=-1, faults=inj)
    base = f"http://127.0.0.1:{gw.port}"
    try:
        victim = _full_budget_prompt(eng)
        cancels = []
        orig_cancel = eng.cancel
        eng.cancel = lambda req: (cancels.append(req.request_id), orig_cancel(req))[1]
        truncated = 0
        for _ in range(4):
            resp = _post(base, {"tokens": victim, "greedy": True, "stream": True})
            try:
                body = resp.read()
            except http.client.IncompleteRead as e:
                body = e.partial
            except (ConnectionError, OSError):
                body = b""
            lines = []
            for ln in body.decode(errors="replace").splitlines():
                try:
                    lines.append(json.loads(ln))
                except ValueError:
                    pass
            if not (lines and lines[-1].get("done")):
                truncated += 1
        assert inj.stats()["gw.disconnect"]["fires"] >= 1
        assert truncated >= 1 and len(cancels) == truncated
        snap = _quiesce(eng)
        c = snap["counters"]
        assert c["admitted"] == c["completed"] + c["cancelled"]
        radix = snap["prefix_cache"]
        assert radix["free_pages"] + radix["cached_pages"] == snap["num_pages"]
        assert radix["shared_pages"] == 0
        resp = _post(base, {"tokens": victim, "greedy": True, "stream": True})
        lines = [json.loads(ln) for ln in resp.read().decode().splitlines()]
        assert lines[-1]["done"] is True and len(lines) - 1 == eng.max_new_tokens
    finally:
        gw.close()
        eng.close()


def test_engine_loop_death_reaches_the_clients(tiny):
    """A failing decode chunk kills the loop thread: the open stream ends
    with the exception, and so does the next submit — nothing hangs."""
    eng = _engine(tiny, seed=0)
    try:
        def broken_step():
            raise RuntimeError("device fault in the decode chunk")

        eng.session.step = broken_step
        req, _ = eng.submit([5, 6, 7], greedy=True)
        with pytest.raises(RuntimeError, match="loop died"):
            list(eng.stream(req, timeout=30))
        with pytest.raises(RuntimeError, match="device fault"):
            eng.submit([5, 6, 7])
        assert eng.snapshot()["counters"]["completed"] == 0
    finally:
        eng.close()


def test_engine_needs_a_card_unless_asked_for_cpu(tiny, monkeypatch):
    _, _, cfg, params = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(params, cfg, eos_token_id=EOS, pad_token_id=PAD)
