"""The port's compiled decode loop (`sampler/graph.py`) on the CPU, where
each chunk of `sync_every` iterations runs eagerly:

- the chunked body (sync_every 1, 3, 8; max_tokens not a multiple of it)
  equals the per-step loop — tokens, logprobs and every counter — greedy
  and sampled on one seed (both draw in the same order), on the
  contiguous, paged, int8 and int8 paged caches, speculative decode on
  both layouts, and the queued session (rows, decode_iterations, the
  admission schedule, the acceptance counters);
- a batch whose rows all emit EOS at step 2: the counters equal JAX's
  loops' (its while_loop's step count, spec verify_steps, the session's
  decode_iterations) though the chunk runs on past the end;
- the chunked greedy streams equal JAX's jitted loops;
- a chunk reads nothing back to the host;
- launch bookkeeping with a stand-in graph: a capture records and counts
  nothing, each replay adds the recorded launches, a failed capture names
  the last kernel it launched.

Greedy tokens are compared exactly, logprobs within 1e-5 (f32); on the CPU
the chunked and per-step paths compute the same ops in the same order, so
they are compared exactly."""

import contextlib
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LORA, jax_config, left_pad, make_params, port_config
from nanorlhf_tpu.sampler import sampler as js
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.bridge import params_from_numpy
from nanorlhf_tpu_torch.sampler import graph as tg
from nanorlhf_tpu_torch.sampler import sampler as ts
from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession

torch.set_num_threads(1)

ATOL = 1e-5
PAD, EOS = 0, 3


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("qwen_tied")
    jparams, tparams = make_params(jcfg, seed=21)
    return jcfg, jparams, port_config(jcfg), tparams


@pytest.fixture(scope="module")
def chain():
    """Markov chains v -> v+1 -> ... -> 30 -> EOS (tests/test_paged_cache.py):
    a prompt ending in v generates (30 - v) + 1 tokens greedily, so rows end
    at staggered lengths and the n-gram drafter's drafts are accepted."""
    from tests.test_speculative import cycle_model

    sigma = list(range(32))
    for t in range(10, 30):
        sigma[t] = t + 1
    sigma[30] = EOS
    jcfg, jparams = cycle_model(sigma, vocab=32, peak=3.0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, port_config(jcfg), tparams


def _prompts(lengths, T, seed=1):
    rng = np.random.default_rng(seed)
    return left_pad([rng.integers(4, 128, n).tolist() for n in lengths], T, PAD)


def _run(params, cfg, ids, *, seed=0, lora_scale=LORA.scale, eos=EOS, **sp):
    """generate → (tokens, logprobs or None, counters, timings)."""
    timings, paged, spec = {}, [], []
    out = ts.generate(params, cfg, torch.as_tensor(ids).long(), torch.as_tensor(ids != PAD),
                      torch.Generator().manual_seed(seed), ts.SamplingParams(**sp),
                      eos_token_id=eos, pad_token_id=PAD, lora_scale=lora_scale,
                      timings=timings, paged_stats_out=paged, spec_stats_out=spec)
    toks, lps = out if sp.get("capture_logprobs") else (out, None)
    counters = {"decode_steps": timings["decode_steps"]}
    if paged and paged[0]["decode_iterations"] is not None:
        counters["decode_iterations"] = paged[0]["decode_iterations"]
        counters["admissions"] = paged[0]["admissions"]
        counters["pages_recycled"] = paged[0]["pages_recycled"]
    if spec:
        counters.update({k: np.asarray(v).tolist() for k, v in spec[0].items()})
    return toks, lps, counters, timings


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    if a[1] is not None:
        assert torch.equal(a[1], b[1])
    assert a[2] == b[2]


MONOLITHIC = {
    # name: (model config changes, SamplingParams fields)
    "contiguous": ({}, {}),
    "paged": ({}, dict(page_size=4)),
    "int8": (dict(kv_cache_quant="int8"), {}),
    "int8_paged": (dict(kv_cache_quant="int8"), dict(page_size=5)),
    "spec": ({}, dict(spec_k=3, spec_ngram=2)),
    "spec_paged": ({}, dict(spec_k=3, spec_ngram=2, page_size=4)),
}
SAMPLED = dict(temperature=1.3, top_p=0.9, top_k=8)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("sync_every", [1, 3, 8])
@pytest.mark.parametrize("loop", sorted(MONOLITHIC))
def test_chunk_equals_per_step_loop(tiny, chain, loop, sync_every, greedy):
    """Tokens, logprobs and counters of the chunked body equal the per-step
    loop's, and the chunks ran fewer than sync_every iterations past the
    last live one."""
    mc, sp = MONOLITHIC[loop]
    if "spec_k" in sp:   # the chain model, so that drafts are accepted
        jcfg, _, cfg, params = chain
        ids, lora_scale = left_pad([[9, v] for v in (11, 14, 25, 17)], 2, PAD), 1.0
    else:
        jcfg, _, cfg, params = tiny
        ids, lora_scale = _prompts((5, 8, 3), 8), LORA.scale
    cfg = dataclasses.replace(cfg, **mc)
    sp = dict(sp, n=2, max_tokens=11, capture_logprobs=True, greedy=greedy,
              sync_every=sync_every, **({} if greedy else SAMPLED))
    step = _run(params, cfg, ids, seed=7, lora_scale=lora_scale, decode_loop="per_step", **sp)
    chunk = _run(params, cfg, ids, seed=7, lora_scale=lora_scale, **sp)
    _assert_same(chunk, step)
    run, steps = chunk[3]["graph_steps_run"], chunk[3]["decode_steps"]
    assert run % sync_every == 0 and 0 <= run - steps < sync_every
    assert chunk[3]["graph_replays"] == 0 and step[3]["graph_steps_run"] == 0
    assert _build.launch_counts() == {k: 0 for k in _build.KERNELS}


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("sync_every", [1, 3, 8])
@pytest.mark.parametrize("spec_k", [0, 3], ids=["decode", "spec"])
def test_queued_chunk_equals_per_step_loop(chain, spec_k, sync_every, greedy):
    """The queued session: rows, decode_iterations, the admission schedule
    and the acceptance counters of the chunked session equal the per-step
    session's (which takes the draws of the chunk's predicated-off tail)."""
    jcfg, jparams, cfg, tparams = chain
    ids = left_pad([[9, v] for v in (11, 28, 13, 27, 15, 28, 17, 26)], 2, PAD)
    sp = dict(max_tokens=14, page_size=4, decode_rows=3, capture_logprobs=True,
              greedy=greedy, spec_k=spec_k, spec_ngram=2, sync_every=sync_every,
              **({} if greedy else dict(temperature=1.0, top_p=0.95, top_k=8)))
    step = _run(tparams, cfg, ids, seed=3, lora_scale=1.0, decode_loop="per_step", **sp)
    chunk = _run(tparams, cfg, ids, seed=3, lora_scale=1.0, **sp)
    _assert_same(chunk, step)
    assert chunk[2]["admissions"] and chunk[2]["pages_recycled"] > 0
    assert chunk[3]["graph_steps_run"] % sync_every == 0
    assert chunk[3]["graph_steps_run"] >= chunk[2]["decode_iterations"]


def test_queued_greedy_rows_and_schedule_equal_jax(chain):
    """The chunked queued session at sync_every 8 (JAX's default) gives
    JAX's monolithic greedy rows, and JAX's scheduler's iterations and
    admissions."""
    jcfg, jparams, cfg, tparams = chain
    ids = left_pad([[9, v] for v in (11, 28, 13, 27, 15, 28, 17, 26)], 2, PAD)
    sp = dict(greedy=True, max_tokens=24, page_size=4, decode_rows=2)
    toks, _, counters, _ = _run(tparams, cfg, ids, lora_scale=1.0, **sp)
    jstats = []
    want = js.generate(jparams, jcfg, jnp.asarray(ids), jnp.asarray(ids != PAD),
                       jax.random.PRNGKey(0), js.SamplingParams(**sp), eos_token_id=EOS,
                       pad_token_id=PAD, lora_scale=1.0, paged_stats_out=jstats)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    assert counters["decode_iterations"] == int(np.asarray(jstats[0]["decode_iterations"]))
    assert [(a["row"], a["queue_index"], a["iteration"]) for a in counters["admissions"]] \
        == [(int(a["row"]), int(a["queue_index"]), int(a["iteration"]))
            for a in jstats[0]["admissions"]]


@pytest.mark.parametrize("loop", ["contiguous", "paged", "int8", "spec", "spec_paged"])
def test_chunked_greedy_streams_equal_jax(tiny, loop):
    jcfg, jparams, cfg, tparams = tiny
    mc, sp = MONOLITHIC[loop]
    jcfg, cfg = dataclasses.replace(jcfg, **mc), dataclasses.replace(cfg, **mc)
    ids = _prompts((6, 8, 4), 8, seed=4)
    sp = dict(sp, greedy=True, n=2, max_tokens=13, capture_logprobs="spec_k" not in sp)
    toks, lps, _, _ = _run(tparams, cfg, ids, sync_every=3, eos=200, **sp)
    want = js.generate(jparams, jcfg, jnp.asarray(ids), jnp.asarray(ids != PAD),
                       jax.random.PRNGKey(0), js.SamplingParams(**sp), eos_token_id=200,
                       pad_token_id=PAD, lora_scale=LORA.scale)
    if sp["capture_logprobs"]:
        np.testing.assert_array_equal(toks.numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(lps.numpy(), np.asarray(want[1]), atol=ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


def _jax_monolithic_steps(jparams, jcfg, ids, eos, n, max_tokens):
    """The iterations JAX's jitted monolithic while_loop runs (its final
    step counter - 1), greedy, shared-prompt fan-out n."""
    kw = dict(max_tokens=max_tokens, eos_token_id=eos, pad_token_id=PAD, temperature=1.0,
              top_p=0.95, greedy=True, lora_scale=LORA.scale, top_k=64,
              capture_logprobs=False, approx_top_k=True)
    state = js._prefill_state(jparams, jcfg, jnp.asarray(ids), jnp.asarray(ids != PAD),
                              jax.random.PRNGKey(0), prompt_fanout=n, **kw)
    Tp = ids.shape[1]
    final = jax.lax.while_loop(
        lambda s: (s[0] < max_tokens) & ~jnp.all(s[5]),
        lambda s: js._decode_body(jparams, jcfg, s, Tp=Tp, **kw), state)
    return int(final[0]) - 1


@pytest.mark.parametrize("kind", ["monolithic", "spec", "queued"])
def test_early_finish_counters_equal_jax(tiny, kind):
    """Every row emits EOS at step 2: the chunk (sync_every 8) runs on
    predicated off, and the counters still equal JAX's."""
    jcfg, jparams, cfg, tparams = tiny
    ids = _prompts((6,), 6, seed=2)
    base = dict(greedy=True, n=4, max_tokens=12)
    probe = _run(tparams, cfg, ids, eos=200, **base)[0]
    eos = int(probe[0, 2])
    assert (probe[:, 2] == eos).all() and not (probe[:, :2] == eos).any()
    sp = dict(base, **{"monolithic": {}, "spec": dict(spec_k=2),
                       "queued": dict(page_size=4, decode_rows=3)}[kind])
    toks, _, counters, timings = _run(tparams, cfg, ids, eos=eos, **sp)
    assert (toks[:, 3:] == PAD).all() and (toks[:, 2] == eos).all()
    assert timings["graph_steps_run"] >= 8
    jstats, jspec = [], []
    js.generate(jparams, jcfg, jnp.asarray(ids), jnp.asarray(ids != PAD),
                jax.random.PRNGKey(0), js.SamplingParams(**sp), eos_token_id=eos,
                pad_token_id=PAD, lora_scale=LORA.scale, paged_stats_out=jstats,
                spec_stats_out=jspec)
    if kind == "monolithic":
        assert counters["decode_steps"] == 2 == _jax_monolithic_steps(
            jparams, jcfg, ids, eos, 4, 12)
    elif kind == "spec":
        for key in ("verify_steps", "drafted", "accepted", "emitted", "row_steps"):
            assert counters[key] == int(np.asarray(jspec[0][key])), key
        assert counters["decode_steps"] == counters["verify_steps"]
    else:
        assert counters["decode_iterations"] == int(np.asarray(jstats[0]["decode_iterations"]))
        assert len(counters["admissions"]) == int(np.asarray(jstats[0]["admitted_midloop"]))


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every Python-level read of a tensor back to the host raises, and so
    does indexing with a 0-d integer tensor (torch reads such an index back
    with `item()` in C++)."""
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"host read inside a chunk: Tensor.{name}")
        return f

    for name in ("item", "__bool__", "__int__", "__float__", "__index__", "tolist",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))

    def guarded(orig):
        def f(self, index, *rest):
            parts = index if isinstance(index, tuple) else (index,)
            for p in parts:
                if isinstance(p, torch.Tensor) and p.dim() == 0 and not p.is_floating_point() \
                        and p.dtype != torch.bool:
                    raise AssertionError("host read inside a chunk: a 0-d tensor index")
            return orig(self, index, *rest)
        return f

    monkeypatch.setattr(torch.Tensor, "__getitem__", guarded(torch.Tensor.__getitem__))
    monkeypatch.setattr(torch.Tensor, "__setitem__", guarded(torch.Tensor.__setitem__))
    try:
        yield
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("loop", ["contiguous", "paged", "int8", "spec", "queued",
                                  "spec_queued"])
def test_a_chunk_reads_nothing_back_to_the_host(tiny, monkeypatch, loop):
    jcfg, jparams, cfg, tparams = tiny
    mc, sp = MONOLITHIC.get(loop, ({}, {}))
    if loop.endswith("queued"):
        sp = dict(page_size=4, decode_rows=2, **(dict(spec_k=2) if loop == "spec_queued" else {}))
    cfg = dataclasses.replace(cfg, **mc)
    chunks = []
    run_chunk = tg.ChunkedLoop.run_chunk

    def watched(self):
        with _no_host_reads(pytest.MonkeyPatch()):
            run_chunk(self)
        chunks.append(self.what)

    monkeypatch.setattr(tg.ChunkedLoop, "run_chunk", watched)
    ids = _prompts((5, 7, 4), 8, seed=6)
    _run(tparams, cfg, ids, eos=200, n=2, max_tokens=9, capture_logprobs=True,
         sync_every=3, **SAMPLED, **sp)
    assert len(chunks) >= 3


class _StandInGraph:
    """Stands in for CudaGraphChunk: `capture` runs the chunk's Python (as
    a real capture does, enqueueing nothing here), `replay` records."""

    def __init__(self, fail_after=None):
        self.replays, self.fail_after = 0, fail_after

    def capture(self, fn):
        fn()
        if self.fail_after is not None:
            raise RuntimeError("operation not permitted when stream is capturing")

    def replay(self):
        self.replays += 1


def _fake_kernel(monkeypatch):
    monkeypatch.setattr(_build.Kernel, "function", lambda self, symbol, argtypes: (lambda *a: 0))


def test_launch_bookkeeping_counts_captured_launches_per_replay(monkeypatch):
    _fake_kernel(monkeypatch)
    _build.reset_launch_counts()
    k4, k10 = _build.KERNELS["decode_attention"], _build.KERNELS["fused_logprob"]

    def body():
        k4.launch("x", [])
        k4.launch("x", [])
        k10.launch("y", [])

    graph = _StandInGraph()
    loop = tg.ChunkedLoop(body, sync_every=3, device="cpu", use_graph=True,
                          graph_factory=lambda: graph)
    loop.run_chunk()                    # the warm-up chunk: eager, counted
    assert (k4.launches, k10.launches) == (6, 3)
    for _ in range(4):
        loop.run_chunk()                # capture once, then replays
    assert graph.replays == 4 and loop.replays == 4
    assert loop.captured == {"decode_attention": 6, "fused_logprob": 3}
    assert (k4.launches, k10.launches) == (6 + 4 * 6, 3 + 4 * 3)
    assert loop.steps_run == 5 * 3
    timings = {}
    loop.record(timings)
    assert timings["graph_steps_run"] == 15 and timings["graph_replays"] == 4
    assert timings["graph_capture_s"] >= 0
    assert timings["graph_pool_bytes"] == 0     # no device memory on the CPU
    _build.add_launches({"decode_attention": 2})
    assert k4.launches == 32
    _build.reset_launch_counts()


def test_a_failed_capture_raises_naming_the_last_kernel(monkeypatch):
    _fake_kernel(monkeypatch)
    _build.reset_launch_counts()
    k7 = _build.KERNELS["paged_decode_attention"]
    loop = tg.ChunkedLoop(lambda: k7.launch("x", []), sync_every=2, device="cpu",
                          use_graph=True, graph_factory=lambda: _StandInGraph(fail_after=1))
    loop.run_chunk()
    with pytest.raises(RuntimeError, match="capture of the decode chunk failed.*"
                                           "paged_decode_attention"):
        loop.run_chunk()
    assert k7.launches == 2 and loop.replays == 0   # nothing counted from the capture
    assert not _build._stack()
    _build.reset_launch_counts()


class _Holder:
    """Garbage in a reference cycle whose collection must not happen inside
    a capture (an earlier session's loop holding its graph)."""

    def __init__(self, log):
        self.log, self.me = log, self

    def __del__(self):
        self.log.append("collected")


@pytest.mark.parametrize("fail", [False, True])
def test_capture_runs_with_the_cyclic_collector_paused(fail):
    """Unreachable cycles are collected before the capture starts, the
    collector stays off while the chunk is captured, and it is on again
    after the capture, also after a failed one."""
    log = []

    class Recording(_StandInGraph):
        def capture(self, fn):
            log.append(("capturing, collector on", gc.isenabled()))
            super().capture(fn)

    loop = tg.ChunkedLoop(lambda: None, sync_every=2, device="cpu", use_graph=True,
                          graph_factory=lambda: Recording(fail_after=1 if fail else None))
    loop.run_chunk()
    _Holder(log)                       # unreachable at once, but in a cycle
    assert gc.isenabled()
    if fail:
        with pytest.raises(RuntimeError, match="capture"):
            loop.run_chunk()
    else:
        loop.run_chunk()
    assert log == ["collected", ("capturing, collector on", False)]
    assert gc.isenabled()


def test_decode_loop_options_are_checked(tiny):
    jcfg, jparams, cfg, tparams = tiny
    ids = _prompts((4,), 4)
    with pytest.raises(ValueError, match="decode_loop"):
        _run(tparams, cfg, ids, max_tokens=4, decode_loop="eager")
    with pytest.raises(ValueError, match="sync_every"):
        _run(tparams, cfg, ids, max_tokens=4, sync_every=0)


def test_session_table_and_carry_keep_their_storage(tiny):
    """A replay reads the storage it was captured on: admissions, releases
    and decode chunks write the block table and the carry in place."""
    jcfg, jparams, cfg, tparams = tiny
    ids = torch.as_tensor(_prompts((5, 6, 4), 6, seed=8)).long()
    sess = DecodeSession(tparams, cfg, rows=2, prompt_len=6, max_tokens=5, page_size=4,
                         eos_token_id=EOS, pad_token_id=PAD, generator=torch.Generator(),
                         greedy=True, lora_scale=LORA.scale, sync_every=3)
    sess.bootstrap(ids, ids != PAD)
    ptrs = {k: v.data_ptr() for k, v in sess.state.items() if isinstance(v, torch.Tensor)}
    table = sess.table.data_ptr()
    while not sess.step().all():
        pass
    sess.release(0)
    sess.admit(0, ids[2].numpy(), (ids[2] != PAD).numpy(), 2)
    sess.step()
    assert sess.table.data_ptr() == table
    assert {k: sess.state[k].data_ptr() for k in ptrs} == ptrs
    np.testing.assert_array_equal(sess.table.numpy(), sess._pstate.table)
