"""The port's decode session in its serving compositions, against the JAX
package on a tiny f32 model:

- greedy queued streams and the session's counters equal JAX's with the
  radix prefix cache on and off, chunked prefill on and off (× radix),
  and speculative decode under the radix cache (the seeded drafter):
  dispatch_events, launches, decode iterations, dispatch tokens, prefix
  hit tokens, chunked_admissions, prefill_backlog_peak, accepted drafts;
- the serving engine's greedy stream equals the rollout scheduler's for
  the same prompt, with and without chunked prefill and spec decode;
- `compose_check`: JAX's legal and illegal cases, the same exception
  class;
- a stand-in graph shows that a row's new temperature, top-p or greedy
  flag, written in place by an admission, reaches the replayed chunk.

Greedy tokens and integer counters are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from _torch_parity import jax_config, left_pad, make_params, port_config
from nanorlhf_tpu.sampler import SamplingParams as JaxSamplingParams
from nanorlhf_tpu.sampler import compose_check as jax_compose_check
from nanorlhf_tpu.sampler import generate as jax_generate
from nanorlhf_tpu.serving.radix import RadixCache as JaxRadixCache
from nanorlhf_tpu_torch.sampler import sampler as ts
from nanorlhf_tpu_torch.sampler.paged import session as tsess
from nanorlhf_tpu_torch.serving.engine import ServingEngine
from nanorlhf_tpu_torch.serving.radix import RadixCache

torch.set_num_threads(1)

EOS, PAD = 3, 0
TP = 12          # padded prompt width
MT = 8           # max_tokens
FAMILY = [5, 6, 7, 8, 9, 10, 11, 12]
OVERLAP = [FAMILY] * 6
# mixed: two families with shared prefixes of different lengths, a long
# cold prompt and a short one (mid-page radix hits, COW splits, chunking)
MIXED = [FAMILY, FAMILY[:5] + [40, 41], [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30],
         FAMILY[:6] + [50, 51, 52], [60, 61], FAMILY]

COUNTERS = ("launches", "decode_iterations", "dispatch_events", "dispatch_tokens",
            "prefix_hit_tokens", "chunked_admissions", "prefill_backlog_peak")
STATS = ("admitted_midloop", "pages_recycled", "decode_iterations",
         "prefill_token_dispatch", "dispatch_events", "chunked_admissions",
         "prefill_backlog_peak", "num_pages")


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("qwen_tied")
    jparams, tparams = make_params(jcfg, seed=7, lora=False)
    return jcfg, jparams, port_config(jcfg), tparams


def _run_port(tiny, prompts, *, spec_k=0, radix=False, prefill_chunk=0):
    _, _, cfg, params = tiny
    ids = left_pad(prompts, TP, PAD)
    stats, spec_stats = [], []
    out = ts.generate(
        params, cfg, torch.as_tensor(ids).long(), torch.as_tensor(ids != PAD),
        torch.Generator().manual_seed(0),
        ts.SamplingParams(max_tokens=MT, greedy=True, page_size=4, decode_rows=2,
                          spec_k=spec_k, prefill_chunk=prefill_chunk),
        eos_token_id=EOS, pad_token_id=PAD, paged_stats_out=stats,
        spec_stats_out=spec_stats, prefix_cache=RadixCache() if radix else None)
    return out.numpy(), stats[0], (spec_stats[0] if spec_stats else None)


def _run_jax(tiny, prompts, *, spec_k=0, radix=False, prefill_chunk=0):
    jcfg, jparams, _, _ = tiny
    ids = left_pad(prompts, TP, PAD)
    stats, spec_stats = [], []
    out = jax_generate(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(ids != PAD), jax.random.PRNGKey(0),
        JaxSamplingParams(max_tokens=MT, greedy=True, page_size=4, decode_rows=2,
                          spec_k=spec_k, prefill_chunk=prefill_chunk),
        eos_token_id=EOS, pad_token_id=PAD, paged_stats_out=stats,
        spec_stats_out=spec_stats, prefix_cache=JaxRadixCache() if radix else None)
    return np.asarray(out), stats[0], (spec_stats[0] if spec_stats else None)


CASES = {
    "plain": dict(),
    "radix": dict(radix=True),
    "chunked": dict(prefill_chunk=4),
    "radix_chunked": dict(radix=True, prefill_chunk=4),
    "spec": dict(spec_k=3),
    "spec_radix": dict(spec_k=3, radix=True),
    "spec_radix_chunked": dict(spec_k=3, radix=True, prefill_chunk=4),
}


@pytest.fixture(scope="module")
def runs(tiny):
    out = {}
    for corpus, prompts in (("overlap", OVERLAP), ("mixed", MIXED)):
        for name, kw in CASES.items():
            out[corpus, name] = (_run_port(tiny, prompts, **kw),
                                 _run_jax(tiny, prompts, **kw))
    return out


@pytest.mark.parametrize("corpus", ["overlap", "mixed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_streams_and_stats_match_jax(runs, corpus, case):
    (got, gst, gspec), (want, wst, wspec) = runs[corpus, case]
    np.testing.assert_array_equal(got, want)
    for k in STATS:
        assert gst[k] == wst[k], (k, gst[k], wst[k])
    for k in ("prefix_hit_tokens", "cow_splits", "evicted_pages", "shared_pages"):
        assert (k in gst) == (k in wst)
        if k in gst:
            assert gst[k] == wst[k], (k, gst[k], wst[k])
    assert gst["session"]["counters"] == wst["session"]["counters"]
    assert gst["session"]["features"] == wst["session"]["features"]
    if gspec is not None:
        for k in ("verify_steps", "drafted", "accepted", "emitted", "row_steps"):
            assert int(gspec[k]) == int(np.asarray(wspec[k])), k


@pytest.mark.parametrize("corpus", ["overlap", "mixed"])
def test_every_composition_keeps_the_greedy_stream(runs, corpus):
    """Greedy output is the same across every legal composition (each
    changes the dispatch shape only), and the chunked runs did chunk."""
    ref = runs[corpus, "plain"][0][0]
    for name in CASES:
        np.testing.assert_array_equal(runs[corpus, name][0][0], ref, err_msg=name)
    for name in ("chunked", "radix_chunked", "spec_radix_chunked"):
        st = runs[corpus, name][0][1]
        assert st["chunked_admissions"] > 0 and st["prefill_backlog_peak"] > 0
    both, spec, radix = (runs["overlap", n][0] for n in ("spec_radix", "spec", "radix"))
    assert both[1]["dispatch_events"] < min(radix[1]["dispatch_events"],
                                            spec[1]["dispatch_events"])
    assert int(both[2]["accepted"]) > int(spec[2]["accepted"])
    assert runs["mixed", "radix"][0][1]["cow_splits"] > 0


# --------------------------------------------------------------------- #
# the serving engine: one scheduler code path
# --------------------------------------------------------------------- #

def _serve(tiny, prompts, **kw):
    _, _, cfg, params = tiny
    eng = ServingEngine(params, cfg, eos_token_id=EOS, pad_token_id=PAD, page_size=4,
                        prompt_len=TP, max_new_tokens=MT, rows=2, seed=0,
                        device="cpu", **kw)
    try:
        reqs = [eng.submit(p, greedy=True)[0] for p in prompts]
        toks = [list(eng.stream(r)) for r in reqs]
    finally:
        eng.close()     # joins the loop: the counters are final
    return toks, eng.snapshot()


def _rollout_streams(rollout):
    out = []
    for row in rollout:
        eos = np.nonzero(row == EOS)[0]
        out.append((row[:int(eos[0]) + 1] if eos.size else row).tolist())
    return out


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=4), dict(spec_k=3)],
                         ids=["plain", "chunked", "spec"])
def test_engine_stream_equals_rollout_stream(tiny, runs, kw):
    """Same prompts, greedy: the engine's per-request streams equal the
    rollout scheduler's rows (and JAX's), with chunked prefill and spec
    decode on as well."""
    want = _rollout_streams(runs["mixed", "plain"][1][0])
    got, snap = _serve(tiny, MIXED, **kw)
    assert got == want
    sess = snap["session"]
    assert sess["mode"] == "serving" and sess["features"]["per_row_sampling"]
    assert sess["features"]["prefix_cache"]
    assert snap["counters"]["completed"] == len(MIXED)
    assert snap["prefix_cache"]["hit_tokens"] > 0
    if kw.get("prefill_chunk"):
        assert sess["counters"]["chunked_admissions"] > 0


def test_engine_stream_matches_jax_engine(tiny):
    """The JAX engine on the same requests: the same greedy streams and the
    same radix counters."""
    from nanorlhf_tpu.serving.engine import ServingEngine as JaxEngine

    jcfg, jparams, _, _ = tiny
    eng = JaxEngine(jparams, jcfg, eos_token_id=EOS, pad_token_id=PAD, page_size=4,
                    prompt_len=TP, max_new_tokens=MT, rows=2, seed=0)
    try:
        reqs = [eng.submit(p, greedy=True)[0] for p in MIXED]
        want = [list(eng.stream(r)) for r in reqs]
    finally:
        eng.close()
    wsnap = eng.snapshot()
    got, snap = _serve(tiny, MIXED)
    assert got == want
    for k in ("hit_tokens", "cow_splits", "lookups", "lookup_tokens", "inserted_nodes",
              "shared_pages_acquired", "nodes", "cached_pages"):
        assert snap["prefix_cache"][k] == wsnap["prefix_cache"][k], k
    assert snap["prefill_token_dispatch"] == wsnap["prefill_token_dispatch"]


# --------------------------------------------------------------------- #
# compose_check: the one legality matrix
# --------------------------------------------------------------------- #

ILLEGAL = [
    (dict(page_size=4, compaction_segments=2), False, "page_size"),
    (dict(spec_k=2, compaction_segments=2), False, "spec_k"),
    (dict(), True, "continuous batching"),
    (dict(page_size=4), True, "continuous batching"),
    (dict(prefill_chunk=4), False, "prefill_chunk"),
    (dict(page_size=4, prefill_chunk=4), False, "prefill_chunk"),
]
LEGAL = [
    dict(page_size=4, decode_rows=2, spec_k=3),
    dict(page_size=4, decode_rows=2, prefill_chunk=4, spec_k=3),
    dict(page_size=4, spec_k=3),
]


@pytest.mark.parametrize("kw,pc,match", ILLEGAL)
def test_compose_check_illegal_as_jax(kw, pc, match):
    with pytest.raises(ValueError, match=match):
        jax_compose_check(JaxSamplingParams(**kw), prefix_cache=pc)
    with pytest.raises(ValueError, match=match):
        ts.compose_check(ts.SamplingParams(**kw), prefix_cache=pc)


@pytest.mark.parametrize("kw", LEGAL)
def test_compose_check_legal_as_jax(kw):
    pc = kw.get("page_size", 0) > 0 and kw.get("decode_rows", 0) > 0
    jax_compose_check(JaxSamplingParams(**kw), prefix_cache=pc)
    ts.compose_check(ts.SamplingParams(**kw), prefix_cache=pc)


def test_compaction_alone_is_legal_but_not_ported():
    """JAX's last legal case, compaction alone: legal in the matrix, the
    one knob the port still refuses (NotImplementedError)."""
    jax_compose_check(JaxSamplingParams(compaction_segments=2))
    with pytest.raises(NotImplementedError, match="compaction"):
        ts.compose_check(ts.SamplingParams(compaction_segments=2))


@pytest.mark.parametrize("kw,match", [
    (dict(per_row=True, capture_logprobs=True), "capture_logprobs"),
    (dict(per_row=True, spec_k=2), "greedy"),
])
def test_session_refuses_what_jax_refuses(tiny, kw, match):
    jcfg, jparams, cfg, params = tiny
    from nanorlhf_tpu.sampler.paged.session import DecodeSession as JaxSession

    common = dict(rows=2, prompt_len=TP, max_tokens=MT, page_size=4,
                  eos_token_id=EOS, pad_token_id=PAD)
    with pytest.raises(ValueError, match=match):
        JaxSession(jparams, jcfg, key=jax.random.PRNGKey(0), **common, **kw)
    with pytest.raises(ValueError, match=match):
        tsess.DecodeSession(params, cfg, generator=torch.Generator(), **common, **kw)


# --------------------------------------------------------------------- #
# the graph trap: per-row parameters reach a replayed chunk
# --------------------------------------------------------------------- #

class _RecordingGraph:
    """Stands in for a captured CUDA graph: `capture` keeps the chunk and
    records every device buffer the session's body reads (a real capture
    runs nothing either); `replay` fails unless each is still the same
    tensor object with the same storage (a real graph keeps reading what
    it captured — a buffer rebound instead of written in place would be
    silently ignored), then runs the chunk."""

    BUFFERS = ("r_temp", "r_topp", "r_greedy", "r_budget", "table", "prompt_res",
               "seed_rep", "seed_len")

    def __init__(self, sess):
        self.sess, self.replays = sess, 0

    def _held(self):
        s = self.sess
        held = {n: getattr(s, n) for n in self.BUFFERS}
        held.update({f"state.{k}": v for k, v in s.state.items()
                     if isinstance(v, torch.Tensor)})
        return held

    def capture(self, fn):
        self.fn = fn
        self.held = {n: (t, t.data_ptr()) for n, t in self._held().items()}

    def replay(self):
        for n, t in self._held().items():
            t0, ptr = self.held[n]
            assert t is t0 and t.data_ptr() == ptr, f"{n} was rebound after capture"
        self.fn()
        self.replays += 1


def test_new_row_params_reach_the_replayed_chunk(tiny):
    """Two rows decode sampled at a high temperature; once the chunk is
    captured, row 0 is re-admitted greedy and row 1 at temperature ~0 and
    top-p ~0 (a point mass on the argmax): both now emit the greedy
    stream of their prompt, through replays of the captured chunk."""
    _, _, cfg, params = tiny
    sess = tsess.DecodeSession(
        params, cfg, rows=2, prompt_len=TP, max_tokens=MT, page_size=4,
        eos_token_id=EOS, pad_token_id=PAD, generator=torch.Generator().manual_seed(3),
        per_row=True, prefix_cache=RadixCache(), sync_every=2)
    graph = _RecordingGraph(sess)
    sess._loop.use_graph = True
    sess._loop.graph_factory = lambda: graph
    ids = left_pad([FAMILY, [20, 21, 22, 23, 24]], TP, PAD)
    mask = ids != PAD
    for r in range(2):
        sess.admit(r, ids[r], mask[r], r, budget=MT, temperature=5.0, top_p=1.0,
                   greedy=False)
    sess.step()
    sess.step()                 # the capture and its first replay
    assert graph.replays == 1 and sess._loop.graph is graph
    for r in range(2):
        sess.cancel_row(r)
    sess.admit(0, ids[0], mask[0], 10, budget=MT, greedy=True)
    sess.admit(1, ids[1], mask[1], 11, budget=MT, temperature=1e-6, top_p=1e-6)
    while not sess.step().all():
        pass
    assert graph.replays > 0
    want = _rollout_streams(runs_greedy(tiny, [FAMILY, [20, 21, 22, 23, 24]]))
    out = sess.state["out"].numpy()
    n = sess.state["n_gen"].numpy()
    assert [out[r, :n[r]].tolist() for r in range(2)] == want
    assert sess.r_greedy.tolist() == [True, False]


def runs_greedy(tiny, prompts):
    return _run_port(tiny, prompts)[0]


# --------------------------------------------------------------------- #
# the trainer: rollout_prefix_cache and rollout_prefill_chunk
# --------------------------------------------------------------------- #

def test_grpo_update_with_prefix_cache_and_chunked_prefill(tmp_path):
    """One GRPO update through the radix cache with chunked prefill on the
    queued paged rollout: finite rows, the session/* and prefix rows, the
    trainer's long-lived tree stats and its /statusz snapshot."""
    import json
    import os

    from nanorlhf_tpu_torch.entrypoints import common
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut

    def trainer(**over):
        cfg = one_card_cut(build_config())
        cfg.sft_model_path = "tiny-demo"
        cfg.output_dir = str(tmp_path / f"run{len(over)}")
        cfg.response_length = 6
        cfg.per_device_train_batch_size = 2
        cfg.total_episodes = 32
        cfg.lora_r, cfg.lora_alpha = 4, 8
        cfg.rollout_page_size, cfg.rollout_decode_rows = 4, 4
        for k, v in over.items():
            setattr(cfg, k, v)
        tr = common.build_trainer(cfg, device="cpu")
        tr.reward_func = lambda texts, eos: np.asarray(
            [float(len(t) % 7) for t in texts], np.float32)
        return tr

    tr = trainer(rollout_prefix_cache=True, rollout_prefill_chunk=4)
    state = tr.train(num_updates=1)
    assert state["global_step"] == 1
    row = [json.loads(line) for line in
           open(os.path.join(tr.cfg.output_dir, "metrics.jsonl"))][-1]
    for key in ("session/dispatch_events", "session/chunked_admissions",
                "session/prefill_backlog", "rollout/prefix_hit_frac", "pages/shared",
                "loss/policy_avg_new"):
        assert np.isfinite(row[key]), key
    assert row["session/chunked_admissions"] > 0 and row["session/prefill_backlog"] > 0
    assert row["rollout/prefix_hit_frac"] > 0   # sample_n repeats of each prompt
    assert tr.prefix_cache.stats["lookups"] == tr.cfg.batch_size * tr.cfg.sample_n
    snap = tr._statusz()["prefix_cache"]
    assert snap["lookups"] > 0 and snap["hit_tokens"] > 0
    assert tr._statusz()["session"]["features"]["prefill_chunk"] == 4
