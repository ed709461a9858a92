"""The port's paged sampler paths against the contiguous one and against the
JAX sampler, on tiny f32 models:

- the monolithic paged loop (identity table) equals the contiguous loop bit
  for bit — page sizes dividing and not dividing the logical width, logprob
  capture, n=2 shared-prompt fan-out — and JAX's paged greedy stream;
- the int8 KV cache: contiguous and paged greedy streams equal each other
  and JAX's int8 greedy stream;
- continuous batching on the chain model of `tests/test_paged_cache.py`
  (built in JAX, bridged): the queued greedy rows equal JAX's monolithic
  rows in fewer decode iterations than the fixed-batch schedule, with the
  same admission and recycling counts;
- sampled queued rows keep the output contract, an admission's first token
  comes from its queue entry's own generator, and that draw passes a TV
  check against the exact filtered distribution.

Greedy tokens are compared exactly, logprobs within 1e-5 (f32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LORA, jax_config, left_pad, make_params, port_config
from nanorlhf_tpu.sampler import sampler as js
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.bridge import params_from_numpy
from nanorlhf_tpu_torch.sampler import sampler as ts
from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession

torch.set_num_threads(1)

ATOL = 1e-5
PAD, EOS = 0, 3


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("qwen_tied")
    jparams, tparams = make_params(jcfg, seed=11)
    return jcfg, jparams, port_config(jcfg), tparams


def _prompts(lengths, T, seed=1):
    rng = np.random.default_rng(seed)
    return left_pad([rng.integers(4, 128, n).tolist() for n in lengths], T, PAD)


def _port(params, cfg, ids, seed=0, stats=None, lora_scale=LORA.scale, **sp):
    return ts.generate(params, cfg, torch.as_tensor(ids).long(),
                       torch.as_tensor(ids != PAD), torch.Generator().manual_seed(seed),
                       ts.SamplingParams(**sp), eos_token_id=EOS, pad_token_id=PAD,
                       lora_scale=lora_scale, paged_stats_out=stats)


def _jax(params, cfg, ids, lora_scale=LORA.scale, stats=None, **sp):
    return js.generate(params, cfg, jnp.asarray(ids), jnp.asarray(ids != PAD),
                       jax.random.PRNGKey(0), js.SamplingParams(**sp),
                       eos_token_id=EOS, pad_token_id=PAD, lora_scale=lora_scale,
                       paged_stats_out=stats)


PAGED_CASES = {
    # name: (page_size, n, capture_logprobs)
    "p8": (8, 1, False),
    "p5_not_dividing": (5, 1, True),
    "p5_fanout_n2": (5, 2, True),
    "p8_fanout_n2_unshared": (8, 2, False),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_monolithic_paged_greedy_equals_contiguous_and_jax(tiny, case):
    jcfg, jparams, cfg, tparams = tiny
    P, n, capture = PAGED_CASES[case]
    ids = _prompts((5, 8, 3), 8)
    sp = dict(greedy=True, n=n, max_tokens=11, capture_logprobs=capture,
              shared_prompt_prefill=not case.endswith("unshared"))
    contiguous = _port(tparams, cfg, ids, **sp)
    stats = []
    paged = _port(tparams, cfg, ids, stats=stats, page_size=P, **sp)
    if capture:
        assert torch.equal(paged[0], contiguous[0])
        assert torch.equal(paged[1], contiguous[1])
    else:
        assert torch.equal(paged, contiguous)
    want = _jax(jparams, jcfg, ids, page_size=P, **sp)
    got = paged[0] if capture else paged
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[0] if capture else want))
    if capture:
        np.testing.assert_allclose(paged[1].numpy(), np.asarray(want[1]), atol=ATOL, rtol=0)
    st = stats[0]
    assert st["pages_recycled"] == 0 and st["admitted_midloop"] == 0
    assert st["rows"] == 3 * n and 0.0 < st["page_utilization"] <= 1.0
    assert _build.launch_counts() == {k: 0 for k in _build.KERNELS}


@pytest.mark.parametrize("page_size", [0, 5])
def test_int8_greedy_equals_jax_and_across_layouts(tiny, page_size):
    jcfg, jparams, cfg, tparams = tiny
    jq = dataclasses.replace(jcfg, kv_cache_quant="int8")
    tq = dataclasses.replace(cfg, kv_cache_quant="int8")
    ids = _prompts((6, 8), 8, seed=3)
    sp = dict(greedy=True, n=2, max_tokens=10, capture_logprobs=True)
    got = _port(tparams, tq, ids, page_size=page_size, **sp)
    base = _port(tparams, tq, ids, **sp)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    want = _jax(jparams, jq, ids, page_size=page_size, **sp)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL, rtol=0)
    # the queued route over the int8 pool
    queued = _port(tparams, tq, ids, page_size=4, decode_rows=3, **sp)
    assert torch.equal(queued[0], base[0])
    np.testing.assert_allclose(queued[1].numpy(), base[1].numpy(), atol=ATOL, rtol=0)


# --------------------------------------------------------------------- #
# continuous batching on the chain model
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def chain():
    """Markov chains v -> v+1 -> ... -> 30 -> EOS: a prompt ending in v
    generates exactly (30 - v) + 1 tokens greedily (test_paged_cache.py)."""
    from tests.test_speculative import cycle_model

    sigma = list(range(32))
    for t in range(10, 30):
        sigma[t] = t + 1
    sigma[30] = EOS
    jcfg, jparams = cycle_model(sigma, vocab=32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, port_config(jcfg), tparams


def test_queued_long_tail_fewer_iterations_same_tokens(chain):
    jcfg, jparams, cfg, tparams = chain
    starts = [11, 28, 13, 27, 15, 28, 17, 26]
    lengths = [31 - v for v in starts]
    ids = left_pad([[9, v] for v in starts], 2, PAD)
    R, max_tokens = 2, 24
    mono = _jax(jparams, jcfg, ids, lora_scale=1.0, greedy=True, max_tokens=max_tokens)
    stats = []
    queued = _port(tparams, cfg, ids, stats=stats, lora_scale=1.0, greedy=True,
                   max_tokens=max_tokens, page_size=4, decode_rows=R)
    np.testing.assert_array_equal(queued.numpy(), np.asarray(mono))
    fixed_iters = sum(max(lengths[i:i + R]) - 1 for i in range(0, len(lengths), R))
    st = stats[0]
    assert st["decode_iterations"] < fixed_iters
    assert st["admitted_midloop"] == len(starts) - R == 6
    assert st["pages_recycled"] > 0
    assert 0.0 < st["page_utilization"] <= 1.0
    for adm in st["admissions"]:
        assert 0 <= adm["row"] < R and R <= adm["queue_index"] < len(starts)
    assert st["dispatch_events"] == 1 + 6 + st["decode_iterations"]
    assert st["session"]["counters"]["decode_iterations"] == st["decode_iterations"]
    # JAX's scheduler on the same queue: the same schedule
    jstats = []
    _jax(jparams, jcfg, ids, lora_scale=1.0, stats=jstats, greedy=True,
         max_tokens=max_tokens, page_size=4, decode_rows=R)
    for key in ("decode_iterations", "admitted_midloop", "pages_recycled", "num_pages"):
        assert st[key] == int(np.asarray(jstats[0][key])), key
    assert st["page_utilization"] == pytest.approx(jstats[0]["page_utilization"])


def test_queued_sampled_rows_keep_the_output_contract(tiny):
    jcfg, jparams, cfg, tparams = tiny
    ids = _prompts((5, 7, 4, 6), 8, seed=5)

    def run(eos, stats=None):
        return ts.generate(
            tparams, cfg, torch.as_tensor(ids).long(), torch.as_tensor(ids != PAD),
            torch.Generator().manual_seed(4),
            ts.SamplingParams(n=3, max_tokens=12, page_size=4, decode_rows=5,
                              temperature=1.3, top_p=0.98, capture_logprobs=True),
            eos_token_id=eos, pad_token_id=PAD, lora_scale=LORA.scale,
            paged_stats_out=stats)

    # the stop token: the commonest early token of a run without one, so
    # rows end at staggered lengths and admissions land mid-loop
    free, _ = run(eos=-1)
    eos = int(np.bincount(free[:, 1:6].numpy().ravel()).argmax())
    stats = []
    toks, lps = run(eos, stats)
    assert toks.shape == (12, 12) and lps.shape == (12, 12)
    ended = 0
    for row, lp in zip(toks.numpy(), lps.numpy()):
        hits = np.flatnonzero(row == eos)
        end = hits[0] + 1 if hits.size else row.size
        ended += hits.size > 0
        assert (row[end:] == PAD).all() and (lp[end:] == 0).all()
        assert (lp[:end] <= 0).all() and (lp[:end] < 0).any()
    assert ended > 0
    assert stats[0]["admitted_midloop"] == 12 - 5


def test_admission_first_token_stream_and_distribution(tiny):
    """An admitted row's first token is drawn from its queue entry's own
    generator (not the resident row's), and that draw follows the exact
    filtered distribution (TV distance over 20000 queue indices)."""
    jcfg, jparams, cfg, tparams = tiny
    ids = torch.as_tensor(_prompts((6, 6), 6, seed=7)).long()
    mask = ids != PAD
    sample = dict(temperature=0.9, top_p=0.8, top_k=6)
    sess = DecodeSession(tparams, cfg, rows=1, prompt_len=6, max_tokens=4,
                         page_size=4, eos_token_id=EOS, pad_token_id=PAD,
                         generator=torch.Generator().manual_seed(9),
                         lora_scale=LORA.scale, **sample)
    sess.bootstrap(ids, mask)
    logits, _ = ts.prefill(tparams, cfg, ids[1:], mask[1:],
                           ts.init_kv_cache(cfg, 1, 10, torch.float32, "cpu"),
                           lora_scale=LORA.scale)
    for q in (5, 41):
        assert sess.release(0) > 0
        sess.admit(0, ids[1].numpy(), mask[1].numpy(), q)
        want = ts._sample_token(sess.admission_generator(q), logits, greedy=False, **sample)
        assert int(sess.state["cur_tok"][0]) == int(want[0])
    n_draws = 20000
    draws = np.asarray([int(ts._sample_token(sess.admission_generator(q), logits,
                                             greedy=False, **sample)[0])
                        for q in range(n_draws)])
    exact = torch.softmax(ts.filtered_logits_full(logits, 0.9, 0.8, 6, True), -1)[0].numpy()
    freq = np.bincount(draws, minlength=exact.size) / n_draws
    assert (freq[exact == 0] == 0).all()
    assert 0.5 * np.abs(freq - exact).sum() < 0.03
