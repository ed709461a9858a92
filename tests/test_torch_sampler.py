"""The port's sampler (sampler/sampler.py) against the JAX sampler on the
tiny f32 model: greedy streams identical, filtered logits and logprobs
within 1e-5, and the sampled distribution equal by enumeration (threefry
and Philox streams cannot match bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LORA, jax_config, left_pad, make_params, port_config
from nanorlhf_tpu.sampler import sampler as js
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.sampler import sampler as ts

torch.set_num_threads(1)

ATOL = 1e-5
PAD = 0


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("qwen_tied")
    jparams, tparams = make_params(jcfg, seed=11)
    return jcfg, jparams, port_config(jcfg), tparams


def _prompts(lengths, T, seed=1):
    rng = np.random.default_rng(seed)
    return left_pad([rng.integers(4, 128, n).tolist() for n in lengths], T, PAD)


def _run_both(tiny, ids, eos, **sp):
    jcfg, jparams, cfg, tparams = tiny
    mask = ids != PAD
    want = js.generate(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                       jax.random.PRNGKey(0), js.SamplingParams(**sp),
                       eos_token_id=eos, pad_token_id=PAD, lora_scale=LORA.scale)
    timings = {}
    got = ts.generate(tparams, cfg, torch.as_tensor(ids).long(), torch.as_tensor(mask),
                      torch.Generator().manual_seed(0), ts.SamplingParams(**sp),
                      eos_token_id=eos, pad_token_id=PAD, lora_scale=LORA.scale,
                      timings=timings)
    return want, got, timings


@pytest.mark.parametrize("shared", [True, False])
def test_greedy_streams_identical_n4(tiny, shared):
    ids = _prompts((5, 8), 8)
    want, got, _ = _run_both(tiny, ids, eos=200, greedy=True, n=4, max_tokens=10,
                             shared_prompt_prefill=shared)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (8, 10)
    assert _build.launch_counts() == {n: 0 for n in _build.KERNELS}


def test_greedy_all_eos_early_exit(tiny):
    ids = _prompts((6,), 6, seed=2)
    probe, _, _ = _run_both(tiny, ids, eos=200, greedy=True, n=4, max_tokens=12)
    eos = int(np.asarray(probe)[0, 2])  # every row (same prompt) emits it
    want, got, timings = _run_both(tiny, ids, eos=eos, greedy=True, n=4, max_tokens=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    first = int(np.argmax(np.asarray(want)[0] == eos))
    assert (got.numpy()[:, first + 1:] == PAD).all()
    assert timings["decode_steps"] == first  # the loop stopped at the all-EOS step


def test_captured_logprobs_match(tiny):
    ids = _prompts((4, 7), 7, seed=3)
    (wt, wl), (gt, gl), _ = _run_both(tiny, ids, eos=200, greedy=True, n=2,
                                      max_tokens=6, capture_logprobs=True,
                                      temperature=0.7)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("top_p,top_k", [(0.9, 8), (0.8, 0), (1.0, 64), (0.95, 64)])
def test_filtered_logits_and_token_logprob(top_p, top_k, rng):
    logits = (rng.standard_normal((5, 50)) * 2).astype(np.float32)
    want = np.asarray(js.filtered_logits_full(jnp.asarray(logits), 0.7, top_p, top_k, False))
    got = ts.filtered_logits_full(torch.as_tensor(logits), 0.7, top_p, top_k, False).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0)
    tok = rng.integers(0, 50, 5)
    np.testing.assert_allclose(
        ts._token_logprob(torch.as_tensor(logits), torch.as_tensor(tok), 0.7).numpy(),
        np.asarray(js._token_logprob(jnp.asarray(logits), jnp.asarray(tok), 0.7)),
        atol=ATOL, rtol=0)


# TV(empirical, exact) over N draws from a 16-way categorical: its mean is
# about 0.5·Σ sqrt(2 p(1-p) / (π N)) ≤ 0.5·sqrt(2·16 / (π N)) ≈ 0.011 at
# N = 20000; 0.03 leaves ~3x headroom for a fixed seed.
N_DRAWS = 20000
TV_BOUND = 0.03


@pytest.mark.parametrize("top_p,top_k", [(0.8, 6), (0.9, 0), (1.0, 64)])
def test_sampled_distribution_by_enumeration(top_p, top_k, rng):
    logits = (rng.standard_normal(16) * 1.5).astype(np.float32)
    exact = np.asarray(jax.nn.softmax(
        js.filtered_logits_full(jnp.asarray(logits)[None], 0.9, top_p, top_k, False)[0]))
    draws = ts._sample_token(torch.Generator().manual_seed(7),
                             torch.as_tensor(logits).expand(N_DRAWS, 16), 0.9,
                             top_p, False, top_k).numpy()
    freq = np.bincount(draws, minlength=16) / N_DRAWS
    assert (freq[exact == 0] == 0).all()  # nothing outside the keep set
    assert 0.5 * np.abs(freq - exact).sum() < TV_BOUND


def test_unported_sampling_knobs_raise(tiny):
    jcfg, jparams, cfg, tparams = tiny
    ids = torch.as_tensor(_prompts((3,), 3)).long()
    # compaction_segments, ported by the compaction slice: greedy streams
    # equal the monolithic loop's (tests/test_torch_compaction.py holds it
    # against JAX's compaction)
    greedy = dict(max_tokens=6, n=2, greedy=True)
    compact = ts.generate(tparams, cfg, ids, ids != PAD, torch.Generator(),
                          ts.SamplingParams(compaction_segments=2, **greedy),
                          eos_token_id=1, pad_token_id=PAD, lora_scale=LORA.scale)
    mono = ts.generate(tparams, cfg, ids, ids != PAD, torch.Generator(),
                       ts.SamplingParams(**greedy), eos_token_id=1,
                       pad_token_id=PAD, lora_scale=LORA.scale)
    assert torch.equal(compact, mono)
    # spec_k, ported by the speculative slice: greedy streams equal the
    # monolithic loop's
    spec = ts.generate(tparams, cfg, ids, ids != PAD, torch.Generator(),
                       ts.SamplingParams(spec_k=2, **greedy), eos_token_id=1,
                       pad_token_id=PAD, lora_scale=LORA.scale)
    mono = ts.generate(tparams, cfg, ids, ids != PAD, torch.Generator(),
                       ts.SamplingParams(**greedy), eos_token_id=1,
                       pad_token_id=PAD, lora_scale=LORA.scale)
    assert torch.equal(spec, mono)
    # page_size, ported by the paged slice: the same sampled stream as the
    # contiguous cache (the paged layout is a pure re-layout)
    sp = dict(max_tokens=6, n=2, temperature=0.9)
    paged = ts.generate(tparams, cfg, ids, ids != PAD, torch.Generator().manual_seed(3),
                        ts.SamplingParams(page_size=16, **sp), eos_token_id=1,
                        pad_token_id=PAD, lora_scale=LORA.scale)
    contiguous = ts.generate(tparams, cfg, ids, ids != PAD,
                             torch.Generator().manual_seed(3), ts.SamplingParams(**sp),
                             eos_token_id=1, pad_token_id=PAD, lora_scale=LORA.scale)
    assert torch.equal(paged, contiguous)
    with pytest.raises(ValueError):  # the JAX legality matrix comes first
        ts.compose_check(ts.SamplingParams(spec_k=2, compaction_segments=2))
