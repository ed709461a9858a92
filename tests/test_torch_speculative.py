"""The port's speculative decode (sampler/speculative.py, core/model.py's
`decode_verify`, the queued session's spec mode) against the JAX package
on tiny f32 models:

- `ngram_propose` and greedy `accept_candidates` equal JAX's exactly;
  sampled acceptance follows the filtered distribution (enumeration of the
  rule, then an empirical frequency check);
- `decode_verify` against JAX's (logits and written cache slots, contiguous,
  paged and int8) and against the port's own `decode_step` chain;
- greedy spec streams equal JAX's spec streams and the port's monolithic
  streams token for token, with JAX's statistics, over the contiguous,
  paged, fan-out, int8 and queued layouts; per-row bookkeeping under mixed
  accept lengths; EOS inside an accepted draft; the cycle model halves the
  verify forwards;
- one GRPO update with `rollout_spec_k` through `common.run` on the CPU.

Tolerances: 1e-5 absolute in f32 (the same arithmetic in another order or
GEMM shape); tokens exactly."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
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
from nanorlhf_tpu.core import model as jm
from nanorlhf_tpu.sampler import sampler as js
from nanorlhf_tpu.sampler import speculative as jspec
from nanorlhf_tpu.sampler.paged.pages import full_table as jax_full_table
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.bridge import params_from_numpy
from nanorlhf_tpu_torch.core import model as tm
from nanorlhf_tpu_torch.sampler import sampler as ts
from nanorlhf_tpu_torch.sampler import speculative as tspec
from nanorlhf_tpu_torch.sampler.paged.pages import full_table

torch.set_num_threads(1)

ATOL = 1e-5
PAD, EOS = 0, 3


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("qwen_tied")
    jparams, tparams = make_params(jcfg, seed=11)
    return jcfg, jparams, port_config(jcfg), tparams


def _cycle(sigma, vocab=16, peak=12.0):
    """JAX's deterministic Markov "cycle model" (tests/test_speculative.py),
    bridged: after token t the logits are peak·onehot(sigma[t])."""
    from tests.test_speculative import cycle_model

    jcfg, jparams = cycle_model(sigma, vocab=vocab, peak=peak)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, port_config(jcfg), tparams


def _prompts(lengths, T, seed=1):
    rng = np.random.default_rng(seed)
    return left_pad([rng.integers(4, 128, n).tolist() for n in lengths], T, PAD)


def _port(params, cfg, ids, lora_scale=LORA.scale, seed=0, **sp):
    stats = []
    out = ts.generate(params, cfg, torch.as_tensor(ids).long(), torch.as_tensor(ids != PAD),
                      torch.Generator().manual_seed(seed), ts.SamplingParams(**sp),
                      eos_token_id=EOS, pad_token_id=PAD, lora_scale=lora_scale,
                      spec_stats_out=stats)
    return out, (stats[0] if stats else None)


def _jax(params, cfg, ids, lora_scale=LORA.scale, **sp):
    stats = []
    out = js.generate(params, cfg, jnp.asarray(ids), jnp.asarray(ids != PAD),
                      jax.random.PRNGKey(0), js.SamplingParams(**sp), eos_token_id=EOS,
                      pad_token_id=PAD, lora_scale=lora_scale, spec_stats_out=stats)
    return out, (stats[0] if stats else None)


def _stats(st) -> dict:
    return {k: np.asarray(v.tolist() if isinstance(v, torch.Tensor) else v).tolist()
            for k, v in st.items()}


# --------------------------------------------------------------------- #
# drafting and acceptance
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("m", [1, 2, 3])
def test_ngram_propose_matches_jax(m):
    rng = np.random.default_rng(m)
    B, S, k = 8, 24, 4
    buf = rng.integers(1, 5, (B, S)).astype(np.int32)   # small vocab: many matches
    end = rng.integers(m, S + 1, B).astype(np.int32)
    valid_start = rng.integers(0, 6, B).astype(np.int32)
    buf[0, :] = np.arange(S) + 10                      # a row with no match
    end[1], valid_start[1] = 20, 0                     # a row with a match
    buf[1, 20 - m:20] = buf[1, 5:5 + m]
    want_d, want_h = jspec.ngram_propose(jnp.asarray(buf), jnp.asarray(end),
                                         jnp.asarray(valid_start), k=k, m=m,
                                         pad_token_id=PAD)
    got_d, got_h = tspec.ngram_propose(torch.as_tensor(buf).long(), torch.as_tensor(end).long(),
                                       torch.as_tensor(valid_start).long(), k=k, m=m,
                                       pad_token_id=PAD)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    assert not bool(got_h[0]) and bool(got_h.any())


def test_greedy_accept_candidates_matches_jax():
    rng = np.random.default_rng(5)
    B, k, V = 6, 4, 11
    logits = rng.standard_normal((B, k + 1, V)).astype(np.float32)
    t_hat = logits.argmax(-1)
    drafts = rng.integers(0, V, (B, k))
    for b in range(B):  # row b agrees with the argmax chain for b tokens
        n = min(b, k)
        drafts[b, :n] = t_hat[b, :n]
        if n < k:
            drafts[b, n] = (t_hat[b, n] + 1) % V
    kw = dict(temperature=1.0, top_p=0.95, top_k=64, greedy=True, approx_top_k=True)
    want_e, want_a = jspec.accept_candidates(jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
                                             jax.random.PRNGKey(0), **kw)
    got_e, got_a = tspec.accept_candidates(torch.as_tensor(logits), torch.as_tensor(drafts),
                                           None, **kw)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert got_a.tolist() == [0, 1, 2, 3, 4, 4]


def test_sampled_acceptance_follows_the_filtered_distribution():
    """With a point-mass drafter, P(tok = d) = p̃(d) and P(tok = v != d) =
    (1 - p̃(d))·p̃(v)/(1 - p̃(d)) = p̃(v): the rule's induced marginal is
    enumerated from the port's own tensors for every draft (the argument of
    JAX's test_rejection_sampling_exact_small_vocab_enumeration), then
    `accept_candidates` is run on 20000 rows with one generator and the
    frequency of its first emitted token held to p̃ within 0.02 per entry
    (the standard deviation of a frequency of 20000 draws is at most
    0.0036)."""
    V, k, n = 8, 2, 20000
    logits = torch.as_tensor(np.random.default_rng(0).normal(size=(1, k + 1, V)) * 2.0,
                             dtype=torch.float32)
    sp = dict(temperature=0.8, top_p=0.9, top_k=V, approx_top_k=False)
    filt = ts.filtered_logits_full(logits, sp["temperature"], sp["top_p"], sp["top_k"],
                                   sp["approx_top_k"])
    target = torch.softmax(filt, -1)[0, 0].numpy()
    jtarget = np.asarray(jax.nn.softmax(js.filtered_logits_full(
        jnp.asarray(logits.numpy()), 0.8, 0.9, V, False), axis=-1))[0, 0]
    np.testing.assert_allclose(target, jtarget, atol=1e-6)
    for d0 in range(V):
        p_d = target[d0]
        masked = filt[0, 0].clone()
        masked[d0] = -float("inf")
        res = torch.softmax(masked, -1).nan_to_num(0.0).numpy()
        induced = (1.0 - p_d) * res
        induced[d0] += p_d
        np.testing.assert_allclose(induced, target, atol=1e-6)
    for d0 in (int(target.argmax()), int(np.flatnonzero(target > 0)[-1])):
        drafts = torch.tensor([[d0, (d0 + 3) % V]]).expand(n, k)
        emitted, _ = tspec.accept_candidates(logits.expand(n, k + 1, V), drafts,
                                             torch.Generator().manual_seed(d0),
                                             greedy=False, **sp)
        freq = np.bincount(emitted[:, 0].numpy(), minlength=V) / n
        assert (freq[target == 0] == 0).all()
        np.testing.assert_allclose(freq, target, atol=0.02)


# --------------------------------------------------------------------- #
# the model's verify forward
# --------------------------------------------------------------------- #

def _verify_inputs(layout):
    ids = left_pad([[5, 6, 7], [9, 10, 11, 12], [13, 14]], 4, PAD)
    B, Tp, K1, T = 3, 4, 4, 14
    mask = ids != PAD
    n_gen = np.asarray([1, 3, 2])               # rows at different depths
    fill = (Tp + n_gen - 1).astype(np.int32)
    plen = mask.sum(1)
    key_mask = np.zeros((B, T), bool)
    key_mask[:, :Tp] = mask
    for b in range(B):
        key_mask[b, Tp:fill[b]] = True
    cand = np.asarray([[20, 21, 22, 23], [30, 31, 32, 33], [40, 41, 42, 43]], np.int32)
    pos = (plen + n_gen - 1)[:, None] + np.arange(K1)[None, :]
    return ids, mask, T, fill, key_mask, cand, pos.astype(np.int32)


@pytest.mark.parametrize("layout", ["contiguous", "paged", "int8"])
def test_decode_verify_matches_jax(tiny, layout):
    """Prefill, then the earlier generated tokens written by a per-row
    verify, then `decode_verify` over 4 candidates at per-row fills: the
    logits and every cache slot written, against JAX's."""
    jcfg, jparams, cfg, tparams = tiny
    if layout == "int8":
        jcfg = dataclasses.replace(jcfg, kv_cache_quant="int8")
        cfg = dataclasses.replace(cfg, kv_cache_quant="int8")
    ids, mask, T, fill, key_mask, cand, pos = _verify_inputs(layout)
    B, P = 3, 4
    nb = -(-T // P)
    if layout == "paged":
        jcache = jm.init_paged_kv_cache(jcfg, B * nb, P, jnp.float32)
        tcache = tm.init_paged_kv_cache(cfg, B * nb, P, torch.float32, "cpu")
        jkw = dict(page_table=jax_full_table(B, nb), page_size=P)
        tkw = dict(page_table=torch.as_tensor(full_table(B, nb)), page_size=P)
        jpre, tpre = dict(jkw, logical_len=T), dict(tkw, logical_len=T)
    else:
        jcache = jm.init_kv_cache(jcfg, B, T, jnp.float32)
        tcache = tm.init_kv_cache(cfg, B, T, torch.float32, "cpu")
        jkw = tkw = jpre = tpre = {}
    _, jcache = jm.prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), jcache,
                           lora_scale=LORA.scale, **jpre)
    tm.prefill(tparams, cfg, torch.as_tensor(ids).long(), torch.as_tensor(mask), tcache,
               lora_scale=LORA.scale, **tpre)
    # the rows' earlier tokens (slots Tp .. fill - 1) through a first verify
    # at fill 4 that writes without logits
    fill0 = np.full(3, 4, np.int32)
    km0 = np.zeros_like(key_mask)
    km0[:, :4] = mask
    prev = cand + 50
    pos0 = (mask.sum(1)[:, None] + np.arange(4)[None, :]).astype(np.int32)
    _, jcache = jm.decode_verify(jparams, jcfg, jnp.asarray(prev), jnp.asarray(pos0),
                                 jnp.asarray(fill0), jnp.asarray(km0), jcache,
                                 lora_scale=LORA.scale, want_logits=False, **jkw)
    none, _ = tm.decode_verify(tparams, cfg, torch.as_tensor(prev).long(),
                               torch.as_tensor(pos0).long(), torch.as_tensor(fill0),
                               torch.as_tensor(km0), tcache, lora_scale=LORA.scale,
                               want_logits=False, **tkw)
    assert none is None
    jl, jcache = jm.decode_verify(jparams, jcfg, jnp.asarray(cand), jnp.asarray(pos),
                                  jnp.asarray(fill), jnp.asarray(key_mask), jcache,
                                  lora_scale=LORA.scale, **jkw)
    tl, tcache = tm.decode_verify(tparams, cfg, torch.as_tensor(cand).long(),
                                  torch.as_tensor(pos).long(), torch.as_tensor(fill),
                                  torch.as_tensor(key_mask), tcache,
                                  lora_scale=LORA.scale, **tkw)
    assert tl.shape == (3, 4, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    # every written slot: the prompt, the earlier tokens, the candidates
    for jc, tc in zip(jcache, tcache):
        jc, tc = np.asarray(jc, np.float32), tc.float().numpy()
        if layout == "int8" and jc.ndim == tc.ndim + 1:
            jc = jc[:, :, :, 0]                # JAX's [.., 8, T] scales
        for b in range(3):
            for t in range(fill[b] + 4):
                if layout == "paged":
                    page, off = b * nb + t // P, t % P
                    got, want = tc[:, page, :, off], jc[:, page, :, off]
                else:
                    got, want = tc[:, b, :, t], jc[:, b, :, t]
                np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                           err_msg=f"row {b} slot {t}")


def test_decode_verify_matches_decode_step_chain(tiny):
    """`decode_verify` over 4 candidates equals 4 chained `decode_step`s in
    the logits and in the cache. The tolerance is 1e-5, not the JAX test's
    1e-6: the K/V projections of 4 rows through one GEMM round differently
    in f32 from 1 row at a time (JAX's own test of this measures 5.7e-6 on
    18 of 1536 cache elements, relative 3.8e-6)."""
    jcfg, jparams, cfg, tparams = tiny
    ids = torch.as_tensor(left_pad([[5, 6, 7], [9, 10, 11]], 4, PAD)).long()
    mask = ids != PAD
    B, Tp, K1, T = 2, 4, 4, 12
    caches0 = tm.init_kv_cache(cfg, B, T, torch.float32, "cpu")
    tm.prefill(tparams, cfg, ids, mask, caches0, lora_scale=LORA.scale)
    cand = torch.tensor([[20, 21, 22, 23], [30, 31, 32, 33]])
    plen = mask.sum(1)
    chain = tuple(c.clone() for c in caches0)
    key_mask = torch.zeros((B, T), dtype=torch.bool)
    key_mask[:, :Tp] = mask
    step_logits = []
    for i in range(K1):
        key_mask[:, Tp + i] = True
        lg, _ = tm.decode_step(tparams, cfg, cand[:, i], plen + i, Tp + i, key_mask,
                               chain, lora_scale=LORA.scale)
        step_logits.append(lg)
    key_mask0 = torch.zeros((B, T), dtype=torch.bool)
    key_mask0[:, :Tp] = mask
    vl, vc = tm.decode_verify(tparams, cfg, cand, plen[:, None] + torch.arange(K1)[None],
                              torch.full((B,), Tp), key_mask0, caches0,
                              lora_scale=LORA.scale)
    for i in range(K1):
        np.testing.assert_allclose(vl[:, i].numpy(), step_logits[i].numpy(), atol=ATOL,
                                   rtol=0, err_msg=f"position {i}")
    for a, b in zip(vc, chain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


# --------------------------------------------------------------------- #
# greedy streams and statistics against JAX and the monolithic loop
# --------------------------------------------------------------------- #

STREAM_CASES = {
    # name: (spec_k, sampling knobs)
    "contiguous_k3": (3, {}),
    "paged_p5_k2_capture": (2, dict(page_size=5, capture_logprobs=True)),
    "fanout_n2_k3": (3, dict(n=2)),
    "int8_k4": (4, dict(kv_cache_quant="int8")),
    "queued_p4_r2_k3": (3, dict(page_size=4, decode_rows=2, capture_logprobs=True)),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_greedy_spec_streams_equal_jax_and_monolithic(tiny, case):
    jcfg, jparams, cfg, tparams = tiny
    k, knobs = STREAM_CASES[case]
    knobs = dict(knobs)
    if knobs.pop("kv_cache_quant", None):
        jcfg = dataclasses.replace(jcfg, kv_cache_quant="int8")
        cfg = dataclasses.replace(cfg, kv_cache_quant="int8")
    ids = _prompts((5, 8, 3), 8)
    sp = dict(greedy=True, max_tokens=12, **knobs)
    spec, st = _port(tparams, cfg, ids, spec_k=k, **sp)
    mono, _ = _port(tparams, cfg, ids, **sp)
    want, jst = _jax(jparams, jcfg, ids, spec_k=k, **sp)
    capture = sp.get("capture_logprobs", False)
    toks = spec[0] if capture else spec
    assert torch.equal(toks, mono[0] if capture else mono)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want[0] if capture else want))
    if capture:
        np.testing.assert_allclose(spec[1].numpy(), np.asarray(want[1]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(spec[1].numpy(), mono[1].numpy(), atol=ATOL, rtol=0)
    assert _stats(st) == _stats(jst)
    assert st["emitted"] >= st["verify_steps"] or "decode_rows" in knobs
    assert _build.launch_counts() == {n: 0 for n in _build.KERNELS}


def test_mixed_accept_lengths_keep_per_row_bookkeeping():
    """Rows accepting at different rates (a cycling row, a constant row, a
    row with no early match): after every iteration each row's key_mask is
    the contiguous [Tp - plen, Tp + n_gen - 1) and its output is pad past
    n_gen — and the state equals JAX's carry."""
    sigma = list(range(16))
    sigma[5], sigma[6], sigma[7], sigma[8] = 6, 7, 8, 5
    jcfg, jparams, cfg, tparams = _cycle(sigma)
    ids = left_pad([[5, 6, 7, 8, 5], [9, 9, 9], [1, 2, 4, 10, 12]], 6, PAD)
    mask = ids != PAD
    Tp, max_tokens, k = 6, 20, 3
    common = dict(max_tokens=max_tokens, eos_token_id=EOS, temperature=1.0, top_p=0.95,
                  greedy=True, lora_scale=1.0, top_k=64, capture_logprobs=False,
                  approx_top_k=True)
    jstate = jspec._spec_state(js._prefill_state(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0),
        pad_token_id=PAD, cache_extra=k, **common))
    tids = torch.as_tensor(ids).long()
    state = tspec._spec_state(ts._prefill_state(
        tparams, cfg, tids, torch.as_tensor(mask), torch.Generator(), pad_token_id=PAD,
        cache_extra=k, **common))
    plen = mask.sum(1)
    rates = []
    for _ in range(4):
        jd = jspec._draft_fn(jnp.asarray(ids), jstate, Tp=Tp, spec_k=k, spec_ngram=2,
                             pad_token_id=PAD)
        jstate = jspec._verify_fn(jparams, jcfg, jstate, jd, Tp=Tp, pad_token_id=PAD,
                                  spec_k=k, **common)
        drafts = tspec._draft_fn(tids, state, Tp=Tp, spec_k=k, spec_ngram=2,
                                 pad_token_id=PAD)
        np.testing.assert_array_equal(drafts.numpy(), np.asarray(jd))
        prev = state["n_gen"].clone()
        tspec._verify_fn(tparams, cfg, state, drafts, Tp=Tp, spec_k=k,
                         generator=None, **common)
        n_gen = state["n_gen"].numpy()
        rates.append(n_gen - prev.numpy())
        for b in range(3):
            want = np.zeros(state["key_mask"].shape[1], bool)
            want[Tp - plen[b]:Tp + n_gen[b] - 1] = True
            np.testing.assert_array_equal(state["key_mask"][b].numpy(), want)
            assert (state["out"][b, n_gen[b]:] == PAD).all()
        for i, name in ((1, "out"), (4, "key_mask"), (5, "done"), (6, "cur_tok"),
                        (7, "n_gen"), (14, "row_acc")):
            np.testing.assert_array_equal(state[name].numpy(), np.asarray(jstate[i]), name)
    rates = np.stack(rates)
    assert rates.max() > 1 and any(len(set(r.tolist())) > 1 for r in rates)


def test_eos_inside_an_accepted_draft_ends_the_row():
    """The prompt seeds an n-gram whose continuation runs THROUGH EOS: the
    draft [EOS, 9, ..] is accepted up to the EOS and the row stops there."""
    sigma = list(range(16))
    sigma[5], sigma[6], sigma[7] = 6, 7, EOS
    sigma[EOS] = 11
    jcfg, jparams, cfg, tparams = _cycle(sigma)
    ids = left_pad([[9, 6, 7, EOS, 9, 5, 6]], 8, PAD)
    sp = dict(greedy=True, max_tokens=16)
    spec, st = _port(tparams, cfg, ids, lora_scale=1.0, spec_k=3, spec_ngram=2, **sp)
    mono, _ = _port(tparams, cfg, ids, lora_scale=1.0, **sp)
    row = spec[0].numpy()
    assert row[:2].tolist() == [7, EOS] and (row[2:] == PAD).all()
    assert torch.equal(spec, mono)
    # the drafted EOS was accepted (acc 1), but the emission ends at it: the
    # accepted count is the drafts emitted before the row's last token, 0
    assert st["verify_steps"] == 1
    _, jst = _jax(jparams, jcfg, ids, lora_scale=1.0, spec_k=3, spec_ngram=2, **sp)
    assert _stats(st) == _stats(jst)


def test_repetitive_cycle_accepts_and_halves_the_verify_forwards():
    sigma = list(range(16))
    sigma[5], sigma[6], sigma[7], sigma[8] = 6, 7, 8, 5
    jcfg, jparams, cfg, tparams = _cycle(sigma)
    ids = left_pad([[5, 6, 7, 8, 5]], 6, PAD)
    sp = dict(greedy=True, max_tokens=48)
    spec, st = _port(tparams, cfg, ids, lora_scale=1.0, spec_k=4, **sp)
    mono, _ = _port(tparams, cfg, ids, lora_scale=1.0, **sp)
    assert torch.equal(spec, mono)
    assert mono[0, :8].tolist() == [6, 7, 8, 5, 6, 7, 8, 5]
    assert st["verify_steps"] * 2 <= 48
    assert int(st["accepted"]) / max(int(st["drafted"]), 1) > 0.5
    _, jst = _jax(jparams, jcfg, ids, lora_scale=1.0, spec_k=4, **sp)
    assert _stats(st) == _stats(jst)


def test_sampled_spec_keeps_the_contract_and_scores_like_a_rescore(tiny):
    """Sampled spec with logprob capture (tiny model, mixed accept lengths):
    the captured logprobs equal a rescoring forward of the emitted tokens
    at every position — a wrong cache slot or key_mask bit would shift some
    position's distribution — and the queued sampled route keeps the output
    contract."""
    from nanorlhf_tpu_torch.ops.masking import logprobs_from_logits

    jcfg, jparams, cfg, tparams = tiny
    ids = _prompts((3, 4), 5, seed=4)
    temp = 0.9
    for knobs in ({}, dict(page_size=4, decode_rows=1)):
        (out, lp), st = _port(tparams, cfg, ids, seed=11, spec_k=3, max_tokens=10,
                              temperature=temp, capture_logprobs=True, **knobs)
        qr = torch.cat([torch.as_tensor(ids).long(), out], 1)
        logits = tm.padded_forward_logits(tparams, cfg, qr, PAD, lora_scale=LORA.scale,
                                          response_context_length=ids.shape[1])
        scored = logprobs_from_logits(logits, out, temp)
        for b in range(out.shape[0]):
            hits = (out[b] == EOS).nonzero()
            end = int(hits[0]) + 1 if len(hits) else out.shape[1]
            np.testing.assert_allclose(lp[b, :end].numpy(), scored[b, :end].numpy(),
                                       atol=1e-4, rtol=0)
            assert (out[b, end:] == PAD).all()
        assert int(st["emitted"]) >= int(st["row_steps"])


def test_spec_with_compaction_raises_and_tracer_is_not_ported(tiny):
    """Spec decode with compaction raises. An enabled tracer, which raised
    until the telemetry planes were ported, now runs the traced loop: its
    greedy tokens and stats equal the compiled loop's, with one
    draft/verify span pair per verify step."""
    from nanorlhf_tpu_torch.telemetry import SpanTracer

    jcfg, jparams, cfg, tparams = tiny
    ids = _prompts((3,), 3)
    with pytest.raises(ValueError, match="compaction"):
        _port(tparams, cfg, ids, spec_k=2, compaction_segments=2)

    ids = _prompts((3, 6, 2), 6)
    args = (tparams, cfg, torch.as_tensor(ids).long(), torch.as_tensor(ids != PAD))
    kw = dict(max_tokens=9, eos_token_id=EOS, pad_token_id=PAD, spec_k=2,
              greedy=True, lora_scale=LORA.scale)
    tracer = SpanTracer(enabled=True)
    traced_stats, plain_stats = [], []
    traced = tspec.generate_spec(*args, torch.Generator(), tracer=tracer,
                                 spec_stats_out=traced_stats, **kw)
    plain = tspec.generate_spec(*args, torch.Generator(),
                                spec_stats_out=plain_stats, **kw)
    assert torch.equal(traced, plain)
    assert _stats(traced_stats[0]) == _stats(plain_stats[0])
    spans = [e for e in tracer.trace_events() if e["ph"] == "X"]
    steps = plain_stats[0]["verify_steps"]
    assert steps > 0
    assert [e["name"] for e in spans] == ["rollout.draft", "rollout.verify"] * steps
    assert [e["args"]["iteration"] for e in spans[1::2]] == list(range(steps))


# --------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------- #

def test_grpo_update_with_spec_decode_logs_the_acceptance_rows(tmp_path):
    from nanorlhf_tpu_torch.entrypoints import common
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut

    cfg = one_card_cut(build_config(rollout_spec_k=3))
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path / "run")
    cfg.response_length = 8
    cfg.per_device_train_batch_size = 2
    cfg.total_episodes = 32
    cfg.lora_r, cfg.lora_alpha = 4, 8
    state = common.run(cfg, device="cpu", num_updates=1)
    assert state["global_step"] == 1 and state["opt_steps"] >= 1
    rows = [json.loads(line) for line in open(os.path.join(cfg.output_dir, "metrics.jsonl"))]
    assert len(rows) == 1
    row = rows[0]
    for key in ("rollout/draft_acceptance", "rollout/accepted_per_step",
                "rollout/spec_verify_steps"):
        assert np.isfinite(row[key]), key
    assert 0.0 <= row["rollout/draft_acceptance"] <= 1.0
    assert row["rollout/accepted_per_step"] >= 1.0
    assert 1.0 <= row["rollout/spec_verify_steps"] <= cfg.response_length
    assert np.isfinite(row["loss/policy_avg_new"])
