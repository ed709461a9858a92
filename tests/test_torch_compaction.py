"""Compacting decode (`sampler/compaction.py`) against the JAX package's on
the tiny f32 model: greedy streams identical to JAX's compaction and to the
port's monolithic loop (exact, contiguous and int8 caches, with the prompt
fan-out), the sampled contract and its streams before the first compaction,
captured logprobs, and GRPO updates through the trainer with
`rollout_compaction_segments`. The EOS id is chosen from a first greedy run
so rows end at spread steps and the batch really compacts."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LORA, jax_config, make_params, port_config
from nanorlhf_tpu.sampler import sampler as js
from nanorlhf_tpu_torch.sampler import compaction as tc
from nanorlhf_tpu_torch.sampler import sampler as ts

torch.set_num_threads(1)

PAD = 0
ROWS, TP, MAX = 16, 6, 24


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("qwen_tied")
    jparams, tparams = make_params(jcfg, seed=0)
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 128, (ROWS, TP)).astype(np.int32)
    ids[:, 0] = PAD  # a little left-padding
    ids[3, :3] = PAD
    return jcfg, jparams, port_config(jcfg), tparams, ids


def _port(tiny, ids, eos, cfg=None, generator=None, stats=None, **sp):
    _, _, pcfg, tparams, _ = tiny
    return ts.generate(tparams, cfg or pcfg, torch.as_tensor(ids).long(),
                       torch.as_tensor(ids != PAD), generator or torch.Generator(),
                       ts.SamplingParams(**sp), eos_token_id=eos, pad_token_id=PAD,
                       lora_scale=LORA.scale, compaction_stats_out=stats)


def _jax(tiny, ids, eos, jcfg=None, **sp):
    j, jparams, _, _, _ = tiny
    return np.asarray(js.generate(jparams, jcfg or j, jnp.asarray(ids),
                                  jnp.asarray(ids != PAD), jax.random.PRNGKey(2),
                                  js.SamplingParams(**sp), eos_token_id=eos,
                                  pad_token_id=PAD, lora_scale=LORA.scale))


def _spread_eos(tokens: np.ndarray) -> int:
    """A token many rows emit, at the most spread first positions: rows then
    finish at varied steps (the chip phase's planted EOS, on the CPU)."""
    firsts = collections.defaultdict(dict)
    for r, row in enumerate(tokens):
        for t, tok in enumerate(row.tolist()):
            firsts[tok].setdefault(r, t)
    return max(firsts, key=lambda tok: (len(set(firsts[tok].values())), len(firsts[tok])))


@pytest.fixture(scope="module")
def eos(tiny):
    return _spread_eos(_port(tiny, tiny[4], eos=-1, greedy=True, max_tokens=MAX).numpy())


@pytest.mark.parametrize("n,sync_every", [(1, 8), (1, 3), (2, 8)])
def test_greedy_compaction_matches_jax_and_monolithic(tiny, eos, n, sync_every):
    ids = tiny[4] if n == 1 else tiny[4][:8]
    stats: list = []
    got = _port(tiny, ids, eos, stats=stats, greedy=True, max_tokens=MAX, n=n,
                compaction_segments=6, sync_every=sync_every).numpy()
    mono = _port(tiny, ids, eos, greedy=True, max_tokens=MAX, n=n).numpy()
    want = _jax(tiny, ids, eos, greedy=True, max_tokens=MAX, n=n, compaction_segments=6)
    np.testing.assert_array_equal(got, mono)
    np.testing.assert_array_equal(got, want)
    menu = stats[0]["menu"]
    assert stats[0]["compactions"] >= 1, menu
    assert [m[0] for m in menu][0] == ROWS and all(m[0] >= tc._MIN_BATCH for m in menu)
    sizes = [m[0] for m in menu]
    assert sizes == sorted(sizes, reverse=True) and len(set(sizes)) == len(sizes)
    assert sum(m[1] for m in menu) == (got != PAD).sum(1).max() - 1


def test_compaction_with_int8_kv_cache(tiny, eos):
    """The int8 cache's four tensors (values and scales, batch on axis 1)
    move with their rows: greedy compacted == monolithic int8 == JAX's."""
    jcfg, _, pcfg, _, ids = tiny
    q8, jq8 = (dataclasses.replace(c, kv_cache_quant="int8") for c in (pcfg, jcfg))
    stats: list = []
    got = _port(tiny, ids, eos, cfg=q8, stats=stats, greedy=True, max_tokens=MAX,
                compaction_segments=6).numpy()
    mono = _port(tiny, ids, eos, cfg=q8, greedy=True, max_tokens=MAX).numpy()
    want = _jax(tiny, ids, eos, jcfg=jq8, greedy=True, max_tokens=MAX,
                compaction_segments=6)
    np.testing.assert_array_equal(got, mono)
    np.testing.assert_array_equal(got, want)
    assert stats[0]["compactions"] >= 1


def test_sampled_compaction_contract(tiny):
    """Sampled: the right-padded contract holds (EOS ends a row, pads
    after), tokens in vocab; the streams equal the monolithic loop's through
    the first segment (same generator, same batch shape); after it they
    differ in bits, not in distribution (a chunk's predicated-off tail past
    the segment's end draws too, and a gather reshapes the draws). The EOS
    is the token most rows of a monolithic sampled run emit before 3/4 of
    the budget, so the batch compacts."""
    ids, max_tokens, segments = tiny[4], 64, 8
    sp = dict(temperature=1.0, top_p=0.95, max_tokens=max_tokens)
    mono = _port(tiny, ids, -1, generator=torch.Generator().manual_seed(1), **sp).numpy()
    firsts = collections.defaultdict(set)
    for r, row in enumerate(mono):
        for tok in set(row[:max_tokens * 3 // 4].tolist()):
            firsts[tok].add(r)
    eos = max(firsts, key=lambda tok: len(firsts[tok]))
    stats: list = []
    got = _port(tiny, ids, eos, generator=torch.Generator().manual_seed(1), stats=stats,
                compaction_segments=segments, **sp).numpy()
    mono = _port(tiny, ids, eos, generator=torch.Generator().manual_seed(1), **sp).numpy()
    assert got.shape == (ROWS, max_tokens)
    for row in got:
        hits = np.where(row == eos)[0]
        if len(hits):
            assert (row[hits[0] + 1:] == PAD).all()
        assert (row >= 0).all() and (row < 128).all()
    assert stats[0]["compactions"] >= 1
    first = -(-max_tokens // segments) + 1  # the prefill's token and the first segment's
    np.testing.assert_array_equal(got[:, :first], mono[:, :first])


def test_capture_logprobs_with_compaction(tiny, eos):
    """Captured logprobs ride the gather: greedy compacted (tokens,
    logprobs) equal the monolithic loop's; live logprobs finite, <= 0."""
    ids = tiny[4]
    sp = dict(greedy=True, max_tokens=16, capture_logprobs=True)
    out, lp = _port(tiny, ids, eos, compaction_segments=4, **sp)
    mono_out, mono_lp = _port(tiny, ids, eos, **sp)
    assert lp.shape == out.shape and lp.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), mono_out.numpy())
    np.testing.assert_allclose(lp.numpy(), mono_lp.numpy(), rtol=0, atol=1e-5)
    live = out.numpy() != PAD
    assert np.isfinite(lp.numpy()[live]).all() and (lp.numpy()[live] <= 0).all()


def test_batch_sharding_waits_for_a14b(tiny, eos, tmp_path_factory):
    """The per-rank carry (`batch_sharding=mesh`, data = 2 on spawned gloo
    ranks): each rank compacts its own block of 32 greedy rows (16 a rank,
    JAX's smallest menu term 1 a rank, so `_MIN_BATCH`) and the gathered
    rows equal the one-rank compacting run's and JAX's, on every rank."""
    import _torch_mesh_ranks as M
    import _torch_sp_ranks as R
    from nanorlhf_tpu_torch.bridge import params_to_numpy

    _, _, pcfg, tparams, ids = tiny
    ids = np.concatenate([ids, ids[::-1]])
    arg = {"axes": (2, 1, 1, 1), "cfg": dataclasses.asdict(pcfg),
           "tree": params_to_numpy(tparams), "ids": ids, "pad": PAD, "eos": eos,
           "max_tokens": MAX, "segments": 6, "lora_scale": LORA.scale}
    ranks = R.shared_spawn(tmp_path_factory, "compaction_carry", M.run_cases, 2,
                           ([("compaction", arg)],))
    stats: list = []
    one = _port(tiny, ids, eos, stats=stats, greedy=True, max_tokens=MAX,
                compaction_segments=6).numpy()
    want = _jax(tiny, ids, eos, greedy=True, max_tokens=MAX, compaction_segments=6)
    np.testing.assert_array_equal(one, want)
    for (got,) in ranks:
        np.testing.assert_array_equal(got["out"], one)
        sizes = [m[0] for m in got["menu"]]
        assert sizes[0] == ROWS and len(sizes) >= 2, got["menu"]
        assert all(b >= tc._MIN_BATCH for b in sizes)


def _planted_eos(tokens: np.ndarray, pad: int, max_tokens: int, segments: int):
    """(eos, menu): the token under which the rows of a monolithic run
    would compact the batch most often (`predicted_menu`), then the one
    most rows emit."""
    firsts = collections.defaultdict(dict)
    for r, row in enumerate(tokens.tolist()):
        for t, tok in enumerate(row):
            if tok != pad:
                firsts[tok].setdefault(r, t)

    def menu(tok):
        return tc.predicted_menu([firsts[tok].get(r) for r in range(len(tokens))],
                                 max_tokens, segments)

    eos = max(firsts, key=lambda tok: (len(menu(tok)), len(firsts[tok])))
    return eos, menu(eos)


@pytest.mark.parametrize("segments", [3, 6])
def test_predicted_menu_matches_the_loop(tiny, eos, segments):
    """`predicted_menu` (the rule the chip phase plants its EOS by) gives
    the greedy loop's menu from the monolithic rows' EOS columns."""
    ids = tiny[4]
    mono = _port(tiny, ids, eos, greedy=True, max_tokens=MAX).numpy()
    ends = [int(np.argmax(row == eos)) if (row == eos).any() else None for row in mono]
    stats: list = []
    _port(tiny, ids, eos, stats=stats, greedy=True, max_tokens=MAX,
          compaction_segments=segments)
    assert [m[0] for m in stats[0]["menu"]] == tc.predicted_menu(ends, MAX, segments)
    assert stats[0]["compactions"] >= 1


def test_trainer_compaction_updates(tmp_path):
    """Two GRPO updates through `common.build_trainer` with compacting
    decode (JAX's trainer smoke), the first rollout compacting: its batch
    is three copies of one prompt and one of another, sampled at
    temperature 1e-3 (at the launcher's 0.9, or at 0.05, the tiny random
    model's rows share no token), and its EOS is planted from a monolithic run of the
    same batch from the same generator state, whose first compaction the
    loop must meet exactly (the draws are the same until it). So the
    trainer's rollout goes through the gather, the owner flush and menu
    padding; every metric row is finite."""
    import json

    from nanorlhf_tpu_torch.entrypoints import common
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config
    from nanorlhf_tpu_torch.trainer import rollout as trollout

    cfg = build_config()
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path)
    cfg.response_length = 16
    cfg.per_device_train_batch_size, cfg.gradient_accumulation_steps = 4, 1
    cfg.num_mini_batches, cfg.total_episodes = 1, 8
    cfg.save_steps, cfg.load_best_model_at_end = 0, False
    cfg.rollout_compaction_segments = 4
    cfg.temperature = 1e-3
    tr = common.build_trainer(cfg, device="cpu")
    rows = tr.dataset.input_ids
    other = next(r for r in rows[1:] if not np.array_equal(r, rows[0]))
    tr.dataset.input_ids = np.stack([rows[0]] * 3 + [other])
    tr._reset_data_iterator()
    planted, seen = {}, []
    real = trollout.generate

    def planting(params, mcfg, ids, mask, generator, sp, **kw):
        if not planted:
            g = torch.Generator(device=generator.device)
            g.set_state(generator.get_state())
            mono = real(params, mcfg, ids, mask, g,
                        dataclasses.replace(sp, compaction_segments=0), eos_token_id=-1,
                        pad_token_id=kw["pad_token_id"], lora_scale=kw["lora_scale"])
            planted["eos"], planted["menu"] = _planted_eos(
                mono.numpy(), kw["pad_token_id"], sp.max_tokens, sp.compaction_segments)
            tr.tokenizer.eos_token_id = planted["eos"]
        out = real(params, mcfg, ids, mask, generator, sp,
                   **{**kw, "eos_token_id": planted["eos"]})
        seen.append(kw["compaction_stats_out"][-1])
        return out

    trollout.generate = planting
    try:
        state = tr.train(num_updates=2)
    finally:
        trollout.generate = real
        tr.close()
    assert state["global_step"] == 2 and len(seen) == 2
    assert len(planted["menu"]) >= 2 and seen[0]["compactions"] >= 1
    # 12 rows of the first prompt end, 4 live rows take a batch of 8
    assert [m[0] for m in seen[0]["menu"]][:2] == planted["menu"][:2] == [16, 8]
    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")
            if "loss/policy_avg_new" in l]
    assert len(rows) == 2
    assert all(np.isfinite(r["loss/policy_avg_new"]) for r in rows)
