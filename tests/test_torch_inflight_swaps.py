"""In-flight weight swaps in the port (`sampler/paged/scheduler.py`,
`sampler/paged/session.py`, `envs/rollout.py`, the weight store's swap
refresh) against the JAX package's (`tests/test_inflight_swaps.py`'s
counterparts):

- JAX's unit tests of `_finalize_segments` and `make_swap_refresh` (the
  base install, monotone versions, the `swap.stale` delay) on the port's
  copies; the per-segment IS weights and losses against JAX's (a single
  segment is the whole-sequence weight bit for bit, two segments clamp
  tighter);
- the queued scheduler: two forced mid-decode installs leave the greedy
  stream unchanged and stamp segments that tile every row's generation
  with strictly increasing versions; an install of OTHER weights changes
  what the following chunks emit exactly as a per-step loop that installs
  the same tree at the same step (the witness `chip_smoke.py` phase 17 (b)
  repeats on the card);
- the install never rebinds the session's parameters: a stand-in graph
  that holds the tensors it captured fails the moment a swap replaces
  them — a CPU run cannot see the card's captured addresses, this can;
- the episode driver: a silent poll is bit-identical, a publish after
  turn 1 stamps a second segment at the re-admission boundary;
- the trainer: swaps on at staleness 0 equal swaps off over both
  transports; at staleness 1 the update takes `segment_ages`; JAX's
  ValueErrors on the knob, with its messages.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_counterparts import run_jax_test
from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from nanorlhf_tpu.algos import losses as jlosses
from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
from nanorlhf_tpu_torch.algos import losses as tlosses
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.sampler import sampler as ts
from nanorlhf_tpu_torch.sampler.paged import session as tsession
from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession
from nanorlhf_tpu_torch.trainer.optim import flatten
from test_torch_decode_graph import EOS, PAD, _prompts, _StandInGraph, chain, tiny  # noqa: F401
from test_torch_orchestrator import assert_same_run, cfg_for, run_trainer
from test_trainer_smoke import make_trainer

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["test_finalize_segments_tiles_and_drops_empty",
                                  "test_swap_refresh_base_install_and_monotone_versions",
                                  "test_swap_stale_fault_delays_but_keeps_versions_increasing"])
def test_jax_units_hold_on_the_port(name, monkeypatch):
    swapped = run_jax_test(monkeypatch, "test_inflight_swaps", name, {})
    assert {"_finalize_segments", "make_swap_refresh", "store_poll",
            "VersionedWeightStore", "FaultInjector"} <= set(swapped)


# ---------------------------------------------------------------------------
# per-segment IS
# ---------------------------------------------------------------------------

def _lp(seed=3, B=4, T=9):
    rng = np.random.default_rng(seed)
    new = (rng.standard_normal((B, T)) * 0.3 - 2).astype(np.float32)
    old = (new + rng.standard_normal((B, T)) * 0.2).astype(np.float32)
    beh = (old + rng.standard_normal((B, T)) * 0.9).astype(np.float32)
    ref = (new + rng.standard_normal((B, T)) * 0.1).astype(np.float32)
    adv = rng.standard_normal((B, T)).astype(np.float32)
    mask = rng.random((B, T)) > 0.2
    return new, old, beh, ref, adv, mask


def _losses(mod, cast, new, old, beh, ref, adv, mask, ages):
    kw = dict(behavior_logprobs=cast(beh), is_truncation=2.0,
              segment_ages=None if ages is None else cast(ages))
    n, o, r, a, m = map(cast, (new, old, ref, adv, mask))
    return [mod.ppo_clip_loss_token(n, o, a, m, 0.2, **kw),
            mod.grpo_loss(n, o, r, a, m, 0.2, 0.05, **kw),
            mod.ppo_clip_loss_sequence(n, o, a[:, 0], m, 0.2, **kw)]


def test_single_segment_losses_bitexact():
    """Zero ages (no swap landed) through every loss that takes them: loss
    and aux identical to the whole-sequence weights, to the bit."""
    arrays = _lp()
    zeros = np.zeros(arrays[0].shape, np.int32)
    for (l0, a0), (l1, a1) in zip(_losses(tlosses, torch.as_tensor, *arrays, None),
                                  _losses(tlosses, torch.as_tensor, *arrays, zeros)):
        assert torch.equal(l0, l1)
        assert all(torch.equal(a0[k], a1[k]) for k in a0)


def test_multi_segment_loss_matches_jax_and_clamps_tighter():
    """A two-segment row: the age-1 segment clamps at ρ̄^(1/2); the port's
    losses equal JAX's at 1e-6 and differ from the whole-sequence ones."""
    arrays = _lp()
    ages = np.zeros(arrays[0].shape, np.int32)
    ages[:, :4] = 1
    w, _ = tlosses.segment_is_weights(torch.full((1, 2), -1.0), torch.full((1, 2), -2.0),
                                      torch.tensor([[0, 1]]), 2.0)
    np.testing.assert_allclose(w.numpy(), [[2.0, 2.0 ** 0.5]], rtol=1e-6)
    port = _losses(tlosses, torch.as_tensor, *arrays, ages)
    ref = _losses(jlosses, jnp.asarray, *arrays, ages)
    whole = _losses(tlosses, torch.as_tensor, *arrays, None)
    for (lp, ap), (lj, aj), (lw, _) in zip(port, ref, whole):
        np.testing.assert_allclose(float(lp), float(lj), rtol=1e-6, atol=1e-6)
        for k in aj:
            np.testing.assert_allclose(float(ap[k]), float(aj[k]), rtol=1e-6, atol=1e-6)
        assert float(lp) != float(lw)


# ---------------------------------------------------------------------------
# the queued scheduler
# ---------------------------------------------------------------------------

def _queued(params, cfg, ids, refresh=None, stats=None, **sp):
    sp = {**dict(greedy=True, max_tokens=24, page_size=4, decode_rows=2, sync_every=3), **sp}
    out = ts.generate(params, cfg, torch.as_tensor(ids).long(), torch.as_tensor(ids != PAD),
                      torch.Generator().manual_seed(0), ts.SamplingParams(**sp),
                      eos_token_id=EOS, pad_token_id=PAD, paged_stats_out=stats,
                      weight_refresh=refresh)
    return out.numpy()


def _chain_ids(starts, T=6):
    rows = [[4, 5, s] for s in starts]
    return np.asarray([[PAD] * (T - len(r)) + r for r in rows], np.int64)


def _own(params):
    return {k: _own(v) if isinstance(v, dict) else v.clone() for k, v in params.items()}


def test_forced_two_swaps_segments_tile_generation(chain):
    """Two forced installs of the same weights mid-decode: the greedy
    stream is unchanged, every queue entry's segments tile [0, n_generated)
    with strictly increasing versions, the long row alive at both installs
    carries 3 segments, and a row admitted after the last install starts
    at the newest version."""
    _, _, cfg, params = chain
    ids = _chain_ids([11, 27, 17, 28])
    calls = {"n": 0, "v": 0}

    def refresh():
        calls["n"] += 1
        if calls["n"] in (2, 3):
            calls["v"] += 1
            return calls["v"], params
        return calls["v"], None

    stats = []
    out = _queued(_own(params), cfg, ids, refresh, stats)
    np.testing.assert_array_equal(out, _queued(params, cfg, ids))
    st = stats[0]
    assert st["swap_installs"] == 2 and st["swap_wait_s"] >= 0.0
    segments = st["segments"]
    for q, segs in enumerate(segments):
        n_gen = int(np.sum(out[q] != PAD))
        assert segs[0]["tok_range"][0] == 0 and segs[-1]["tok_range"][1] == n_gen
        for a, b in zip(segs, segs[1:]):
            assert a["tok_range"][1] == b["tok_range"][0]
            assert b["policy_version"] > a["policy_version"]
    assert [s["policy_version"] for s in segments[0]] == [0, 1, 2]
    assert segments[3] == [{"policy_version": 2,
                            "tok_range": [0, int(np.sum(out[3] != PAD))]}]


def _other(params, scale=1.7):
    """A different tree of the same shapes (the embeddings rescaled)."""
    fresh = copy.deepcopy(params)
    fresh["embed_tokens"] = fresh["embed_tokens"] * scale
    return fresh


def test_a_swap_changes_the_following_chunks_like_a_per_step_install(tiny):
    """Installing OTHER weights at the second host sync changes what the
    later chunks emit — exactly as in a per-step loop that installs the
    same tree at the same step; without the install both equal the plain
    stream."""
    _, _, cfg, params = tiny
    ids = _prompts((5, 6, 4, 3), 6, seed=4)

    def refresh_at(k):
        calls = {"n": 0}

        def refresh():
            calls["n"] += 1
            return (1, _other(params)) if calls["n"] == k else (calls["n"] > k, None)
        return refresh

    base = _queued(params, cfg, ids, max_tokens=12)
    chunked = _queued(_own(params), cfg, ids, refresh_at(2), max_tokens=12)
    per_step = _queued(_own(params), cfg, ids, refresh_at(2), max_tokens=12,
                       decode_loop="per_step")
    np.testing.assert_array_equal(chunked, per_step)
    assert not np.array_equal(chunked, base)
    np.testing.assert_array_equal(chunked[:, :3], base[:, :3])   # before the swap


class _HeldGraph(_StandInGraph):
    """A stand-in capture that holds what a CUDA graph holds: the parameter
    tensors the chunk read at capture. A replay reads THOSE tensors — it
    raises if the session's tree now holds other objects (a rebinding the
    real graph would never see), then runs the chunk."""

    def __init__(self, sess):
        super().__init__()
        self.sess = sess

    def capture(self, fn):
        self.fn = fn
        self.held = {p: t for p, t in flatten(self.sess.params).items()}
        fn()

    def replay(self):
        now = flatten(self.sess.params)
        rebound = [p for p, t in self.held.items() if now[p] is not t]
        if rebound:
            raise RuntimeError(f"replay reads stale captured tensors: {rebound[:3]}")
        super().replay()
        self.fn()


def test_a_swap_never_rebinds_the_captured_parameters(tiny, monkeypatch):
    """After a capture, an install must write into the captured tensors: the
    held-tensor stand-in graph accepts `install_params` (the values change,
    the objects stay) and catches a rebinding (`sess.params = fresh`, JAX's
    install) at the next replay."""
    _, _, cfg, params = tiny
    ids = torch.as_tensor(_prompts((5, 6), 6, seed=2)).long()

    def session():
        sess = DecodeSession(_own(params), cfg, rows=2, prompt_len=6, max_tokens=10,
                             page_size=4, eos_token_id=EOS, pad_token_id=PAD,
                             generator=torch.Generator().manual_seed(0), greedy=True,
                             sync_every=2)
        sess._loop.use_graph = True
        sess._loop.graph_factory = lambda: _HeldGraph(sess)
        sess.bootstrap(ids, ids != PAD)
        sess.step()          # eager warm-up
        sess.step()          # capture + first replay
        return sess

    fresh = _other(params)
    sess = session()
    held = dict(sess._loop.graph.held)
    assert sess.install_params(fresh) == len(flatten(params))
    sess.step()              # replays on the same, now rewritten, tensors
    assert all(flatten(sess.params)[p] is t for p, t in held.items())
    assert torch.equal(sess.params["embed_tokens"], fresh["embed_tokens"])
    sess = session()
    sess.params = fresh      # the rebinding a replayed graph would not see
    with pytest.raises(RuntimeError, match="stale captured tensors"):
        sess.step()


def test_install_refuses_a_tree_that_does_not_fit(tiny):
    _, _, cfg, params = tiny
    live = _own(params)
    bad = _own(params)
    bad["embed_tokens"] = bad["embed_tokens"][:, :2]
    with pytest.raises(ValueError, match="does not fit"):
        tsession.copy_params(live, bad)
    assert tsession.copy_params(live, params) == len(flatten(params))
    same = {k: live[k] for k in live}
    assert tsession.copy_params(live, same) == 0      # its own tensors: nothing


# ---------------------------------------------------------------------------
# the episode driver
# ---------------------------------------------------------------------------

def test_env_driver_silent_poll_bit_identical_and_swap_segments(monkeypatch):
    from test_torch_envs import DRIVER, _driver_prompts, echo_env
    from _torch_parity import jax_config, make_params, port_config
    from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
    from nanorlhf_tpu_torch.envs.rollout import run_env_episodes

    jcfg = jax_config("qwen_tied", vocab_size=256)
    _, params = make_params(jcfg, seed=0, lora=False)
    cfg = port_config(jcfg)

    def run(refresh):
        tok = ToyTokenizer(vocab_size=256)
        ids, mask = _driver_prompts(2, 8)
        env = echo_env()
        env.eos_token = tok.eos_token
        try:
            return run_env_episodes(
                _own(params), cfg, torch.as_tensor(ids), torch.as_tensor(mask),
                torch.Generator().manual_seed(7),
                ts.SamplingParams(max_tokens=DRIVER["turn_tokens"], n=2, greedy=True),
                env, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                tokenizer=tok, weight_refresh=refresh, **DRIVER)
        finally:
            env.close()

    base = run(None)
    silent = run(lambda: (0, None))
    np.testing.assert_array_equal(base["tokens"], silent["tokens"])
    assert silent["swap_installs"] == 0 and all(len(s) == 1 for s in silent["segments"])
    calls = {"n": 0}

    def hot():
        calls["n"] += 1
        return (1, params) if calls["n"] == 2 else (min(calls["n"] - 1, 1), None)

    out = run(hot)
    np.testing.assert_array_equal(base["tokens"], out["tokens"])
    assert out["swap_installs"] == 1
    assert any(len(s) >= 2 for s in out["segments"])
    for segs in out["segments"]:
        for a, b in zip(segs, segs[1:]):
            assert a["tok_range"][1] == b["tok_range"][0]
            assert b["policy_version"] > a["policy_version"]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

PAGED_FLEET = dict(rollout_orchestrator=True, rollout_workers=2, max_staleness=0,
                   rollout_page_size=4, rollout_decode_rows=4)


@pytest.fixture(scope="module")
def paged_fleet(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        return run_trainer(tmp_path_factory.mktemp("swapbase"), mp, updates=2,
                           **PAGED_FLEET)[:2]
    finally:
        mp.undo()


@pytest.mark.parametrize("transport", ["inprocess", "rpc"])
def test_swaps_on_staleness0_bit_identical(transport, paged_fleet, tmp_path, monkeypatch):
    """At staleness 0 no publish can land mid-rollout: every poll returns no
    tree, and the run reproduces the swaps-off run over both transports,
    with the swap rows present, no install and one segment a sample."""
    seen, rows, _ = run_trainer(tmp_path, monkeypatch, updates=2,
                                rollout_transport=transport,
                                rollout_inflight_swaps=True, **PAGED_FLEET)
    assert_same_run(paged_fleet, (seen, rows))
    for row in rows:
        assert row["rollout/swap_installs"] == 0.0
        assert row["rollout/segments_per_sample"] == 1.0


def test_swaps_at_staleness1_feed_segment_ages_to_the_update(tmp_path, monkeypatch):
    """Staleness 1 with capture and truncated IS: mid-rollout publishes
    install, rows carry several segments, and the update's minibatches
    carry `segment_ages` (and `behavior_logprobs`) in every step."""
    from nanorlhf_tpu_torch.orchestrator import weight_store
    from nanorlhf_tpu_torch.trainer import update as tupdate

    # the second rollout (dispatched from version 0 while update 0 runs)
    # holds its first chunk poll until version 1 is published: the install
    # lands mid-rollout by construction, not by thread timing
    made = []
    real_make = weight_store.make_swap_refresh

    def make(poll, *, have_version=None, **kw):
        inner = real_make(poll, have_version=have_version, **kw)
        made.append(have_version)
        if len(made) != 2:
            return inner
        polls = [0]

        def refresh():
            polls[0] += 1
            if polls[0] == 2:
                store = tr_box[0]._orchestrator.store
                store.wait_for_version(have_version + 1, timeout=30)
            return inner()
        return refresh

    monkeypatch.setattr(weight_store, "make_swap_refresh", make)
    keys = []
    real = tupdate.microbatch_loss

    def spy(policy, mcfg, cfg, mb, *a, **k):
        keys.append(set(mb))
        return real(policy, mcfg, cfg, mb, *a, **k)

    monkeypatch.setattr(tupdate, "microbatch_loss", spy)
    kw = dict(rollout_orchestrator=True, max_staleness=1, rollout_page_size=4,
              rollout_decode_rows=4, rollout_inflight_swaps=True,
              sampler_logprob_capture=True, response_length=16)
    tr_box = [common.build_trainer(cfg_for(tmp_path, **kw), device="cpu")]
    _, rows, tr = run_trainer(tmp_path, monkeypatch, trainer=tr_box[0])
    assert keys and all({"segment_ages", "behavior_logprobs"} <= k for k in keys)
    assert rows[1]["rollout/swap_installs"] >= 1
    assert rows[1]["rollout/segments_per_sample"] > 1.0
    assert all(np.isfinite(r["loss/policy_avg_new"]) for r in rows)
    assert "offpolicy/is_weight_mean_new" in rows[-1]


def test_a_publish_after_the_producer_took_its_tree_is_installed(monkeypatch):
    """The single producer's swap refresh starts from the version of the
    tree it dispatched, not the store's newest (as a fleet worker's starts
    from its lease's): a publish landing between the two is installed at
    the first poll, so the stream runs on the version its segments say."""
    import threading

    from nanorlhf_tpu_torch.orchestrator.orchestrator import RolloutOrchestrator
    from nanorlhf_tpu_torch.orchestrator.weight_store import VersionedWeightStore

    real_latest = VersionedWeightStore.latest
    raced = []

    def latest(self):
        out = real_latest(self)
        if not raced:      # the producer's take: the trainer publishes just after
            raced.append(out[0])
            self.publish({"v": 1})
        return out

    monkeypatch.setattr(VersionedWeightStore, "latest", latest)
    got, done = [], threading.Event()

    def dispatch(index, tree, weight_refresh=None):
        got.append((index, tree, weight_refresh()))
        done.set()
        return {"index": index}

    orch = RolloutOrchestrator(dispatch_fn=dispatch, initial_params={"v": 0},
                               max_staleness=0, inflight_swaps=True)
    try:
        assert done.wait(10)
    finally:
        orch.close(join_timeout=10)
    assert raced == [0]
    assert got[0] == (0, {"v": 0}, (1, {"v": 1}))


def test_swaps_config_validation(tmp_path):
    for knobs in (dict(rollout_inflight_swaps=True),
                  dict(rollout_inflight_swaps=True, rollout_orchestrator=True)):
        with pytest.raises(ValueError) as jerr:
            make_trainer(JaxAlgoName.GRPO, tmp_path / "jax", **knobs)
        with pytest.raises(ValueError) as perr:
            common.build_trainer(cfg_for(tmp_path / "port", **knobs), device="cpu")
        assert str(perr.value) == str(jerr.value)
