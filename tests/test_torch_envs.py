"""The port's multi-turn environments (`nanorlhf_tpu_torch/envs`, the
per-turn advantages, the trainer's env path) against the JAX package's, on
the CPU: each test of `tests/test_envs.py` that has a port counterpart, and

- the copied modules (the extractor, the environments, the pooled
  executor) held against their originals on the same inputs;
- `grpo_turn_advantage` / `per_turn_terminal_rewards` against JAX's on
  numpy inputs made from a seed (0 tolerance for the z-score's NaN→0 rule,
  1e-6 otherwise);
- the episode driver on the port's `DecodeSession` against JAX's
  `run_env_episodes` on the bridged tiny model: greedy token streams, loss
  masks, turn ends, turn rewards and admission counts equal; sampled runs
  keep the same contract and paged counts (their tokens match JAX's in
  distribution only);
- the trainer: two multi-turn GRPO updates end to end, the single-turn env
  bit-identical to the bare reward callable, the multi-turn config errors
  equal to JAX's messages.

Greedy streams are compared exactly."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import closes_trainers, jax_config, make_params, port_config  # noqa: F401
from nanorlhf_tpu.algos import grpo_turn_advantage as jax_turn_advantage
from nanorlhf_tpu.algos import per_turn_terminal_rewards as jax_turn_rewards
from nanorlhf_tpu.data import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu.envs import PythonToolEnv as JaxPythonToolEnv
from nanorlhf_tpu.envs import extract_python_block as jax_extract
from nanorlhf_tpu.envs import run_env_episodes as jax_run_env_episodes
from nanorlhf_tpu.rewards.python_executor import ExecutionResult as JaxExecutionResult
from nanorlhf_tpu.sampler import SamplingParams as JaxSamplingParams
from nanorlhf_tpu_torch.algos.advantages import (
    grpo_group_advantage,
    grpo_turn_advantage,
    per_turn_terminal_rewards,
)
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.envs import (
    PythonToolEnv,
    SingleTurnEnv,
    build_env,
    extract_python_block,
    run_env_episodes,
)
from nanorlhf_tpu_torch.resilience import FaultInjector, parse_fault_spec
from nanorlhf_tpu_torch.rewards.python_executor import ExecutionResult, PooledPythonExecutor
from nanorlhf_tpu_torch.sampler.sampler import SamplingParams
from nanorlhf_tpu_torch.telemetry import LineageLedger, chains, read_ledger
from nanorlhf_tpu_torch.trainer import rollout as trollout
from nanorlhf_tpu_torch.trainer import trainer as ttrainer

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools", "inspect_run.py")

# the toy tokenizer collapses whitespace, so fenced ```python blocks don't
# survive a decode round trip: the tests pin the extracted program through
# the public extractor hook; the observation is still a real execution
PINNED_PROGRAM = "print(6 * 7)"


def text_reward(pairs, eos_token):
    """Deterministic text-only reward: equal answers on equal streams."""
    return np.asarray([float(len(s.split()) % 5) + (1.0 if eos_token in s else 0.0)
                       for s in pairs], np.float32)


# ---------------------------------------------------------------------------
# the copied units: interface, extraction, advantages, executor, inspector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "thought ```python\nprint(1)\n``` more ```python\nprint(2)\n``` done",
    "no code here",
    "```python x=1```",
    "```python\n```",
])
def test_extract_python_block_takes_last_fenced_block(text):
    assert extract_python_block(text) == jax_extract(text)
    if "print(2)" in text:
        assert extract_python_block(text).strip() == "print(2)"
    if text == "no code here":
        assert extract_python_block(text) is None


def test_single_turn_env_round_trip_matches_reward_func():
    env = build_env("single_turn", text_reward, eos_token="</s>")
    fn = env.as_reward_func()
    pairs = ["a b c", "d e </s>", "f"]
    assert np.array_equal(np.asarray(fn(pairs, "</s>")), text_reward(pairs, "</s>"))
    with pytest.raises(ValueError):
        build_env("single_turn", text_reward, max_turns=2)
    with pytest.raises(ValueError):
        build_env("no_such_env", text_reward)


def test_python_tool_env_steps_and_terminal_reward():
    env, jenv = (cls(text_reward, max_turns=2) for cls in (PythonToolEnv, JaxPythonToolEnv))
    try:
        outs = []
        for e in (env, jenv):
            e.eos_token = "</s>"
            st = e.reset(["q: "])
            obs, rew, done = e.step(st, ["```python\nprint(6 * 7)\n```"], indices=[0])
            assert not done[0] and rew[0] == 0.0
            assert "42" in obs[0]              # real subprocess stdout fed back
            obs2, rew2, done2 = e.step(st, ["final answer 42"], indices=[0])
            assert done2[0] and obs2[0] == ""
            assert rew2[0] == text_reward([st.prompts[0] + st.transcripts[0]], "</s>")[0]
            outs.append((obs, rew, done, obs2, rew2, done2, st.transcripts, st.turn))
        for got, want in zip(*outs):
            assert np.array_equal(np.asarray(got), np.asarray(want))
    finally:
        env.close()
        jenv.close()


def test_grpo_turn_advantage_degenerates_to_group_advantage():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(8, 1)).astype(np.float32)     # K=1: one turn
    t = grpo_turn_advantage(torch.as_tensor(r), 4).numpy()
    g = grpo_group_advantage(torch.as_tensor(r[:, 0]), 4).numpy()
    np.testing.assert_allclose(t[:, 0], g, rtol=1e-6, atol=1e-6)
    r2 = rng.normal(size=(8, 2)).astype(np.float32)    # K=2: column by column
    t2 = grpo_turn_advantage(torch.as_tensor(r2), 4).numpy()
    for k in range(2):
        np.testing.assert_allclose(
            t2[:, k], grpo_group_advantage(torch.as_tensor(r2[:, k]), 4).numpy(),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,groups,n,k", [(0, 4, 4, 2), (1, 3, 2, 3), (2, 8, 4, 1)])
def test_grpo_turn_advantage_matches_jax(seed, groups, n, k):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(groups * n, k)).astype(np.float32)
    r[:n, 0] = 1.5                  # a group that ties on a turn: NaN → 0
    r[n:2 * n] = 0.0                # a group absent from every turn
    got = grpo_turn_advantage(torch.as_tensor(r), n).numpy()
    want = np.asarray(jax_turn_advantage(jnp.asarray(r), n))
    ties = np.zeros_like(r, bool)
    ties[:n, 0] = True
    ties[n:2 * n] = True
    assert np.array_equal(got[ties], want[ties]) and not got[ties].any()
    np.testing.assert_allclose(got[~ties], want[~ties], rtol=1e-6, atol=1e-6)


def test_per_turn_terminal_rewards_spikes_and_absent_turns():
    adv = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    ends = torch.tensor([[3, 7], [5, -1]])               # -1 = turn never ran
    dense = per_turn_terminal_rewards(adv, ends, 10).numpy()
    want = np.zeros((2, 10), np.float32)
    want[0, 3], want[0, 7], want[1, 5] = 1.0, 2.0, 3.0
    np.testing.assert_allclose(dense, want)              # the -1 column dropped


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_turn_terminal_rewards_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, K, T = 6, 3, 12
    adv = rng.normal(size=(B, K)).astype(np.float32)
    ends = np.sort(rng.integers(0, T, (B, K)), axis=1)
    ends[rng.random((B, K)) < 0.3] = -1                  # absent turns
    ends[0] = [4, 4, -1]                                 # two spikes on one token
    got = per_turn_terminal_rewards(torch.as_tensor(adv), torch.as_tensor(ends), T).numpy()
    want = np.asarray(jax_turn_rewards(jnp.asarray(adv), jnp.asarray(ends), T))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_pooled_executor_warm_reuse_and_timeout_respawn():
    ex = PooledPythonExecutor(timeout=20.0)
    try:
        r1 = ex.run("print('alpha'); answer = 6 * 7")
        assert r1.ok and "alpha" in r1.stdout and r1.answer == "42"
        pid1 = ex.worker_pid
        assert pid1 is not None
        r2 = ex.run("print('beta')")
        assert r2.ok and "beta" in r2.stdout
        assert ex.worker_pid == pid1, "second call must reuse the warm worker"
        r3 = ex.run("raise RuntimeError('boom')")
        assert not r3.ok and "boom" in r3.error
        assert ex.worker_pid == pid1, "a snippet error must not kill the worker"
    finally:
        ex.close()
    assert ex.worker_pid is None


def test_pooled_executor_timeout_reaps_then_respawns():
    ex = PooledPythonExecutor(timeout=1.0)
    try:
        assert ex.run("x = 1").ok
        pid1 = ex.worker_pid
        r = ex.run("import time; time.sleep(60)")
        assert not r.ok and "timeout" in r.error
        assert ex.worker_pid is None, "the wedged worker must be reaped"
        r2 = ex.run("print('back')")
        assert r2.ok and "back" in r2.stdout
        assert ex.worker_pid is not None and ex.worker_pid != pid1
    finally:
        ex.close()


def test_inspect_run_turns_report_from_ledger_alone(tmp_path):
    led = LineageLedger(str(tmp_path))
    for idx in range(3):
        led.generation(idx, policy_version=0, gen_s=0.1)
        for t in range(1, 3):
            led.turn(idx, step=0, row=idx, turn=t, tool_wall_s=0.25,
                     obs_range=[16, 20] if t == 1 else None,
                     obs_tokens=4 if t == 1 else 0,
                     reward=float(t), tok_range=[0, 16])
    led.close()
    out = subprocess.run([sys.executable, TOOLS, str(tmp_path), "--turns", "--json"],
                         capture_output=True, text=True, check=True)
    rep = json.loads(out.stdout)
    assert rep["turns_per_episode"] == 2.0
    assert len(rep["episodes"]) == 3
    for ep in rep["episodes"]:
        assert ep["turns"] == 2
        assert ep["obs_tokens"] == [4, 0]
        assert ep["rewards"] == [1.0, 2.0]
        assert ep["tool_wall_s"] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# the episode driver on the port's session (tiny model, CPU) against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("qwen_tied", vocab_size=256)
    jparams, tparams = make_params(jcfg, seed=0, lora=False)
    return jcfg, jparams, port_config(jcfg), tparams


def _driver_prompts(B, Tp):
    tok = ToyTokenizer(vocab_size=256)
    ids = np.full((B, Tp), tok.pad_token_id, np.int64)
    mask = np.zeros((B, Tp), bool)
    for i in range(B):
        e = tok.encode(f"prompt {i} compute the answer now")[:Tp]
        ids[i, Tp - len(e):] = e
        mask[i, Tp - len(e):] = True
    return ids, mask


class _NullExecutor:
    """A canned observation in place of the subprocess: driver mechanics do
    not need one per turn. `delay(ep)` sleeps before answering (tool
    latency that reorders completions)."""

    def __init__(self, result_cls, obs_text=" tool says 42 ", delay=None):
        self.result_cls, self.obs_text, self.delay = result_cls, obs_text, delay
        self.calls = 0

    def run(self, code):
        self.calls += 1
        if self.delay is not None:
            import time

            time.sleep(self.delay(self.calls))
        return self.result_cls(ok=True, stdout=self.obs_text)

    def close(self):
        pass


def echo_env(jax_side=False, max_turns=2, delay=None):
    """PythonToolEnv with the canned executor and the pinned program."""
    cls, res = ((JaxPythonToolEnv, JaxExecutionResult) if jax_side
                else (PythonToolEnv, ExecutionResult))
    return cls(text_reward, max_turns=max_turns, executor=_NullExecutor(res, delay=delay),
               extractor=lambda text: PINNED_PROGRAM)


DRIVER = dict(max_turns=2, turn_tokens=12, obs_budget=8, response_length=40,
              page_size=4, decode_rows=2)


def _port_driver(tiny, env, *, faults=None, greedy=False, seed=7, B=2, n=2, Tp=8):
    _, _, cfg, params = tiny
    tok = ToyTokenizer(vocab_size=256)
    ids, mask = _driver_prompts(B, Tp)
    env.eos_token = tok.eos_token
    try:
        return tok, run_env_episodes(
            params, cfg, torch.as_tensor(ids), torch.as_tensor(mask),
            torch.Generator().manual_seed(seed),
            SamplingParams(max_tokens=DRIVER["turn_tokens"], temperature=1.0, n=n,
                           greedy=greedy), env,
            eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
            tokenizer=tok, faults=faults, **DRIVER)
    finally:
        env.close()


def _jax_driver(tiny, env, *, greedy=False, B=2, n=2, Tp=8):
    jcfg, jparams, _, _ = tiny
    tok = JaxToyTokenizer(vocab_size=256)
    ids, mask = _driver_prompts(B, Tp)
    for i in range(B):  # the toy tokenizers learn words as they encode
        tok.encode(f"prompt {i} compute the answer now")
    env.eos_token = tok.eos_token
    try:
        return jax_run_env_episodes(
            jparams, jcfg, jnp.asarray(ids.astype(np.int32)), jnp.asarray(mask),
            jax.random.PRNGKey(7),
            JaxSamplingParams(max_tokens=DRIVER["turn_tokens"], temperature=1.0, n=n,
                              greedy=greedy), env,
            eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
            tokenizer=tok, **DRIVER)
    finally:
        env.close()


def _check_episode_contract(out, rows):
    st = out["stats"]
    assert out["tokens"].shape[0] == rows
    assert st["env/turns_per_episode"] == 2.0
    assert st["env/obs_tokens"] > 0
    # every episode re-admitted exactly once through the session's
    # admission path, its turn-1 pages released first
    assert out["admissions"] == rows
    assert out["pages_recycled"] > 0
    # the loss mask is False EXACTLY on the recorded observation spans
    expected = np.ones_like(out["loss_mask"])
    for rec in out["turns"]:
        if rec["obs_range"]:
            a, b = rec["obs_range"]
            expected[rec["row"], a:b] = False
            assert rec["obs_tokens"] == b - a > 0
    assert np.array_equal(out["loss_mask"], expected)
    assert (~out["loss_mask"]).sum() > 0
    for ep in range(rows):
        recs = [r for r in out["turns"] if r["row"] == ep]
        assert [r["turn"] for r in recs] == [1, 2]
        e1, e2 = out["turn_ends"][ep]
        assert 0 <= e1 < e2 < out["tokens"].shape[1]
    np.testing.assert_allclose(out["scores"], out["turn_rewards"].sum(1))


def test_driver_two_turns_masked_obs_and_page_recycling(tiny):
    _, out = _port_driver(tiny, echo_env())
    _check_episode_contract(out, 4)
    assert out["stats"]["env/tool_errors"] == 0.0


def test_driver_greedy_streams_equal_jax(tiny):
    """Greedy episodes through the port's session equal JAX's driver: the
    packed streams, loss masks, turn ends, turn rewards and paged counts."""
    _, got = _port_driver(tiny, echo_env(), greedy=True)
    want = _jax_driver(tiny, echo_env(jax_side=True), greedy=True)
    _check_episode_contract(got, 4)
    for key in ("tokens", "loss_mask", "turn_ends", "turn_rewards", "scores"):
        assert np.array_equal(got[key], np.asarray(want[key])), key
    assert (got["admissions"], got["pages_recycled"]) == (want["admissions"],
                                                          want["pages_recycled"])
    # the turn records equal JAX's but for the tools' wall seconds
    assert [{k: v for k, v in r.items() if k != "tool_wall_s"} for r in got["turns"]] == [
        {k: v for k, v in r.items() if k != "tool_wall_s"} for r in want["turns"]]
    for k in ("env/turns_per_episode", "env/obs_tokens", "env/tool_errors"):
        assert got["stats"][k] == want["stats"][k], k


def test_driver_sampled_keeps_jax_contract_and_counts(tiny):
    """Sampled episodes match JAX's in distribution only (Philox against
    threefry): both keep the episode contract, and the paged counts — every
    admission claims a full budget — are equal."""
    _, got = _port_driver(tiny, echo_env())
    want = _jax_driver(tiny, echo_env(jax_side=True))
    _check_episode_contract(got, 4)
    _check_episode_contract({k: np.asarray(v) if k not in ("turns", "stats") else v
                             for k, v in want.items()}, 4)
    assert (got["admissions"], got["pages_recycled"]) == (want["admissions"],
                                                          want["pages_recycled"])


def test_driver_greedy_stream_is_schedule_independent(tiny):
    """Tool completion order races through thread scheduling; a greedy
    episode stream must not care: each row's logits depend only on its own
    pages, and the admission streams are keyed on (episode, turn)."""
    _, a = _port_driver(tiny, echo_env(), greedy=True)
    # later calls answer first: the episodes come back in reverse order
    _, b = _port_driver(tiny, echo_env(delay=lambda call: 0.05 * max(0, 4 - call)),
                        greedy=True)
    for key in ("tokens", "loss_mask", "turn_ends"):
        assert np.array_equal(a[key], b[key]), key


def test_driver_fault_sites_hang_delays_and_crash_degrades(tiny):
    faults = FaultInjector(parse_fault_spec(
        "env.hang:at=1,delay=0.3,worker=0 env.crash:at=1,worker=1"))
    tok, out = _port_driver(tiny, echo_env(), faults=faults)
    st = out["stats"]
    # every episode still completes its 2 turns — the crash became an
    # error-text observation — and the absorption is counted
    assert st["env/turns_per_episode"] == 2.0
    assert st["env/tool_errors"] == 1.0
    recs = {(r["row"], r["turn"]): r for r in out["turns"]}
    assert recs[(0, 1)]["tool_wall_s"] >= 0.3           # env.hang stalled it
    crash = recs[(1, 1)]
    assert crash["obs_range"] is not None
    a, b = crash["obs_range"]
    assert "InjectedFault" in tok.decode(out["tokens"][1, a:b])


def test_driver_admission_that_cannot_allocate_raises(tiny, monkeypatch):
    """An episode whose continuation cannot get pages is not dropped: the
    admission raises."""
    from nanorlhf_tpu_torch.sampler.paged import session as tsession

    monkeypatch.setattr(tsession, "alloc_row", lambda state, row, nb: (state, False))
    with pytest.raises(RuntimeError, match="allocator underflow"):
        _port_driver(tiny, echo_env(), greedy=True)


# ---------------------------------------------------------------------------
# the trainer end to end + the single-turn parity pin + the config errors
# ---------------------------------------------------------------------------


def _env_cfg(tmp_path, name, **over):
    cfg = one_card_cut(build_config())
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path / name)
    cfg.response_length = 48
    cfg.sample_n = 2
    cfg.kl_coef = 0.0
    cfg.per_device_train_batch_size = 2
    cfg.gradient_accumulation_steps = 1
    cfg.num_mini_batches = 2
    cfg.total_episodes = 8
    cfg.lora_r, cfg.lora_alpha = 4, 8
    cfg.learning_rate = 1e-3
    cfg.save_steps = 0
    cfg.load_best_model_at_end = False
    cfg.num_printed_samples = 0
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _read_metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_multi_turn_grpo_end_to_end(tmp_path, monkeypatch):
    """Two GRPO updates on the 2-turn python-tool env over the paged
    session, through the launcher's `build_trainer`: every observation
    token trains at loss_mask=False in the assembled batch, the update
    steps on finite gradients, and `turn` lineage events join the rollout's
    `generation` and `reward` events."""
    from nanorlhf_tpu_torch.envs import rollout as envroll

    cfg = _env_cfg(tmp_path, "env_e2e", rollout_page_size=4, rollout_decode_rows=2,
                   env_name="python_tool", env_max_turns=2, env_turn_tokens=16,
                   env_obs_budget=8, lineage=True)
    tr = common.build_trainer(cfg, device="cpu")
    # the terminal grader: a reward with variance inside the groups, so the
    # turn advantages (and the gradients) are not all zero on a random model
    tr.env.reward_func = lambda pairs, eos: np.asarray(
        [float(len(s) % 7) for s in pairs], np.float32)
    assert isinstance(tr.env, PythonToolEnv) and tr._env_multi_turn
    tr.env.extractor = lambda text: PINNED_PROGRAM

    payloads, batches, grads = [], [], []
    real_run, real_asm = envroll.run_env_episodes, ttrainer.assemble_batch
    real_update = ttrainer.update_minibatch
    monkeypatch.setattr(envroll, "run_env_episodes",
                        lambda *a, **k: payloads.append(real_run(*a, **k)) or payloads[-1])
    monkeypatch.setattr(ttrainer, "assemble_batch",
                        lambda *a, **k: batches.append(real_asm(*a, **k)) or batches[-1])

    def update(*a, **k):
        assert "loss_mask" in a[4]
        opt_state, st = real_update(*a, **k)
        grads.append(st["grad_norm"])
        return opt_state, st

    monkeypatch.setattr(ttrainer, "update_minibatch", update)
    state = tr.train(num_updates=2)
    assert state["global_step"] == 2
    assert len(payloads) == 2 and len(batches) == 2
    assert all(np.isfinite(g) for g in grads) and any(g > 0 for g in grads)

    rows = _read_metrics(cfg.output_dir)
    assert len(rows) == 2
    for row in rows:
        assert row["env/turns_per_episode"] >= 2.0
        assert row["env/obs_tokens"] > 0
        assert 0.0 <= row["env/tool_stall_overlap"] <= 1.0
        assert np.isfinite(row["loss/policy_avg_new"])

    for payload, (batch, _) in zip(payloads, batches):
        expected = np.ones_like(payload["loss_mask"])
        n_obs = 0
        for rec in payload["turns"]:
            if rec["obs_range"]:
                a, b = rec["obs_range"]
                expected[rec["row"], a:b] = False
                n_obs += b - a
        assert n_obs > 0
        assert np.array_equal(payload["loss_mask"], expected)
        # the kept rows carry their episodes' masks through keep-1-of-N
        bm = np.asarray(batch["loss_mask"])
        assert (~bm).sum() > 0
        payload_rows = {m.tobytes() for m in payload["loss_mask"]}
        for r in bm:
            assert r.tobytes() in payload_rows
        np.testing.assert_allclose(payload["scores"], payload["turn_rewards"].sum(1))

    events = list(read_ledger(cfg.output_dir))
    by_index = chains(events)
    turn_evs = [e for e in events if e["type"] == "turn"]
    assert turn_evs
    for ev in turn_evs:
        assert {"generation", "reward"} <= set(by_index[ev["rollout_index"]])
    assert len(turn_evs) == sum(len(p["turns"]) for p in payloads)

    out = subprocess.run([sys.executable, TOOLS, cfg.output_dir, "--turns", "--json"],
                         capture_output=True, text=True, check=True)
    rep = json.loads(out.stdout)
    assert rep["turns_per_episode"] >= 2.0
    assert len(rep["episodes"]) == sum(p["tokens"].shape[0] for p in payloads)


def test_per_turn_advantages_reach_the_batch(tmp_path):
    """`assemble_batch` on a multi-turn rollout: one spike an episode turn
    (its z-scored turn advantage at the turn's last model token) summed
    into reward-to-go, the observation mask carried, no stop-token cut."""
    cfg = _env_cfg(tmp_path, "asm", rollout_page_size=4, env_name="python_tool",
                   env_max_turns=2, env_turn_tokens=4, env_obs_budget=2)
    cfg.finalize(1)
    T = 10
    responses = np.array([[5, 6, 3, 7, 8, 9, 3, 0, 0, 0],
                          [5, 3, 7, 9, 3, 0, 0, 0, 0, 0]])
    loss_mask = np.ones((2, T), bool)
    loss_mask[0, 3:5], loss_mask[1, 2:3] = False, False
    ro = {"queries": np.array([[4, 4], [4, 4]]), "responses": responses,
          "logprobs": np.zeros((2, T), np.float32),
          "ref_logprobs": np.zeros((2, T), np.float32),
          "advantages": np.zeros(2, np.float32),
          "turn_advantages": np.array([[1.0, -2.0], [0.5, 0.25]], np.float32),
          "turn_ends": np.array([[2, 6], [1, 4]]), "loss_mask": loss_mask,
          "env": {}, "keep": np.zeros(2, np.int64)}
    batch, info = trollout.assemble_batch(ro, cfg, stop_id=3, pad_id=0, eos_id=3)
    want = np.zeros((2, T), np.float32)
    want[0, :3], want[0, 3:7] = 1.0 - 2.0, -2.0
    want[1, :2], want[1, 2:5] = 0.5 + 0.25, 0.25
    np.testing.assert_allclose(batch["advantages"], want)
    assert np.array_equal(batch["loss_mask"], loss_mask)
    assert np.array_equal(info["post"], responses)   # interior EOS kept


# wall-clock / throughput keys legitimately differ between two identical
# runs; everything else must match exactly for the parity pin
_TIMEY = re.compile(r"(time|_s$|sec|mfu|perf|latency|wall|overlap|^t$|^t_mono$)",
                    re.IGNORECASE)


def test_single_turn_env_bit_identical_to_bare_reward_func(tmp_path):
    rows = {}
    for name, over in (("bare", {}),
                       ("env", dict(env_name="single_turn", env_max_turns=1))):
        tr = common.build_trainer(_env_cfg(tmp_path, name, response_length=16, **over),
                                  device="cpu")
        if name == "env":
            assert isinstance(tr.env, SingleTurnEnv) and not tr._env_multi_turn
            tr.env.reward_func = text_reward   # the env unwraps this callable
        else:
            tr.reward_func = text_reward
        assert tr.train(num_updates=2)["global_step"] == 2
        tr.close()
        rows[name] = _read_metrics(str(tmp_path / name))
    assert len(rows["bare"]) == len(rows["env"]) == 2
    for a, b in zip(rows["bare"], rows["env"]):
        ka = {k for k in a if not _TIMEY.search(k)}
        assert ka == {k for k in b if not _TIMEY.search(k)}
        for k in sorted(ka):
            assert a[k] == b[k], f"metric {k!r} diverged: {a[k]} != {b[k]}"


MULTI_TURN_BAD = {
    "no_pages": dict(env_turn_tokens=16, env_obs_budget=8),
    "budget": dict(rollout_page_size=4, rollout_decode_rows=2, env_turn_tokens=32,
                   env_obs_budget=8),
    "not_grpo": dict(algo="rloo", rollout_page_size=4, env_turn_tokens=16,
                     env_obs_budget=8),
    "spec_decode": dict(rollout_page_size=4, rollout_spec_k=2, env_turn_tokens=16,
                        env_obs_budget=8),
    "prefix_cache": dict(rollout_page_size=4, rollout_decode_rows=2,
                         rollout_prefix_cache=True, env_turn_tokens=16, env_obs_budget=8),
}


@pytest.mark.parametrize("case", sorted(MULTI_TURN_BAD))
def test_multi_turn_config_validation(case, tmp_path):
    """Each multi-turn config JAX's trainer refuses, refused by the port's
    with the same ValueError message."""
    from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
    from test_envs import _env_trainer

    knobs = dict(MULTI_TURN_BAD[case], env_name="python_tool", env_max_turns=2)
    jknobs = dict(knobs)
    if "algo" in jknobs:
        jknobs["algo"] = JaxAlgoName(jknobs["algo"])
    with pytest.raises(ValueError) as jax_err:
        _env_trainer(tmp_path, f"jax_{case}", **jknobs)
    cfg = _env_cfg(tmp_path, f"port_{case}")
    for k, v in knobs.items():
        setattr(cfg, k, ttrainer.AlgoName(v) if k == "algo" else v)
    with pytest.raises(ValueError) as port_err:
        common.build_trainer(cfg, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
