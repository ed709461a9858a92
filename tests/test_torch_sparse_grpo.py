"""The port's sparse GRPO trainer and R1-Zero launcher against the JAX
package's, on the CPU (tiny model, plain versions of every kernel, f32).

Both trainers take the same patched rollout (seeded tokens with EOS planted
at spread positions), the same rewards, keep indices and epoch
permutations (the port's own draws, handed to JAX), at the same global
batch (JAX on a one-device mesh), with the token budgets cut so that the
tiny rows fill several buckets, some padded with all-pad rows. Held: the
kept rows, the context width, the response cut, every bucket's rows and
(rows_b, width) in scoring and in the update, each update bucket's
logprobs and advantages (1e-5), the loss scale, the metric row (1e-5)
and the trainable leaves after the update (1e-5). Then the skip path, a
resume after a skipped update, the greedy accuracy eval's texts,
`build_config` literal by literal, the knobs that raise, and the CPU
only when asked. The sparse update is also held on its other routes: the
naive full-logits branch and remat_policy="dots", and with
sampler_logprob_capture (scripted sampler logprobs fed to both)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (closes_trainers: autouse)
    LORA,
    closes_trainers,
    jax_config,
    make_params,
    port_config,
)
from nanorlhf_tpu.data import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu.entrypoints import grpo_r1 as jr1
from nanorlhf_tpu.parallel import MeshConfig as JaxMeshConfig
from nanorlhf_tpu.parallel.mesh import make_mesh
from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
from nanorlhf_tpu.trainer import RLConfig as JaxRLConfig
from nanorlhf_tpu.trainer import sparse_grpo as jsg
from nanorlhf_tpu_torch.bridge import params_to_numpy
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
from nanorlhf_tpu_torch.entrypoints import grpo_r1
from nanorlhf_tpu_torch.trainer import rollout as trollout
from nanorlhf_tpu_torch.trainer import sparse_grpo as tsg
from nanorlhf_tpu_torch.trainer.config import MeshConfig, RLConfig
from nanorlhf_tpu_torch.trainer.optim import flatten

torch.set_num_threads(1)

V = 128
N = 2            # samples a prompt
PROMPTS = 8      # prompts an update
RESP = 24
KNOBS = dict(
    response_length=RESP, temperature=0.9, sample_n=N, kl_coef=0.0,
    total_episodes=64, per_device_train_batch_size=4, gradient_accumulation_steps=1,
    num_mini_batches=2, num_ppo_epochs=1, learning_rate=1e-3, adam_eps=1e-5,
    use_lora=True, lora_r=LORA.r, lora_alpha=LORA.alpha, gradient_checkpointing=False,
    save_steps=0, eval_steps=0, fused_logprob_chunk=5,
)
# the token budgets, cut so that rows of 17-40 tokens fill several buckets
FORWARD_BUDGET, BACKWARD_BUDGET = 96, 40


def _configs(tmp_path, **over):
    knobs = {**KNOBS, **over}
    jcfg = JaxRLConfig(algo=JaxAlgoName.GRPO, output_dir=str(tmp_path / "jax"),
                       mesh=JaxMeshConfig(1, 1, 1), **knobs)
    cfg = RLConfig(algo="grpo", output_dir=str(tmp_path / "port"), **knobs)
    return jcfg, cfg


def _responses(seed: int) -> np.ndarray:
    """[PROMPTS·N, RESP] seeded tokens with EOS (id 1) planted at spread
    positions; every fourth row has none."""
    rng = np.random.default_rng(seed)
    out = rng.integers(3, V, (PROMPTS * N, RESP)).astype(np.int32)
    for i, at in enumerate(rng.integers(0, RESP, PROMPTS * N)):
        if i % 4 != 3:
            out[i, at] = 1
    return out


def _rewards(seed: int, zero_groups=(1,)) -> np.ndarray:
    """Seeded rewards with variance in every group but `zero_groups`, whose
    samples all score 0 (the sparse filter drops them)."""
    r = np.random.default_rng(seed).random((PROMPTS, N)).astype(np.float32)
    r[list(zero_groups)] = 0.0
    return r.reshape(-1)


def _captured(seed: int) -> np.ndarray:
    """[PROMPTS·N, RESP] seeded sampler logprobs in (-3, 0), distinct in
    every row and column: a wrong row or a wrong cut cannot match."""
    rng = np.random.default_rng(seed)
    return (-0.01 - 3.0 * rng.random((PROMPTS * N, RESP))).astype(np.float32)


class _Script:
    """The patched rollout and reward of each update, in call order, and
    what each trainer asked for. A rollout with captured logprobs makes
    the patched `generate` return (tokens, logprobs), as the sampler does
    under capture."""

    def __init__(self, rollouts):
        self.rollouts = rollouts  # [(responses, rewards[, captured])] an update
        self.gen_calls = 0
        self.rew_calls = 0
        self.queries = []

    def tokens(self, prompt_ids):
        self.queries.append(np.asarray(prompt_ids))
        rollout = self.rollouts[self.gen_calls]
        self.gen_calls += 1
        return rollout[0] if len(rollout) == 2 else (rollout[0], rollout[2])

    def generate(self, as_array):
        """The patched `generate` of one trainer, `as_array` its array type."""
        def gen(params, config, ids, *a, **k):
            out = self.tokens(ids)
            return tuple(map(as_array, out)) if isinstance(out, tuple) else as_array(out)

        return gen

    def reward(self, texts, ids, tokenizer):
        out = self.rollouts[self.rew_calls][1]
        self.rew_calls += 1
        assert len(texts) == len(out)
        return out


def _dataset(jtok, tok):
    qa = jr1.synthetic_math_corpus(64)
    return (jr1.build_prompt_dataset(qa, jtok, max_prompt_len=16),
            grpo_r1.build_prompt_dataset(qa, tok, max_prompt_len=16))


def _run_port(monkeypatch, cfg, tparams, mcfg, tok, ds, script, updates, record):
    monkeypatch.setattr(trollout, "generate", script.generate(torch.as_tensor))
    monkeypatch.setattr(tsg, "forward_token_budget", lambda *a, **k: FORWARD_BUDGET)
    monkeypatch.setattr(tsg, "BACKWARD_BUDGET", BACKWARD_BUDGET)
    keep_fn, perm_fn, batches_fn = (tsg.keep_one_of_n_indices, tsg.epoch_permutation,
                                    tsg.create_batches)

    def keep(gen, b, n):
        out = keep_fn(gen, b, n)
        record["keep"].append(out.numpy().copy())
        return out

    def perm(*a):
        out = perm_fn(*a)
        record["perm"].append(out.copy())
        return out

    def batches(lengths, budget):
        out = batches_fn(lengths, budget)
        record["batches"].append((np.asarray(lengths).tolist(), budget, out))
        return out

    grads_fn = tsg.SparseGRPOTrainer.bucket_grads

    def bucket_grads(self, mb, ctx, scale):
        record["mb"].append(({k: v.numpy().copy() for k, v in mb.items()}, ctx, scale))
        return grads_fn(self, mb, ctx, scale)

    monkeypatch.setattr(tsg, "keep_one_of_n_indices", keep)
    monkeypatch.setattr(tsg, "epoch_permutation", perm)
    monkeypatch.setattr(tsg, "create_batches", batches)
    monkeypatch.setattr(tsg.SparseGRPOTrainer, "bucket_grads", bucket_grads)
    tr = tsg.SparseGRPOTrainer(cfg, mcfg, tok, tparams, ds, script.reward)
    try:
        tr.train(updates)
    finally:
        tr.close()
    return tr


def _run_jax(monkeypatch, jcfg, jparams, jmodel, jtok, jds, script, updates, record,
             port_record):
    monkeypatch.setattr(jsg, "generate", script.generate(jnp.asarray))
    monkeypatch.setattr(jsg, "forward_token_budget", lambda *a, **k: FORWARD_BUDGET)
    monkeypatch.setattr(jsg, "BACKWARD_BUDGET", BACKWARD_BUDGET)
    keeps, perms = list(port_record["keep"]), list(port_record["perm"])
    monkeypatch.setattr(jsg, "keep_one_of_n_indices",
                        lambda key, b, n: jnp.asarray(keeps.pop(0)))
    real_perm = jax.random.permutation

    def perm(key, n, *a, **k):
        if perms and len(perms[0]) == n:
            return jnp.asarray(perms.pop(0))
        return real_perm(key, n, *a, **k)

    monkeypatch.setattr(jax.random, "permutation", perm)
    batches_fn = jsg.create_batches

    def batches(lengths, budget):
        out = batches_fn(lengths, budget)
        record["batches"].append((np.asarray(lengths).tolist(), budget, out))
        return out

    monkeypatch.setattr(jsg, "create_batches", batches)
    grad_fn_builder = jsg.SparseGRPOTrainer._bucket_grad_fn

    def bucket_grad_fn(self):
        fn = grad_fn_builder(self)

        def wrapped(trainable, frozen, mb, ctx, scale):
            record["mb"].append(({k: np.asarray(v) for k, v in mb.items()}, ctx,
                                 float(scale)))
            return fn(trainable, frozen, mb, ctx, scale)

        return wrapped

    monkeypatch.setattr(jsg.SparseGRPOTrainer, "_bucket_grad_fn", bucket_grad_fn)
    jtr = jsg.SparseGRPOTrainer(jcfg, jmodel, jtok, jparams, jds, script.reward,
                                mesh=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    try:
        jtr.train(updates)
    finally:
        jtr.close()
    return jtr


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _trained_pair(monkeypatch, tmp_path, rollouts, updates=1, **over):
    jcfg, cfg = _configs(tmp_path, **over)
    jmodel = jax_config("qwen_tied", vocab_size=V)
    mcfg = port_config(jmodel)
    jparams, tparams = make_params(jmodel, seed=3)
    jtok, tok = JaxToyTokenizer(V), ToyTokenizer(V)
    jds, ds = _dataset(jtok, tok)
    rec = {"keep": [], "perm": [], "batches": [], "mb": []}
    jrec = {"batches": [], "mb": []}
    port_script, jax_script = _Script(rollouts), _Script(rollouts)
    tr = _run_port(monkeypatch, cfg, tparams, mcfg, tok, ds, port_script, updates, rec)
    jtr = _run_jax(monkeypatch, jcfg, jparams, jmodel, jtok, jds, jax_script, updates,
                   jrec, rec)
    return tr, jtr, rec, jrec, port_script, jax_script


def test_sparse_update_matches_jax(monkeypatch, tmp_path):
    _check_sparse_update(monkeypatch, tmp_path)


# the update's other routes: the naive full-logits branch in scoring and in
# the bucket gradients (JAX's `_bucket_score_fn` / `_bucket_grad_fn`
# non-fused branches), and remat_policy="dots"
ROUTES = {
    "naive": dict(fused_logprob=False),
    "naive_remat": dict(fused_logprob=False, gradient_checkpointing=True),
    "dots": dict(remat_policy="dots", gradient_checkpointing=True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sparse_update_routes_match_jax(route, monkeypatch, tmp_path):
    from nanorlhf_tpu_torch.trainer import update as tupdate

    entropies = []
    real = tupdate.chunked_entropy
    monkeypatch.setattr(tupdate, "chunked_entropy",
                        lambda *a, **k: entropies.append(1) or real(*a, **k))
    _check_sparse_update(monkeypatch, tmp_path, **ROUTES[route])
    # the bucket gradients took the naive branch exactly when asked
    assert bool(entropies) == (not ROUTES[route].get("fused_logprob", True))


@pytest.mark.parametrize("kl", [0.0, 0.05])
def test_sampler_logprob_capture_matches_jax(kl, monkeypatch, tmp_path):
    """sampler_logprob_capture: the update's policy logprobs are the
    sampler's, cut to the kept rows (1 of N, then the sparse filter) and
    to the response cut. Ref-free (kl 0) no scoring bucket runs; with a
    KL the buckets run the reference alone. Held as the plain update is,
    and each real row's logprobs are its own sample's captured ones."""
    _check_sparse_update(monkeypatch, tmp_path, captured=_captured(0), kl_coef=kl,
                         sampler_logprob_capture=True)


def _check_sparse_update(monkeypatch, tmp_path, captured=None, **over):
    rollout = (_responses(0), _rewards(0, zero_groups=(1, 5)))
    tr, jtr, rec, jrec, ps, js = _trained_pair(
        monkeypatch, tmp_path, [rollout if captured is None else (*rollout, captured)],
        **over)
    # the same prompts (the port de-pads before generating; the tokens are
    # the same)
    assert [list(r[r != 0]) for r in ps.queries[0]] == \
        [list(r[r != 0]) for r in js.queries[0]]
    # the same buckets: scoring (forward budget), then each minibatch's;
    # ref-free under capture nothing is scored (JAX still cuts the scoring
    # buckets it then skips)
    no_scoring = captured is not None and tr._ref_free
    assert [b[1] for b in rec["batches"]] == \
        [FORWARD_BUDGET] * (not no_scoring) + [BACKWARD_BUDGET, BACKWARD_BUDGET]
    assert rec["batches"] == jrec["batches"][int(no_scoring):]
    # 2 groups filtered: 6 kept rows, two minibatches of 4 and 2
    assert sum(len(b[0]) for b in rec["batches"] if b[1] == BACKWARD_BUDGET) == \
        PROMPTS - 2
    assert len(rec["mb"]) == len(jrec["mb"]) >= 3
    if captured is not None:
        # every real row's logprobs are the captured ones of its own
        # sample: the kept one of its group, at the same response tokens
        pick = np.arange(PROMPTS), rec["keep"][0]
        want_lp = captured.reshape(PROMPTS, N, -1)[pick]
        want_resp = rollout[0].reshape(PROMPTS, N, -1)[pick]
        for mb, _, _ in rec["mb"]:
            w = mb["responses"].shape[1]
            for lp, pm, resp in zip(mb["logprobs"], mb["padding_mask"], mb["responses"]):
                if pm.all():
                    continue  # an all-pad row of the rows menu
                hits = [i for i in range(PROMPTS)
                        if np.array_equal(lp[~pm], want_lp[i, :w][~pm])]
                assert len(hits) == 1 and \
                    np.array_equal(resp[~pm], want_resp[hits[0], :w][~pm])
    for (mb, ctx, scale), (jmb, jctx, jscale) in zip(rec["mb"], jrec["mb"]):
        assert ctx == jctx == tr.update_log[0]["context_length"]
        assert scale == pytest.approx(jscale, abs=1e-7)
        assert mb.keys() == jmb.keys()
        for k in ("query_responses", "responses", "padding_mask"):
            np.testing.assert_array_equal(mb[k], jmb[k], err_msg=k)
        for k in ("logprobs", "ref_logprobs", "advantages"):
            np.testing.assert_allclose(mb[k], jmb[k], atol=1e-5, rtol=1e-5, err_msg=k)
    # scoring buckets' (real rows, rows_b, width): rows_b from the rows menu,
    # one of them padded with all-pad rows
    score_buckets = tr.update_log[0]["score_buckets"]
    assert all(rb in (1, 2, 4, 8) and rb >= n for n, rb, _ in score_buckets)
    assert any(rb > n for n, rb, _ in score_buckets) != no_scoring
    # the metric row
    row = [r for r in _rows(tmp_path / "port" / "metrics.jsonl") if "episode" in r][-1]
    jrow = [r for r in _rows(tmp_path / "jax" / "metrics.jsonl") if "episode" in r][-1]
    # wall-clock rows, and the compile counters (XLA's compiles in JAX,
    # kernel builds in the port)
    skip = {"time", "t_mono", "sec_per_episode", "mem/peak_bytes_in_use",
            "perf/mfu", "perf/tokens_per_sec_step", "perf/tokens_per_sec_update",
            "perf/tokens_per_sec_rollout", "perf/recompiles",
            "perf/recompile_seconds"}
    shared = (set(row) & set(jrow)) - skip
    assert {"sparse/kept_frac", "loss/policy_avg_new", "policy/entropy_avg_new",
            "lr", "eval_response_length", "mem/logits_bytes_saved"} <= shared
    assert ("sampler_capture/ratio_drift_new" in shared) == (captured is not None)
    for k in shared:
        np.testing.assert_allclose(row[k], jrow[k], atol=1e-5, rtol=1e-5, err_msg=k)
    assert row["sparse/kept_frac"] == pytest.approx((PROMPTS - 2) / PROMPTS)
    # the trainable leaves after the update
    want = flatten(jax.tree.map(np.asarray, jtr.params))
    got = flatten(params_to_numpy(tr.trainable))
    assert got and all(p in want for p in got)
    for p, g in got.items():
        np.testing.assert_allclose(g, want[p], atol=1e-5, rtol=1e-4, err_msg="/".join(p))
    assert tr.state == {k: jtr.state[k] for k in tr.state}


def test_padded_bucket_gradient_equals_the_unpadded_one(monkeypatch, tmp_path):
    """All-pad rows added to a bucket (the rows menu) change neither its
    loss nor its gradient: 3 rows padded to 4 against the same 3 rows."""
    _, cfg = _configs(tmp_path)
    jmodel = jax_config("qwen_tied", vocab_size=V)
    _, tparams = make_params(jmodel, seed=3)
    tok = ToyTokenizer(V)
    _, ds = _dataset(JaxToyTokenizer(V), tok)
    tr = tsg.SparseGRPOTrainer(cfg, port_config(jmodel), tok, tparams, ds,
                               lambda texts, eos: np.zeros(len(texts), np.float32))
    try:
        rng = np.random.default_rng(9)
        ctx, rows = 16, 3
        resp = _responses(9)[:rows]
        post = np.where(np.cumsum(resp == 1, axis=1) - (resp == 1) > 0, 0, resp)
        pm = post == 0
        arrays = {"qr": np.concatenate([ds.input_ids[:rows], resp], axis=1),
                  "responses": resp,
                  "logprobs": np.where(pm, 1.0, rng.normal(-4.8, 0.3, resp.shape)),
                  "ref_logprobs": np.where(pm, 1.0, -4.8),
                  "advantages": np.where(pm, 0.0, rng.normal(0, 1, (rows, 1))
                                         * np.ones_like(resp)),
                  "padding_mask": pm}
        arrays = {k: v.astype(np.float32) if v.dtype == np.float64 else v
                  for k, v in arrays.items()}
        arrays.update(qr_len=ctx + (~pm).sum(1), context_length=ctx)
        sel = np.arange(rows)
        padded, _ = tr.bucket_batch(arrays, sel)
        assert padded["query_responses"].shape[0] == 4
        assert bool((padded["query_responses"][3] == 0).all())
        monkeypatch.setattr(tr, "_rows_menu", [1, 2, 3, 4, 8])
        plain, _ = tr.bucket_batch(arrays, sel)
        assert plain["query_responses"].shape[0] == rows
        g_pad, aux_pad = tr.bucket_grads(padded, ctx, 0.75)
        g, aux = tr.bucket_grads(plain, ctx, 0.75)
        assert aux_pad["pg_loss"] == pytest.approx(aux["pg_loss"], abs=1e-6)
        for p in g:
            assert torch.isfinite(g_pad[p]).all()
            torch.testing.assert_close(g_pad[p], g[p], atol=1e-6, rtol=1e-5)
        assert any(float(t.abs().max()) > 0 for t in g.values())
    finally:
        tr.close()


def test_all_zero_rewards_skip_the_update(monkeypatch, tmp_path):
    """An update whose every group scores alike: a metrics event row
    (rollout-indexed, no episode), no optimizer step, the rollout cursor
    advanced — on both sides."""
    zero = np.zeros(PROMPTS * N, np.float32)
    tr, jtr, rec, jrec, _, _ = _trained_pair(
        monkeypatch, tmp_path, [(_responses(1), zero), (_responses(2), zero)], updates=2)
    for t in (tr, jtr):
        assert t.state["global_step"] == 0 and t.state["rollouts"] == 2
        assert t.state["episode"] == 2 * PROMPTS
        assert t.state.get("opt_steps", 0) == 0
    assert [r["skipped"] for r in tr.update_log] == [True, True]
    events = [r for r in _rows(tmp_path / "port" / "metrics.jsonl")]
    jevents = [r for r in _rows(tmp_path / "jax" / "metrics.jsonl")
               if "sparse_skip/raw_score_mean" in r]
    assert [r["step"] for r in events] == [r["step"] for r in jevents] == [1, 2]
    assert all("episode" not in r and r["sparse_skip/raw_score_mean"] == 0.0
               for r in events)
    assert rec["batches"] == jrec["batches"] == []


def _port_run(tmp_path, monkeypatch, name, rollouts, updates, resume=False):
    jcfg, cfg = _configs(tmp_path / name, save_steps=1)
    jmodel = jax_config("qwen_tied", vocab_size=V)
    _, tparams = make_params(jmodel, seed=3)
    tok = ToyTokenizer(V)
    _, ds = _dataset(JaxToyTokenizer(V), tok)
    script = _Script(rollouts)
    monkeypatch.setattr(trollout, "generate", lambda params, config, ids, *a, **k:
                        torch.as_tensor(script.tokens(ids)))
    monkeypatch.setattr(tsg, "forward_token_budget", lambda *a, **k: FORWARD_BUDGET)
    monkeypatch.setattr(tsg, "BACKWARD_BUDGET", BACKWARD_BUDGET)
    tr = tsg.SparseGRPOTrainer(cfg, port_config(jmodel), tok, tparams, ds, script.reward)
    if resume:
        tr.resume_from_checkpoint()
        script.gen_calls = script.rew_calls = tr.state["rollouts"]
    try:
        tr.train(updates)
    finally:
        tr.close()
    return tr


def test_resume_after_a_skipped_update_replays_the_run(monkeypatch, tmp_path):
    """Updates: trained, skipped, trained. Interrupted after the skip (the
    checkpoint of update 1 holds rollouts=1; the skip saved nothing) and
    resumed, the run replays the skipped rollout and trains update 2 to the
    uninterrupted run's leaves, bit for bit."""
    rollouts = [(_responses(3), _rewards(3)), (_responses(4), np.zeros(PROMPTS * N,
                                                                       np.float32)),
                (_responses(5), _rewards(5))]
    whole = _port_run(tmp_path, monkeypatch, "whole", rollouts, 3)
    part = _port_run(tmp_path, monkeypatch, "part", rollouts, 2)
    assert part.state["rollouts"] == 2 and part.state["global_step"] == 1
    resumed = _port_run(tmp_path, monkeypatch, "part", rollouts, 2, resume=True)
    assert [r["index"] for r in resumed.update_log] == [1, 2]
    assert [r["skipped"] for r in resumed.update_log] == [True, False]
    assert resumed.state == whole.state
    for p, t in flatten(whole.trainable).items():
        assert torch.equal(t, flatten(resumed.trainable)[p]), p
    assert resumed.update_log[1]["update_buckets"] == whole.update_log[2]["update_buckets"]


def test_sparse_trainer_runs_the_host_planes(monkeypatch, tmp_path):
    """The sparse loop's calls into the host planes (JAX `sparse_grpo.py`
    from :380): updates trained, skipped, trained with telemetry and the
    lineage ledger on — the trace validates, each trained update is one
    `train.update` span with its kept rows and the skip one `sparse.skip`
    instant, the ledger drops the zero-advantage rows one by one and closes
    the trained indices with `outcome`, the rows carry `perf/*` and
    `health/*`; then a SIGTERM on the skip path commits an emergency
    checkpoint and raises `Preempted`."""
    from nanorlhf_tpu_torch.resilience import Preempted
    from nanorlhf_tpu_torch.telemetry import read_ledger, validate_trace_file

    rollouts = [(_responses(3), _rewards(3)),
                (_responses(4), np.zeros(PROMPTS * N, np.float32)),
                (_responses(5), _rewards(5)),
                (_responses(6), np.zeros(PROMPTS * N, np.float32))]
    _, cfg = _configs(tmp_path, save_steps=0, telemetry=True, lineage=True)
    jmodel = jax_config("qwen_tied", vocab_size=V)
    _, tparams = make_params(jmodel, seed=3)
    tok = ToyTokenizer(V)
    _, ds = _dataset(JaxToyTokenizer(V), tok)
    script = _Script(rollouts)
    monkeypatch.setattr(trollout, "generate", lambda params, config, ids, *a, **k:
                        torch.as_tensor(script.tokens(ids)))
    monkeypatch.setattr(tsg, "forward_token_budget", lambda *a, **k: FORWARD_BUDGET)
    monkeypatch.setattr(tsg, "BACKWARD_BUDGET", BACKWARD_BUDGET)
    tr = tsg.SparseGRPOTrainer(cfg, port_config(jmodel), tok, tparams, ds, script.reward)
    tr.train(3)
    out = str(tmp_path / "port")
    assert validate_trace_file(f"{out}/trace.json") == []
    events = json.load(open(f"{out}/trace.json"))["traceEvents"]
    updates = [e["args"] for e in events if e["name"] == "train.update"]
    assert [u["rollout_index"] for u in updates] == [0, 2]
    assert all(u["kept_rows"] == PROMPTS - 1 for u in updates)
    assert [e["args"]["rollout_index"] for e in events if e["name"] == "sparse.skip"] == [2]
    ledger = list(read_ledger(out))
    zero = [e for e in ledger if e.get("reason") == "sparse_zero_advantage"]
    assert sorted({e["rollout_index"] for e in zero}) == [0, 1, 2]
    assert len([e for e in zero if e["rollout_index"] == 1]) == PROMPTS
    assert [e["rollout_index"] for e in ledger if e["type"] == "outcome"] == [0, 2]
    row = [r for r in _rows(f"{out}/metrics.jsonl") if "episode" in r][-1]
    assert row["perf/model_flops_per_step"] > 0 and "health/verdict" in row
    assert tr.latency.count("latency/reward_s") == 3

    tr.reward_func = lambda *a: (tr._preemption.trigger(), script.reward(*a))[1]
    with pytest.raises(Preempted, match="emergency checkpoint"):
        tr.train(1)
    assert tr.ckpt.latest_step() == 2 and tr.state["rollouts"] == 4
    assert json.load(open(f"{out}/blackbox_2.json"))["reason"] == "preemption"
    tr.close()


def test_greedy_accuracy_eval_matches_jax(monkeypatch):
    """The launcher's accuracy eval: greedy texts of the port's sampler on
    the trainer's device equal to JAX's, and the same accuracy."""
    jmodel = jax_config("qwen_tied", vocab_size=V)
    jparams, tparams = make_params(jmodel, seed=4)
    eval_qa = jr1.synthetic_math_corpus(5, seed=1)
    texts = {"jax": [], "port": []}
    for side, mod in (("jax", jr1), ("port", grpo_r1)):
        real = mod.get_boxed
        monkeypatch.setattr(mod, "get_boxed", lambda t, side=side, real=real:
                            texts[side].append(t) or real(t))
    jfake = type("T", (), dict(tokenizer=JaxToyTokenizer(V), params=jparams,
                               mcfg=jmodel, lora_scale=LORA.scale))()
    fake = type("T", (), dict(tokenizer=ToyTokenizer(V), params=tparams,
                              mcfg=port_config(jmodel), lora_scale=LORA.scale,
                              device=torch.device("cpu")))()
    kw = dict(max_prompt_len=16, eval_response_length=6, use_subprocess=False, batch=3)
    acc_j = jr1.make_accuracy_func(eval_qa, **kw)(jfake)
    acc = grpo_r1.make_accuracy_func(eval_qa, **kw)(fake)
    assert len(texts["port"]) == len(eval_qa)
    assert texts["port"] == texts["jax"]
    assert acc == acc_j


def test_rollout_samples_from_the_int8_view_and_the_rollout_config(monkeypatch, tmp_path):
    """With rollout_quant="int8" and kv_cache_quant="int8" the sparse
    trainer's rollout samples from the int8 view of the base (its LoRA the
    live adapters) under the int8-cache model config, as JAX's
    `_rollout_params()` / `_rollout_mcfg`; scoring and the update keep the
    exact weights and config."""
    _, cfg = _configs(tmp_path, rollout_quant="int8", kv_cache_quant="int8")
    jmodel = jax_config("qwen_tied", vocab_size=V)
    _, tparams = make_params(jmodel, seed=3)
    tok = ToyTokenizer(V)
    _, ds = _dataset(JaxToyTokenizer(V), tok)
    script = _Script([(_responses(6), _rewards(6))])
    seen = []

    def gen(params, config, ids, *a, **k):
        seen.append((params, config))
        return torch.as_tensor(script.tokens(ids))

    monkeypatch.setattr(trollout, "generate", gen)
    real_score = tsg.score_chunk
    scored = []
    monkeypatch.setattr(tsg, "score_chunk", lambda params, ref, mcfg, *a, **k:
                        scored.append((params, mcfg)) or real_score(params, ref, mcfg,
                                                                    *a, **k))
    tr = tsg.SparseGRPOTrainer(cfg, port_config(jmodel), tok, tparams, ds, script.reward)
    try:
        tr.train(1)
        (params, config), = seen
        assert params["layers"]["q_proj"]["kernel_q"].dtype == torch.int8
        assert params["lora"] is tr.params["lora"]
        assert config.kv_cache_quant == "int8" and tr.mcfg.kv_cache_quant == "none"
        assert scored and all(p is tr.params and m is tr.mcfg for p, m in scored)
        assert tr.update_log[0]["kept"] > 0 and not tr.update_log[0]["skipped"]
    finally:
        tr.close()


@pytest.mark.parametrize("fused", [True, False])
def test_budgets_at_8k_rows_match_jax(fused):
    """The scoring and backward token budgets at Qwen2's 151,936-token
    vocabulary on both branches, and the buckets they cut from 8,000-token
    rows: on the naive branch the vocab cap (7,067 tokens) and the backward
    budget (half of it) are narrower than one 8,021-token row, which then
    makes a bucket of its own, as in JAX."""
    from types import SimpleNamespace

    from nanorlhf_tpu.trainer.bucketing import create_batches as jax_create_batches

    vocab = 151936
    fwd = tsg.forward_token_budget(vocab, fused_logprob=fused)
    assert fwd == jsg.forward_token_budget(vocab, fused_logprob=fused)
    fake = SimpleNamespace(mcfg=SimpleNamespace(vocab_size=vocab),
                           cfg=SimpleNamespace(fused_logprob=fused))
    bwd = tsg.SparseGRPOTrainer.backward_budget(fake)
    assert bwd == min(jsg.BACKWARD_BUDGET, fwd // 2)
    assert (fwd, bwd) == ((22 * 2316, 4 * 2316) if fused else (7067, 3533))
    lengths = np.array([8021, 2100, 8021, 1300, 5000, 221, 8021, 700])
    for budget in (fwd, bwd):
        got = tsg.create_batches(lengths, budget)
        assert got == jax_create_batches(lengths, budget)
        assert sorted(i for b in got for i in b) == list(range(len(lengths)))
        assert all(len(b) == 1 for b in got if lengths[b].max() > budget)


def test_toy_prompts_decode_on_every_rank_with_a_token_cache(tmp_path):
    """Two ranks build the r1 prompts over one token cache directory, the
    second after the first wrote it: the toy tokenizer's decode table fills
    only as it encodes, so both must encode and decode the same texts."""
    qa = grpo_r1.synthetic_math_corpus(16)
    cache = str(tmp_path / "token_cache")
    toks = [ToyTokenizer(V), ToyTokenizer(V)]
    dss = [grpo_r1.build_prompt_dataset(qa, t, max_prompt_len=16, cache_dir=cache)
           for t in toks]
    np.testing.assert_array_equal(dss[0].input_ids, dss[1].input_ids)
    texts = [t.batch_decode(ds.input_ids) for t, ds in zip(toks, dss)]
    assert texts[0] == texts[1] and not any("<unk:" in x for x in texts[1])


def test_build_config_matches_jax():
    def norm(cfg):
        d = dataclasses.asdict(cfg)
        d["algo"] = cfg.algo.value
        return d

    assert norm(grpo_r1.build_config()) == norm(jr1.build_config())
    assert norm(grpo_r1.build_config(rollout_spec_k=4)) == norm(
        jr1.build_config(rollout_spec_k=4))
    cut = grpo_r1.r1_card_cut(grpo_r1.build_config())
    assert cut.response_length == 8000 and cut.sample_n == 4
    cut.finalize(1)
    assert cut.batch_size == 8 and cut.local_mini_batch_size == 4


@pytest.mark.parametrize("knob,value", [
    ("mesh", MeshConfig(data=-1, sp=2)),
    ("rollout_ahead", True),
    ("rollout_orchestrator", True),
    ("sampler_logprob_capture", True),
    ("env_name", "python_tool"),
])
def test_unported_knobs_raise(knob, value, tmp_path):
    """Sequence parallelism on one process raises the mesh's ValueError
    (it trains on spawned ranks, `tests/test_torch_sparse_grpo_sp.py`); a
    multi-turn environment is refused with
    JAX's ValueError (the dense trainer drives it); the orchestrator is
    refused by `train()` with JAX's ValueError; rollout_ahead and sampler
    logprob capture are ported and train."""
    _, cfg = _configs(tmp_path)
    setattr(cfg, knob, value)
    jmodel = jax_config("qwen_tied", vocab_size=V)
    _, tparams = make_params(jmodel, seed=3)
    tok = ToyTokenizer(V)
    _, ds = _dataset(JaxToyTokenizer(V), tok)

    def varied(texts, eos):
        return np.asarray([len(x) % 3 for x in texts], np.float32)

    if knob in ("rollout_ahead", "sampler_logprob_capture", "rollout_orchestrator"):
        tr = tsg.SparseGRPOTrainer(cfg, port_config(jmodel), tok, tparams, ds, varied)
        if knob == "rollout_orchestrator":
            with pytest.raises(ValueError, match="^rollout_orchestrator is not supported "
                               "by SparseGRPOTrainer yet: the sparse all-zero-advantage"):
                tr.train(num_updates=1)
            return
        tr.train(num_updates=2)
        assert [r["index"] for r in tr.update_log] == [0, 1]
        assert tr.state["rollouts"] == 2 and tr._stream is None
        if knob == "sampler_logprob_capture":
            # the sampler's logprobs stood for the policy forward: ref-free
            # (r1's kl_coef 0) no scoring bucket runs at all
            done = [r for r in tr.update_log if not r["skipped"]]
            assert tr._ref_free and done
            assert all(r["score_buckets"] == [] for r in done)
        return
    # a multi-turn environment is ported for the dense trainer only: the
    # sparse one refuses it with JAX's ValueError (the paged cache set, so
    # that the dense trainer's own checks pass first)
    refusal = (ValueError, "torchrun")
    if knob == "env_name":
        cfg.env_max_turns, cfg.rollout_page_size = 2, 4
        cfg.env_turn_tokens = cfg.env_obs_budget = cfg.response_length // 4
        refusal = (ValueError, "does not drive multi-turn environments")
    with pytest.raises(refusal[0], match=refusal[1]):
        tsg.SparseGRPOTrainer(cfg, port_config(jmodel), tok, tparams, ds, varied)


def test_launcher_needs_a_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = grpo_r1.r1_card_cut(grpo_r1.build_config())
    cfg.output_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        grpo_r1.main(cfg, num_updates=1)


def test_launcher_trains_on_cpu_when_asked(monkeypatch, tmp_path):
    """`build_trainer` then one update on the CPU: the tiny model, the
    synthetic corpus (the datasets loader refused), the token cache, the
    initial and per-update accuracy eval on two questions, the launcher's
    reward wrapped to plant variance, and a committed checkpoint."""
    def offline(*a, **k):
        raise OSError("offline")

    monkeypatch.setattr(grpo_r1, "_load_hf_dataset", offline)
    cfg = grpo_r1.r1_card_cut(grpo_r1.build_config())
    cfg.sft_model_path = "tiny"
    cfg.output_dir = str(tmp_path / "r1")
    cfg.dataset_cache_dir = str(tmp_path / "r1" / "token_cache")
    cfg.export_hf_dir = None
    cfg.response_length = 8
    cfg.lora_r, cfg.lora_alpha = 4, 8
    tr = grpo_r1.build_trainer(cfg, max_prompt_len=64, eval_response_length=4,
                               device="cpu")
    graded = []
    reward = tr.reward_func

    def planted(texts, ids, tok):
        graded.append(reward(texts, ids, tok))
        return np.random.default_rng(7).random(len(texts)).astype(np.float32)

    tr.reward_func = planted
    _, eval_qa = grpo_r1.load_math_datasets("meta-math/MetaMathQA", "HuggingFaceH4/MATH-500")
    tr.accuracy_func = grpo_r1.make_accuracy_func(eval_qa[:2], max_prompt_len=64,
                                                  eval_response_length=4)
    try:
        state = tr.train(1)
        seen = {"log": tr.update_log, "latest": tr.ckpt.latest_step()}
    finally:
        tr.close()
    assert state["global_step"] == 1 and seen["latest"] == 1
    assert seen["log"][0]["kept"] > 0 and not seen["log"][0]["skipped"]
    assert len(graded) == 1 and float(graded[0].sum()) == 0.0
    rows = _rows(tmp_path / "r1" / "metrics.jsonl")
    assert "initial_accuracy" in rows[0]
    assert "eval_accuracy_new" in rows[-1] and np.isfinite(rows[-1]["loss/policy_avg_new"])
