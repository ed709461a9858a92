"""The learning-curve harness on the port — the counterpart of
`tools/learning_run.py`: sparse GRPO (the R1-Zero path, `SparseGRPOTrainer`)
climbing a shaped math-format reward from a random-init policy, then, with
`LEARN_BINARY_UPDATES > 0`, the binary r1 reward on the same policy.

    python -m nanorlhf_tpu_torch.entrypoints.learning_run [--device cpu]

No checkpoint or dataset is downloaded: a synthetic arithmetic corpus
(`build_corpus`) goes through the toy tokenizer's chat template, and the
reward is shaped so that a from-scratch policy can climb it:

    reward = digit_density                  (fraction of response tokens that
                                             are digits)
           + 0.5 · has_boxed_format         (emits `\\boxed{...}`)
           + 1.0 · boxed_answer_correct     (exact answer)
           + 0.25 · stopped_with_eos

The second phase swaps in the binary reward (1.0 iff the boxed answer is
exactly right), the regime where most groups tie and the sparse filter
skips the update; the artifact records the skip counts of both phases.
The reward helpers, the corpus and the `LEARN_*` knobs are copies of the
JAX tool's (`tests/test_torch_learning_rewards.py` holds them against it).

Env knobs: LEARN_UPDATES (30), LEARN_BINARY_UPDATES (0), LEARN_MODEL
(small8m | tiny | 1_5b: Qwen2-1.5B's geometry at the toy 512 vocab),
LEARN_PROMPTS (32 per update), LEARN_RESPONSE (64), LEARN_LR (8e-3),
LEARN_TEMP (1.0), LEARN_MAX_OPERAND (50), LEARN_OUT (output/learning).
The run directory is `output/learning_run.<pid>`; the artifact is
`<LEARN_OUT>/learning_curve.json`, with the wall seconds of each phase.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time

import numpy as np


def model_config(name: str):
    """tiny | 1_5b | small8m (the default): the JAX tool's geometries."""
    from nanorlhf_tpu_torch.core.config import ModelConfig

    if name == "tiny":
        return ModelConfig.qwen2_tiny(vocab_size=512)
    if name == "1_5b":
        # Qwen2-1.5B's hidden/layers/heads at the toy 512 vocab: the toy
        # tokenizer's digit share sets the reward's base rate, and at a real
        # vocab every group ties at zero and the sparse filter starves
        return dataclasses.replace(ModelConfig.qwen2_1_5b(), vocab_size=512)
    return dataclasses.replace(
        ModelConfig.qwen2_tiny(vocab_size=512),
        hidden_size=256,
        intermediate_size=688,
        num_hidden_layers=4,
        num_attention_heads=8,
        num_key_value_heads=2,
    )


_BOXED = re.compile(r"\\boxed\{([^{}]*)\}")


def _expected_answer(s: str, answers_by_prompt: dict):
    """Ground truth for the prompt embedded in decoded sample `s` (first
    prompt-substring match wins) — the one matching rule both rewards
    share."""
    for p, a in answers_by_prompt.items():
        if p in s:
            return a
    return None


def make_reward(answers_by_prompt: dict):
    """Shaped r1-style reward (module docstring). `answers_by_prompt` maps
    the prompt text (sans padding) to the ground-truth answer string."""

    def reward(pmt_and_responses, eos_token):
        out = []
        for s in pmt_and_responses:
            # the response is what follows the chat template's generation
            # marker; without one the whole string is scored
            resp = s.split("<assistant>")[-1]
            toks = resp.replace(eos_token, " ").split()
            digits = sum(1 for t in toks if t.strip().isdigit())
            r = digits / max(len(toks), 1)
            m = _BOXED.search(resp)
            if m:
                r += 0.5
                want = _expected_answer(s, answers_by_prompt)
                if want is not None and m.group(1).strip() == want:
                    r += 1.0
            if eos_token in s:
                r += 0.25
            out.append(r)
        return np.asarray(out, np.float32)

    return reward


def make_binary_reward(answers_by_prompt: dict):
    """r1-contract binary reward: 1.0 iff the \\boxed answer is exactly the
    ground truth, else 0.0 — no format shaping, no partial credit."""

    def reward(pmt_and_responses, eos_token):
        out = []
        for s in pmt_and_responses:
            m = _BOXED.search(s.split("<assistant>")[-1])
            want = _expected_answer(s, answers_by_prompt) if m else None
            out.append(1.0 if (want is not None
                               and m.group(1).strip() == want) else 0.0)
        return np.asarray(out, np.float32)

    return reward


def build_corpus(tok, n: int, seed: int, max_operand: int = 50):
    """Arithmetic prompts and their answers. Addends are drawn from
    1..max_operand-1 (floored at 2 so the range is never empty): small
    operands make answers single tokens, so exploration can hit them."""
    rng = np.random.default_rng(seed)
    max_operand = max(2, max_operand)
    texts, answers = [], {}
    for _ in range(n):
        a = int(rng.integers(1, max_operand))
        b = int(rng.integers(1, max_operand))
        q = f"What is {a} plus {b}? Put the answer in \\boxed{{}}."
        texts.append(q)
        answers[q] = str(a + b)
    return texts, answers


def knobs() -> dict:
    """The LEARN_* environment knobs, with the JAX tool's defaults."""
    env = os.environ
    return {
        "updates": int(env.get("LEARN_UPDATES", 30)),
        "binary_updates": int(env.get("LEARN_BINARY_UPDATES", 0)),
        "model": env.get("LEARN_MODEL", "small8m"),
        "prompts": int(env.get("LEARN_PROMPTS", 32)),
        "response": int(env.get("LEARN_RESPONSE", 64)),
        "lr": float(env.get("LEARN_LR", 8e-3)),
        "temperature": float(env.get("LEARN_TEMP", 1.0)),
        "max_operand": int(env.get("LEARN_MAX_OPERAND", 50)),
        "out": env.get("LEARN_OUT", os.path.join("output", "learning")),
    }


def _series(rows: list, shaped_steps: int) -> list:
    return [{"step": r["step"],
             "score": round(r.get("eval_objective/scores_old", 0.0), 4),
             "entropy": round(r.get("policy/entropy_avg_new", 0.0), 3),
             "resp_len": round(r.get("eval_response_length", 0.0), 2),
             "phase": "binary" if r["step"] > shaped_steps else "shaped"}
            for r in rows if "eval_objective/scores_old" in r]


def _mean3(series: list, last: bool) -> float:
    part = series[-3:] if last else series[:3]
    return round(float(np.mean([s["score"] for s in part])), 4) if part else 0.0


def main(device="cuda") -> dict:
    """Build the model, corpus and `SparseGRPOTrainer` on `device`, train the
    shaped phase and the binary phase, write the artifact and return it."""
    import torch

    from nanorlhf_tpu_torch.core.model import init_params
    from nanorlhf_tpu_torch.data.datasets import PromptDataset, _left_pad, encode_texts
    from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
    from nanorlhf_tpu_torch.resilience import Preempted
    from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig
    from nanorlhf_tpu_torch.trainer.optim import flatten
    from nanorlhf_tpu_torch.trainer.sparse_grpo import SparseGRPOTrainer

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("learning_run: device='cuda' but no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    k = knobs()
    mcfg = model_config(k["model"])
    tok = ToyTokenizer(vocab_size=min(4096, mcfg.vocab_size))
    params = init_params(mcfg, 0, torch.bfloat16, device)
    n_params = sum(t.numel() for t in flatten(params).values())

    texts, answers = build_corpus(tok, 256, seed=0, max_operand=k["max_operand"])
    templated = [tok.apply_chat_template([{"role": "user", "content": t}],
                                         tokenize=False, add_generation_prompt=True)
                 for t in texts]
    ids = encode_texts(tok, templated, max_prompt_len=32)
    dataset = PromptDataset(_left_pad(ids, tok.pad_token_id), tok.pad_token_id)

    # a fresh run directory: the metrics logger appends
    run_dir = os.path.join("output", f"learning_run.{os.getpid()}")
    shutil.rmtree(run_dir, ignore_errors=True)
    updates, binary_updates = k["updates"], k["binary_updates"]
    cfg = RLConfig(
        algo=AlgoName.GRPO,
        exp_name="learning-curve",
        output_dir=run_dir,
        response_length=k["response"],
        temperature=k["temperature"],
        top_p=0.95,
        rollout_top_k=0,                 # r1 default: exact nucleus
        sample_n=4,
        kl_coef=0.0,                     # r1: no KL
        learning_rate=k["lr"],
        per_device_train_batch_size=k["prompts"],
        gradient_accumulation_steps=1,
        num_mini_batches=1,
        total_episodes=(updates + binary_updates) * k["prompts"] * 4,
        use_lora=False,                  # full fine-tuning: a random base
        gradient_checkpointing=True,
        save_steps=0,
        report_to="jsonl",
        logging_steps=1,
    )
    trainer = SparseGRPOTrainer(cfg, mcfg, tok, params, dataset, make_reward(answers))
    interrupted = None
    shaped_steps, shaped_skips = None, 0
    seconds = {"shaped": None, "binary": None}
    try:
        t0 = time.perf_counter()
        state = trainer.train(num_updates=updates)
        seconds["shaped"] = time.perf_counter() - t0
        shaped_steps = state["global_step"]
        shaped_skips = state["rollouts"] - shaped_steps
        if binary_updates > 0:
            # the same policy and trainer; only the reward becomes binary
            trainer.reward_func = make_binary_reward(answers)
            t0 = time.perf_counter()
            state = trainer.train(num_updates=binary_updates)
            seconds["binary"] = time.perf_counter() - t0
    except (KeyboardInterrupt, Preempted) as e:
        interrupted = f"{type(e).__name__}: {e}"
        state = trainer.state
        print(f"[learning_run] interrupted ({interrupted}) — writing the "
              f"artifact from {state['global_step']} completed updates")
        if shaped_steps is None:
            shaped_steps = state["global_step"]
            shaped_skips = state["rollouts"] - shaped_steps
            binary_updates = 0
    finally:
        trainer.close()
    shaped_rollouts = shaped_steps + shaped_skips

    rows = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        for line in fh:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    series = _series(rows, shaped_steps)
    shaped_series = [s for s in series if s["phase"] == "shaped"]
    bin_series = [s for s in series if s["phase"] == "binary"]
    # a skip row's raw score mean tells starved-at-zero (all failed) from
    # starved-solved (all right): both groups carry zero advantage
    skip_raw = [{"rollout": r["sparse_skip/rollout_index"],
                 "raw_score_mean": round(r["sparse_skip/raw_score_mean"], 4)}
                for r in rows if "sparse_skip/raw_score_mean" in r]
    artifact = {
        "what": "sparse-GRPO (r1 path) reward curve on nanorlhf_tpu_torch, "
                "shaped math-format reward, from-scratch policy"
                + (" + binary-reward phase (r1 contract)" if binary_updates else ""),
        "device": str(device),
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "model": k["model"],
        "n_params": int(n_params),
        "knobs": k,
        "updates": state["global_step"],
        "episodes": state["episode"],
        "shaped_phase": {"updates_stepped": shaped_steps,
                         "updates_skipped_by_sparse_filter": shaped_skips,
                         "seconds": seconds["shaped"]},
        "reward_first3_avg": _mean3(shaped_series, last=False),
        "reward_last3_avg": _mean3(shaped_series, last=True),
        "series": series,
    }
    if binary_updates > 0:
        attempted = state["rollouts"] - shaped_rollouts
        binary = {
            "updates_attempted": attempted,
            "updates_stepped": state["global_step"] - shaped_steps,
            "updates_skipped_by_sparse_filter": (
                state["rollouts"] - state["global_step"] - shaped_skips),
            "seconds": seconds["binary"],
            "binary_first3_avg": _mean3(bin_series, last=False),
            "binary_last3_avg": _mean3(bin_series, last=True),
        }
        bin_skip = [s["raw_score_mean"] for s in skip_raw
                    if s["rollout"] > shaped_rollouts]
        if bin_skip:
            avg = float(np.mean(bin_skip))
            binary["skipped_raw_score_mean_avg"] = round(avg, 4)
            binary["starvation_mode"] = ("uniformly_failed" if avg < 0.05
                                         else "uniformly_solved" if avg > 0.95
                                         else "mixed_groups")
        artifact["binary_phase"] = binary
    if interrupted:
        artifact["interrupted"] = interrupted
    os.makedirs(k["out"], exist_ok=True)
    path = os.path.join(k["out"], "learning_curve.json")
    with open(path, "w") as fh:
        json.dump(artifact, fh, indent=1)
    print(f"wrote {path}: shaped reward {artifact['reward_first3_avg']:.3f} -> "
          f"{artifact['reward_last3_avg']:.3f} over {shaped_steps} updates "
          f"({n_params / 1e6:.1f}M params, {artifact['device_kind']})"
          + (f"; binary phase {artifact['binary_phase']}" if binary_updates else ""))
    return artifact


if __name__ == "__main__":
    from nanorlhf_tpu_torch.entrypoints.common import device_arg

    main(device_arg("the learning-curve harness (sparse GRPO, shaped then binary reward)"))
