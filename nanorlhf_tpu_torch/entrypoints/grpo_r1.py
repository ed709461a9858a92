"""R1-Zero launcher — the port of `nanorlhf_tpu/entrypoints/grpo_r1.py`:
sparse GRPO on math reasoning.

A base (non-instruct) model, MetaMathQA training prompts and MATH-500
eval, the binary boxed-answer reward, 8,000-token responses with kl_coef
0.0, and a greedy accuracy eval before training and every `eval_steps`
updates. Without the datasets on disk it falls back to a synthetic
arithmetic corpus, and without the model to random weights in its
geometry (`common.resolve_model`), so the whole sparse path still runs.

`build_config` is the JAX launcher's literal, field for field.
`sequence_parallel > 1`, `rollout_ahead` and the orchestrator are accepted
for parity and make the trainer raise NotImplementedError.

Run (at `r1_card_cut`, 8 prompts × 4 samples, 8,000-token responses):
    python -m nanorlhf_tpu_torch.entrypoints.grpo_r1 [--device cpu]
        [--updates N]
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from nanorlhf_tpu_torch.data.datasets import PromptDataset, _left_pad, _load_hf_dataset
from nanorlhf_tpu_torch.entrypoints.common import _device, resolve_model
from nanorlhf_tpu_torch.rewards import get_boxed, is_correct
from nanorlhf_tpu_torch.sampler.sampler import SamplingParams, generate
from nanorlhf_tpu_torch.trainer.config import AlgoName, MeshConfig, RLConfig
from nanorlhf_tpu_torch.trainer.sparse_grpo import SparseGRPOTrainer

# the reference's math prompt template (`grpo_r1.py:228`)
TEMPLATE = (
    "# Question:\nQUESTION\nPlease reason step by step, and put your final "
    "answer within \\boxed{}.\n# Answer:\n"
)


def build_config(sequence_parallel: int = 1,
                 rollout_ahead: bool = False,
                 rollout_spec_k: int = 0) -> RLConfig:
    """The reference r1 launcher's settings (`grpo_r1.py:92-145`)."""
    cfg = RLConfig(
        algo=AlgoName.GRPO,
        exp_name="grpo-r1-v0",
        sft_model_path="Qwen/Qwen2-1.5B",        # base model
        output_dir="output/grpo-r1-v0",
        response_length=8000,
        kl_coef=0.0,
        temperature=0.9,
        # exact full-vocab nucleus (the reference's untruncated top_p): no
        # top-k pre-trim for a base model at temperature 0.9
        rollout_top_k=0,
        sample_n=4,
        learning_rate=6e-6,
        per_device_train_batch_size=4,
        gradient_accumulation_steps=8,
        num_mini_batches=16,
        total_episodes=250000,
        use_lora=True,
        lora_r=64,
        lora_alpha=16,
        eval_steps=10,
        save_steps=1,
        save_total_limit=8,
        dataset_cache_dir="output/grpo-r1-v0/token_cache",
        export_hf_dir="output/grpo-r1-v0/hf_export",
    )
    cfg.rollout_ahead = rollout_ahead
    cfg.rollout_spec_k = rollout_spec_k
    if sequence_parallel > 1:
        cfg.mesh = MeshConfig(data=-1, sp=sequence_parallel)
    return cfg


def r1_card_cut(cfg: RLConfig) -> RLConfig:
    """The batch one card runs end to end. The launcher's update (4 prompts
    a microbatch × 8 accumulation steps × 16 minibatches = 512 prompts × 4
    samples at 8,000 tokens) needs a KV cache of 2048 rows × 8,021 slots,
    about 500 GB. Cut to 8 prompts × 4 samples (32 decode rows, ~7.8 GB
    of cache): the launcher's 4 prompts a minibatch, num_mini_batches 2,
    gradient_accumulation_steps 1 (the sparse loop packs its backward
    passes by the token budget and never reads it). The response length,
    the widths and the budgets stay the launcher's; eval every update."""
    cfg.gradient_accumulation_steps = 1
    cfg.num_mini_batches = 2
    cfg.eval_steps = 1
    return cfg


# ---------------------------------------------------------------------------
# datasets: MetaMathQA / MATH-500, synthetic arithmetic fallback
# ---------------------------------------------------------------------------


def synthetic_math_corpus(n: int, seed: int = 0):
    """Offline stand-in: single-step arithmetic with known boxed answers."""
    rng = np.random.default_rng(seed)
    qa = []
    for _ in range(n):
        a, b = int(rng.integers(2, 99)), int(rng.integers(2, 99))
        op = rng.choice(["+", "-", "*"])
        ans = {"+": a + b, "-": a - b, "*": a * b}[op]
        qa.append((f"What is {a} {op} {b}?", str(ans)))
    return qa


def load_math_datasets(train_name: str, eval_name: str, limit: int | None = None):
    """(train_qa, eval_qa) as lists of (question, boxed answer), from the
    local HF cache or a local directory (the port's loader never goes
    online); the synthetic corpus when they do not load."""
    try:
        train = _load_hf_dataset(train_name, "train")
        train_qa = []
        for row in train:
            resp = row["response"]
            marker = "The answer is: "
            i = resp.find(marker)
            if i != -1:
                train_qa.append((row["query"], resp[i + len(marker):].strip()))
        ev = _load_hf_dataset(eval_name, "test")
        eval_qa = [(row["problem"], get_boxed(row["solution"])) for row in ev]
        if limit:
            train_qa, eval_qa = train_qa[:limit], eval_qa[: min(limit, 500)]
        return train_qa, eval_qa
    except Exception as e:
        print(f"[offline demo] math datasets unavailable ({type(e).__name__}) — "
              "synthetic arithmetic corpus")
        return synthetic_math_corpus(512), synthetic_math_corpus(64, seed=1)


def build_prompt_dataset(train_qa, tokenizer, max_prompt_len: int = 512,
                         cache_dir: str | None = None):
    """Templated, tokenized, left-padded prompts. `cache_dir` turns on the
    token cache (`data/token_cache.py`) keyed on the corpus, the template,
    the cut and the tokenizer: a relaunch skips tokenizing."""
    ids = None
    cache_path = fp = None
    # a tokenizer whose decode table fills as it encodes (the toy one,
    # `parallel_safe` False) must encode its prompts: from the cache its
    # decode would give `<unk:…>` texts — on one rank of several, graded
    # texts that differ from the others'
    if cache_dir is not None and getattr(tokenizer, "parallel_safe", True):
        from nanorlhf_tpu_torch.data.token_cache import (
            corpus_fingerprint, load_token_cache, save_token_cache, tokenizer_identity)

        corpus_h = hashlib.blake2b(
            "\x1e".join(q for q, _ in train_qa).encode(), digest_size=8).hexdigest()
        fp = corpus_fingerprint(corpus=corpus_h, template=TEMPLATE,
                                max_prompt_len=max_prompt_len,
                                tok=tokenizer_identity(tokenizer))
        cache_path = os.path.join(cache_dir, f"prompts-{fp:016x}.tok")
        ids = load_token_cache(cache_path, fp)
    if ids is None:
        texts = [TEMPLATE.replace("QUESTION", q) for q, _ in train_qa]
        ids = [tokenizer.encode(t)[:max_prompt_len] for t in texts]
        if cache_path is not None:
            save_token_cache(cache_path, ids, fp)
    return PromptDataset(_left_pad(ids, tokenizer.pad_token_id), tokenizer.pad_token_id)


# ---------------------------------------------------------------------------
# reward + accuracy (the r1 protocol)
# ---------------------------------------------------------------------------


def make_r1_reward(train_index: dict, use_subprocess: bool = True):
    """Binary reward through the r1 signature
    `(pmt_and_responses, responses_ids, tokenizer)` (`grpo_r1.py:250-273`):
    1 where the boxed answer grades equal to the question's answer."""

    def reward_func(pmt_and_responses, responses_ids, tokenizer):
        rewards = np.zeros(len(pmt_and_responses), np.float32)
        for i, s in enumerate(pmt_and_responses):
            q_start = len("# Question:\n")
            q_end = s.find("\nPlease reason step by step, and")
            if q_end == -1:
                continue
            question = s[q_start:q_end]
            a_idx = s.find("\n# Answer:\n", q_end)
            if a_idx == -1:
                continue
            solution = s[a_idx + len("\n# Answer:\n"):]
            end = solution.find(tokenizer.eos_token)
            if end != -1:
                solution = solution[:end]
            gt = train_index.get(question)
            if gt is None:
                continue
            if is_correct(get_boxed(solution), gt, use_subprocess=use_subprocess):
                rewards[i] = 1.0
        return rewards

    return reward_func


def make_accuracy_func(eval_qa, max_prompt_len: int = 512,
                       eval_response_length: int = 1024,
                       use_subprocess: bool = True, batch: int = 64):
    """Greedy-decode accuracy on the eval set (`grpo_r1.py:276-341`), on the
    trainer's device."""

    def accuracy_func(trainer) -> float:
        tok = trainer.tokenizer
        texts = [TEMPLATE.replace("QUESTION", q) for q, _ in eval_qa]
        ids = _left_pad([tok.encode(t)[:max_prompt_len] for t in texts], tok.pad_token_id)
        correct = 0
        for i in range(0, len(eval_qa), batch):
            chunk = torch.as_tensor(ids[i:i + batch], dtype=torch.int64,
                                    device=trainer.device)
            out = generate(
                trainer.params, trainer.mcfg, chunk, chunk != tok.pad_token_id,
                torch.Generator(device=trainer.device).manual_seed(0),
                SamplingParams(greedy=True, max_tokens=eval_response_length),
                eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                lora_scale=trainer.lora_scale)
            for row, (_, gt) in zip(out.cpu().numpy(), eval_qa[i:i + batch]):
                text = tok.decode(row, skip_special_tokens=True)
                if is_correct(get_boxed(text), gt, use_subprocess=use_subprocess):
                    correct += 1
        return correct / max(len(eval_qa), 1)

    return accuracy_func


def build_trainer(cfg: RLConfig | None = None, limit: int | None = None,
                  max_prompt_len: int = 512, eval_response_length: int = 1024, *,
                  device="cuda") -> SparseGRPOTrainer:
    """The model, the math data, the reward, the accuracy eval and the
    `SparseGRPOTrainer` over them, on `device`."""
    cfg = cfg or build_config()
    device = _device(device, "grpo_r1.build_trainer")
    mcfg, params, tokenizer = resolve_model(cfg.sft_model_path, cfg.seed,
                                            attention_impl=cfg.attention_impl,
                                            device=device)
    train_qa, eval_qa = load_math_datasets("meta-math/MetaMathQA",
                                           "HuggingFaceH4/MATH-500", limit=limit)
    dataset = build_prompt_dataset(train_qa, tokenizer, max_prompt_len=max_prompt_len,
                                   cache_dir=cfg.dataset_cache_dir)
    return SparseGRPOTrainer(
        cfg, mcfg, tokenizer, params, dataset, make_r1_reward(dict(train_qa)),
        accuracy_func=make_accuracy_func(eval_qa, max_prompt_len=max_prompt_len,
                                         eval_response_length=eval_response_length))


def main(cfg: RLConfig | None = None, limit: int | None = None,
         max_prompt_len: int = 512, eval_response_length: int = 1024, *,
         device="cuda", num_updates: int | None = None) -> dict:
    """`build_trainer`, then train. Returns the trainer state."""
    trainer = build_trainer(cfg, limit, max_prompt_len, eval_response_length,
                            device=device)
    try:
        return trainer.train(num_updates)
    finally:
        trainer.close()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="sparse GRPO, r1 (r1_card_cut)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--updates", type=int, default=1, help="updates to train")
    args = ap.parse_args()
    state = main(r1_card_cut(build_config()), device=args.device,
                 num_updates=args.updates)
    print(f"trained: {state}")
