"""The port's learning-curve harness (`nanorlhf_tpu_torch/entrypoints/
learning_run.py`): its copies of the JAX tool's reward helpers and corpus
(`tools/learning_run.py`), each case of `tests/test_learning_rewards.py`
run through the port and held equal to the tool's output on the same
inputs."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import learning_run as jlr  # noqa: E402

from nanorlhf_tpu_torch.entrypoints import learning_run as tlr  # noqa: E402

EOS = "</s>"


def _prompt(q):
    return f"<user> {q} <assistant>"


def _both(make, answers, texts):
    """The port's reward on `texts`, held equal to the tool's."""
    got = make(tlr)(answers)(texts, EOS)
    np.testing.assert_array_equal(got, make(jlr)(answers)(texts, EOS))
    return got


def test_binary_reward_is_binary():
    q = "What is 2 plus 3? Put the answer in \\boxed{}."
    cases = [
        (_prompt(q) + " \\boxed{5} " + EOS, 1.0),       # exact → 1
        (_prompt(q) + " \\boxed{ 5 } " + EOS, 1.0),     # whitespace stripped
        (_prompt(q) + " \\boxed{6} " + EOS, 0.0),       # wrong → 0
        (_prompt(q) + " the answer is 5 " + EOS, 0.0),  # unboxed → 0
        (_prompt(q) + " 5 5 5 5 5", 0.0),               # digits alone → 0
    ]
    out = _both(lambda m: m.make_binary_reward, {q: "5"}, [s for s, _ in cases])
    np.testing.assert_array_equal(out, [e for _, e in cases])


def test_binary_reward_no_partial_credit():
    """Unlike the shaped reward, format alone must score zero."""
    q = "What is 10 plus 1? Put the answer in \\boxed{}."
    boxed_wrong = _prompt(q) + " \\boxed{99} " + EOS
    assert _both(lambda m: m.make_reward, {q: "11"}, [boxed_wrong])[0] > 0.0
    assert _both(lambda m: m.make_binary_reward, {q: "11"}, [boxed_wrong])[0] == 0.0


def test_shaped_reward_components():
    q = "What is 4 plus 4? Put the answer in \\boxed{}."
    digits_only = _prompt(q) + " 1 2 3 4"
    r_digits = _both(lambda m: m.make_reward, {q: "8"}, [digits_only])[0]
    assert 0.9 <= r_digits <= 1.0  # 4/4 digit tokens
    full = _prompt(q) + " \\boxed{8} " + EOS
    r_full = _both(lambda m: m.make_reward, {q: "8"}, [full])[0]
    assert r_full > r_digits
    assert r_full >= 1.5  # 0.5 format + 1.0 correct + 0.25 eos at least


def test_shaped_scores_response_only():
    """Prompt digits must not leak into the density term."""
    q = "What is 40 plus 41? Put the answer in \\boxed{}."
    no_digit_resp = _prompt(q) + " hello world"
    assert _both(lambda m: m.make_reward, {q: "81"}, [no_digit_resp])[0] == 0.0


@pytest.mark.parametrize("seed,max_operand", [(3, 50), (0, 50), (7, 2), (1, 1)])
def test_build_corpus_answers_consistent(seed, max_operand):
    class Tok:  # build_corpus only threads the tokenizer through
        pass

    texts, answers = tlr.build_corpus(Tok(), 64, seed=seed, max_operand=max_operand)
    assert (texts, answers) == jlr.build_corpus(Tok(), 64, seed=seed,
                                                max_operand=max_operand)
    assert len(texts) == 64
    for t in texts:
        assert t in answers
        a, b = [int(x) for x in t.split("?")[0].split() if x.isdigit()]
        assert answers[t] == str(a + b)


def test_knobs_and_geometries_match_the_tool(monkeypatch):
    """The LEARN_* defaults and the three geometries are the tool's."""
    from nanorlhf_tpu_torch.core.config import ModelConfig

    for k in list(os.environ):
        if k.startswith("LEARN_"):
            monkeypatch.delenv(k)
    kn = tlr.knobs()
    assert (kn["updates"], kn["binary_updates"], kn["model"], kn["prompts"],
            kn["response"], kn["lr"], kn["temperature"], kn["max_operand"]) == (
        30, 0, "small8m", 32, 64, 8e-3, 1.0, 50)
    for name in ("tiny", "1_5b", "small8m"):
        want = {k: v for k, v in vars(jlr.model_config(name)).items()
                if not k.startswith("spmd_")}
        assert vars(tlr.model_config(name)) == want
    assert isinstance(tlr.model_config("1_5b"), ModelConfig)
