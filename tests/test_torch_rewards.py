"""The port's copies of the r1 reward stack (`rewards/math_grader.py`,
`answer_extraction.py`, `eval_dispatch.py`, `builders.
make_binary_math_reward`) against the JAX package's, on the golden,
strictness and benchmark-dispatch cases of the JAX package's own tests,
each a case of its own; and the copies' subprocess reaping and forkserver
preload naming the port's modules."""

import multiprocessing

import numpy as np
import pytest

from nanorlhf_tpu.rewards import answer_extraction as jae
from nanorlhf_tpu.rewards import builders as jbuilders
from nanorlhf_tpu.rewards import eval_dispatch as jed
from nanorlhf_tpu.rewards import math_grader as jmg
from nanorlhf_tpu_torch import rewards as trewards
from nanorlhf_tpu_torch.rewards import answer_extraction as tae
from nanorlhf_tpu_torch.rewards import builders as tbuilders
from nanorlhf_tpu_torch.rewards import eval_dispatch as ted
from nanorlhf_tpu_torch.rewards import math_grader as tmg
from test_grader_golden import EQUIV_GOLDEN


@pytest.mark.parametrize("pred,gt,want", EQUIV_GOLDEN)
def test_golden_equivalence_matches_jax(pred, gt, want):
    assert tmg.math_answers_equal(pred, gt) is jmg.math_answers_equal(pred, gt) is want
    assert tmg.is_correct(pred, gt, use_subprocess=False) is \
        jmg.is_correct(pred, gt, use_subprocess=False)


# (function name, args, kwargs) of the strictness and dispatch tests
# (test_grader_strictness.py, test_grader_golden.py,
# test_eval_dispatch_benchmarks.py)
GRADER_CASES = [
    ("math_answers_equal", ("0.5", "50"), {}),
    ("math_answers_equal", ("50", "0.5"), {}),
    ("math_answers_equal", ("1234", "12.34"), {}),
    ("math_answers_equal", ("50%", "0.5"), {}),
    ("math_answers_equal", ("0.5", "50\\%"), {}),
    ("math_answers_equal", ("(1,2)\\cup(3,4)", "(3,4)\\cup(1,2)"), {}),
    ("math_answers_equal", ("(1,2)\\cup(3,4)", "(1,2)"), {}),
    ("math_answers_equal", ("5\\neq x", "x \\neq 5"), {}),
    ("math_answers_equal", ("x \\neq 5", "x \\neq 6"), {}),
    ("math_answers_equal", ("x \\neq 5", "x = 5"), {}),
    ("math_answers_equal", ("\\{(1,2),(3,4)\\}", "\\{(1,4),(3,2)\\}"), {}),
    ("math_answers_equal", ("\\{(1,2),(3,4)\\}", "\\{(3,4),(1,2)\\}"), {}),
    ("math_answers_equal", ("\\{1\\}\\cup\\{2\\}", "\\{2\\}\\cup\\{1\\}"), {}),
    ("math_answers_equal", ("\\{[1,2],[3,4]\\}", "\\{[1,4],[3,2]\\}"), {}),
    ("is_correct", ("0.5", "50"), {"use_subprocess": False}),
    ("is_correct", ("50", "50"), {"use_subprocess": False}),
    ("is_correct", ("", "50"), {"use_subprocess": False}),
    ("get_boxed", ("so \\boxed{\\frac{1}{2}} and more",), {}),
    ("get_boxed", ("no box here",), {}),
    ("get_boxed", ("\\boxed{a{b}c} then \\boxed{7}",), {}),
]
DISPATCH_CASES = [
    ("is_correct_item", ("0.5", "50"), {}),
    ("is_correct_item", ("50", "0.5"), {}),
    ("is_correct_item", ("(1,2)\\cup(3,4)", "(3,4)\\cup(1,2)"), {}),
    ("is_correct_item", (["1", "2"], ["2", "1"]), {}),
    ("is_correct_item", (["1"], ["1", "2"]), {}),
    ("is_correct_item", (["1", "3"], ["1", "2"]), {}),
    ("is_correct_item", ("0.5", "\\frac{1}{2}"), {}),
    ("is_correct_item", ("42", "41"), {}),
    ("is_correct_item", ("3.14159", "3.1414"), {"prec": 1e-3}),
    ("is_correct_item", ("1,000", "1000"), {}),
    ("eval_math", (["7", "2", "3"], ["2", "3", "3"]), {}),
    ("eval_math", (["3", "2"], ["2", "3"]), {}),
    ("eval_math", (["2"], ["2", "3"]), {}),
    ("eval_math", ("4", ["4"]), {}),
    ("eval_agieval_gaokao_math_cloze", (["(1,2); 5"], ["(1,2)", "5"]), {}),
    ("eval_agieval_gaokao_math_cloze", (["5; (1,2)"], ["(1,2)", "5"]), {}),
    ("eval_agieval_gaokao_math_cloze", (["9; 1; 2"], ["1", "2"]), {}),
    ("eval_agieval_gaokao_math_cloze", ("12", "12"), {}),
    ("eval_agieval_gaokao_mathqa", (["A is wrong, B is right"], "B"), {}),
    ("eval_agieval_gaokao_mathqa", (["no idea"], "A"), {}),
    ("eval_math_sat", ("b", "B"), {}),
    ("eval_math_sat", (["C", "A"], "a"), {}),
    ("eval_math_sat", ([], "A"), {}),
    ("eval_ocwcourses", ("3.0 m/s", "3"), {}),
    ("eval_ocwcourses", ("100.0000001", "100"), {}),
    ("eval_ocwcourses", ("102", "100"), {}),
    ("eval_ocwcourses", ("-5.00000001", "-5"), {}),
    ("eval_ocwcourses", ("3 \\times 10^{4}", "30000"), {}),
    ("eval_ocwcourses", ("y = x + 1", "y = 1 + x"), {}),
    ("eval_ocwcourses", ("\\frac{1}{2}", "0.5"), {}),
    ("eval_ocwcourses", ("", "3"), {}),
    ("eval_minif2f_isabelle", ("anything", "x"), {}),
]
EXTRACT_CASES = [
    ("extract_math_answer", ("q", "First \\boxed{3} then later \\boxed{\\frac{1}{2}}.",
                             "math")),
    ("extract_math_answer", ("Find all roots, separated by commas.",
                             "The answer is \\boxed{1, 2, 3}", "math")),
    ("extract_math_answer", ("q", "\\boxed{3 \\text{ and } 5}", "math")),
    ("extract_gsm_few_shot_cot_answer", ("q", "So 4 + 5 = 9 dollars total.", "gsm8k")),
    ("extract_gsm_few_shot_cot_answer", ("q", "The total is 12 dollars.\nQ: next 99",
                                         "gsm8k")),
    ("extract_sat_few_shot_answer", ("q", "Therefore the final answer is (B).", "sat")),
    ("extract_sat_few_shot_answer", ("q", "no choice given", "sat")),
    ("extract_ocwcourses_few_shot_answer",
     ("q", "Thus the final answer is 42. I hope it is correct.", "ocw")),
    ("extract_cmath_few_shot_test", ("q", "所以答案是 42。", "cmath")),
    ("extract_agieval_gaokao_mathcloze_few_shot_cot_test",
     ("q", "答案是$\\frac{1}{2}$", "gaokao")),
    ("extract_answer", ("The answer is \\boxed{5}.",)),
    ("get_all_boxed", ("\\boxed{1} and \\boxed{2}",)),
]


@pytest.mark.parametrize("name,args,kw", GRADER_CASES)
def test_grader_cases_match_jax(name, args, kw):
    assert getattr(tmg, name)(*args, **kw) == getattr(jmg, name)(*args, **kw)


@pytest.mark.parametrize("name,args,kw", DISPATCH_CASES)
def test_dispatch_cases_match_jax(name, args, kw):
    assert getattr(ted, name)(*args, **kw) == getattr(jed, name)(*args, **kw)


@pytest.mark.parametrize("name,args", EXTRACT_CASES)
def test_extraction_cases_match_jax(name, args):
    assert getattr(tae, name)(*args) == getattr(jae, name)(*args)


@pytest.mark.parametrize("task", ["math", "MATH500", "gsm8k_test", "sat-math", "ocw",
                                  "unknown-task"])
def test_extractor_and_evaluator_registries_match_jax(task):
    text = "The answer is \\boxed{7}, so = 3 apples; the final answer is (a)"
    assert tae.get_extractor(task)("q", text, task) == \
        jae.get_extractor(task)("q", text, task)
    assert ted.get_evaluator(task).__name__ == jed.get_evaluator(task).__name__


def test_is_correct_through_the_forked_grader_matches_jax():
    for pred, gt, want in EQUIV_GOLDEN[:4]:
        assert tmg.is_correct(pred, gt, timeout=5.0) is \
            jmg.is_correct(pred, gt, timeout=5.0) is want


def test_forkserver_preloads_the_ports_module(monkeypatch):
    seen = {}

    class Ctx:
        def set_forkserver_preload(self, names):
            seen["names"] = names

    monkeypatch.setenv("NANORLHF_GRADER_START_METHOD", "forkserver")
    monkeypatch.setattr(tmg, "_GRADER_CTX", None)
    monkeypatch.setattr(multiprocessing, "get_context", lambda method: Ctx())
    tmg._grader_context()
    assert "nanorlhf_tpu_torch.rewards.math_grader" in seen["names"]
    assert not any(n.startswith("nanorlhf_tpu.") for n in seen["names"])


def test_a_timed_out_grade_is_reaped_by_the_ports_procs(monkeypatch):
    reaped = []
    from nanorlhf_tpu_torch.resilience import procs

    real = procs.reap_process
    monkeypatch.setattr(procs, "reap_process", lambda p: reaped.append(p) or real(p))
    assert tmg.call_with_timeout(_sleep_worker, timeout=0.05) is False
    assert len(reaped) == 1 and not reaped[0].is_alive()


def _sleep_worker(q):
    import time

    time.sleep(30)
    q.put(True)


def test_binary_math_reward_matches_jax():
    index = {"What is 2 + 3?": "5", "What is 1/2?": "0.5"}
    texts = ["Q: What is 2 + 3?|A: \\boxed{5}</s>", "Q: What is 2 + 3?|A: \\boxed{6}",
             "Q: What is 1/2?|A: \\boxed{\\frac{1}{2}}", "Q: unknown|A: \\boxed{1}",
             "Q: What is 1/2?|A: no box"]

    def question(s):
        return s[3:s.index("|")]

    def solution(s, eos):
        return s[s.index("|A: ") + 4:].split(eos)[0]

    kw = dict(use_subprocess=False)
    got = tbuilders.make_binary_math_reward(index, question, solution, **kw)(texts, "</s>")
    want = jbuilders.make_binary_math_reward(index, question, solution, **kw)(texts, "</s>")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0, 1, 0, 0])
    assert set(trewards.__all__) == set(__import__("nanorlhf_tpu.rewards",
                                                   fromlist=["__all__"]).__all__)
