"""Multi-benchmark correctness dispatch — `is_correct` over single answers,

A copy of `nanorlhf_tpu/rewards/eval_dispatch.py`.
answer lists, and set unions, plus per-benchmark evaluators.

Capability parity with the vendored Qwen eval script
(the reference's `examples/r1-v0/utils/eval/eval_script.py`):

- `is_correct_item` (`eval_script.py:6-44`): list-vs-list predictions use
  bipartite coverage — every predicted answer must match some ground-truth
  answer AND every ground-truth answer must be matched (multi-part answers
  in any order); strings containing ``\\cup`` split into their union pieces
  and recurse as lists; scalar strings grade by numeric closeness
  (comma-stripped, ``prec`` tolerance), exact match, then the full
  `math_answers_equal` ladder.
- per-benchmark evaluators (`eval_script.py:46-172`): MATH multi-answer
  dedup/truncate, gaokao cloze bracket-aware splitting, gaokao mathqa
  latest-choice-letter, SAT/MMLU case-insensitive letters, OCW
  numeric/equation/expression grading, minif2f passthrough — looked up via
  `get_evaluator(dataset_name)`.
"""

from __future__ import annotations

import re

from nanorlhf_tpu_torch.rewards.math_grader import (
    _numeric_equal,
    _parse_sympy,
    _sympy_equal,
    _try_float,
    math_answers_equal,
    normalize_math_answer,
)


def is_correct_item(pred, answer, prec: float = 1e-3) -> bool:
    if isinstance(pred, list) and isinstance(answer, list):
        pred_matched: set[int] = set()
        ans_matched: set[int] = set()
        for i, p in enumerate(pred):
            for j, a in enumerate(answer):
                if is_correct_item(p, a, prec=prec):
                    pred_matched.add(i)
                    ans_matched.add(j)
        return len(pred_matched) == len(pred) and len(ans_matched) == len(answer)
    if isinstance(pred, str) and isinstance(answer, str):
        if "\\cup" in pred and "\\cup" in answer:
            return is_correct_item(
                pred.split("\\cup"), answer.split("\\cup"), prec=prec
            )
        try:
            if abs(
                float(re.sub(r",", "", pred)) - float(re.sub(r",", "", answer))
            ) < prec:
                return True
        except (ValueError, TypeError):
            pass
        # offline-eval leniency: accept x100/÷100 numeric variants like the
        # reference eval toolkit (`eval_utils.math_equal:195-214`); the live
        # training reward calls math_answers_equal directly and stays strict
        return bool(answer and pred == answer) or math_answers_equal(
            pred, answer, percent_variants=True
        )
    # mixed scalar/list: wrap the scalar (the reference raises; grading a
    # reward must not crash the training loop)
    if isinstance(pred, str):
        return is_correct_item([pred], answer, prec=prec)
    if isinstance(answer, str):
        return is_correct_item(pred, [answer], prec=prec)
    return False


def _dedup_keep_order(xs: list) -> list:
    out = []
    for x in xs:
        if x not in out:
            out.append(x)
    return out


def eval_math(pred, answer, prec: float = 1e-3) -> bool:
    """MATH: dedup repeated answers on both sides, keep only the LAST
    len(answer) predictions (models sometimes box non-answer strings early),
    then bipartite-match (`eval_script.py:46-70`)."""
    if isinstance(pred, str):
        pred = [pred]
    if isinstance(answer, str):
        answer = [answer]  # gold often stored scalar; truncation must run
    if isinstance(pred, list) and isinstance(answer, list):
        answer = _dedup_keep_order(answer)
        pred = _dedup_keep_order(pred)[-len(answer):]
    return is_correct_item(pred, answer, prec=prec)


def _last_str(x) -> str:
    """Coerce a maybe-list to its last string element. The reference asserts
    str and crashes (`eval_script.py:73-74`); a mislabeled dataset row must
    score 0, not abort the eval/reward loop (module no-crash rule)."""
    if isinstance(x, list):
        x = x[-1] if x else ""
    return x if isinstance(x, str) else str(x)


def eval_last_single_answer(pred, answer, prec: float = 1e-3) -> bool:
    """Scalar benchmarks (GSM8K etc., `eval_script.py:72-75`); list inputs
    coerce to their last element (extractors return lists)."""
    return is_correct_item(_last_str(pred), _last_str(answer), prec=prec)


def _split_top_level(piece: str) -> list[str]:
    """Split on ';' anywhere and on ',' outside brackets
    (`eval_script.py:81-99` bracket-counting loop)."""
    out: list[str] = []
    depth = 0
    cur: list[str] = []
    for ch in piece:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == ";" or (ch == "," and depth == 0):
            part = "".join(cur).strip()
            if part:
                out.append(part)
            cur = []
        else:
            cur.append(ch)
    part = "".join(cur).strip()
    if part:
        out.append(part)
    return out


def eval_agieval_gaokao_math_cloze(pred, answer, prec: float = 1e-3) -> bool:
    """Gaokao cloze: split predictions bracket-aware, dedup, keep the last
    len(answer), require IN-ORDER pairwise match (`eval_script.py:77-110`).
    A scalar answer wraps to a one-element list (the reference asserts list
    and would crash; len() on the raw string would count characters)."""
    if isinstance(pred, str):
        pred = [pred]
    if isinstance(answer, str):
        answer = [answer]
    parts: list[str] = []
    for p in pred:
        for part in _split_top_level(p):
            if part not in parts:
                parts.append(part)
    parts = parts[-len(answer):]
    if len(parts) != len(answer):
        return False
    return all(
        is_correct_item(p, a, prec=prec) for p, a in zip(parts, answer)
    )


def eval_agieval_gaokao_mathqa(pred, answer, prec: float = 1e-3) -> bool:
    """Gaokao mathqa: the chosen letter is the one whose FIRST occurrence in
    the joined prediction text is LATEST (`eval_script.py:112-124`)."""
    if isinstance(pred, str):
        pred = [pred]
    pred_str = " ".join(pred)
    tag, idx = None, -1
    for t in "ABCD":
        if t in pred_str and pred_str.index(t) > idx:
            tag, idx = t, pred_str.index(t)
    return tag == _last_str(answer)


def eval_math_sat(pred, answer, prec: float = 1e-3) -> bool:
    """Case-insensitive choice-letter match (`eval_script.py:126-129`)."""
    return _last_str(pred).lower() == _last_str(answer).lower()


eval_mmlu_stem = eval_math_sat  # `eval_script.py:131-132`


_OCW_INVALID = "[invalidanswer]"

# dimension words the OCW answers carry; stripped before numeric parsing
# (`ocwcourses_eval_utils.normalize_numeric:26-57` unit list)
_OCW_UNITS = (
    "eV",
    " \\mathrm{~kg} \\cdot \\mathrm{m} / \\mathrm{s}",
    " kg m/s", "kg*m/s", "kg",
    "m/s", "m / s", "m s^{-1}", "\\text{ m/s}", " \\mathrm{m/s}",
    " \\text{ m/s}",
    "g/mole", "g/mol", "\\mathrm{~g}", "\\mathrm{~g} / \\mathrm{mol}",
    "W", "erg/s", "years", "year", "cm",
)


def _ocw_normalize_numeric(s: str):
    """Strip units, then evaluate to a float; sympy handles latex-ish
    scalars like ``3 \\times 10^{4}``. Returns float or _OCW_INVALID."""
    for unit in _OCW_UNITS:
        s = s.replace(unit, "").strip()
    for maybe_unit in ("m", "s", "cm"):
        s = s.replace("\\mathrm{" + maybe_unit + "}", "")
        s = s.replace("\\mathrm{~" + maybe_unit + "}", "")
        s = s.strip()
    s = s.strip("$").strip()
    v = _try_float(s)
    if v is not None:
        return v
    try:
        expr = _parse_sympy(s.replace("\\times", "*"))
        if expr.is_number:
            return float(expr)
    except Exception:
        pass
    return _OCW_INVALID


def _ocw_numeric_equality(n1: float, n2: float, threshold: float = 0.01) -> bool:
    """Reference parity (`ocwcourses_eval_utils.numeric_equality:69-75`):
    rel_tol 1e-5 closeness on the main path; `threshold` (1% of the mean)
    applies only in the near-zero carve-out. Unlike the reference, exact
    equality always passes (its carve-out grades 0 == 0 and negative pairs
    False — `abs(n1-n2) < threshold*(n1+n2)/2` is never true for a zero or
    negative mean)."""
    import math

    if n1 == n2:
        return True
    if math.isclose(n1, 0.0, abs_tol=1e-8) or math.isclose(
        n2, 0.0, abs_tol=1e-8
    ) or math.isclose(n1 - n2, 0.0, abs_tol=1e-8):
        return abs(n1 - n2) < threshold * abs(n1 + n2) / 2
    return math.isclose(n1, n2, rel_tol=1e-5)


def _ocw_normalize_equation(s: str):
    """Parse an equation string to a canonical sympy Equality, or invalid
    (`ocwcourses_eval_utils.normalize_symbolic_equation:77-97`)."""
    if not isinstance(s, str) or "=" not in s:
        return _OCW_INVALID
    s = s.strip()
    if s.startswith("\\["):
        s = s[2:]
    if s.endswith("\\]"):
        s = s[:-2]
    s = s.replace("\\left(", "(").replace("\\right)", ")")
    s = s.replace("\\\\", "\\").strip("$")
    lhs, _, rhs = s.partition("=")
    try:
        import sympy

        eq = sympy.Eq(_parse_sympy(lhs), _parse_sympy(rhs))
        return sympy.simplify(eq)
    except Exception:
        return _OCW_INVALID


def eval_ocwcourses(pred, answer, prec: float = 1e-3) -> bool:
    """OCW: answer type decides the grader — numeric (unit-stripped, rel_tol
    1e-5 with a 1%-of-mean near-zero carve-out), equation (canonical sympy
    Equality), or tex expression (normalize + symbolic equivalence)
    (`eval_script.py:134-170`)."""
    pred, answer = _last_str(pred), _last_str(answer)
    if not pred:
        return False
    if _try_float(answer) is not None:
        gold = _ocw_normalize_numeric(answer)
        got = _ocw_normalize_numeric(pred)
        if gold == _OCW_INVALID or got == _OCW_INVALID:
            return False
        return _ocw_numeric_equality(got, gold)
    if "=" in answer:
        gold = _ocw_normalize_equation(answer)
        got = _ocw_normalize_equation(pred)
        return gold != _OCW_INVALID and got != _OCW_INVALID and gold == got
    a = normalize_math_answer(pred)
    b = normalize_math_answer(answer)
    return a == b or _numeric_equal(a, b, tol=prec) or _sympy_equal(a, b)


def eval_minif2f_isabelle(pred, answer, prec: float = 1e-3) -> bool:
    """Formal-proof benchmark: correctness is decided by the proof checker
    downstream, not string grading (`eval_script.py:171-172`)."""
    return True


_EVALUATORS = {
    "math-cot": eval_math,
    "math": eval_math,
    "gsm8k-cot": eval_last_single_answer,
    "gsm8k": eval_last_single_answer,
    "cmath": eval_last_single_answer,
    "mgsm-zh": eval_last_single_answer,
    "mgsm_zh": eval_last_single_answer,
    "agieval-gaokao-math-cloze": eval_agieval_gaokao_math_cloze,
    "agieval-gaokao-mathqa": eval_agieval_gaokao_mathqa,
    "math_sat": eval_math_sat,
    "sat": eval_math_sat,
    "mmlu-stem": eval_mmlu_stem,
    "mmlu_stem": eval_mmlu_stem,
    "ocwcourses": eval_ocwcourses,
    "ocw": eval_ocwcourses,
    "minif2f-isabelle": eval_minif2f_isabelle,
}


def get_evaluator(dataset: str):
    """Per-benchmark evaluator lookup; unknown names fall back to the
    generic `is_correct_item` (logged once per name)."""
    key = dataset.strip().lower()
    if key in _EVALUATORS:
        return _EVALUATORS[key]
    from nanorlhf_tpu_torch.utils.logging import warn_once

    warn_once(
        "nanorlhf_tpu_torch.rewards",
        "no per-benchmark evaluator for %r; using generic is_correct_item",
        dataset,
    )
    return is_correct_item
