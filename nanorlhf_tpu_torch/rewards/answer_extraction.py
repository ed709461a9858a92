"""Benchmark-style answer extraction from model completions.

A copy of `nanorlhf_tpu/rewards/answer_extraction.py`.

Capability parity with the vendored Qwen data-processing toolkit
(the reference's `examples/r1-v0/utils/data_processing/
answer_extraction.py:245-330`): per-format extractors that recover a final
answer string from free-form reasoning text. Compact fresh implementation
covering the formats the training/eval paths use.
"""

from __future__ import annotations

import re

from nanorlhf_tpu_torch.rewards.math_grader import get_boxed

_ANSWER_MARKERS = (
    "the answer is:",
    "the answer is",
    "the final answer is",
    "final answer:",
    "answer:",
)

_NUMBER_RE = re.compile(r"-?\d[\d,]*(?:\.\d+)?(?:/\d+)?")


def extract_after_marker(text: str) -> str:
    """Text after the last 'The answer is'-style marker (MetaMathQA format,
    `grpo_r1.py:231-234`)."""
    low = text.lower()
    best = -1
    best_len = 0
    for marker in _ANSWER_MARKERS:
        i = low.rfind(marker)
        if i > best:
            best, best_len = i, len(marker)
    if best == -1:
        return ""
    ans = text[best + best_len:].strip()
    # stop at sentence/line end
    for stop in ("\n", ". ", ".\n"):
        j = ans.find(stop)
        if j != -1:
            ans = ans[:j]
    return ans.strip().rstrip(".")


def extract_last_number(text: str) -> str:
    """Last number in the text (GSM8K-style fallback)."""
    matches = _NUMBER_RE.findall(text)
    return matches[-1].replace(",", "") if matches else ""


def extract_answer(text: str, fmt: str = "auto") -> str:
    """Dispatcher: 'boxed' | 'marker' | 'last_number' | 'auto'
    (boxed → marker → last number)."""
    if fmt == "boxed":
        return get_boxed(text)
    if fmt == "marker":
        return extract_after_marker(text)
    if fmt == "last_number":
        return extract_last_number(text)
    return get_boxed(text) or extract_after_marker(text) or extract_last_number(text)


# ---------------------------------------------------------------------------
# per-benchmark extractors — the reference's dispatch surface
# (`answer_extraction.py:207-338`): each takes (question, reasoning, task)
# ---------------------------------------------------------------------------


def get_all_boxed(text: str) -> list[str]:
    """Every \\boxed{...} in order, brace-matched (exhaust variant of
    get_boxed; `extract_boxed_answers` parity)."""
    out = []
    pos = 0
    while True:
        i = text.find("boxed{", pos)
        if i == -1:
            return out
        body = text[i + len("boxed{"):]
        depth = 1
        for j, ch in enumerate(body):
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    out.append(body[:j].strip())
                    pos = i + len("boxed{") + j
                    break
        else:
            return out  # unbalanced


def _extract_all(reasoning: str) -> list[str]:
    """General answer extraction, exhaust mode (`extract_answer:207-243`):
    'final answer is $X$. I hope' → all boxed → 'he answer is' marker →
    last number; results line-clipped and stripped."""
    preds: list[str] = []
    if "final answer is $" in reasoning and "$. I hope" in reasoning:
        tmp = reasoning.split("final answer is $", 1)[1]
        preds = [tmp.split("$. I hope", 1)[0].strip()]
    elif "boxed" in reasoning:
        preds = get_all_boxed(reasoning)
    elif "he answer is" in reasoning:
        preds = [reasoning.split("he answer is")[-1].strip()]
    else:
        n = extract_last_number(reasoning)
        preds = [n] if n else []
    out = []
    for ans in preds:
        ans = ans.strip().split("\n")[0]
        ans = ans.lstrip(":").rstrip(".").rstrip("/").strip()
        out.append(ans)
    return out


def extract_math_answer(question: str, reasoning: str, task: str) -> list[str]:
    """MATH-style multi-answer extraction (`answer_extraction.py:245-254`):
    'separated by commas' questions split bare comma lists; \\text{and}
    separators split too."""
    answer: list[str] = []
    for ans in _extract_all(reasoning):
        if "separated by commas" in question and all(
            ch not in ans for ch in "()[]"
        ):
            answer.extend(a.strip() for a in ans.split(","))
        elif re.search(r"\\text\{\s*and\s*\}", ans):
            answer.extend(
                a.strip()
                for a in re.sub(r"\\text\{\s*and\s*\}", "[SEP]", ans).split("[SEP]")
            )
        else:
            answer.append(ans.strip())
    return answer


def extract_math_few_shot_cot_answer(question, reasoning, task):
    if "Problem:" in reasoning:
        reasoning = reasoning.split("Problem:", 1)[0]
    return extract_math_answer(question, reasoning, task)


def extract_last_single_answer(question, reasoning, task):
    preds = _extract_all(reasoning)
    return preds[-1] if preds else ""


def extract_gsm_few_shot_cot_answer(question, reasoning, task):
    """Last plain number (`answer_extraction.py:264-271`)."""
    if "Q: " in reasoning:
        reasoning = reasoning.split("Q: ", 1)[0]
    pred = re.findall(r"-?\d+\.?\d*", reasoning)
    return pred[-1] if pred else "[invalid]"


def extract_sat_few_shot_answer(question, reasoning, task):
    """Multiple-choice letter (`answer_extraction.py:294-300`)."""
    if "Problem:" in reasoning:
        reasoning = reasoning.split("Problem:", 1)[0]
    m = re.search(r"the final answer is \(?(?P<ans>[abcd])\)?", reasoning.lower())
    return m.group("ans").upper() if m else "placeholder"


def extract_mmlu_stem(question, reasoning, task):
    if "Problem:" in reasoning:
        reasoning = reasoning.split("Problem:", 1)[0]
    return extract_sat_few_shot_answer(question, reasoning, task)


def extract_ocwcourses_few_shot_answer(question, reasoning, task):
    """'final answer is X. I hope it is correct.' (`:302-311`)."""
    if "Problem:" in reasoning:
        reasoning = reasoning.split("Problem:", 1)[0]
    m = re.search(r"final answer is (?P<ans>.*)\. I hope it is correct\.", reasoning)
    return m.group("ans") if m else "[invalid]"


def extract_agieval_gaokao_mathcloze_few_shot_cot_test(question, reasoning, task):
    if "问题 " in reasoning:
        reasoning = reasoning.split("问题 ", 1)[0]
    if "答案是" in reasoning:
        ans = reasoning.split("答案是", 1)[1].strip()
        ans = ans.split("\n")[0].strip()
        return [ans.strip("$").strip("。").strip()]
    return ["placeholder"]


def extract_agieval_gaokao_mathqa_few_shot_cot_test(question, reasoning, task):
    if "问题 " in reasoning:
        reasoning = reasoning.split("问题 ", 1)[0]
    if "答案是" in reasoning:
        ans = reasoning.split("答案是", 1)[1].strip()
        return ans.split("\n")[0].strip()
    return "placeholder"


def extract_cmath_few_shot_test(question, reasoning, task):
    if "问题：" in reasoning:
        reasoning = reasoning.split("问题：", 1)[0]
    if "答案是" in reasoning:
        ans = reasoning.split("答案是", 1)[1].strip()
        ans = ans.split("\n")[0].strip("：").strip("。")
        nums = re.findall(r"-?\d+\.?\d*", ans)
        return nums[-1] if nums else "[invalid]"
    return extract_last_single_answer(question, reasoning, task)


def extract_minif2f_isabelle(question, reasoning, task):
    if "Informal:" in reasoning:
        reasoning = reasoning.split("Informal:", 1)[0]
    return reasoning.strip()


# task-name → extractor registry; unknown tasks fall back to the general
# last-answer extraction (same shape as the reference's eval dispatch)
_EXTRACTORS = {
    "math": extract_math_answer,
    "math-500": extract_math_answer,
    "math_few_shot": extract_math_few_shot_cot_answer,
    "gsm8k": extract_gsm_few_shot_cot_answer,
    "sat-math": extract_sat_few_shot_answer,
    "sat": extract_sat_few_shot_answer,
    "mmlu-stem": extract_mmlu_stem,
    "mmlu_stem": extract_mmlu_stem,
    "ocwcourses": extract_ocwcourses_few_shot_answer,
    "ocw": extract_ocwcourses_few_shot_answer,
    "agieval-gaokao-mathcloze": extract_agieval_gaokao_mathcloze_few_shot_cot_test,
    "agieval-gaokao-mathqa": extract_agieval_gaokao_mathqa_few_shot_cot_test,
    "cmath": extract_cmath_few_shot_test,
    "minif2f_isabelle": extract_minif2f_isabelle,
}


_EXTRACTOR_PREFIXES = (
    ("math", extract_math_answer),
    ("gsm", extract_gsm_few_shot_cot_answer),
    ("sat", extract_sat_few_shot_answer),
    ("mmlu", extract_mmlu_stem),
    ("ocw", extract_ocwcourses_few_shot_answer),
    ("cmath", extract_cmath_few_shot_test),
    ("minif2f", extract_minif2f_isabelle),
)


def get_extractor(task: str):
    """Benchmark name → extractor, tolerant of spelling variants ('MATH500',
    'gsm8k_test', ...): exact key, then normalized key, then name-prefix
    rules; the general last-answer fallback is LOGGED so a silent dispatch
    miss (graded with the wrong answer shape) is observable."""
    if task in _EXTRACTORS:
        return _EXTRACTORS[task]
    norm = task.strip().lower().replace("_", "-")
    if norm in _EXTRACTORS:
        return _EXTRACTORS[norm]
    compact = norm.replace("-", "")
    for prefix, fn in _EXTRACTOR_PREFIXES:
        if compact.startswith(prefix):
            return fn
    import logging

    from nanorlhf_tpu_torch.utils.logging import warn_once

    warn_once(
        "nanorlhf_tpu_torch.rewards",
        "no benchmark extractor for task %r; using last-answer fallback",
        task, level=logging.INFO,
    )
    return extract_last_single_answer
