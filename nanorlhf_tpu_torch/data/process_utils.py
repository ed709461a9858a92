"""Per-benchmark dataset item processors.

(the port's copy of `nanorlhf_tpu/data/process_utils.py`.)

Capability parity with the reference's data-processing toolkit
(the reference's `examples/r1-v0/utils/data_processing/process_utils.py:5-158`):
each processor takes one raw benchmark item (a dict in that benchmark's
native schema) and yields zero or more normalized samples:

    {"dataset": <name>, "id": ..., "messages": [{"role","content"}, ...],
     "answer": <str | list[str]>, ...extra benchmark fields}

Processors are host-side, pure-Python generators (an item may be skipped by
yielding nothing — e.g. MATH items whose gold answer fails extraction).
A registry maps benchmark names to processors, mirroring how the reference's
eval scripts pick a processor per `dataset` field.
"""

from __future__ import annotations

import re
from typing import Callable, Iterator

from nanorlhf_tpu_torch.rewards.answer_extraction import extract_math_answer
from nanorlhf_tpu_torch.rewards.math_grader import normalize_math_answer

Sample = dict
Processor = Callable[[dict], Iterator[Sample]]


def process_gsm8k_test(item: dict) -> Iterator[Sample]:
    """GSM8K: strip calculator annotations `<<...>>`, append the boxed
    answer sentence, de-comma the gold answer (ref `process_utils.py:5-15`)."""
    cot = re.sub(r"<<[^<>]*>>", "", item["cot"])
    yield {
        "dataset": "gsm8k-cot",
        "id": item["id"],
        "messages": [
            {"role": "user", "content": item["question"]},
            {
                "role": "assistant",
                "content": cot
                + "\nSo the answer is $\\boxed{"
                + item["answer"].strip()
                + "}$.",
            },
        ],
        "answer": item["answer"].replace(",", ""),
    }


def process_math_test(item: dict) -> Iterator[Sample]:
    """MATH: gold answer extracted from the official solution; items whose
    solution yields no answer are dropped (ref `process_utils.py:17-35`).
    The solution text is re-wrapped one sentence per line."""
    question = item["problem"]
    try:
        answer = extract_math_answer(question, item["solution"], task="cot")
    except Exception:
        return
    if not answer:
        return
    yield {
        "dataset": "math-cot",
        "id": item["id"],
        "level": item.get("level"),
        "type": item.get("type"),
        "category": item.get("category"),
        "messages": [
            {"role": "user", "content": question},
            {
                "role": "assistant",
                "content": "\n".join(
                    re.split(r"(?<=\.) (?=[A-Z])", item["solution"])
                ),
            },
        ],
        "answer": answer,
    }


def process_math_sat(item: dict) -> Iterator[Sample]:
    """SAT-math: reflow 'A) ... B) ...' options into '(A) ... (B) ...' and
    append the choice prompt (ref `process_utils.py:37-55`)."""
    options = item["options"].strip()
    if not options.startswith("A"):
        raise ValueError(f"SAT options must start with 'A': {options[:20]!r}")
    options = "(" + options
    for ch in "BCDEFG":
        options = re.sub(rf" {ch}\) ", f" ({ch}) ", options)
    question = (
        f"{item['question'].strip()}\n"
        "What of the following is the right choice? Explain your answer.\n"
        f"{options.strip()}"
    )
    yield {
        "dataset": "math_sat",
        "id": item["id"],
        "language": "en",
        "messages": [
            {"role": "user", "content": question},
            {"role": "assistant", "content": item["Answer"]},
        ],
        "answer": item["Answer"],
    }


def process_ocwcourses(item: dict) -> Iterator[Sample]:
    """OCW Courses (ref `process_utils.py:57-69`)."""
    yield {
        "dataset": "OCWCourses",
        "id": item["id"],
        "language": "en",
        "messages": [
            {"role": "user", "content": item["problem"].strip()},
            {"role": "assistant", "content": item["solution"].strip()},
        ],
        "answer": item["answer"],
    }


def process_mmlu_stem(item: dict) -> Iterator[Sample]:
    """MMLU-STEM: label the four options (A)-(D) and append the choice
    prompt (ref `process_utils.py:71-89`)."""
    options = [
        f"({label}) {str(option).strip()}"
        for label, option in zip("ABCD", item["options"])
    ]
    question = (
        f"{item['question'].strip()}\n"
        "What of the following is the right choice? Explain your answer.\n"
        f"{', '.join(options)}"
    )
    yield {
        "dataset": "MMLU-STEM",
        "id": item["id"],
        "language": "en",
        "messages": [
            {"role": "user", "content": question},
            {"role": "assistant", "content": item["answer"]},
        ],
        "answer": item["answer"],
    }


def process_mgsm_zh(item: dict) -> Iterator[Sample]:
    """MGSM-zh: de-comma the numeric answer in place (ref
    `process_utils.py:91-93`)."""
    out = dict(item)
    out["answer"] = out["answer"].replace(",", "")
    yield out


def process_cmath(item: dict) -> Iterator[Sample]:
    """CMATH (ref `process_utils.py:95-107`)."""
    yield {
        "dataset": "cmath",
        "id": item["id"],
        "grade": item.get("grade"),
        "reasoning_step": item.get("reasoning_step"),
        "messages": [
            {"role": "user", "content": item["question"].strip()},
            {"role": "assistant", "content": ""},
        ],
        "answer": item["golden"].strip().replace(",", ""),
    }


def process_agieval_gaokao_math_cloze(item: dict) -> Iterator[Sample]:
    """Gaokao math cloze: multi-answer gold split on ';' and normalized
    (ref `process_utils.py:109-119`)."""
    yield {
        "dataset": "agieval-gaokao-math-cloze",
        "id": item["id"],
        "messages": [
            {"role": "user", "content": item["question"].strip()},
            {"role": "assistant", "content": ""},
        ],
        "answer": [
            normalize_math_answer(ans)
            for ans in item["answer"].strip().split(";")
        ],
    }


def process_agieval_gaokao_mathqa(item: dict) -> Iterator[Sample]:
    """Gaokao mathqa: options arrive as '(A)...'; reflow to 'A: ...'
    (ref `process_utils.py:121-141`)."""
    question = item["question"].strip()
    options = []
    for option in item["options"]:
        option = option.strip()
        if len(option) < 4 or not (
            option[0] == "(" and option[2] == ")" and option[1] in "ABCD"
        ):
            raise ValueError(f"malformed gaokao option: {option[:10]!r}")
        options.append(f"{option[1]}: {option[3:].strip()}")
    # the reference interpolates the Python list (its prompt literally shows
    # "['A: 1', ...]", `process_utils.py:133`) — joined cleanly here
    yield {
        "dataset": "agieval-gaokao-mathqa",
        "id": item["id"],
        "messages": [
            {"role": "user", "content": f"{question}\n{' '.join(options)}"},
            {"role": "assistant", "content": ""},
        ],
        "answer": item["label"],
    }


def process_agieval_gaokao_mathqa_few_shot_cot_test(
    item: dict,
) -> Iterator[Sample]:
    """Gaokao mathqa few-shot variant: Chinese choice prompt, options joined
    inline (ref `process_utils.py:143-156`)."""
    question = item["question"].strip().rstrip("\\")
    options = " ".join(opt.strip() for opt in item["options"])
    yield {
        "dataset": "agieval-gaokao-mathqa",
        "id": item["id"],
        "messages": [
            {
                "role": "user",
                "content": f"{question}\n从以下选项中选择:    {options}",
            },
            {"role": "assistant", "content": ""},
        ],
        "answer": item["label"],
    }


def process_minif2f_isabelle(item: dict) -> Iterator[Sample]:
    """miniF2F (Isabelle): wrap the informal statement+proof as a comment
    above the formal statement (ref `process_utils.py:158-169`)."""
    question = (
        f"(*### Problem\n\n{item['informal_statement'].strip()}\n\n"
        f"### Solution\n\n{item['informal_proof'].strip()} *)\n\n"
        f"Formal:\n{item['formal_statement'].strip()}"
    )
    yield {
        "dataset": "minif2f-isabelle",
        "id": item["id"],
        "messages": [
            {"role": "user", "content": question},
            {"role": "assistant", "content": ""},
        ],
        "answer": "placeholder",
    }


PROCESSORS: dict[str, Processor] = {
    "gsm8k": process_gsm8k_test,
    "gsm8k-cot": process_gsm8k_test,
    "math": process_math_test,
    "math-cot": process_math_test,
    "math_sat": process_math_sat,
    "sat": process_math_sat,
    "ocwcourses": process_ocwcourses,
    "ocw": process_ocwcourses,
    "mmlu_stem": process_mmlu_stem,
    "mmlu-stem": process_mmlu_stem,
    "mgsm-zh": process_mgsm_zh,
    "mgsm_zh": process_mgsm_zh,
    "cmath": process_cmath,
    "agieval-gaokao-math-cloze": process_agieval_gaokao_math_cloze,
    "agieval-gaokao-mathqa": process_agieval_gaokao_mathqa,
    "agieval-gaokao-mathqa-few-shot": (
        process_agieval_gaokao_mathqa_few_shot_cot_test
    ),
    "minif2f-isabelle": process_minif2f_isabelle,
}


def get_processor(name: str) -> Processor:
    """Look up a benchmark item processor by (normalized) dataset name."""
    key = name.strip().lower()
    if key in PROCESSORS:
        return PROCESSORS[key]
    raise KeyError(
        f"no dataset processor for {name!r}; known: {sorted(set(PROCESSORS))}"
    )


def process_items(name: str, items: list[dict]) -> list[Sample]:
    """Run a benchmark's processor over raw items, flattening the yields."""
    proc = get_processor(name)
    out: list[Sample] = []
    for item in items:
        out.extend(proc(item))
    return out
