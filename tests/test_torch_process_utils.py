"""The port's copy of the dataset item processors
(`nanorlhf_tpu_torch/data/process_utils.py`) against the JAX package's
(`nanorlhf_tpu/data/process_utils.py`): each case of
`tests/test_process_utils.py`, run through the port, whose every output
(and every refusal) must equal the original's on the same items."""

import pytest

from nanorlhf_tpu.data import process_utils as jpu
from nanorlhf_tpu_torch.data.process_utils import PROCESSORS, get_processor


def process_items(name, items):
    """The port's `process_items`, held equal to the JAX package's on the
    same items (a refusal must be the same exception type)."""
    try:
        want = jpu.process_items(name, [dict(x) for x in items])
    except Exception as e:  # the port must refuse the same way
        with pytest.raises(type(e)):
            _port_process_items(name, items)
        raise
    got = _port_process_items(name, items)
    assert got == want
    return got


def _port_process_items(name, items):
    from nanorlhf_tpu_torch.data.process_utils import process_items as port

    return port(name, [dict(x) for x in items])


def test_gsm8k_strips_calculator_and_boxes_answer():
    (s,) = process_items("gsm8k", [{
        "id": 1,
        "question": "Tom has 3 apples and buys 4 more. How many?",
        "cot": "3 + 4 = <<3+4=7>>7.",
        "answer": "7",
    }])
    assert s["dataset"] == "gsm8k-cot"
    assistant = s["messages"][1]["content"]
    assert "<<" not in assistant and ">>" not in assistant
    assert assistant.endswith("So the answer is $\\boxed{7}$.")
    assert s["answer"] == "7"


def test_gsm8k_decommas_answer():
    (s,) = process_items("gsm8k", [{
        "id": 1, "question": "q", "cot": "c", "answer": "1,234",
    }])
    assert s["answer"] == "1234"


def test_math_extracts_gold_from_solution():
    (s,) = process_items("math", [{
        "id": "m1",
        "problem": "What is 2+2?",
        "solution": "We compute. The final answer is $\\boxed{4}$.",
        "level": "Level 1",
        "type": "Algebra",
        "category": "arith",
    }])
    assert s["answer"] == ["4"]
    assert s["level"] == "Level 1"


def test_math_drops_unextractable_items():
    out = process_items("math", [{
        "id": "m2", "problem": "p", "solution": "no final value stated here",
    }])
    assert out == []


def test_math_solution_reflowed_per_sentence():
    (s,) = process_items("math", [{
        "id": "m3",
        "problem": "p",
        "solution": "First step. Second step. The answer is $\\boxed{1}$.",
    }])
    assistant = s["messages"][1]["content"]
    assert assistant.splitlines()[0] == "First step."
    assert assistant.splitlines()[1] == "Second step."


def test_math_sat_reflows_options():
    (s,) = process_items("math_sat", [{
        "id": 9,
        "question": "Pick one.",
        "options": "A) one B) two C) three",
        "Answer": "B",
    }])
    q = s["messages"][0]["content"]
    assert "(A) one" in q and "(B) two" in q and "(C) three" in q
    assert "right choice" in q
    assert s["answer"] == "B"


def test_mmlu_stem_labels_options():
    (s,) = process_items("mmlu_stem", [{
        "id": 2,
        "question": "Which gas?",
        "options": ["O2", "N2", "CO2", "He"],
        "answer": "A",
    }])
    q = s["messages"][0]["content"]
    assert "(A) O2, (B) N2, (C) CO2, (D) He" in q


def test_mgsm_zh_decommas_in_place():
    (s,) = process_items("mgsm-zh", [{
        "id": 3, "question": "q", "answer": "2,000",
    }])
    assert s["answer"] == "2000"
    assert s["question"] == "q"  # passthrough of other fields


def test_cmath_uses_golden_field():
    (s,) = process_items("cmath", [{
        "id": 4, "question": " q ", "golden": " 1,5 ",
        "grade": 3, "reasoning_step": 2,
    }])
    assert s["answer"] == "15"
    assert s["messages"][0]["content"] == "q"


def test_gaokao_cloze_splits_multi_answer():
    (s,) = process_items("agieval-gaokao-math-cloze", [{
        "id": 5, "question": "fill in", "answer": "1; 2",
    }])
    assert s["answer"] == ["1", "2"]


def test_gaokao_mathqa_reflows_paren_options():
    (s,) = process_items("agieval-gaokao-mathqa", [{
        "id": 6,
        "question": "choose",
        "options": ["(A) 1", "(B) 2"],
        "label": "A",
    }])
    assert s["answer"] == "A"
    assert "A: 1" in s["messages"][0]["content"]


def test_gaokao_mathqa_rejects_malformed_options():
    with pytest.raises(ValueError):
        process_items("agieval-gaokao-mathqa", [{
            "id": 6, "question": "q", "options": ["A) 1"], "label": "A",
        }])


def test_minif2f_wraps_informal_as_comment():
    (s,) = process_items("minif2f-isabelle", [{
        "id": 7,
        "informal_statement": "stmt",
        "informal_proof": "proof",
        "formal_statement": "theorem t: ...",
    }])
    q = s["messages"][0]["content"]
    assert q.startswith("(*### Problem")
    assert q.endswith("Formal:\ntheorem t: ...")


def test_registry_lookup_normalizes_and_raises():
    assert get_processor("GSM8K") is PROCESSORS["gsm8k"]
    assert sorted(PROCESSORS) == sorted(jpu.PROCESSORS)
    with pytest.raises(KeyError):
        get_processor("nope")
    with pytest.raises(KeyError):
        jpu.get_processor("nope")
