"""Reward functions — the port of `nanorlhf_tpu/rewards`: the math grader,
answer extraction and the multi-benchmark dispatch (copies of the JAX
package's jax-free modules), and the reward builders."""

from nanorlhf_tpu_torch.rewards.answer_extraction import (
    extract_answer,
    extract_math_answer,
    get_all_boxed,
    get_extractor,
)
from nanorlhf_tpu_torch.rewards.builders import (
    make_binary_math_reward,
    make_rm_reward,
    make_rule_reward,
)
from nanorlhf_tpu_torch.rewards.eval_dispatch import is_correct_item
from nanorlhf_tpu_torch.rewards.math_grader import (
    call_with_timeout,
    get_boxed,
    is_correct,
    math_answers_equal,
    normalize_math_answer,
)

__all__ = [
    "get_boxed",
    "get_all_boxed",
    "normalize_math_answer",
    "math_answers_equal",
    "is_correct",
    "is_correct_item",
    "call_with_timeout",
    "extract_answer",
    "extract_math_answer",
    "get_extractor",
    "make_binary_math_reward",
    "make_rm_reward",
    "make_rule_reward",
]
