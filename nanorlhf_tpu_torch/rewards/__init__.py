"""Reward functions — the port of `nanorlhf_tpu/rewards`: the math grader,
answer extraction, the multi-benchmark dispatch and the pooled Python
executor (copies of the JAX package's jax-free modules), and the reward
builders.

The builders import torch, so they load on first use (`__getattr__`): a
process that imports only the grader or the executor — the pooled
executor's spawned worker, which re-imports this package at every spawn —
does not pay for torch."""

from nanorlhf_tpu_torch.rewards.answer_extraction import (
    extract_answer,
    extract_math_answer,
    get_all_boxed,
    get_extractor,
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

_BUILDERS = ("make_binary_math_reward", "make_rm_reward", "make_rule_reward")


def __getattr__(name):
    if name in _BUILDERS:
        from nanorlhf_tpu_torch.rewards import builders

        return getattr(builders, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
