"""Reward-function builders — the port of `nanorlhf_tpu/rewards/builders.py`
(the rule-based builder the offline launcher uses).

Protocol: `reward_func(pmt_and_responses: list[str], eos_token: str) ->
array[B]`, host-side.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def make_rule_reward(fn: Callable[[str, str], float]):
    """Lift a per-string scoring fn into the reward protocol."""

    def reward_func(pmt_and_responses, eos_token):
        return np.asarray([fn(s, eos_token) for s in pmt_and_responses], np.float32)

    return reward_func
