"""Vectorized multi-turn environments — the port of `nanorlhf_tpu/envs`.

`Environment.reset/step` is the episode contract; `SingleTurnEnv` lifts
any existing reward callable into it (the degenerate case IS the current
pipeline); `PythonToolEnv` feeds pooled-executor stdout back as
mid-episode observations (both copies of the JAX package's modules);
`run_env_episodes` drives episodes over the port's paged `DecodeSession`
(`envs/rollout.py`, a rewrite on torch).
"""

from nanorlhf_tpu_torch.envs.base import Environment, EnvState, SingleTurnEnv
from nanorlhf_tpu_torch.envs.python_tool import PythonToolEnv, extract_python_block
from nanorlhf_tpu_torch.envs.rollout import run_env_episodes

ENV_REGISTRY = ("single_turn", "python_tool")


def build_env(name: str, reward_func, *, max_turns: int = 1,
              tool_timeout: float = 5.0, eos_token: str = "",
              extractor=None) -> Environment:
    """Construct a named environment around an existing reward callable.

    ``single_turn`` wraps ``reward_func`` one-shot (must have
    ``max_turns == 1``); ``python_tool`` runs fenced ```python blocks as
    mid-episode tools and grades the full transcript with ``reward_func``
    at episode end. The trainer injects ``eos_token`` so reward callables
    keep their ``(pairs, eos_token)`` protocol.
    """
    if name == "single_turn":
        if max_turns != 1:
            raise ValueError(
                f"env 'single_turn' is single-turn by definition; "
                f"env_max_turns={max_turns}")
        env: Environment = SingleTurnEnv(reward_func)
    elif name == "python_tool":
        env = PythonToolEnv(reward_func, max_turns=max_turns,
                            timeout=tool_timeout, extractor=extractor)
    else:
        raise ValueError(f"unknown env {name!r}; known: {ENV_REGISTRY}")
    env.eos_token = eos_token
    return env


__all__ = [
    "Environment",
    "EnvState",
    "SingleTurnEnv",
    "PythonToolEnv",
    "extract_python_block",
    "run_env_episodes",
    "build_env",
    "ENV_REGISTRY",
]
