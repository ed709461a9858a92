"""Vectorized environment interface for tool-augmented multi-turn rollouts.

(the port's copy of `nanorlhf_tpu/envs/base.py`.)

The reference's reward layer is single-shot — ``reward_func(prompt +
response, eos_token)`` grades a finished completion and that is the entire
"environment". This module promotes that contract to a real environment
interface (ROADMAP item 4) without breaking it:

- ``Environment.reset(prompts) -> EnvState`` starts one episode per prompt.
- ``Environment.step(state, responses) -> (observations, rewards, done)``
  consumes the model's turn text and returns the environment's reply
  (observation text appended to the context for the next turn), this turn's
  scalar reward, and whether each episode ended.

Both calls are VECTORIZED over episodes; ``step`` additionally takes
``indices`` so the multi-turn driver (envs/rollout.py) can step a single
episode the moment its row hits EOS-of-turn instead of barriering the
batch on the slowest tool.

``SingleTurnEnv`` lifts any existing ``reward_func`` into this interface:
one turn, empty observation, the wrapped callable's score as the terminal
reward. The degenerate case IS the current pipeline — the trainer routes
a single-turn env through the exact same generate + reward-dispatch path
as a bare reward_func, and tests/test_envs.py pins the two bit-identical
(docs/ENVIRONMENTS.md).

Masking contract: tokens the ENVIRONMENT wrote (observations) are not the
policy's actions. The rollout driver records their spans and the trainer
threads a per-token ``loss_mask`` (False on observation tokens) through
``algos/losses.py``'s existing ``mask`` argument, so environment text is
conditioned on but never scored (docs/ENVIRONMENTS.md §masking).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np


@dataclass
class EnvState:
    """Per-episode host-side state. Arrays are indexed by episode.

    ``turn`` counts COMPLETED model turns; ``done`` episodes take no more
    steps; ``transcripts`` accumulates the episode text (model turns +
    observations) so terminal graders can score the whole interaction.
    """

    prompts: list[str]
    turn: np.ndarray
    done: np.ndarray
    transcripts: list[str]
    meta: dict = field(default_factory=dict)

    @classmethod
    def fresh(cls, prompts: Sequence[str]) -> "EnvState":
        n = len(prompts)
        return cls(
            prompts=list(prompts),
            turn=np.zeros(n, np.int32),
            done=np.zeros(n, bool),
            transcripts=[""] * n,
        )


class Environment:
    """Vectorized environment contract (docs/ENVIRONMENTS.md).

    Subclasses override ``reset``/``step``; ``max_turns`` bounds episode
    length (the driver also enforces its own budget). ``eos_token`` is the
    tokenizer's EOS string — injected by the trainer at construction so
    reward callables keep their existing ``(pairs, eos_token)`` protocol.
    """

    max_turns: int = 1
    eos_token: str = ""

    def reset(self, prompts: Sequence[str]) -> EnvState:
        return EnvState.fresh(prompts)

    def step(
        self,
        state: EnvState,
        responses: Sequence[str],
        indices: Optional[Sequence[int]] = None,
    ) -> tuple[list[str], np.ndarray, np.ndarray]:
        """Consume one model turn for the episodes in ``indices`` (None =
        all, in order) and return (observations, rewards, done) aligned
        with ``responses``. Implementations mutate ``state`` in place —
        per-episode slots are disjoint, so concurrent single-index steps
        from the driver's tool threads are safe."""
        raise NotImplementedError

    def as_reward_func(self) -> Callable:
        """A single-turn env back out as ``(pairs, eos_token) -> scores``
        via a real reset/step round trip. The trainer unwraps any
        ``max_turns == 1`` env through this so generation and reward
        dispatch stay on the exact non-env code path (the parity pin)
        while the env machinery is still exercised on every update."""
        if self.max_turns != 1:
            raise ValueError(
                f"as_reward_func() is the single-turn unwrap; "
                f"max_turns={self.max_turns}")

        def fn(pairs, eos_token):
            self.eos_token = eos_token
            st = self.reset([""] * len(pairs))
            _, scores, _ = self.step(st, list(pairs))
            return scores

        return fn


class SingleTurnEnv(Environment):
    """Any ``reward_func`` lifted into the environment interface.

    One turn: the response is graded by the wrapped callable and the
    episode ends — no observation, no continuation. This is the degenerate
    case, pinned bit-identical to the non-env pipeline: the trainer
    unwraps it back into a plain reward callable (``as_reward_func``) so
    generation, reward dispatch (retries, the ``reward.exec`` fault site),
    and every metric stay on the exact code path they were on before
    environments existed.
    """

    max_turns = 1

    def __init__(self, reward_func: Callable):
        self.reward_func = reward_func

    def step(
        self,
        state: EnvState,
        responses: Sequence[str],
        indices: Optional[Sequence[int]] = None,
    ) -> tuple[list[str], np.ndarray, np.ndarray]:
        idx = list(range(len(responses))) if indices is None else list(indices)
        texts = [state.prompts[i] + r for i, r in zip(idx, responses)]
        scores = np.asarray(
            self.reward_func(texts, self.eos_token), np.float32
        )
        for i, r in zip(idx, responses):
            state.transcripts[i] += r
            state.turn[i] += 1
            state.done[i] = True
        return [""] * len(responses), scores, np.ones(len(responses), bool)
