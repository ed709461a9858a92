"""Python-tool environment: mid-episode code execution as observations.

(the port's copy of `nanorlhf_tpu/envs/python_tool.py`.)

The reference's r1 tooling only ever runs model-emitted Python as a
*grader* after the episode ends (`rewards/python_executor.py`). Here the
same executor becomes a mid-episode TOOL: a turn that ends with a fenced
```python block pauses generation, the snippet runs in the pooled
subprocess executor, and its stdout (or traceback) comes back as the next
turn's observation text — the model continues from a context that now
contains real execution results.

Executor pooling matters here: the spawn-context bootstrap fence from the
original ``PythonExecutor`` costs seconds PER SPAWN, which a grader pays
once per sample but a tool would pay once per TURN. ``PooledPythonExecutor``
keeps one warm worker process across turns (same terminate→kill escalation
on timeout), so steady-state tool calls cost milliseconds.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Sequence

import numpy as np

from nanorlhf_tpu_torch.envs.base import Environment, EnvState
from nanorlhf_tpu_torch.rewards.python_executor import PooledPythonExecutor

_CODE_RE = re.compile(r"```python\s(.*?)```", re.DOTALL)


def extract_python_block(text: str) -> Optional[str]:
    """Last fenced ```python block in ``text``, or None. The LAST block is
    the tool call the turn ends on — earlier blocks are quoted context."""
    blocks = _CODE_RE.findall(text)
    return blocks[-1].strip() if blocks else None


class PythonToolEnv(Environment):
    """Tool-augmented episodes over the pooled Python executor.

    A turn whose text contains a ```python block (and turns remain) gets
    the snippet's stdout back as a fenced ```output observation and the
    episode continues; otherwise the episode ends and ``reward_func``
    (the unchanged ``(pairs, eos_token)`` protocol) grades the FULL
    transcript — prompt, every model turn, every observation. Intermediate
    turns earn 0 reward; per-turn credit assignment happens in
    ``algos.advantages`` from the turn-end positions the driver records.

    ``extractor`` overrides the fenced-block regex for prompt formats with
    a different tool-call grammar (it returns the snippet string or None).
    A tool failure — nonzero-exit snippet, timeout, or an injected
    ``env.crash`` fault absorbed by the driver — still produces an
    observation (the error text), never a crashed rollout.
    """

    def __init__(
        self,
        reward_func: Optional[Callable] = None,
        max_turns: int = 2,
        timeout: float = 5.0,
        executor=None,
        extractor: Optional[Callable[[str], Optional[str]]] = None,
        obs_chars: int = 512,
    ):
        if max_turns < 1:
            raise ValueError(f"max_turns={max_turns}")
        self.reward_func = reward_func
        self.max_turns = max_turns
        self.extractor = extractor or extract_python_block
        self.obs_chars = obs_chars
        self.executor = (
            executor if executor is not None
            else PooledPythonExecutor(timeout=timeout)
        )

    def reset(self, prompts: Sequence[str]) -> EnvState:
        return EnvState.fresh(prompts)

    def _terminal_reward(self, state: EnvState, i: int) -> float:
        if self.reward_func is None:
            return 0.0
        score = self.reward_func(
            [state.prompts[i] + state.transcripts[i]], self.eos_token
        )
        return float(np.asarray(score).reshape(-1)[0])

    def step(
        self,
        state: EnvState,
        responses: Sequence[str],
        indices: Optional[Sequence[int]] = None,
    ) -> tuple[list[str], np.ndarray, np.ndarray]:
        idx = list(range(len(responses))) if indices is None else list(indices)
        obs_out: list[str] = []
        rewards = np.zeros(len(responses), np.float32)
        done = np.zeros(len(responses), bool)
        for k, (i, resp) in enumerate(zip(idx, responses)):
            state.transcripts[i] += resp
            turn = int(state.turn[i]) + 1
            code = self.extractor(resp)
            if code is not None and turn < self.max_turns:
                res = self.executor.run(code)
                text = (res.stdout if res.ok else (res.error or res.stdout))
                text = (text or "").strip()[: self.obs_chars]
                obs = f" ```output {text} ``` "
                state.transcripts[i] += obs
                obs_out.append(obs)
            else:
                obs_out.append("")
                done[k] = True
                state.done[i] = True
                rewards[k] = self._terminal_reward(state, i)
            state.turn[i] = turn
        return obs_out, rewards, done

    def close(self):
        self.executor.close()
