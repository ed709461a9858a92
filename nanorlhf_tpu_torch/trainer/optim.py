"""The optimizer of the update — the port of `RLTrainer._build_optimizer`
(`nanorlhf_tpu/trainer/trainer.py:1227-1269`): optax's `multi_transform`
over the trainable tree's groups ("policy", and "value" for PPO's value
model), each group an AdamW with its own learning rate (`learning_rate`,
`value_learning_rate or learning_rate`), its own cosine-to-`min_lr_rate`
schedule (linear warmup first when `warmup_steps > 0`) and, when
`max_grad_norm` is set, its own `clip_by_global_norm` in front: each
group is clipped by its own norm, not by the norm of both.

The update rule is optax's, step for step: m ← b1·m + (1−b1)·g,
v ← b2·v + (1−b2)·g², m̂ = m / (1 − b1^t), v̂ = v / (1 − b2^t),
u = −lr(t−1) · (m̂ / (√v̂ + eps) + wd · p), p ← p + u in f32, cast back to
p's dtype. The schedule is read at the update's own count (0 for the
first). The moments are f32: optax initialises them in the parameter's
dtype but its first update promotes them to f32 (the f32 gradient meets
the bf16 zeros), so from the first step on they agree.

Trees are nested dicts like the parameters; `flatten` turns them into
`{path: tensor}`. The parameters are stepped IN PLACE (JAX returns new
arrays): only the trainable leaves ever change, so a frozen leaf shared
with another tree (the ref model's base weights) never moves.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nanorlhf_tpu_torch.parallel.fsdp import group_norms


def flatten(tree: dict, prefix: tuple = ()) -> dict:
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def cosine_decay(init_value: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(float(count), float(decay_steps))
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cos + alpha)

    return schedule


def lr_schedule(lr: float, total_steps: int, min_lr_rate: float,
                warmup_steps: int = 0):
    """The trainer's schedule: cosine decay from `lr` to `lr·min_lr_rate`
    over `total_steps`, after a linear warmup from 0 when `warmup_steps`
    (optax.warmup_cosine_decay_schedule, whose decay spans the remaining
    `total_steps − warmup_steps`)."""
    if warmup_steps <= 0:
        return cosine_decay(lr, total_steps, min_lr_rate)
    cos = cosine_decay(lr, total_steps - warmup_steps,
                       min_lr_rate if lr != 0.0 else 0.0)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return lr * min(max(count, 0), warmup_steps) / warmup_steps
        return cos(count - warmup_steps)

    return schedule


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: dict   # nested like the trainable leaves, f32
    nu: dict


class AdamW:
    """optax.adamw(schedule, eps, weight_decay), optionally chained after
    clip_by_global_norm(max_grad_norm)."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float | None = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, trainable: dict) -> AdamWState:
        zeros = {p: torch.zeros_like(t, dtype=torch.float32)
                 for p, t in flatten(trainable).items()}
        return AdamWState(0, unflatten(zeros),
                          unflatten({p: z.clone() for p, z in zeros.items()}))

    @torch.no_grad()
    def step(self, trainable: dict, grads: dict, state: AdamWState,
             mesh=None, g_norm: torch.Tensor | None = None) -> AdamWState:
        """One update of `trainable` (in place) from `grads` (f32, same
        tree). Returns the new state; the old one's moments are reused.
        Under an fsdp `mesh` the leaves, the gradients and the moments are
        this rank's shards, and the clip reads the unsharded tree's norm:
        `g_norm` when the caller has it (`parallel.fsdp.group_norms`), else
        computed here."""
        params, g_flat = flatten(trainable), flatten(grads)
        mu, nu = flatten(state.mu), flatten(state.nu)
        if self.max_grad_norm:
            if g_norm is None:
                g_norm = group_norms({None: g_flat}, mesh)[None]
            if not bool(g_norm < self.max_grad_norm):
                g_flat = {p: g / g_norm * self.max_grad_norm
                          for p, g in g_flat.items()}
        count = state.count + 1
        lr = self.schedule(state.count)
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        for path, p in params.items():
            g = g_flat[path].float()
            m, v = mu[path], nu[path]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                u.add_(p.float(), alpha=self.weight_decay)
            p.copy_((p.float() - lr * u).to(p.dtype))
        return AdamWState(count, state.mu, state.nu)


class MultiAdamW:
    """optax.multi_transform labelled by the trainable tree's top-level keys:
    `groups[k]` steps `trainable[k]`. States are `{group: AdamWState}` over
    the groups the tree holds. `mesh`: the leaves are fsdp shards (each
    group's clip reads the unsharded norm)."""

    def __init__(self, groups: dict, mesh=None):
        self.groups = groups
        self.mesh = mesh

    def init(self, trainable: dict) -> dict:
        return {k: self.groups[k].init(v) for k, v in trainable.items()}

    def step(self, trainable: dict, grads: dict, state: dict,
             norms: dict | None = None) -> dict:
        """Each group's step; `norms`: {group: unsharded gradient norm}
        when the caller computed them (`parallel.fsdp.group_norms`)."""
        return {k: self.groups[k].step(v, grads[k], state[k], mesh=self.mesh,
                                       g_norm=None if norms is None else norms[k])
                for k, v in trainable.items()}


def build_optimizer(cfg, mesh=None) -> MultiAdamW:
    """The optimizer of an RLConfig: the policy and value groups (over
    fsdp shards under `mesh`)."""
    total_steps = max(1, cfg.num_total_batches * cfg.num_ppo_epochs
                      * cfg.num_mini_batches)

    def adamw(lr: float) -> AdamW:
        return AdamW(lr_schedule(lr, total_steps, cfg.min_lr_rate, cfg.warmup_steps),
                     eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
                     max_grad_norm=cfg.max_grad_norm)

    return MultiAdamW({"policy": adamw(cfg.learning_rate),
                       "value": adamw(cfg.value_learning_rate or cfg.learning_rate)},
                      mesh=mesh)
