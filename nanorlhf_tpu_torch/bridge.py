"""Numpy bridge between the JAX parameter tree and the port's parameters.

The JAX tree (`nanorlhf_tpu.core.model.init_params` + `core.lora`) holds
projection kernels `[L, in, out]` (x @ W), `lm_head` `[D, V]`, and LoRA
`a: [L, in, r]`, `b: [L, r, out]`. The port keeps the same names and the
stacked layout in torch's nn.Linear orientation: kernels `[L, out, in]`,
`lm_head` `[V, D]`, `a: [L, r, in]`, `b: [L, out, r]`. Everything else
(embeddings, norms, biases, and a value model's score head `score`, kept
`[D, num_labels]` as in JAX) is laid out identically. An int8 rollout
tree's `kernel_q` transposes like a kernel; its `kernel_scale` is
`[L, 1, out]` in both (`core/quant.py`).

Both functions take and return nested dicts: parameters, or any tree laid
out like them by leaf name (gradients, the optimizer's Adam moments), so
the tests compare the port's update with the JAX trainer's in one layout.
`params_from_numpy` takes numpy arrays (`jax.tree.map(np.asarray,
params)`); this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# leaves whose last two axes swap between the two layouts
_TRANSPOSED = ("kernel", "kernel_q", "lm_head", "a", "b")


def _convert(tree, fn, name=None):
    if isinstance(tree, dict):
        return {k: _convert(v, fn, k) for k, v in tree.items()}
    return fn(tree, name in _TRANSPOSED)


def params_from_numpy(tree: dict, device="cpu", dtype=None) -> dict:
    """JAX-layout numpy tree → the port's torch parameters on `device`
    (floating leaves cast to `dtype` when given)."""

    def leaf(a, transpose):
        a = np.asarray(a)
        if transpose:
            a = np.swapaxes(a, -1, -2)
        t = torch.from_numpy(np.array(a, order="C")).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.contiguous()

    return _convert(tree, leaf)


def params_to_numpy(params: dict) -> dict:
    """The port's torch parameters → a JAX-layout numpy tree (f32 for bf16
    leaves, which numpy cannot hold)."""

    def leaf(t, transpose):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        return np.ascontiguousarray(np.swapaxes(a, -1, -2)) if transpose else a

    return _convert(params, leaf)
