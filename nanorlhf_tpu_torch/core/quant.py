"""Weight-only int8 rollout weights — the port of
`nanorlhf_tpu/core/quant.py`.

With `RLConfig.rollout_quant="int8"` generation samples from int8 base
projections with one f32 scale per output channel; LoRA, embeddings and
norms stay the live bf16 tensors (`rollout_view`), and scoring and the
update always run the exact weights. Under LoRA the base is frozen, so the
trainer quantizes once; under full fine-tuning it re-quantizes before each
rollout.

The port keeps kernels `[L, out, in]` (`bridge.py`), so the absmax runs
over the LAST axis (JAX's `[L, in, out]` runs it over the second to last).
The scale is stored `[L, 1, out]`, JAX's own layout, which broadcasts over
`F.linear`'s output; `bridge.py` transposes `kernel_q` and passes
`kernel_scale` through. The rounding is JAX's bit for bit as its trainer
runs it (`quantize_layers` under `jax.jit`): the scale is the absmax times
the f32 reciprocal of 127 (XLA turns the division by the constant into
that product), the values are divided by the scale in f32, rounded half
to even and clipped to ±127.

JAX has no kernel here (XLA fuses the upcast into the matmul); the port's
`_proj` upcasts with a plain `q.to(bf16)` and multiplies the scale into
the output (`core/model.py`).
"""

from __future__ import annotations

import torch

# the stacked-kernel projections of core/model.py's layer tree
QUANT_PROJS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)


@torch.no_grad()
def quantize_kernel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., out, in] → (int8 [..., out, in], f32 scale [..., 1, out])."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0), min=1e-12)
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.transpose(-1, -2).contiguous()


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """The inverse of `quantize_kernel`: [..., out, in] of `dtype`."""
    return (q.float() * scale.transpose(-1, -2)).to(dtype)


def quantize_layers(layers: dict) -> dict:
    """Replace each projection's `kernel` with (`kernel_q`,
    `kernel_scale`). Other leaves (biases, norms) pass through by
    reference."""
    out = {}
    for name, entry in layers.items():
        if isinstance(entry, dict) and name in QUANT_PROJS:
            e = dict(entry)
            e["kernel_q"], e["kernel_scale"] = quantize_kernel(e.pop("kernel"))
            out[name] = e
        else:
            out[name] = entry
    return out


def rollout_view(params: dict, quant_layers: dict) -> dict:
    """The live parameter tree with its layers swapped for the quantized
    ones: embeddings, norms and LoRA adapters stay the caller's tensors."""
    return {**params, "layers": quant_layers}
