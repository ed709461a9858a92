"""Analytic model-FLOPs / MFU / throughput accounting and the recompile
counter — the port of `nanorlhf_tpu/telemetry/mfu.py`.

The accounting is the JAX module's napkin model, unchanged:

    fwd FLOPs per token ≈ 2 · n_params        (one MAC per weight)
    bwd ≈ 2 × fwd  →  train tokens cost 3 · fwd

per update:

    flops = (decode + prefill + score_tokens) · 2N  +  train_tokens · 6N
    MFU   = flops / wall_seconds / (peak_flops_per_chip · n_devices)

with the same deliberate approximations (no attention term, no value
model, decode counted at the configured response_length).

What differs from JAX:

  * `peak_flops_per_chip(device)` reads `torch.cuda.get_device_name`. The
    table holds the H100's dense bf16 peak, 989 TFLOP/s (the SXM part's
    figure); any other CUDA card falls back to it with known=False, and
    the CPU gets the nominal 1e12, also known=False — MFU stays a finite
    series there, not a utilization.
  * `RecompileCounter` counts the port's run-time compiles: the nvcc builds
    and library loads of `_build` (`_build.on_compile`), with their
    seconds. It does NOT count CUDA-graph captures: every `generate`
    captures its decode loop anew (about one capture per 7.5 s update on
    the card until graphs are cached across rollouts), which is above the
    health plane's `recompile_storm` warn rate of 0.05/s — counting
    captures would make that rule fire on every healthy run. The
    captures' seconds are in the rollout timings (`graph_capture_s`).
"""

from __future__ import annotations

from typing import Optional

from nanorlhf_tpu_torch.analysis.lockorder import make_lock

# peak dense bf16 FLOPs/s per card by device name (substring match on
# torch.cuda.get_device_name)
PEAK_FLOPS_PER_CHIP = {
    "H100": 989e12,
}
FALLBACK_KIND = "H100"
CPU_PEAK_FLOPS = 1e12   # nominal; CPU MFU is not meaningful, only finite


def peak_flops_per_chip(device) -> tuple[float, bool]:
    """(peak_flops, known): the dense bf16 peak of the card `device` names.
    An unknown CUDA card falls back to the H100 figure (known=False); the
    CPU gets the nominal constant (known=False)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return CPU_PEAK_FLOPS, False
    name = torch.cuda.get_device_name(device)
    for kind, peak in PEAK_FLOPS_PER_CHIP.items():
        if kind in name:
            return peak, True
    return PEAK_FLOPS_PER_CHIP[FALLBACK_KIND], False


def flops_param_count(params: dict) -> int:
    """Parameter count for the 2N-per-token FLOPs model: the base policy
    tree without its LoRA adapters (`"lora"`)."""

    def count(node) -> int:
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return int(node.numel())

    return sum(count(v) for k, v in params.items() if k != "lora")


def update_flops(n_params: int, *, decode_tokens: float = 0.0,
                 prefill_tokens: float = 0.0, score_tokens: float = 0.0,
                 train_tokens: float = 0.0) -> float:
    """Model FLOPs for one RL update under the napkin model (module
    docstring): forward-only tokens at 2N, trained tokens at 3·2N."""
    fwd = 2.0 * float(n_params)
    return (decode_tokens + prefill_tokens + score_tokens) * fwd \
        + train_tokens * 3.0 * fwd


# ---------------------------------------------------------------------- #
# recompile counter (the port's kernel builds and loads)
# ---------------------------------------------------------------------- #


class RecompileCounter:
    """Cumulative count and seconds of the port's kernel builds and library
    loads. Thread-safe."""

    def __init__(self):
        self._lock = make_lock("telemetry.mfu.counter")
        self.count = 0
        self.seconds = 0.0

    def _on_event(self, what: str, secs: float) -> None:
        with self._lock:
            self.count += 1
            self.seconds += float(secs)


_COUNTER: Optional[RecompileCounter] = None
_COUNTER_LOCK = make_lock("telemetry.mfu.registry")


def recompile_counter() -> RecompileCounter:
    """The process-global recompile counter, registered with `_build` on
    first use; every trainer of the process reads the same cumulative
    series, as in JAX."""
    global _COUNTER
    with _COUNTER_LOCK:
        if _COUNTER is None:
            from nanorlhf_tpu_torch import _build

            counter = RecompileCounter()
            _build.on_compile(counter._on_event)
            _COUNTER = counter
    return _COUNTER
