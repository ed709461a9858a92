"""Inference serving plane — the port of `nanorlhf_tpu/serving/`: the
cross-request radix prefix cache (`radix.py`), the continuous-batching
serving engine over the per-row decode session (`engine.py`) and the
stdlib-HTTP streaming token API in front of it (`gateway.py`)."""

from nanorlhf_tpu_torch.serving.radix import RadixCache, RefPagePool

__all__ = ["RadixCache", "RefPagePool", "ServingEngine", "ServingGateway"]


def __getattr__(name):  # engine/gateway pull in the model code — lazy
    if name == "ServingEngine":
        from nanorlhf_tpu_torch.serving.engine import ServingEngine
        return ServingEngine
    if name == "ServingGateway":
        from nanorlhf_tpu_torch.serving.gateway import ServingGateway
        return ServingGateway
    raise AttributeError(name)
