"""Run a JAX-package unit test against the port's copy of the modules it
tests: every name the JAX test module imported from a copied JAX module
(the orchestrator, the fleet and its RPC transport, resilience, telemetry,
the traffic harness, the lock order, the scheduler's segment helper) is
swapped for the port's object of the same name for the duration of the
test, so the JAX test's own helpers and assertions drive the port's
classes. Names with no port counterpart stay JAX's."""

import importlib
import inspect
import types

# JAX modules whose port counterparts are copies (same names, same
# behaviour on host data)
COPIED = ("nanorlhf_tpu.orchestrator", "nanorlhf_tpu.resilience",
          "nanorlhf_tpu.telemetry", "nanorlhf_tpu.loadgen",
          "nanorlhf_tpu.analysis", "nanorlhf_tpu.sampler.paged.scheduler")


def _port_module(name: str):
    try:
        return importlib.import_module("nanorlhf_tpu_torch." + name[len("nanorlhf_tpu."):])
    except ImportError:
        return None


def port_globals(monkeypatch, module) -> list[str]:
    """Swap `module`'s JAX-package globals for the port's; returns the
    swapped names (a test asserts the swap reached what it tests)."""
    swapped = []
    for name, val in list(vars(module).items()):
        if isinstance(val, types.ModuleType):
            src, attr = val.__name__, None
        elif inspect.isclass(val) or inspect.isfunction(val):
            src, attr = val.__module__, val.__name__
        else:
            continue
        if not src or not src.startswith(COPIED):
            continue
        port = _port_module(src)
        if port is None:
            continue
        if attr is None:
            monkeypatch.setattr(module, name, port)
        elif hasattr(port, attr):
            monkeypatch.setattr(module, name, getattr(port, attr))
        else:
            continue
        swapped.append(name)
    return swapped


def run_jax_test(monkeypatch, module_name: str, test_name: str, fixtures: dict,
                 **params):
    """Import the JAX test module, swap its globals for the port's, and call
    `test_name` with its fixtures (looked up in `fixtures` by parameter name)
    and the given parametrize values."""
    module = importlib.import_module(module_name)
    swapped = port_globals(monkeypatch, module)
    fn = getattr(module, test_name)
    kwargs = {}
    for p in inspect.signature(fn).parameters:
        kwargs[p] = params[p] if p in params else fixtures[p]
    fn(**kwargs)
    return swapped
