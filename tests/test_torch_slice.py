"""The whole rollout-and-score slice of the port against the JAX package on
the tiny f32 model (greedy tokens identical; rewards, advantages and the
policy/ref logprobs of the kept rows within 1e-5), plus the port's import
hygiene: no JAX, nothing of nanorlhf_tpu, and no kernel launch for CPU
tensors."""

import ast
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LORA, jax_config, make_params, port_config
from nanorlhf_tpu.algos.advantages import grpo_group_advantage as jax_group_advantage
from nanorlhf_tpu.data.datasets import load_prompt_dataset as jax_load_dataset
from nanorlhf_tpu.data.tokenizer import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu.entrypoints import common as jax_common
from nanorlhf_tpu.entrypoints.grpo import build_config as jax_build_config
from nanorlhf_tpu.sampler import SamplingParams as JaxSamplingParams
from nanorlhf_tpu.sampler import generate as jax_generate
from nanorlhf_tpu.trainer import bucketing as jax_bucketing
from nanorlhf_tpu.trainer.trainer import fused_response_logprobs as jax_fused_scores
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config
from nanorlhf_tpu_torch.sampler.sampler import SamplingParams
from nanorlhf_tpu_torch.trainer import bucketing
from nanorlhf_tpu_torch.trainer import rollout as trollout
from nanorlhf_tpu_torch.trainer.trainer import check_multi_turn_config, check_trainer_supported
from nanorlhf_tpu_torch.trainer.rollout import (
    KEEP_STREAM, check_supported, rollout_and_score, rollout_generator, stream_generator)

torch.set_num_threads(1)

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _datasets():
    jtok, tok = JaxToyTokenizer(4096), ToyTokenizer(4096)
    return (jtok, jax_load_dataset("synthetic:64", jtok),
            tok, load_prompt_dataset("synthetic:64", tok))


def test_dataset_tokenizer_and_depad_parity():
    jtok, jds, tok, ds = _datasets()
    np.testing.assert_array_equal(ds.input_ids, jds.input_ids)
    menu = bucketing.shape_menu(ds.input_ids.shape[1], 16)
    assert menu == jax_bucketing.shape_menu(jds.input_ids.shape[1], 16)
    for batch, jbatch in zip(_take(ds.loader(4, 1), 3), _take(jds.loader(4, 1), 3)):
        np.testing.assert_array_equal(batch, jbatch)
        np.testing.assert_array_equal(bucketing.depad_queries(batch, 0, [4, 8, 64]),
                                      jax_bucketing.depad_queries(jbatch, 0, [4, 8, 64]))
    assert tok.batch_decode(ds.input_ids[:3]) == jtok.batch_decode(jds.input_ids[:3])
    for v in (1, 5, 16, 17, 100):
        assert bucketing.round_up_to_menu(v, menu) == jax_bucketing.round_up_to_menu(v, menu)


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_rollout_and_score_matches_jax():
    """depad → greedy generate (n=4, shared prefill) → rule reward → GRPO
    advantage → keep 1 of N → fused policy (LoRA) and ref scoring of the
    kept rows, both stacks (the JAX side keeps the port's draw: the two
    generators give other bits)."""
    jcfg = jax_config("qwen_tied", vocab_size=4096)
    mcfg = port_config(jcfg)
    jparams, tparams = make_params(jcfg, seed=21)
    jtok, jds, tok, ds = _datasets()
    cfg, jrl = build_config(), jax_build_config()
    for c in (cfg, jrl):
        c.response_length = 8
    queries = next(ds.loader(4, cfg.seed))
    menu = bucketing.shape_menu(ds.input_ids.shape[1], 16)
    pad, eos, n = tok.pad_token_id, tok.eos_token_id, cfg.sample_n
    greedy = dict(temperature=cfg.temperature, top_p=cfg.top_p, n=n,
                  max_tokens=cfg.response_length, greedy=True)

    out = rollout_and_score(
        tparams, {k: v for k, v in tparams.items() if k != "lora"}, mcfg, cfg, tok,
        queries, common.resolve_rm_reward(cfg.reward_model_path),
        rollout_generator(cfg.seed, 0, "cpu"), LORA.scale,
        stream_generator(cfg.seed, KEEP_STREAM, 0), ctx_menu=menu,
        sampling=SamplingParams(**greedy))

    # the same path through the JAX package, step by step
    jq = jax_bucketing.depad_queries(queries, pad, menu)
    responses = np.asarray(jax_generate(
        jparams, jcfg, jnp.asarray(jq), jnp.asarray(jq != pad), jax.random.PRNGKey(0),
        JaxSamplingParams(**greedy), eos_token_id=eos, pad_token_id=pad,
        lora_scale=LORA.scale))
    questions = [q.replace(jtok.pad_token, "") for q in jtok.batch_decode(jq)]
    texts = [q + r for q, r in zip([q for q in questions for _ in range(n)],
                                   jtok.batch_decode(responses))]
    scores = jax_common.resolve_rm_reward(jrl.reward_model_path)(texts, jtok.eos_token)
    adv = np.asarray(jax_group_advantage(jnp.asarray(scores), n))
    keep, rows = out["keep"], np.arange(jq.shape[0])
    assert keep.shape == (jq.shape[0],) and ((keep >= 0) & (keep < n)).all()
    adv = adv.reshape(-1, n)[rows, keep]
    responses = responses.reshape(jq.shape[0], n, -1)[rows, keep]
    qr = jnp.asarray(np.concatenate([jq, responses], axis=1))
    ctx = jq.shape[1]
    lp = jax_fused_scores(jparams, jcfg, qr, qr[:, ctx:], pad, ctx, jrl,
                          lora_scale=LORA.scale)
    ref = {k: v for k, v in jparams.items() if k != "lora"}
    rlp = jax_fused_scores(ref, jcfg, qr, qr[:, ctx:], pad, ctx, jrl)

    np.testing.assert_array_equal(out["queries"], jq)
    np.testing.assert_array_equal(out["responses"], responses)
    np.testing.assert_allclose(out["scores"], scores, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out["advantages"], adv, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["logprobs"], np.asarray(lp), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["ref_logprobs"], np.asarray(rlp), atol=ATOL, rtol=0)
    assert np.abs(out["logprobs"] - out["ref_logprobs"]).max() > 1e-4  # LoRA computes
    assert _build.launch_counts() == {name: 0 for name in _build.KERNELS}


def test_naive_scoring_path_matches_fused():
    """cfg.fused_logprob=False (full logits, the triage path) scores the same
    logprobs as the fused path, and ref-free (ref_params=None) returns the
    policy's for both."""
    from nanorlhf_tpu_torch.trainer.scoring import score_chunk

    jcfg = jax_config("llama_untied", vocab_size=256)
    _, tparams = make_params(jcfg, seed=5)
    cfg = build_config()
    rng = np.random.default_rng(9)
    qr = torch.as_tensor(rng.integers(1, 256, (3, 14)))
    qr[0, :4] = 0  # left-padded prompt
    ref = {k: v for k, v in tparams.items() if k != "lora"}
    fused = score_chunk(tparams, ref, port_config(jcfg), cfg, qr, 6, 0, LORA.scale)
    naive = score_chunk(tparams, ref, port_config(jcfg),
                        dataclasses.replace(cfg, fused_logprob=False), qr, 6, 0, LORA.scale)
    for f, n_ in zip(fused, naive):
        np.testing.assert_allclose(f.numpy(), n_.numpy(), atol=ATOL, rtol=0)
    lp, rlp = score_chunk(tparams, None, port_config(jcfg), cfg, qr, 6, 0, LORA.scale)
    assert rlp is lp
    np.testing.assert_allclose(lp.numpy(), fused[0].numpy(), atol=0, rtol=0)


def test_run_rollout_tiny_cpu():
    cfg = build_config()
    cfg.sft_model_path = "TinyLlama-demo"
    cfg.response_length = 5
    timings = {}
    out = common.run_rollout(cfg, device="cpu", num_prompts=2, timings=timings)
    # one kept sample per prompt is scored; every sample has a score
    assert out["responses"].shape == (2, 5) and out["scores"].shape == (2 * cfg.sample_n,)
    assert out["logprobs"].shape == out["ref_logprobs"].shape == (2, 5)
    assert np.isfinite(out["logprobs"]).all() and (out["logprobs"] <= 0).all()
    # LoRA B starts at zero: the policy equals the ref
    np.testing.assert_array_equal(out["logprobs"], out["ref_logprobs"])
    assert {"prefill_s", "decode_s", "score_s", "total_s"} <= set(timings)
    jax_mcfg, _, _ = jax_common.resolve_model("TinyLlama-demo", 0)
    assert dataclasses.asdict(out["mcfg"]) == {
        k: v for k, v in dataclasses.asdict(jax_mcfg).items()
        if not k.startswith("spmd_")}
    assert _build.launch_counts() == {name: 0 for name in _build.KERNELS}


def test_run_rollout_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        common.run_rollout(build_config())


UNPORTED = [
    # the fleet as JAX accepts it (a fleet without the orchestrator is JAX's
    # ValueError, `test_torch_fleet_checks.py`)
    dict(rollout_orchestrator=True), dict(rollout_workers=2, rollout_orchestrator=True),
    dict(rollout_prefix_cache=True, rollout_page_size=4, rollout_decode_rows=2),
    dict(kv_cache_quant="int8"),
    dict(env_name="python_tool", env_max_turns=2), dict(sampler_logprob_capture=True),
    dict(rollout_quant="int8"),
]
UNPORTED_SAMPLER = [
    dict(rollout_page_size=128), dict(rollout_decode_rows=8), dict(rollout_spec_k=4),
    dict(rollout_compaction_segments=2),
    dict(rollout_prefill_chunk=4, rollout_page_size=4, rollout_decode_rows=2),
]
# knobs that raised until the paged / int8, speculative, int8-weight and
# serving slices ported them: their cases now hold the rollout through the
# knob against the contiguous exact rollout (the radix prefix cache and
# chunked prefill with the continuous batching they need)
PORTED_KNOBS = ("kv_cache_quant", "rollout_page_size", "rollout_decode_rows",
                "rollout_spec_k", "rollout_quant", "rollout_prefix_cache",
                "rollout_prefill_chunk", "rollout_orchestrator", "rollout_workers",
                "sampler_logprob_capture", "rollout_compaction_segments")


def _greedy_rollout(monkeypatch, knobs):
    """run_rollout on the CPU (tiny model, 2 prompts, 6 tokens) with greedy
    sampling and `knobs` set."""
    cfg = build_config()
    cfg.sft_model_path = "tiny-demo"
    cfg.response_length = 6
    for k, v in knobs.items():
        setattr(cfg, k, v)
    greedy = dataclasses.replace(trollout.sampling_params(cfg), greedy=True)
    real = trollout.rollout_and_score
    monkeypatch.setattr(common, "rollout_and_score",
                        lambda *a, **kw: real(*a, sampling=greedy, **kw))
    return common.run_rollout(cfg, device="cpu", num_prompts=2)


def _assert_ported_knob_matches(monkeypatch, knobs):
    got = _greedy_rollout(monkeypatch, knobs)
    want = _greedy_rollout(monkeypatch, {})
    if "kv_cache_quant" in knobs:
        # the int8 cache changes the rollout's numbers, not its contract:
        # the same shapes, finite logprobs, the int8 cache on the paged route
        # gives the same rows as on the contiguous one
        assert got["responses"].shape == want["responses"].shape
        assert np.isfinite(got["logprobs"]).all()
        paged = _greedy_rollout(monkeypatch, dict(knobs, rollout_page_size=4))
        np.testing.assert_array_equal(paged["responses"], got["responses"])
        np.testing.assert_array_equal(paged["logprobs"], got["logprobs"])
    elif "rollout_quant" in knobs:
        # int8 weights sample another stream from the same contract; scoring
        # sees the exact weights: the int8 rollout's responses rescored
        # through the exact tree give its logprobs bit for bit
        assert got["responses"].shape == want["responses"].shape
        assert np.isfinite(got["logprobs"]).all()
        assert got["rollout_params"]["layers"]["q_proj"]["kernel_q"].dtype == torch.int8
        assert want["rollout_params"] is None
        qr = np.concatenate([got["queries"], got["responses"]], axis=1)
        cfg = build_config()
        exact = trollout.score_chunk(got["params"], got["ref_params"], got["mcfg"], cfg,
                                     torch.as_tensor(qr), got["context_length"],
                                     got["tokenizer"].pad_token_id, got["lora_scale"])
        np.testing.assert_array_equal(exact[0].numpy(), got["logprobs"])
        np.testing.assert_array_equal(exact[1].numpy(), got["ref_logprobs"])
    elif "sampler_logprob_capture" in knobs:
        # the sampler's logprobs stand for the policy scoring forward (which
        # does not run): the same rows, the decode path's numbers within
        # f32 rounding of the scoring pass's, the ref forward still exact
        np.testing.assert_array_equal(got["responses"], want["responses"])
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["ref_logprobs"], want["ref_logprobs"])
    else:
        # the orchestrator and the fleet pick which thread generates, not
        # what: one rollout through `run_rollout` is the synchronous one
        np.testing.assert_array_equal(got["responses"], want["responses"])
        np.testing.assert_array_equal(got["logprobs"], want["logprobs"])


@pytest.mark.parametrize("knobs", UNPORTED, ids=lambda d: next(iter(d)))
def test_unported_knobs_raise(knobs, monkeypatch):
    cfg = build_config()
    for k, v in knobs.items():
        setattr(cfg, k, v)
    if next(iter(knobs)) in PORTED_KNOBS:
        check_supported(cfg)
        _assert_ported_knob_matches(monkeypatch, knobs)
        return
    if "env_name" in knobs:
        # multi-turn environments are ported: the rollout's and the
        # trainer's gates accept them, and the multi-turn check the trainer
        # runs on the built environment raises JAX's ValueError for the
        # launcher's contiguous cache (continuations are paged admissions)
        check_supported(cfg)
        check_trainer_supported(cfg)
        with pytest.raises(ValueError, match="requires rollout_page_size > 0"):
            check_multi_turn_config(cfg)
        return
    with pytest.raises(NotImplementedError):
        check_supported(cfg)


@pytest.mark.parametrize("knobs", UNPORTED_SAMPLER, ids=lambda d: next(iter(d)))
def test_unported_sampler_knobs_raise_from_the_rollout(knobs, monkeypatch):
    cfg = build_config()
    cfg.sft_model_path = "tiny-demo"
    for k, v in knobs.items():
        setattr(cfg, k, v)
    check_supported(cfg)  # a sampler knob: caught where the sampler is built
    if next(iter(knobs)) in PORTED_KNOBS:
        _assert_ported_knob_matches(monkeypatch, knobs)
        return
    with pytest.raises(NotImplementedError):
        common.run_rollout(cfg, device="cpu", num_prompts=1)


def test_sequence_parallel_raises():
    """Sequence parallelism is ported: the rollout's gate takes the
    launcher's sp config, and on one process its mesh raises the ValueError
    that names the launcher (`tests/test_torch_sp.py` trains it on spawned
    ranks). Disaggregated rollout devices still raise NotImplementedError
    naming A14c."""
    from nanorlhf_tpu_torch.parallel.mesh import make_mesh

    cfg = build_config(sequence_parallel=2)
    check_supported(cfg)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(cfg.mesh)
    with pytest.raises(NotImplementedError, match="A14c"):
        check_supported(build_config(rollout_devices=4))


def test_rollout_generator_streams():
    a = torch.rand(4, generator=rollout_generator(1, 3, "cpu"))
    b = torch.rand(4, generator=rollout_generator(1, 3, "cpu"))
    c = torch.rand(4, generator=rollout_generator(1, 4, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import nanorlhf_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    nanorlhf_tpu_torch.__path__, 'nanorlhf_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and (\n"
        "    k == 'jax' or k.startswith('jax.') or k == 'nanorlhf_tpu'\n"
        "    or k.startswith('nanorlhf_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25  # every module of the port was imported


_JAX_MODULE = re.compile(r"(jax|nanorlhf_tpu)(\.\w+)*")
_QUOTED_JAX_MODULE = re.compile(r"""["'](nanorlhf_tpu\.|jax["'.])""")


def jax_imports(source: str) -> list[str]:
    """What a source file takes from JAX or the JAX package, in any scope:
    `import` and `from` statements (lazy ones inside functions included),
    and quoted module names (`"nanorlhf_tpu.x"`, `"jax"`: forkserver
    preloads, `importlib.import_module`, `__import__`)."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _JAX_MODULE.fullmatch(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0 \
                and _JAX_MODULE.fullmatch(node.module):
            found.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _JAX_MODULE.fullmatch(node.value.strip()):
            found.append(repr(node.value))
    found += [m.group(0) for m in _QUOTED_JAX_MODULE.finditer(source)]
    return found


@pytest.mark.parametrize("snippet", [
    "import jax",
    "import jax.numpy as jnp",
    "from jax import numpy",
    "def f():\n    from nanorlhf_tpu.resilience import reap_process\n",
    "def f():\n    import nanorlhf_tpu.utils.logging as lg\n",
    "import nanorlhf_tpu",
    "ctx.set_forkserver_preload(['sympy', 'nanorlhf_tpu.rewards.math_grader'])",
    "importlib.import_module('jax')",
    "__import__(\"nanorlhf_tpu.rewards\")",
])
def test_static_scan_refuses_jax_imports(snippet):
    assert jax_imports(snippet)


@pytest.mark.parametrize("snippet", [
    "import nanorlhf_tpu_torch.rewards",
    "from nanorlhf_tpu_torch.resilience.procs import reap_process",
    "x = 'nanorlhf_tpu_torch.rewards.math_grader'",
    "'''The port of `nanorlhf_tpu/trainer/sparse_grpo.py`.'''",
])
def test_static_scan_allows_the_ports_own_names(snippet):
    assert not jax_imports(snippet)


def test_port_sources_import_neither_jax_nor_the_jax_package_in_any_scope():
    """A static scan of every `.py` file of the port and of `chip_smoke.py`:
    no import of jax or the JAX package at any depth (a lazy import inside
    a function never runs at import time, so the import test above cannot
    see it) and no quoted module name of either."""
    pkg = os.path.join(REPO, "nanorlhf_tpu_torch")
    files = [os.path.join(root, f) for root, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) >= 60
    bad = {os.path.relpath(f, REPO): hits for f in files
           if (hits := jax_imports(open(f, encoding="utf-8").read()))}
    assert not bad, bad
