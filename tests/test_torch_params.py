"""HF weights in and out of the port against the JAX package and against
`transformers`: a JAX export (f32, bf16) loaded by the port equals the
bridged tree of JAX's own load exactly; the port's export loads in JAX to
the same tree with the same two JSON files; `merge_lora` as JAX's; tiny
random `transformers` Qwen2 and Llama models loaded by the port give
`transformers`' logits, and `transformers` loads the port's export to
them; and the port writes and loads an HF directory with none of
`safetensors`, `transformers`, `datasets` or `tokenizers` importable."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import KINDS, jax_config, make_params, port_config
from nanorlhf_tpu.core.lora import merge_lora as jax_merge_lora
from nanorlhf_tpu.core.params import export_hf_checkpoint as jax_export
from nanorlhf_tpu.core.params import load_hf_checkpoint as jax_load
from nanorlhf_tpu.data.tokenizer import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu_torch.bridge import params_from_numpy
from nanorlhf_tpu_torch.core import model as tm
from nanorlhf_tpu_torch.core.lora import merge_lora
from nanorlhf_tpu_torch.core.params import export_hf_checkpoint, load_hf_checkpoint
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree)


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], dict):
            _same(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_loads_a_jax_export_exactly(tmp_path, kind, dtype):
    jcfg = jax_config(kind)
    jparams, _ = make_params(jcfg, seed=3, lora=False)
    out = jax_export(jcfg, jparams, str(tmp_path / "ck"), dtype=dtype)
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    mcfg, got = load_hf_checkpoint(out, dtype=tdtype, device="cpu")
    jmcfg, want = jax_load(out, dtype=jdtype)
    # bf16 values travel through f32 numpy exactly
    _same(got, params_from_numpy(_np(want), "cpu", tdtype))
    assert mcfg == port_config(jmcfg)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_loads_the_port_export_to_the_same_tree(tmp_path, kind):
    jcfg = jax_config(kind)
    jparams, params = make_params(jcfg, seed=4)
    port_dir = export_hf_checkpoint(port_config(jcfg), params, str(tmp_path / "port"),
                                    lora_scale=2.0, dtype="float32",
                                    tokenizer=ToyTokenizer(128), bos_token_id=5)
    jax_dir = jax_export(jcfg, jparams, str(tmp_path / "jax"), lora_scale=2.0,
                         dtype="float32", tokenizer=JaxToyTokenizer(128), bos_token_id=5)
    for name in ("config.json", "generation_config.json"):
        assert open(os.path.join(port_dir, name)).read() == \
            open(os.path.join(jax_dir, name)).read(), name
    _, got = jax_load(port_dir, dtype=jnp.float32)
    _, want = jax_load(jax_dir, dtype=jnp.float32)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        # the merged kernels' f32 sums (B·A) may differ in the last place
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7)
    # bf16 export: the same rounding of the same tree, leaf for leaf
    port16 = export_hf_checkpoint(port_config(jcfg), merge_lora(params, 2.0),
                                  str(tmp_path / "port16"))
    _, g16 = jax_load(port16, dtype=jnp.bfloat16)
    want16 = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                          jax_merge_lora(jparams, 2.0))
    for g, w in zip(jax.tree.leaves(g16), jax.tree.leaves(want16)):
        gf, wf = np.asarray(g, np.float32), np.asarray(w, np.float32)
        np.testing.assert_allclose(gf, wf, rtol=2.0**-8, atol=0)


def test_merge_lora_matches_jax():
    jcfg = jax_config("llama_untied")
    jparams, params = make_params(jcfg, seed=5)
    want = params_from_numpy(_np(jax_merge_lora(jparams, 0.75)), "cpu", torch.float32)
    got = merge_lora(params, 0.75)
    assert "lora" not in got and got.keys() == want.keys()
    for name, entry in got["layers"].items():
        for leaf, t in (entry.items() if isinstance(entry, dict) else [("w", entry)]):
            w = want["layers"][name][leaf] if isinstance(entry, dict) else want["layers"][name]
            torch.testing.assert_close(t, w, rtol=1e-6, atol=1e-6)
    assert got["embed_tokens"] is params["embed_tokens"]
    # bf16 kernels are merged in f32 and rounded once
    p16 = {**params, "layers": {k: ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                                     if isinstance(v, dict) else v)
                                 for k, v in params["layers"].items()}}
    m16 = merge_lora(p16, 0.75)["layers"]["q_proj"]["kernel"]
    assert m16.dtype == torch.bfloat16
    want16 = (p16["layers"]["q_proj"]["kernel"].float()
              + 0.75 * params["lora"]["layers"]["q_proj"]["b"]
              @ params["lora"]["layers"]["q_proj"]["a"]).to(torch.bfloat16)
    assert torch.equal(m16, want16)


def _hf_model(kind: str):
    from transformers import LlamaConfig, LlamaForCausalLM, Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(11)
    common = dict(vocab_size=96, hidden_size=64, intermediate_size=112,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=128, rms_norm_eps=1e-6)
    if kind == "qwen_tied":
        model = Qwen2ForCausalLM(Qwen2Config(rope_theta=10_000.0,
                                             tie_word_embeddings=True, **common))
    else:
        model = LlamaForCausalLM(LlamaConfig(rope_theta=500_000.0, attention_bias=False,
                                             tie_word_embeddings=False, **common))
    with torch.no_grad():  # move every weight off its init constants
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model.eval().to(torch.float32)


def _hf_logits(model, ids: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(input_ids=torch.from_numpy(ids)).logits.numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_transformers_oracle_both_ways(tmp_path, kind):
    from transformers import AutoModelForCausalLM

    model = _hf_model(kind)
    src = str(tmp_path / "hf")
    model.save_pretrained(src)
    mcfg, params = load_hf_checkpoint(src, dtype=torch.float32, device="cpu")
    assert mcfg.tie_word_embeddings == (kind == "qwen_tied")
    assert ("lm_head" in params) == (kind != "qwen_tied")
    ids = np.random.default_rng(0).integers(1, 96, (3, 11))
    want = _hf_logits(model, ids)
    got = tm.padded_forward_logits(params, mcfg, torch.from_numpy(ids), 0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    out = export_hf_checkpoint(mcfg, params, str(tmp_path / "port"), dtype="float32")
    back = AutoModelForCausalLM.from_pretrained(out).eval().to(torch.float32)
    assert back.config.model_type == ("qwen2" if kind == "qwen_tied" else "llama")
    np.testing.assert_allclose(_hf_logits(back, ids), want, rtol=1e-4, atol=1e-4)


def test_port_writes_and_loads_without_the_hf_libraries(tmp_path):
    """The card's machine has none of these packages: every port module
    imports, and an HF directory round-trips, with all four unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('safetensors', 'transformers', 'datasets', 'tokenizers', 'jax'):\n"
        "    sys.modules[m] = None\n"
        "import torch, nanorlhf_tpu_torch\n"
        "for m in pkgutil.walk_packages(nanorlhf_tpu_torch.__path__, 'nanorlhf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from nanorlhf_tpu_torch.core.config import ModelConfig\n"
        "from nanorlhf_tpu_torch.core.model import init_params\n"
        "from nanorlhf_tpu_torch.core.params import export_hf_checkpoint, load_hf_checkpoint\n"
        "from nanorlhf_tpu_torch.data.tokenizer import load_tokenizer\n"
        "cfg = ModelConfig.qwen2_tiny(vocab_size=64)\n"
        "p = init_params(cfg, 0, torch.bfloat16, 'cpu')\n"
        f"out = export_hf_checkpoint(cfg, p, {str(tmp_path / 'ck')!r},\n"
        "                           tokenizer=load_tokenizer('toy:64'))\n"
        "cfg2, q = load_hf_checkpoint(out, device='cpu')\n"
        "assert cfg2.vocab_size == 64\n"
        "assert all(torch.equal(q['layers'][k]['kernel'], p['layers'][k]['kernel'])\n"
        "           for k in ('q_proj', 'down_proj'))\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr
    assert json.load(open(tmp_path / "ck" / "config.json"))["eos_token_id"] == 1


def test_resolve_model_loads_an_hf_directory(tmp_path, capsys):
    """The launcher's checkpoint-directory branch: weights and tokenizer
    from the directory, as JAX's `resolve_model` loads them."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from nanorlhf_tpu.entrypoints import common as jax_common
    from nanorlhf_tpu_torch.entrypoints import common

    vocab = {"[UNK]": 0, "</s>": 1, **{f"w{i}": i + 2 for i in range(60)}}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    jcfg = jax_config("qwen_tied")
    jparams, _ = make_params(jcfg, seed=8, lora=False)
    path = jax_export(jcfg, jparams, str(tmp_path / "sft"), tokenizer=PreTrainedTokenizerFast(
        tokenizer_object=tk, unk_token="[UNK]", eos_token="</s>"))
    mcfg, params, tok = common.resolve_model(path, attention_impl="xla", device="cpu")
    jmcfg, jp, jtok = jax_common.resolve_model(path, attention_impl="xla")
    assert "offline demo" not in capsys.readouterr().out
    assert mcfg == port_config(jmcfg)
    _same(params, params_from_numpy(_np(jp), "cpu", torch.bfloat16))
    assert tok.pad_token == jtok.pad_token == "[PAD]" and tok.eos_token_id == 1
    assert tok.encode("w3 w7 w59") == jtok.encode("w3 w7 w59")
