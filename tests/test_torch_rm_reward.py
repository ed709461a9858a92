"""The reward-model builders of the port against the JAX package's:
`make_rm_reward` (a decoder with a score head, strings batched and
right-padded, read at the last real token) on bridged params, and
`make_torch_rm_reward` on a tiny local `transformers` sequence classifier
with its own tokenizer; and `resolve_rm_reward` taking the RM directory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config, make_params, port_config
from nanorlhf_tpu.data.tokenizer import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu.entrypoints import common as jax_common
from nanorlhf_tpu.rewards.builders import make_rm_reward as jax_make_rm_reward
from nanorlhf_tpu.rewards.builders import make_torch_rm_reward as jax_make_torch_rm_reward
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config
from nanorlhf_tpu_torch.rewards.builders import make_rm_reward, make_torch_rm_reward

torch.set_num_threads(1)
TEXTS = ["how do I learn to cook pasta </s>", "ok", "explain why the sky appears blue at "
         "noon and what is a good plan for saving money </s>", "what is", "a b c d e f g",
         "blue", "the printing press </s> tail"]


@pytest.mark.parametrize("kind", ["qwen_tied", "llama_untied"])
def test_rm_reward_matches_jax(kind):
    jcfg = jax_config(kind)
    jparams, params = make_params(jcfg, seed=6, lora=False)
    score = np.random.default_rng(6).normal(0, 1 / 8, (jcfg.hidden_size, 1)).astype(np.float32)
    jrm = {**jparams, "score": jnp.asarray(score)}
    prm = {**params, "score": torch.from_numpy(score)}
    kw = dict(batch_size=3, max_len=6)
    port = make_rm_reward(prm, port_config(jcfg), ToyTokenizer(128), **kw)
    got = port(TEXTS, "</s>")
    want = jax_make_rm_reward(jrm, jcfg, JaxToyTokenizer(128), **kw)(TEXTS, "</s>")
    assert got.shape == (len(TEXTS),) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port(TEXTS, "</s>"), got)


@pytest.fixture
def rm_dir(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import LlamaConfig, LlamaForSequenceClassification, PreTrainedTokenizerFast

    words = sorted({w for t in TEXTS for w in t.split()} - {"</s>"})
    vocab = {"[PAD]": 0, "[UNK]": 1, "</s>": 2, **{w: i + 3 for i, w in enumerate(words)}}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok = PreTrainedTokenizerFast(tokenizer_object=tk, unk_token="[UNK]",
                                  pad_token="[PAD]", eos_token="</s>")
    torch.manual_seed(3)
    model = LlamaForSequenceClassification(LlamaConfig(
        vocab_size=len(vocab), hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_labels=1, pad_token_id=0,
        max_position_embeddings=64))
    path = str(tmp_path / "rm")
    model.save_pretrained(path)
    tok.save_pretrained(path)
    return path


def test_torch_rm_reward_matches_jax(rm_dir, capsys):
    # the port's RM defaults to the card; the CPU is asked for
    got = make_torch_rm_reward(rm_dir, batch_size=2, device="cpu")(TEXTS, "</s>")
    want = jax_make_torch_rm_reward(rm_dir, batch_size=2)(TEXTS, "</s>")
    assert got.shape == (len(TEXTS),) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    # the launcher takes the RM directory as JAX's does
    via_port = common.resolve_rm_reward(rm_dir, batch_size=2, device="cpu")(TEXTS, "</s>")
    via_jax = jax_common.resolve_rm_reward(rm_dir, batch_size=2)(TEXTS, "</s>")
    np.testing.assert_array_equal(via_port, via_jax)
    np.testing.assert_array_equal(via_port, got)
    assert "not found" not in capsys.readouterr().out


@pytest.mark.parametrize("device", [None, "cuda", "cpu"])
def test_launcher_builds_the_rm_on_its_device(device, tmp_path, monkeypatch):
    """The launcher's torch RM goes where the trainer runs: the card by
    default (the reference scores its RM on the GPU), the CPU only when the
    caller asks (`--device cpu`). The stubs record `.to(device)`, so no
    weights load and no card is needed."""
    import transformers

    moved = []

    class _Model:
        def eval(self):
            return self

        def to(self, dev):
            moved.append(str(dev))
            return self

    monkeypatch.setattr(transformers.AutoModelForSequenceClassification,
                        "from_pretrained", staticmethod(lambda path: _Model()))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: object()))
    cfg = build_config()
    cfg.reward_model_path = str(tmp_path)
    monkeypatch.setattr(common, "resolve_model", lambda *a, **kw: (None, None, None))
    monkeypatch.setattr(common, "resolve_dataset", lambda *a, **kw: None)
    if device is None:
        common.resolve_rm_reward(cfg.reward_model_path)
    else:
        common._resolve_all(cfg, torch.device(device))
    assert moved == ["cpu" if device == "cpu" else "cuda"]
