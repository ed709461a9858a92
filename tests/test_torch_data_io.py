"""The launcher's data branches in the port against the JAX package's on the
same inputs: `load_tokenizer` (the toy tokenizer, and a local HF tokenizer
directory built offline with `tokenizers`), `encode_texts` on its three
tiers, `load_prompt_dataset` on a local dataset directory (jsonl with a
`chosen` column) with and without the token cache, the token-cache files
byte for byte (native and Python writers of both packages), and
`resolve_dataset`'s fall-back line. No test here opens a socket."""

import json
import os
import socket

import numpy as np
import pytest

from nanorlhf_tpu.data import datasets as jax_datasets
from nanorlhf_tpu.data import token_cache as jax_token_cache
from nanorlhf_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from nanorlhf_tpu.entrypoints import common as jax_common
from nanorlhf_tpu_torch import native
from nanorlhf_tpu_torch.data import datasets as port_datasets
from nanorlhf_tpu_torch.data import token_cache as port_token_cache
from nanorlhf_tpu_torch.data.tokenizer import load_tokenizer
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config

WORDS = ("how do I learn to cook pasta properly explain why the sky appears blue "
         "what is a good plan for saving money question ok").split()
CHAT = ("{% for m in messages %}<user> {{ m['content'] }} {% endfor %}"
        "{% if add_generation_prompt %}<assistant>{% endif %}")
ROWS = [[5, 6, 7], [], [1], list(range(40)), [2**31 - 1, -2**31]]


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError(f"network access attempted: {a[:2]}")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "getaddrinfo", refuse)


@pytest.fixture
def hf_tokenizer_dir(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[UNK]": 0, "</s>": 1, "<user>": 2, "<assistant>": 3}
    for w in WORDS:
        vocab.setdefault(w, len(vocab))
    tk = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    fast = PreTrainedTokenizerFast(tokenizer_object=tk, unk_token="[UNK]",
                                   eos_token="</s>")
    fast.chat_template = CHAT
    path = str(tmp_path / "tok")
    fast.save_pretrained(path)
    return path


def _texts(n: int) -> list[str]:
    rng = np.random.default_rng(n)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 12))))
            for _ in range(n)]


def test_toy_tokenizer_matches_jax():
    for name in ("toy:97", "toy"):
        port, jax_tok = load_tokenizer(name), jax_load_tokenizer(name)
        assert port.vocab_size == jax_tok.vocab_size
        for t in _texts(20):
            assert port.encode(t) == jax_tok.encode(t)
            assert port.decode(port.encode(t)) == jax_tok.decode(jax_tok.encode(t))


def test_local_hf_tokenizer_matches_jax(hf_tokenizer_dir):
    port, jax_tok = load_tokenizer(hf_tokenizer_dir), jax_load_tokenizer(hf_tokenizer_dir)
    assert port.padding_side == jax_tok.padding_side == "left"
    assert port.pad_token == jax_tok.pad_token == "[PAD]"
    assert port.pad_token_id == jax_tok.pad_token_id
    for t in _texts(10):
        assert port.encode(t) == jax_tok.encode(t)
    batch = _texts(4)
    assert port(batch, padding=True)["input_ids"] == jax_tok(batch, padding=True)["input_ids"]


class PicklableTokenizer:
    """A slow tokenizer the fork pool can carry (module level)."""

    pad_token_id = 0

    def encode(self, text):
        return [3 + (len(w) % 50) for w in text.split()]


def test_encode_texts_tiers_match_jax(hf_tokenizer_dir):
    texts = _texts(64)
    fast = load_tokenizer(hf_tokenizer_dir)
    assert fast.is_fast
    toy = load_tokenizer("toy:512")
    cases = [(fast, 4, 2), (PicklableTokenizer(), 5, 2), (toy, 6, 2),
             (PicklableTokenizer(), 5, 1)]
    for tok, max_len, num_proc in cases:
        serial = [tok.encode(t)[:max_len] for t in texts]
        got = port_datasets.encode_texts(tok, texts, max_len, num_proc=num_proc)
        want = jax_datasets.encode_texts(tok, texts, max_len, num_proc=num_proc)
        assert [list(r) for r in got] == [list(r) for r in want] == serial


def test_extract_hh_question_matches_jax():
    for s in ("\n\nHuman: What is up?\n\nAssistant: Not much.\n\nHuman: ok",
              "no markers at all", "Human: only a question"):
        assert port_datasets.extract_hh_question(s) == jax_datasets.extract_hh_question(s)


def _local_dataset(tmp_path) -> str:
    path = tmp_path / "hh_local"
    path.mkdir()
    rows = [{"chosen": f"\n\nHuman: {t} question {i}\n\nAssistant: ok", "rejected": "x"}
            for i, t in enumerate(_texts(24))]
    (path / "train.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


@pytest.mark.parametrize("tokenizer", ["toy", "hf"])
def test_load_prompt_dataset_on_a_local_directory(tmp_path, monkeypatch, tokenizer,
                                                  hf_tokenizer_dir):
    import datasets.config

    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", str(tmp_path / "hf_cache"))
    name = _local_dataset(tmp_path)
    make = (lambda: load_tokenizer("toy:512")) if tokenizer == "toy" else \
        (lambda: load_tokenizer(hf_tokenizer_dir))
    kw = dict(split="train", max_prompt_len=12, limit=20, seed=3)
    got = port_datasets.load_prompt_dataset(name, make(), **kw)
    want = jax_datasets.load_prompt_dataset(name, make(), **kw)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    assert len(got) == 20 and got.pad_token_id == want.pad_token_id

    # the token cache: a second load hits it, and both packages write the
    # same file under the same fingerprint
    port_dir, jax_dir = str(tmp_path / "port_cache"), str(tmp_path / "jax_cache")
    first = port_datasets.load_prompt_dataset(name, make(), cache_dir=port_dir, **kw)
    jax_datasets.load_prompt_dataset(name, make(), cache_dir=jax_dir, **kw)
    (port_file,), (jax_file,) = os.listdir(port_dir), os.listdir(jax_dir)
    assert port_file == jax_file
    assert open(os.path.join(port_dir, port_file), "rb").read() == \
        open(os.path.join(jax_dir, jax_file), "rb").read()
    monkeypatch.setattr(port_datasets, "encode_texts",
                        lambda *a, **k: pytest.fail("cache miss: re-tokenized"))
    again = port_datasets.load_prompt_dataset(name, make(), cache_dir=jax_dir, **kw)
    np.testing.assert_array_equal(again.input_ids, first.input_ids)
    np.testing.assert_array_equal(again.input_ids, want.input_ids)


def test_local_directory_loads_without_reset_sessions(tmp_path, monkeypatch):
    """`huggingface_hub` 1.x has no `reset_sessions`: the port's loader
    still reads a local dataset directory (JAX's import of it fails)."""
    import datasets.config
    import huggingface_hub.utils

    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", str(tmp_path / "hf_cache"))
    name = _local_dataset(tmp_path)
    with monkeypatch.context() as m:
        m.delattr(huggingface_hub.utils, "reset_sessions")
        got = port_datasets.load_prompt_dataset(name, load_tokenizer("toy:512"), limit=20)
        with pytest.raises(ImportError):
            jax_datasets.load_prompt_dataset(name, load_tokenizer("toy:512"), limit=20)
    want = jax_datasets.load_prompt_dataset(name, load_tokenizer("toy:512"), limit=20)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)


@pytest.mark.parametrize("writer", ["native", "python"])
def test_token_cache_files_byte_for_byte(tmp_path, writer):
    fp = port_token_cache.corpus_fingerprint(name="x", seed=1, tok="t")
    assert fp == jax_token_cache.corpus_fingerprint(name="x", seed=1, tok="t")
    paths = {who: str(tmp_path / f"{who}.tok") for who in ("port", "jax")}
    if writer == "native":
        assert native.available()
        assert native.library_path().parent.name == "_build"
        assert port_token_cache.save_token_cache(paths["port"], ROWS, fp)
        assert jax_token_cache.save_token_cache(paths["jax"], ROWS, fp)
    else:
        assert port_token_cache._write_py(paths["port"], ROWS, fp)
        assert jax_token_cache._write_py(paths["jax"], ROWS, fp)
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    for reader in (port_token_cache.load_token_cache, jax_token_cache.load_token_cache):
        rows = reader(paths["jax"], fp)
        assert [list(map(int, r)) for r in rows] == ROWS
    got = port_token_cache._read_py(paths["port"], fp)
    assert got is not None and got[2] == len(ROWS)
    assert port_token_cache.load_token_cache(paths["port"], fp ^ 1) is None


def test_resolve_dataset_falls_back_with_jaxs_line(monkeypatch, capsys):
    def unavailable(name, split):
        raise FileNotFoundError(name)

    monkeypatch.setattr(port_datasets, "_load_hf_dataset", unavailable)
    monkeypatch.setattr(jax_datasets, "_load_hf_dataset", unavailable)
    cfg = build_config()
    got = common.resolve_dataset(cfg, load_tokenizer("toy:4096"))
    port_out = capsys.readouterr().out
    want = jax_common.resolve_dataset(cfg, jax_load_tokenizer("toy:4096"))
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    assert "synthetic prompts" in port_out and "FileNotFoundError" in port_out
    np.testing.assert_array_equal(got.input_ids, want.input_ids)


def test_hub_name_is_tried_offline_only(capsys):
    """A hub name that is not in the local cache: the load is tried with
    the hub's offline switch on, fails without a socket (the autouse
    fixture refuses any), and the launcher falls back."""
    import huggingface_hub.constants as hub_c

    cfg = build_config()
    assert cfg.train_dataset_name == "Anthropic/hh-rlhf"
    before = hub_c.HF_HUB_OFFLINE
    ds = common.resolve_dataset(cfg, load_tokenizer("toy:4096"))
    assert "synthetic prompts" in capsys.readouterr().out and len(ds) == 512
    assert hub_c.HF_HUB_OFFLINE == before  # the switch is restored
