"""The port's safetensors reader and writer against the installed
`safetensors` library, both ways: every dtype a Qwen2/Llama checkpoint
uses, empty and 0-d tensors, metadata, two shards read in sorted order,
the `pytorch_model.bin` branch, and malformed headers rejected."""

import json
import struct

import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file, save_file

from nanorlhf_tpu_torch.core.safetensors_io import (
    DTYPES,
    SafetensorsError,
    read_safetensors,
    read_state_dict,
    write_safetensors,
)


def _tensors(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, (name, dtype) in enumerate(sorted(DTYPES.items())):
        if dtype.is_floating_point:
            t = torch.randn(3, 5 + i, generator=g).to(dtype)
        elif dtype == torch.bool:
            t = torch.randint(0, 2, (4, 3), generator=g).bool()
        else:
            t = torch.randint(-2**30, 2**30, (7,), generator=g).to(dtype)
        out[f"w.{name}"] = t
    out["empty"] = torch.empty(0, 8, dtype=torch.bfloat16)
    out["scalar"] = torch.tensor(2.5, dtype=torch.float32)
    out["odd"] = torch.arange(3, dtype=torch.float16)  # leaves the next offset unaligned
    out["after_odd"] = torch.arange(5, dtype=torch.int64)
    return out


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_reads_what_the_library_writes(tmp_path):
    path = str(tmp_path / "lib.safetensors")
    want = _tensors()
    save_file(want, path, metadata={"format": "pt", "note": "x"})
    got, meta = read_safetensors(path)
    _same(got, want)
    assert meta == {"format": "pt", "note": "x"}


def test_library_reads_what_the_port_writes(tmp_path):
    path = str(tmp_path / "port.safetensors")
    want = _tensors(1)
    write_safetensors(path, want)
    _same(load_file(path), want)
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt"}
    write_safetensors(path, want, metadata={"k": "v"})
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"k": "v"}
    _same(read_safetensors(path)[0], want)


def test_views_are_writable_and_leave_the_file_alone(tmp_path):
    path = str(tmp_path / "x.safetensors")
    save_file({"a": torch.zeros(4)}, path)
    got, _ = read_safetensors(path)
    got["a"] += 1.0
    assert torch.equal(load_file(path)["a"], torch.zeros(4))


def test_two_shards_in_sorted_order_and_the_bin_branch(tmp_path):
    shards = tmp_path / "sharded"
    shards.mkdir()
    a, b = _tensors(2), _tensors(3)
    save_file({"x": a["w.F32"], "shared": a["w.BF16"]},
              str(shards / "model-00001-of-00002.safetensors"))
    write_safetensors(str(shards / "model-00002-of-00002.safetensors"),
                      {"y": b["w.I64"], "shared": b["w.BF16"]})
    (shards / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"x": "model-00001-of-00002.safetensors"}}))
    sd = read_state_dict(str(shards))
    # a name in both shards takes the later file's tensor, as a dict update
    # in sorted file order does in the JAX loader
    _same(sd, {"x": a["w.F32"], "y": b["w.I64"], "shared": b["w.BF16"]})

    binary = tmp_path / "bin"
    binary.mkdir()
    torch.save({"x": a["w.F16"]}, str(binary / "pytorch_model.bin"))
    _same(read_state_dict(str(binary)), {"x": a["w.F16"]})


def _raw(tmp_path, header: dict, payload: bytes, n: int | None = None) -> str:
    blob = json.dumps(header).encode()
    path = str(tmp_path / "bad.safetensors")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob) if n is None else n) + blob + payload)
    return path


@pytest.mark.parametrize("case", ["overlap", "past_end", "size_mismatch",
                                  "header_past_file", "not_json", "bad_dtype",
                                  "negative_shape", "short_file"])
def test_malformed_headers_are_rejected(tmp_path, case):
    good = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
            "b": {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}}
    payload = bytes(16)
    if case == "overlap":
        good["b"]["data_offsets"] = [4, 12]
        path = _raw(tmp_path, good, payload)
    elif case == "past_end":
        path = _raw(tmp_path, good, payload[:12])
    elif case == "size_mismatch":
        good["b"]["shape"] = [3]
        path = _raw(tmp_path, good, payload)
    elif case == "header_past_file":
        path = _raw(tmp_path, good, payload, n=10_000)
    elif case == "not_json":
        path = str(tmp_path / "bad.safetensors")
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 8) + b"{{{{{{{{" + payload)
    elif case == "bad_dtype":
        good["a"]["dtype"] = "Q7"
        path = _raw(tmp_path, good, payload)
    elif case == "negative_shape":
        good["a"]["shape"] = [-2]
        good["a"]["data_offsets"] = [0, 0]
        path = _raw(tmp_path, good, payload)
    else:
        path = str(tmp_path / "bad.safetensors")
        with open(path, "wb") as f:
            f.write(b"\x01\x02")
    with pytest.raises(SafetensorsError):
        read_safetensors(path)
