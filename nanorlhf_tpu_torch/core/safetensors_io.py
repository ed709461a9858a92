"""A safetensors reader and writer in plain PyTorch — the card's machine has
no `safetensors` package, and numpy cannot hold bf16 without `ml_dtypes`.

The format: an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}`, offsets relative to the byte after the header), then the raw
little-endian tensor bytes. The reader maps the file privately
(copy-on-write, so the tensors it hands out are writable views that never
touch the file) and returns `torch.frombuffer` views: no byte is copied
until a caller copies a tensor, which lets `core/params.py` build each
stacked leaf on the device one layer slice at a time. A header whose
offsets overlap, disagree with the shape, or run past the file is
rejected.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct

import torch

# the dtypes a Qwen2 / Llama checkpoint uses
DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I64": torch.int64,
    "I32": torch.int32,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024  # the safetensors library's own limit


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file."""


def _parse_header(path: str, size: int, head: bytes) -> tuple[dict, dict, int]:
    """(entries, metadata, data start) of a file of `size` bytes."""
    if size < 8:
        raise SafetensorsError(f"{path}: {size} bytes, no header length")
    (n,) = struct.unpack("<Q", head[:8])
    if n > _MAX_HEADER or 8 + n > size:
        raise SafetensorsError(f"{path}: header of {n} bytes runs past the file")
    try:
        header = json.loads(head[8:8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{path}: header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    start, payload = 8 + n, size - 8 - n
    spans = []
    for name, e in header.items():
        try:
            dtype = DTYPES[e["dtype"]]
            shape = [int(s) for s in e["shape"]]
            begin, end = (int(o) for o in e["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise SafetensorsError(f"{path}: bad entry {name!r}: {e!r}") from None
        want = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        if min(shape, default=0) < 0 or not 0 <= begin <= end <= payload \
                or end - begin != want:
            raise SafetensorsError(
                f"{path}: {name!r} spans [{begin}, {end}) for {want} bytes in a "
                f"{payload}-byte payload")
        spans.append((begin, end, name))
    spans.sort()
    for (_, end0, a), (begin1, _, b) in zip(spans, spans[1:]):
        if begin1 < end0:
            raise SafetensorsError(f"{path}: {a!r} and {b!r} overlap")
    return header, metadata, start


def read_safetensors(path: str) -> tuple[dict, dict]:
    """({name: CPU tensor view}, metadata) of one safetensors file. The
    views keep the private mapping alive."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) == 8:
            head += f.read(min(struct.unpack("<Q", head)[0], _MAX_HEADER))
        header, metadata, start = _parse_header(path, size, head)
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
    tensors = {}
    for name, e in header.items():
        dtype, shape = DTYPES[e["dtype"]], e["shape"]
        begin, end = e["data_offsets"]
        if end == begin:
            tensors[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin,
                                offset=start + begin)
        tensors[name] = flat.view(dtype).view(shape)
    return tensors, metadata


def write_safetensors(path: str, tensors: dict, metadata: dict | None = None) -> None:
    """Write `tensors` ({name: tensor}, any device) to `path` with
    `__metadata__` = `metadata` (default {"format": "pt"}, what
    `safetensors.torch.save_file` writes). Tensors are copied to the host
    one at a time. The header is padded with spaces to 8 bytes, as the
    library pads it."""
    header: dict = {"__metadata__": dict(metadata or {"format": "pt"})}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name here")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                host = t.detach().to("cpu").contiguous().reshape(-1)
                f.write(host.view(torch.uint8).numpy().data)


def read_state_dict(model_dir: str) -> dict:
    """The state dict of an HF model directory, as `load_hf_checkpoint` in
    the JAX package reads it: every `*.safetensors` file in sorted order (an
    index file is not read), else `pytorch_model.bin`."""
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        return torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                          map_location="cpu", weights_only=True)
    state: dict = {}
    for name in files:
        state.update(read_safetensors(os.path.join(model_dir, name))[0])
    return state
