"""The port's fleet RPC transport (`nanorlhf_tpu_torch/orchestrator/rpc.py`)
against the JAX package's (`tests/test_fleet_rpc.py`'s counterparts):

- JAX's wire and loopback unit tests (the codec round trip, torn and
  corrupt frames, the net.* fault grammar, the weight stream with zero
  disk writes, epoch fencing of a partitioned worker's late completion,
  reconnect + re-handshake, missed heartbeats, the six-mode network fault
  matrix with bit-identical streams, the /statusz transport table) run
  against the port's copies;
- the port's own wire format: frames of numpy arrays (and of torch tensors
  of numpy's dtypes) are byte-identical to JAX's encoder, header included;
  bfloat16 crosses as its uint16 bits under its dtype name and decodes to
  a `torch.bfloat16` tensor bit for bit, with neither `ml_dtypes` nor JAX
  importable; a published snapshot of bf16 tensors streams to a worker bit
  for bit with zero disk writes.
"""

import builtins
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_counterparts import run_jax_test
from nanorlhf_tpu.orchestrator import rpc as jrpc
from nanorlhf_tpu_torch.orchestrator import (
    BoundedStalenessQueue,
    FleetConfig,
    FleetCoordinator,
    VersionedWeightStore,
)
from nanorlhf_tpu_torch.orchestrator import rpc
from nanorlhf_tpu_torch.orchestrator.orchestrator import SnapshotTree

torch.set_num_threads(1)

JAX_UNITS = [
    ("test_codec_roundtrip_bit_identical", {}),
    ("test_framing_detects_torn_and_corrupt_frames", {}),
    ("test_net_fault_spec_grammar", {}),
    ("test_fetch_weights_round_trips_bit_identical_with_zero_disk_writes", {}),
    ("test_partition_fencing_drops_late_completion_with_ledger_event", {}),
    ("test_reconnect_rehandshakes_and_counts", {}),
    ("test_heartbeat_miss_counted_not_fatal", {}),
    ("test_statusz_snapshot_carries_transport_state", {}),
] + [("test_rpc_fault_matrix_streams_bit_identical", {"spec": s}) for s in (
    None, "net.drop:at=3", "net.duplicate:every=2", "net.tear:at=4",
    "net.delay:every=5,delay=0.05", "net.partition:at=2,worker=0,delay=0.3")]


@pytest.mark.parametrize("name,params", JAX_UNITS,
                         ids=[f"{n}[{p.get('spec', '')}]" for n, p in JAX_UNITS])
def test_jax_units_hold_on_the_port(name, params, monkeypatch, tmp_path):
    swapped = run_jax_test(monkeypatch, "test_fleet_rpc", name,
                           {"tmp_path": tmp_path, "monkeypatch": monkeypatch}, **params)
    assert {"rpc", "FleetCoordinator", "VersionedWeightStore"} <= set(swapped)


# ---------------------------------------------------------------------------
# the port's wire format
# ---------------------------------------------------------------------------

def _corpus():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f64": rng.standard_normal(4),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "i8": rng.integers(-128, 127, 9).astype(np.int8),
        "i32": rng.integers(-9, 9, (2, 3, 4)).astype(np.int32),
        "i64": rng.integers(-9, 9, (7,)).astype(np.int64),
        "u8": rng.integers(0, 255, 6).astype(np.uint8),
        "bool": rng.random((3, 3)) > 0.5,
        "0d": np.asarray(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "nested": [{"a": (1, "x", None), "b": b"\x00\x01"}, 2 ** 70, -3.25, True],
    }


def test_numpy_frames_are_byte_identical_to_jax():
    """The codec and the framing of numpy data are JAX's byte for byte, and
    a torch tensor of a numpy dtype encodes as its numpy array."""
    obj = _corpus()
    assert rpc.dumps(obj) == jrpc.dumps(obj)
    for k, v in obj.items():
        if isinstance(v, np.ndarray) and v.dtype != np.float16 or k == "f16":
            assert rpc.dumps(torch.from_numpy(np.ascontiguousarray(v))) == jrpc.dumps(v), k
    frames = []
    for mod in (rpc, jrpc):
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, mod.dumps(obj), kind=mod.KIND_OBJ)
            a.shutdown(socket.SHUT_WR)
            buf = b""
            while chunk := b.recv(1 << 16):
                buf += chunk
            frames.append(buf)
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]
    kind, payload = None, None
    a, b = socket.socketpair()
    try:
        a.sendall(frames[1])
        kind, payload = rpc.recv_frame(b)
    finally:
        a.close()
        b.close()
    dec = rpc.loads(payload)
    for k, v in obj.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(dec[k], v)
            assert dec[k].dtype == v.dtype


_BF16_CHILD = r"""
import sys
sys.modules["ml_dtypes"] = None    # neither is importable here
sys.modules["jax"] = None
import builtins, struct
import numpy as np, torch
from nanorlhf_tpu_torch.orchestrator import rpc
from nanorlhf_tpu_torch.orchestrator import (BoundedStalenessQueue, FleetConfig,
                                             FleetCoordinator, VersionedWeightStore)
bits = np.asarray([0x0000, 0x8000, 0x3F80, 0x7F80, 0xFF80, 0x7FC1, 0x0001, 0x807F,
                   0x4049, 0xC2F7], np.uint16)
t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).reshape(2, 5)
back = rpc.loads(rpc.dumps({"w": t}))["w"]
assert back.dtype == torch.bfloat16 and back.shape == t.shape
assert np.array_equal(back.view(torch.int16).numpy().view(np.uint16), bits.reshape(2, 5))
q = BoundedStalenessQueue(10, "wait")
coord = FleetCoordinator(q, lambda: np.asarray([0]), config=FleetConfig(poll_interval=0.02))
store = VersionedWeightStore()
store.publish({"emb": t, "f": torch.arange(6, dtype=torch.float32)})
server = rpc.FleetRpcServer(coord, store)
client = rpc.RpcClient(server.address, 0, config=rpc.RpcConfig(chunk_bytes=8))
v, tree = client.fetch_weights()
assert v == 0 and tree["emb"].dtype == torch.bfloat16
assert torch.equal(tree["emb"].view(torch.int16), t.view(torch.int16))
assert tree["f"].dtype == np.float32 and (tree["f"] == np.arange(6)).all()
client.close(); server.close(); coord.close()
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m] is not None]
print("BF16_OK")
"""


def test_bf16_crosses_the_wire_without_ml_dtypes():
    """bfloat16 (every class of value: zeros, ±inf, NaN, subnormals) round
    trips bit for bit through the codec and the weight stream in a process
    where neither `ml_dtypes` nor JAX can be imported."""
    out = subprocess.run([sys.executable, "-c", _BF16_CHILD], capture_output=True,
                         text=True, timeout=120)
    assert "BF16_OK" in out.stdout, out.stderr[-2000:]


def test_fetch_weights_streams_a_bf16_snapshot_bit_for_bit(monkeypatch):
    """A published snapshot of torch leaves (bf16 and f32, as the trainer
    publishes them) reaches a worker bit for bit, with zero disk writes;
    the server reads the leaves after the snapshot's ready event."""
    class Ready:
        waited = 0

        def synchronize(self):
            Ready.waited += 1

    gen = torch.Generator().manual_seed(0)
    snap = SnapshotTree({"embed_tokens": torch.randn(16, 8, generator=gen).to(torch.bfloat16),
                         "lora": {"a": torch.randn(3, 4, generator=gen)}})
    snap.ready = Ready()
    q = BoundedStalenessQueue(10, "wait")
    coord = FleetCoordinator(q, lambda: np.asarray([0]), config=FleetConfig(poll_interval=0.02))
    store = VersionedWeightStore()
    store.publish(snap)
    server = rpc.FleetRpcServer(coord, store)
    client = rpc.RpcClient(server.address, 0, config=rpc.RpcConfig(chunk_bytes=64))
    writes = []
    real_open = builtins.open

    def spy(file, mode="r", *a, **kw):
        if any(c in str(mode) for c in "wax+"):
            writes.append(file)
        return real_open(file, mode, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    try:
        v, tree = client.fetch_weights()
    finally:
        monkeypatch.setattr(builtins, "open", real_open)
        client.close()
        server.close()
        coord.close()
    assert v == 0 and writes == [] and Ready.waited == 1
    assert torch.equal(tree["embed_tokens"].view(torch.int16),
                       snap["embed_tokens"].view(torch.int16))
    np.testing.assert_array_equal(tree["lora"]["a"], snap["lora"]["a"].numpy())
