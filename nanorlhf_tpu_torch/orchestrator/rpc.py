"""Network FleetTransport: length-prefixed binary RPC over loopback/LAN
(docs/FLEET.md §multi-host).

The fleet's control plane sits behind the 3-call FleetTransport
seam, whose in-process half is `InProcessTransport`; this module fills in
the network half with nothing but the stdlib (socket/struct/threading — the
exporter's no-dependency discipline):

- **framing** — every message is one frame: a 13-byte header
  (magic ``nRPC``, kind byte, payload length, CRC32) followed by the
  payload. A torn/half-written frame is detected by length+checksum and
  surfaces as `TornFrame`, a RECOVERABLE transport error: the connection
  drops, the caller retries with jittered backoff
  (`resilience/retry.py`), and persistent failure charges the worker's
  `fleet_failure_budget` — neither side crashes.
- **codec** — a small tagged binary encoding for the JSON-ish + ndarray
  payloads that cross the wire (leases, completions, param trees). No
  pickle: the decoder can only produce data, never code. Arrays travel
  as dtype/shape + raw C-order buffers and round-trip bit-identically.
- **server** (`FleetRpcServer`) — coordinator-side, thread-per-connection.
  Wraps the real `FleetCoordinator` + `VersionedWeightStore` and speaks
  the op set: hello / acquire / complete / heartbeat / fetch_weights /
  worker_failed / lease_revoked / index_done. It is also the transport
  stats provider behind `FleetCoordinator.snapshot()` — the /statusz
  fleet table grows per-worker connection state, RTT, retries, epochs.
- **client** (`RpcClient` + `RemoteCoordinator` + `RpcTransport`) —
  worker-side. Every call gets a per-attempt socket timeout and
  `retry_with_backoff`; a dead connection reconnects and re-handshakes
  (worker id, last lease epoch, last weight version) before the retry
  goes out. `RemoteCoordinator` mirrors the coordinator surface the
  worker loop uses (acquire/complete/worker_failed/...), so
  `RolloutWorker` runs unchanged over the network.

**Fencing.** Leases carry a monotonically increasing *epoch* (fencing
token, stamped by the coordinator at grant time). A partitioned worker
whose lease expired and was re-dispatched can still deliver its late
completion after the link heals — the coordinator compares the
completion's epoch against the highest epoch granted for that index and
rejects stale ones, emitting the existing `fleet_late_duplicate` lineage
drop with ``{"fenced": true, "epoch": ...}``. First-completion-wins
dedup handles races between live workers; the epoch handles the
split-brain case dedup cannot: a revoked holder racing its replacement.

**Weight streaming.** `fetch_weights` streams the versioned store's
param tree with zero disk writes: one header frame (version tag, tree
structure with leaf placeholders, per-leaf dtype/shape/nbytes), then the
leaf buffers as chunked raw frames tagged ``(leaf, offset)`` — chunk
writes are idempotent, so a net.duplicate'd frame is absorbed by
construction. The client caches the last tree by version and sends
``have_version`` so an unchanged policy costs one tiny round trip.

**Fault injection.** The `net.{drop,delay,partition,duplicate,tear}`
sites (resilience/faults.py) fire inside `send_frame` on both the client
request path and the server response path; `net.partition` is client
link state (every call fails fast until the window passes). All
deterministic under the existing `worker=I`/`at=N`/`every=K` grammar.

Loopback is the tested deployment (CPU CI: workers in threads, one
process); the same wire format runs cross-host — see docs/FLEET.md for
the deployment sketch and the native-endianness caveat on arrays.

The port's copy of `nanorlhf_tpu/orchestrator/rpc.py`
(`tests/test_torch_fleet_rpc.py` holds it against the original). Frames
of numpy arrays are byte-identical to the JAX encoder's. Torch tensors
cross the wire as host arrays (`_wire_array`): every dtype numpy knows
travels as its numpy array, and bfloat16 — which JAX decodes through
`ml_dtypes`, a package the port does not depend on — travels as its
uint16 bits under the dtype name "bfloat16" and decodes to a CPU
`torch.bfloat16` tensor through `view`, bit for bit. The weight server
waits on a published snapshot's `ready` event before it reads the leaves,
and a transport waits on an event of the worker's stream before a
completion leaves (`device_ready`) where JAX calls
`jax.block_until_ready`.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading

from nanorlhf_tpu_torch.analysis.lockorder import make_lock, make_rlock
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from nanorlhf_tpu_torch.orchestrator.fleet import FleetTransport, Lease
from nanorlhf_tpu_torch.orchestrator.orchestrator import device_ready
from nanorlhf_tpu_torch.orchestrator.sample_queue import QueuedSample
from nanorlhf_tpu_torch.resilience.retry import retry_with_backoff

_MAGIC = b"nRPC"
_HEADER = struct.Struct("!4sBII")  # magic, kind, payload length, crc32
_MAX_FRAME = 1 << 31
KIND_OBJ = 1    # payload is a codec-encoded object (request/response)
KIND_CHUNK = 2  # payload is !II (leaf, offset) + raw weight bytes
_NET_DEAD = (OSError, EOFError)


class TransportError(RuntimeError):
    """Recoverable transport-level failure (reset, timeout, torn frame,
    injected net fault). The client retries with backoff; retries that
    exhaust surface to the worker loop as an ordinary recoverable failure
    charging the fleet failure budget."""


class TornFrame(TransportError):
    """A frame failed the length/checksum check (half-written frame, torn
    connection, corrupted payload). Both sides treat it as recoverable:
    drop the connection, reconnect, retry."""


class ConnectionClosed(TransportError):
    """Clean EOF at a frame boundary — the peer hung up between frames."""


class RemoteCallError(RuntimeError):
    """The server executed the request and the HANDLER raised — an
    application error, not a transport error; never retried blindly."""


# --------------------------------------------------------------------- #
# framing
# --------------------------------------------------------------------- #


def _recv_exact(sock: socket.socket, n: int, *, at_boundary: bool = False
                ) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if at_boundary and not buf:
                raise ConnectionClosed("peer closed the connection")
            raise TornFrame(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> tuple[int, bytes]:
    """Read one frame -> (kind, payload). Raises ConnectionClosed on clean
    EOF between frames, TornFrame on a truncated/corrupt frame."""
    hdr = _recv_exact(sock, _HEADER.size, at_boundary=True)
    magic, kind, length, crc = _HEADER.unpack(hdr)
    if magic != _MAGIC:
        raise TornFrame(f"bad frame magic {magic!r}")
    if length > _MAX_FRAME:
        raise TornFrame(f"oversized frame ({length} bytes)")
    payload = _recv_exact(sock, length)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise TornFrame("frame checksum mismatch")
    return kind, payload


def send_frame(sock: socket.socket, payload: bytes, kind: int = KIND_OBJ,
               faults=None, worker: Optional[int] = None) -> int:
    """Write one frame; returns bytes put on the wire. The net.* fault
    sites live here — one `fire()` sweep per frame, on whichever side is
    sending, so both directions are coverable (net.partition is handled
    by the client's link state, not per-frame)."""
    frame = _HEADER.pack(
        _MAGIC, kind, len(payload), zlib.crc32(payload) & 0xFFFFFFFF
    ) + payload
    if faults is not None and faults.armed:
        act = faults.fire("net.delay", worker=worker)
        if act is not None and act.startswith("delay:"):
            time.sleep(float(act.split(":", 1)[1]))
        if faults.fire("net.drop", worker=worker) is not None:
            _hard_close(sock)
            raise TransportError("injected net.drop: frame lost")
        if faults.fire("net.tear", worker=worker) is not None:
            # half-write the payload then kill the connection: the peer
            # reads a full header promising more bytes than arrive
            try:
                sock.sendall(frame[: _HEADER.size + max(0, len(payload) // 2)])
            except _NET_DEAD:
                pass
            _hard_close(sock)
            raise TransportError("injected net.tear: frame truncated")
        if faults.fire("net.duplicate", worker=worker) is not None:
            sock.sendall(frame)
            sock.sendall(frame)
            return 2 * len(frame)
    sock.sendall(frame)
    return len(frame)


def _hard_close(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


# --------------------------------------------------------------------- #
# codec: tagged binary encoding (no pickle — data in, data out)
# --------------------------------------------------------------------- #

_U32 = struct.Struct("!I")
_I64 = struct.Struct("!q")
_F64 = struct.Struct("!d")


def dumps(obj) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def loads(buf: bytes):
    obj, off = _dec(buf, 0)
    if off != len(buf):
        raise TornFrame(f"trailing garbage after object ({len(buf) - off}B)")
    return obj


def _enc(obj, out: bytearray) -> None:
    if isinstance(obj, np.generic):  # numpy scalar -> python scalar
        obj = obj.item()
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, int):
        if -(2 ** 63) <= obj < 2 ** 63:
            out += b"i"
            out += _I64.pack(obj)
        else:
            b = obj.to_bytes((obj.bit_length() + 8) // 8, "big", signed=True)
            out += b"I" + _U32.pack(len(b)) + b
    elif isinstance(obj, float):
        out += b"d"
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += b"s" + _U32.pack(len(b)) + b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out += b"b" + _U32.pack(len(b)) + b
    elif isinstance(obj, list):
        out += b"l" + _U32.pack(len(obj))
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, tuple):
        out += b"t" + _U32.pack(len(obj))
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, dict):
        out += b"m" + _U32.pack(len(obj))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    elif _is_arraylike(obj):
        a, name = _wire_array(obj)
        # dtype by NAME (native endianness — loopback/LAN of like hosts;
        # bfloat16 as its uint16 bits under its own name)
        ds = name.encode("ascii")
        out += b"a" + struct.pack("!B", len(ds)) + ds
        out += struct.pack("!B", a.ndim)
        out += struct.pack(f"!{a.ndim}q", *a.shape)
        out += struct.pack("!Q", a.nbytes) + a.tobytes()
    else:
        raise TypeError(f"rpc codec cannot encode {type(obj).__name__}")


def _is_arraylike(obj) -> bool:
    # ndarray, torch.Tensor, anything array-protocol'd that isn't a builtin
    return isinstance(obj, (np.ndarray, torch.Tensor)) or hasattr(obj, "__array__")


_BF16 = "bfloat16"


def _wire_array(obj) -> tuple[np.ndarray, str]:
    """(C-order host array, dtype name on the wire) of an array leaf: a
    torch tensor is copied to the host (bfloat16 as its uint16 bits under
    the name "bfloat16"), anything else goes through `np.asarray`."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(obj)
    a = np.ascontiguousarray(a)
    return a, a.dtype.name


def _dtype(name: str) -> np.dtype:
    """The numpy dtype frames of dtype `name` are read as: bfloat16's bits
    as uint16 (`_from_wire` views them back); numpy's own names as they
    are. No extension-dtype package is needed."""
    return np.dtype(np.uint16) if name == _BF16 else np.dtype(name)


def _from_wire(a: np.ndarray, name: str):
    """A decoded array: bfloat16 bits become a CPU `torch.bfloat16`
    tensor, every other dtype stays the numpy array."""
    if name == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return a


def _dec(buf: bytes, off: int):
    tag = buf[off:off + 1]
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"i":
        return _I64.unpack_from(buf, off)[0], off + 8
    if tag == b"I":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        return int.from_bytes(buf[off:off + n], "big", signed=True), off + n
    if tag == b"d":
        return _F64.unpack_from(buf, off)[0], off + 8
    if tag == b"s":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        return buf[off:off + n].decode("utf-8"), off + n
    if tag == b"b":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        return buf[off:off + n], off + n
    if tag in (b"l", b"t"):
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        items = []
        for _ in range(n):
            v, off = _dec(buf, off)
            items.append(v)
        return (items if tag == b"l" else tuple(items)), off
    if tag == b"m":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(buf, off)
            v, off = _dec(buf, off)
            d[k] = v
        return d, off
    if tag == b"a":
        dlen = buf[off]
        off += 1
        name = buf[off:off + dlen].decode("ascii")
        dtype = _dtype(name)
        off += dlen
        ndim = buf[off]
        off += 1
        shape = struct.unpack_from(f"!{ndim}q", buf, off)
        off += 8 * ndim
        nbytes = struct.unpack_from("!Q", buf, off)[0]
        off += 8
        a = np.frombuffer(buf, dtype=dtype, count=int(np.prod(shape, dtype=np.int64)) if ndim else 1,
                          offset=off).reshape(shape)
        # copy: writable, detached from buf
        return _from_wire(a.copy(), name), off + nbytes
    raise TornFrame(f"unknown codec tag {tag!r} at offset {off - 1}")


# --------------------------------------------------------------------- #
# lease / tree (de)serialization
# --------------------------------------------------------------------- #


def encode_lease(lease: Lease) -> dict:
    return {
        "lease_id": lease.lease_id,
        "worker_id": lease.worker_id,
        "start": lease.start,
        "epoch": lease.epoch,
        "issued_at": lease.issued_at,
        "deadline": lease.deadline,
        "reassigned_from": lease.reassigned_from,
        "batches": list(lease.batches),
    }


def decode_lease(d: dict) -> Lease:
    return Lease(
        lease_id=d["lease_id"], worker_id=d["worker_id"], start=d["start"],
        batches=list(d["batches"]), issued_at=d["issued_at"],
        deadline=d["deadline"], reassigned_from=d.get("reassigned_from"),
        epoch=d.get("epoch", 0),
    )


_LEAF = "__nrpc_leaf__"


def split_leaves(tree):
    """(structure, leaves): the tree with every array leaf replaced by a
    (_LEAF, i) placeholder, plus (host array, wire dtype name) pairs in
    placeholder order."""
    leaves: list = []

    def rec(x):
        if isinstance(x, dict):
            return {k: rec(v) for k, v in x.items()}
        if isinstance(x, list):
            return [rec(v) for v in x]
        if isinstance(x, tuple):
            return tuple(rec(v) for v in x)
        if _is_arraylike(x) and not isinstance(x, (str, bytes)):
            leaves.append(_wire_array(x))
            return (_LEAF, len(leaves) - 1)
        return x

    return rec(tree), leaves


def join_leaves(structure, leaves):
    def rec(x):
        if isinstance(x, dict):
            return {k: rec(v) for k, v in x.items()}
        if isinstance(x, list):
            return [rec(v) for v in x]
        if isinstance(x, tuple):
            if len(x) == 2 and x[0] == _LEAF:
                return leaves[x[1]]
            return tuple(rec(v) for v in x)
        return x

    return rec(structure)


# --------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class RpcConfig:
    """Transport knobs (mirrored by RLConfig.fleet_rpc_*)."""

    host: str = "127.0.0.1"
    port: int = 0                 # 0 = ephemeral (the test/CI default)
    call_timeout: float = 10.0    # per-attempt socket timeout, seconds
    attempts: int = 4             # retry_with_backoff attempts per call
    backoff_base: float = 0.05
    backoff_max: float = 1.0
    poll_interval: float = 0.05   # client acquire-poll cadence
    chunk_bytes: int = 1 << 18    # weight-stream chunk size
    weight_timeout: float = 600.0  # server-side wait for a first publish
    rtt_alpha: float = 0.3


# --------------------------------------------------------------------- #
# coordinator-side server
# --------------------------------------------------------------------- #


class FleetRpcServer:
    """Thread-per-connection RPC server wrapping the live FleetCoordinator
    and VersionedWeightStore. Binds at construction (ephemeral port by
    default — `address` is the (host, port) workers dial) and registers
    itself as the coordinator's transport stats provider, which is how the
    /statusz fleet table grows per-worker connection state."""

    def __init__(self, coordinator, store, config: Optional[RpcConfig] = None,
                 faults=None):
        self.cfg = config or RpcConfig()
        self._coord = coordinator
        self._store = store
        self._faults = faults
        self._lock = make_lock("rpc.server")
        self._closed = threading.Event()
        self._peers: dict[int, dict] = {}  # worker_id -> transport record
        self._bytes_tx = 0
        self._bytes_rx = 0
        self._errors = 0  # torn frames / undecodable payloads / send faults
        self._sock = socket.create_server((self.cfg.host, self.cfg.port))
        self._sock.settimeout(0.2)
        self.address: tuple[str, int] = self._sock.getsockname()[:2]
        coordinator.set_transport("rpc", self.transport_info)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="fleet-rpc-accept"
        )
        self._accept_thread.start()

    # ------------------------------------------------------------ #

    def close(self) -> None:
        self._closed.set()
        _hard_close(self._sock)
        self._accept_thread.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(0.5)  # short recv slices: poll closed between
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name="fleet-rpc-conn",
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        wid: Optional[int] = None
        try:
            while not self._closed.is_set():
                try:
                    kind, payload = recv_frame(conn)
                except socket.timeout:
                    continue
                except ConnectionClosed:
                    break
                except TornFrame:
                    self._note_error(wid)
                    break
                except _NET_DEAD:
                    break
                self._note_rx(wid, _HEADER.size + len(payload))
                if kind != KIND_OBJ:
                    continue  # stray duplicated chunk frame: ignore
                try:
                    req = loads(payload)
                    assert isinstance(req, dict)
                except Exception:
                    self._note_error(wid)
                    break
                if req.get("worker_id") is not None:
                    wid = int(req["worker_id"])
                try:
                    self._handle(conn, req, wid)
                except TransportError:
                    break  # injected send fault: connection is gone
                except _NET_DEAD:
                    break
        finally:
            _hard_close(conn)
            if wid is not None:
                with self._lock:
                    peer = self._peers.get(wid)
                    if peer is not None and peer["state"] == "connected":
                        peer["state"] = "reconnecting"

    # ------------------------------------------------------------ #

    def _handle(self, conn, req: dict, wid: Optional[int]) -> None:
        op = req.get("op")
        seq = req.get("seq", 0)
        try:
            if op == "fetch_weights":
                self._handle_fetch_weights(conn, req, wid)
                return
            resp = self._dispatch_op(op, req, wid)
        except (TransportError,) + _NET_DEAD:
            raise
        except Exception as e:  # application error -> error response
            resp = {"error": f"{type(e).__name__}: {e}"}
        resp["seq"] = seq
        self._send_obj(conn, resp, wid)

    def _dispatch_op(self, op, req: dict, wid: Optional[int]) -> dict:
        coord = self._coord
        if op == "hello":
            with self._lock:
                peer = self._peers.setdefault(wid, _new_peer())
                peer["hellos"] += 1
                peer["state"] = "connected"
                peer["last_epoch"] = int(req.get("last_epoch", 0))
                peer["last_weight_version"] = int(
                    req.get("last_weight_version", -1)
                )
                _merge_client_stats(peer, req.get("stats"))
            return {"ok": True, "version": self._store.version,
                    "epoch": coord.current_epoch}
        if op == "heartbeat":
            coord.heartbeat(wid)
            with self._lock:
                peer = self._peers.setdefault(wid, _new_peer())
                _merge_client_stats(peer, req.get("stats"))
            return {"ok": True}
        if op == "acquire":
            lease, stopped = coord.acquire_nowait(wid)
            return {
                "lease": encode_lease(lease) if lease is not None else None,
                "stop": stopped,
            }
        if op == "complete":
            sample = QueuedSample(
                index=int(req["index"]), version=int(req["version"]),
                payload=req["payload"],
                dispatch_time=float(req["dispatch_time"]),
                ready_time=float(req["ready_time"]),
            )
            lease = coord.lease_by_id(int(req["lease_id"]))
            if lease is None:
                # revoked + pruned already: a stub carries the id/epoch the
                # fencing check and drop attribution need
                lease = Lease(
                    lease_id=int(req["lease_id"]), worker_id=wid,
                    start=sample.index, batches=[None], issued_at=0.0,
                    deadline=0.0, epoch=int(req.get("epoch", 0)),
                )
            accepted = coord.complete(wid, lease, sample.index, sample)
            with self._lock:
                peer = self._peers.setdefault(wid, _new_peer())
                peer["last_epoch"] = max(
                    peer["last_epoch"], int(req.get("epoch", 0))
                )
            return {"accepted": accepted}
        if op == "worker_failed":
            lease = None
            if req.get("lease_id") is not None:
                lease = coord.lease_by_id(int(req["lease_id"]))
            coord.worker_failed(
                wid, lease,
                RemoteCallError(str(req.get("message", "remote failure"))),
                fatal=bool(req.get("fatal", False)),
            )
            return {"ok": True}
        if op == "lease_revoked":
            return {"revoked": not coord.lease_active(int(req["lease_id"]))}
        if op == "index_done":
            return {"done": coord.index_done(int(req["index"]))}
        raise ValueError(f"unknown rpc op {op!r}")

    def _handle_fetch_weights(self, conn, req: dict, wid) -> None:
        seq = req.get("seq", 0)
        have = int(req.get("have_version", -1))
        if have >= 0 and self._store.version == have:
            self._send_obj(conn, {"seq": seq, "unchanged": True,
                                  "version": have}, wid)
            return
        try:
            version, tree = self._store.wait_for_version(
                0, timeout=self.cfg.weight_timeout
            )
        except TimeoutError as e:
            self._send_obj(conn, {"seq": seq,
                                  "error": f"TimeoutError: {e}"}, wid)
            return
        ready = getattr(tree, "ready", None)
        if ready is not None:
            ready.synchronize()  # the snapshot's copies have landed
        structure, leaves = split_leaves(tree)
        header = {
            "seq": seq, "version": version, "structure": structure,
            "leaves": [
                {"dtype": name, "shape": list(a.shape), "nbytes": a.nbytes}
                for a, name in leaves
            ],
        }
        self._send_obj(conn, header, wid)
        # leaf buffers as chunked raw frames tagged (leaf, offset): chunk
        # placement is idempotent, so a net.duplicate'd frame is harmless
        chunk = self.cfg.chunk_bytes
        for i, (a, _name) in enumerate(leaves):
            raw = a.tobytes()
            for off in range(0, max(1, len(raw)), chunk):
                body = struct.pack("!II", i, off) + raw[off:off + chunk]
                n = send_frame(conn, body, kind=KIND_CHUNK,
                               faults=self._faults, worker=wid)
                self._note_tx(wid, n)

    # ------------------------------------------------------------ #

    def _send_obj(self, conn, obj: dict, wid) -> None:
        n = send_frame(conn, dumps(obj), kind=KIND_OBJ,
                       faults=self._faults, worker=wid)
        self._note_tx(wid, n)

    def _note_tx(self, wid, n: int) -> None:
        with self._lock:
            self._bytes_tx += n
            if wid is not None:
                self._peers.setdefault(wid, _new_peer())["bytes_tx"] += n

    def _note_rx(self, wid, n: int) -> None:
        with self._lock:
            self._bytes_rx += n
            if wid is not None:
                self._peers.setdefault(wid, _new_peer())["bytes_rx"] += n

    def _note_error(self, wid) -> None:
        with self._lock:
            self._errors += 1
            if wid is not None:
                self._peers.setdefault(wid, _new_peer())["errors"] += 1

    def transport_info(self) -> dict:
        """Stats provider for FleetCoordinator.stats()/snapshot(): flat
        counters for the fleet/rpc_* metric rows plus the per-worker
        connection table for /statusz."""
        with self._lock:
            peers = {w: dict(p) for w, p in self._peers.items()}
        rtts = [p["rtt_ewma_s"] for p in peers.values()
                if p["rtt_ewma_s"] > 0.0]
        return {
            "name": "rpc",
            "counters": {
                "rpc_retries": float(sum(p["retries"]
                                         for p in peers.values())),
                "rpc_reconnects": float(sum(max(0, p["hellos"] - 1)
                                            for p in peers.values())),
                "rpc_rtt_ewma_s": float(np.mean(rtts)) if rtts else 0.0,
                "rpc_bytes_tx": float(self._bytes_tx),
                "rpc_bytes_rx": float(self._bytes_rx),
                "rpc_errors": float(self._errors + sum(
                    p["errors"] for p in peers.values()
                )),
                "heartbeat_misses": float(sum(p["heartbeat_misses"]
                                              for p in peers.values())),
            },
            "per_worker": {
                w: {
                    "state": ("partitioned" if p["partitioned"]
                              else p["state"]),
                    "rtt_ewma_s": round(p["rtt_ewma_s"], 6),
                    "retries": p["retries"],
                    "reconnects": max(0, p["hellos"] - 1),
                    "heartbeat_misses": p["heartbeat_misses"],
                    "bytes_tx": p["bytes_tx"],
                    "bytes_rx": p["bytes_rx"],
                    "last_epoch": p["last_epoch"],
                    "last_weight_version": p["last_weight_version"],
                }
                for w, p in peers.items()
            },
        }


def _new_peer() -> dict:
    return {
        "state": "reconnecting", "hellos": 0, "retries": 0,
        "heartbeat_misses": 0, "rtt_ewma_s": 0.0, "bytes_tx": 0,
        "bytes_rx": 0, "errors": 0, "last_epoch": 0,
        "last_weight_version": -1, "partitioned": False,
    }


def _merge_client_stats(peer: dict, stats) -> None:
    if not isinstance(stats, dict):
        return
    for k in ("retries", "heartbeat_misses"):
        if k in stats:
            peer[k] = int(stats[k])
    if "rtt_ewma_s" in stats:
        peer["rtt_ewma_s"] = float(stats["rtt_ewma_s"])
    peer["partitioned"] = bool(stats.get("partitioned", False))


# --------------------------------------------------------------------- #
# worker-side client
# --------------------------------------------------------------------- #


class RpcClient:
    """One worker's connection to the coordinator server: request/response
    with sequence numbers (stale duplicated replies are discarded by seq),
    per-attempt socket timeout, retry-with-backoff, and reconnect +
    re-handshake (worker id, last epoch, last weight version) on any
    connection loss. Thread-compatible: a lock serializes wire use."""

    def __init__(self, address: tuple[str, int], worker_id: int,
                 config: Optional[RpcConfig] = None, faults=None,
                 latency=None):
        self.address = (address[0], int(address[1]))
        self.worker_id = int(worker_id)
        self.cfg = config or RpcConfig()
        self._faults = faults
        # telemetry.LatencyHub: per-call-kind RTT histograms — one
        # `latency/rpc_<op>_s` family per op, recorded at the same site
        # as the rtt_ewma_s fold (telemetry.hist ranks above rpc.client
        # in LOCK_ORDER, so recording under self._lock is order-legal)
        self._latency = latency
        self._lock = make_rlock("rpc.client")
        self._sock: Optional[socket.socket] = None
        self._seq = 0
        self._partitioned_until = 0.0
        # client-side transport counters (reported to the server with every
        # hello/heartbeat so the coordinator's /statusz sees them)
        self.connects = 0
        self.retries = 0
        self.heartbeat_misses = 0
        self.rtt_ewma_s = 0.0
        self.last_epoch = 0
        self._cache_version = -1
        self._cache_tree = None

    @property
    def reconnects(self) -> int:
        return max(0, self.connects - 1)

    def stats_payload(self) -> dict:
        return {
            "retries": self.retries,
            "heartbeat_misses": self.heartbeat_misses,
            "rtt_ewma_s": self.rtt_ewma_s,
            "partitioned": time.monotonic() < self._partitioned_until,
        }

    def close(self) -> None:
        with self._lock:
            self._drop()

    # ------------------------------------------------------------ #

    def _drop(self) -> None:
        if self._sock is not None:
            _hard_close(self._sock)
            self._sock = None

    def _check_link(self) -> None:
        """net.partition state: every call fails fast while the link is
        down — the fault fires at most once per call attempt."""
        if time.monotonic() < self._partitioned_until:
            raise TransportError("link partitioned (injected)")
        if self._faults is not None and self._faults.armed:
            act = self._faults.fire("net.partition", worker=self.worker_id)
            if act is not None and act.startswith("partition:"):
                self._partitioned_until = (
                    time.monotonic() + float(act.split(":", 1)[1])
                )
                self._drop()
                raise TransportError("injected net.partition: link down")

    def _ensure_connected(self) -> None:
        if self._sock is not None:
            return
        try:
            sock = socket.create_connection(
                self.address, timeout=self.cfg.call_timeout
            )
        except _NET_DEAD as e:
            raise TransportError(f"connect to {self.address} failed: {e}")
        sock.settimeout(self.cfg.call_timeout)
        self._sock = sock
        self.connects += 1
        # re-handshake: who we are, the last lease epoch we held, and the
        # weight version we already have (resume without a full re-stream)
        resp = self._roundtrip({
            "op": "hello", "worker_id": self.worker_id,
            "last_epoch": self.last_epoch,
            "last_weight_version": self._cache_version,
            "stats": self.stats_payload(),
        })
        if "error" in resp:
            self._drop()
            raise TransportError(f"handshake rejected: {resp['error']}")

    def _roundtrip(self, req: dict) -> dict:
        """One request/response on the live socket; transport faults map to
        TransportError and drop the connection."""
        self._seq += 1
        seq = req["seq"] = self._seq
        sock = self._sock
        try:
            send_frame(sock, dumps(req), kind=KIND_OBJ,
                       faults=self._faults, worker=self.worker_id)
            while True:
                kind, payload = recv_frame(sock)
                if kind != KIND_OBJ:
                    continue  # stray weight chunk from an aborted stream
                resp = loads(payload)
                if isinstance(resp, dict) and resp.get("seq") == seq:
                    return resp
                # stale (duplicated) reply from an earlier seq: discard
        except TransportError:
            self._drop()
            raise
        except socket.timeout as e:
            self._drop()
            raise TransportError(f"call timed out: {e}")
        except _NET_DEAD as e:
            self._drop()
            raise TransportError(f"connection lost: {e}")

    def call(self, op: str, *, attempts: Optional[int] = None,
             stop: Optional[threading.Event] = None, **fields) -> dict:
        """`op` with retry/backoff. Raises TransportError when every
        attempt failed, RemoteCallError when the server's handler raised."""

        def attempt():
            with self._lock:
                self._check_link()
                self._ensure_connected()
                t0 = time.perf_counter()
                resp = self._roundtrip(
                    {"op": op, "worker_id": self.worker_id, **fields}
                )
                rtt = time.perf_counter() - t0
                a = self.cfg.rtt_alpha
                self.rtt_ewma_s = rtt if self.rtt_ewma_s <= 0.0 else (
                    a * rtt + (1 - a) * self.rtt_ewma_s
                )
                if self._latency is not None and self._latency.enabled:
                    self._latency.record(f"latency/rpc_{op}_s", rtt)
            if "error" in resp:
                raise RemoteCallError(resp["error"])
            return resp

        def on_retry(_i, _e):
            self.retries += 1

        sleep = time.sleep if stop is None else (lambda s: stop.wait(s))
        return retry_with_backoff(
            attempt, attempts=attempts or self.cfg.attempts,
            backoff_base=self.cfg.backoff_base,
            backoff_max=self.cfg.backoff_max, jitter=0.25,
            retry_on=(TransportError,), on_retry=on_retry, sleep=sleep,
        )

    # ------------------------------------------------------------ #

    def fetch_weights(self, stop: Optional[threading.Event] = None
                      ) -> tuple[int, object]:
        """(version, tree) streamed from the server's versioned store —
        header frame + chunked raw leaf buffers, zero disk writes. Cached
        by version: an unchanged policy costs one small round trip."""

        def attempt():
            with self._lock:
                self._check_link()
                self._ensure_connected()
                t0 = time.perf_counter()
                resp = self._roundtrip({
                    "op": "fetch_weights", "worker_id": self.worker_id,
                    "have_version": self._cache_version,
                })
                if "error" in resp:
                    raise RemoteCallError(resp["error"])
                if resp.get("unchanged"):
                    return self._cache_version, self._cache_tree
                try:
                    leaves = self._recv_leaves(resp["leaves"])
                except socket.timeout as e:
                    self._drop()
                    raise TransportError(f"weight stream stalled: {e}")
                except _NET_DEAD as e:
                    self._drop()
                    raise TransportError(f"weight stream lost: {e}")
                tree = join_leaves(resp["structure"], leaves)
                self._cache_version = int(resp["version"])
                self._cache_tree = tree
                a = self.cfg.rtt_alpha
                rtt = time.perf_counter() - t0
                self.rtt_ewma_s = rtt if self.rtt_ewma_s <= 0.0 else (
                    a * rtt + (1 - a) * self.rtt_ewma_s
                )
                if self._latency is not None and self._latency.enabled:
                    self._latency.record("latency/rpc_fetch_weights_s", rtt)
                return self._cache_version, tree

        def on_retry(_i, _e):
            self.retries += 1

        sleep = time.sleep if stop is None else (lambda s: stop.wait(s))
        return retry_with_backoff(
            attempt, attempts=self.cfg.attempts,
            backoff_base=self.cfg.backoff_base,
            backoff_max=self.cfg.backoff_max, jitter=0.25,
            retry_on=(TransportError,), on_retry=on_retry, sleep=sleep,
        )

    def _recv_leaves(self, metas: list[dict]) -> list:
        bufs = [bytearray(int(m["nbytes"])) for m in metas]
        need = sum(len(b) for b in bufs)
        got = 0
        seen: set[tuple[int, int]] = set()
        while got < need:
            kind, payload = recv_frame(self._sock)
            if kind != KIND_OBJ and kind != KIND_CHUNK:
                raise TornFrame(f"unexpected frame kind {kind}")
            if kind == KIND_OBJ:
                continue  # stale duplicated reply straggling in the stream
            leaf, off = struct.unpack_from("!II", payload)
            data = payload[8:]
            if leaf >= len(bufs) or off + len(data) > len(bufs[leaf]):
                raise TornFrame("weight chunk outside leaf bounds")
            bufs[leaf][off:off + len(data)] = data
            if (leaf, off) not in seen:  # duplicates are idempotent
                seen.add((leaf, off))
                got += len(data)
        return [
            _from_wire(np.frombuffer(bytes(b), dtype=_dtype(m["dtype"]))
                       .reshape(m["shape"]).copy(), m["dtype"])
            for b, m in zip(bufs, metas)
        ]


class RemoteCoordinator:
    """Client-side proxy with the coordinator surface RolloutWorker uses
    (acquire / complete / worker_failed / lease_revoked / index_done), so
    the in-process worker loop runs unchanged over the network."""

    def __init__(self, client: RpcClient, poll_interval: float = 0.05):
        self._client = client
        self._poll = poll_interval

    def acquire(self, worker_id: int, stop: threading.Event
                ) -> Optional[Lease]:
        while not stop.is_set():
            try:
                resp = self._client.call("acquire", stop=stop)
            except (TransportError, RemoteCallError):
                resp = None  # server unreachable: keep polling until stop
            if resp is not None:
                if resp.get("stop"):
                    return None
                if resp.get("lease") is not None:
                    lease = decode_lease(resp["lease"])
                    self._client.last_epoch = max(
                        self._client.last_epoch, lease.epoch
                    )
                    return lease
            if stop.wait(self._poll):
                return None
        return None

    def complete(self, worker_id: int, lease: Lease, index: int,
                 sample: QueuedSample) -> bool:
        resp = self._client.call(
            "complete", lease_id=lease.lease_id, epoch=lease.epoch,
            index=index, version=sample.version, payload=sample.payload,
            dispatch_time=sample.dispatch_time,
            ready_time=sample.ready_time,
        )
        return bool(resp.get("accepted"))

    def worker_failed(self, worker_id: int, lease: Optional[Lease],
                      exc: BaseException, fatal: bool = False) -> None:
        try:
            self._client.call(
                "worker_failed",
                lease_id=None if lease is None else lease.lease_id,
                fatal=fatal, message=f"{type(exc).__name__}: {exc}",
                attempts=2,
            )
        except (TransportError, RemoteCallError):
            pass  # unreachable: the lease deadline sweep handles it

    def lease_revoked(self, lease: Lease) -> bool:
        try:
            resp = self._client.call("lease_revoked",
                                     lease_id=lease.lease_id, attempts=1)
            return bool(resp.get("revoked"))
        except (TransportError, RemoteCallError):
            return False  # can't tell: keep working, fencing protects us

    def index_done(self, index: int) -> bool:
        try:
            resp = self._client.call("index_done", index=index, attempts=1)
            return bool(resp.get("done"))
        except (TransportError, RemoteCallError):
            return False


class RpcTransport(FleetTransport):
    """The 3-call FleetTransport over RpcClient. Generation itself runs
    locally on the worker (the rollout pod owns the model); the wire
    carries weights in and heartbeats/completions out — the direct
    in-memory stream that replaces the reference's disk round-trip."""

    def __init__(self, client: RpcClient,
                 dispatch_fn: Callable[[int, object, dict, int], dict]):
        self._client = client
        self._dispatch_fn = dispatch_fn

    def fetch_weights(self, worker_id: int, stop=None):
        return self._client.fetch_weights(stop=stop)

    def poll_weights(self, worker_id: int, have_version: int, stop=None):
        # in-flight swap poll (docs/ORCHESTRATOR.md §in-flight swaps): the
        # client's by-version cache makes the no-newer-weights case one tiny
        # have_version round trip (the server answers "unchanged" and no
        # leaf bytes move). Transport failures are swallowed — a missed
        # poll is a missed swap opportunity inside the decode loop, not a
        # worker failure; the next sync point retries.
        try:
            version, tree = self._client.fetch_weights(stop=stop)
        except (TransportError, RemoteCallError):
            return have_version, None
        if version <= have_version:
            return version, None
        return version, tree

    def heartbeat(self, worker_id: int) -> None:
        # best-effort: a missed heartbeat is COUNTED, never fatal — the
        # coordinator notices real silence through the lease deadline
        try:
            self._client.call("heartbeat", attempts=1,
                              stats=self._client.stats_payload())
        except (TransportError, RemoteCallError):
            self._client.heartbeat_misses += 1

    def dispatch(self, worker_id: int, index: int, queries, tree,
                 weight_refresh=None):
        if weight_refresh is not None:
            payload = self._dispatch_fn(
                index, queries, tree, worker_id, weight_refresh
            )
        else:
            payload = self._dispatch_fn(index, queries, tree, worker_id)
        device_ready(payload)
        return payload
