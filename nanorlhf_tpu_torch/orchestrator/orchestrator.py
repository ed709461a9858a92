"""RolloutOrchestrator — the port of `nanorlhf_tpu/orchestrator/orchestrator.py`:
the producer-thread rollout pipeline over the version-tagged weight store
and the bounded-staleness queue.

Generalizes the trainer's one-step `rollout_ahead` prefetch into a
configurable pipelined depth (PipelineRL / LlamaRL): a daemon producer
thread pulls prompt batches, grabs the LATEST published policy snapshot,
runs generation, waits until the sample is ready on the device, and
enqueues it version-tagged; the trainer consumes via `get()` and publishes
a new version after every optimizer update. Unlike rollout_ahead (whose
prefetch lives inside one `train()` call) the pipeline stays warm across
`train(num_updates=1)` invocations.

Determinism contract (JAX's): the producer is the ONLY consumer of the
trainer's data iterator, and generation draws come from the trainer's
index-keyed stream (`rollout_generator(seed, index)`), so the data and
random streams are exactly the ones the synchronous trainer would see —
the basis of the checkpoint/resume journal.

Streams, where the port differs from JAX's `jax.block_until_ready`:

  * the producer thread runs under a `torch.cuda.Stream` of its own
    (`producer_stream`): on the legacy default stream its generation would
    serialize with the trainer's update and the overlap would be lost;
  * before a sample enters the queue the producer records a
    `torch.cuda.Event` on its stream and synchronizes on it
    (`device_ready`): the consumer receives finished samples, and [t0, t1]
    is the true generation window of the overlap meter;
  * the consumer marks every CUDA tensor of a sample it takes as used on
    its own stream (`adopt_payload`, `Tensor.record_stream`), so the
    caching allocator cannot hand a block the producer freed back to the
    producer while the trainer's stream still reads it;
  * a published snapshot (`SnapshotTree`) carries the event recorded on
    the trainer's stream after its clones; a reader's stream waits on it
    before reading (`reader_wait`).

`OverlapMeter` is the port's copy in `telemetry/overlap.py`, re-exported
here as JAX's module exports it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import torch

from nanorlhf_tpu_torch.orchestrator.sample_queue import (
    BoundedStalenessQueue,
    ProducerFailed,
    QueuedSample,
)
from nanorlhf_tpu_torch.orchestrator import weight_store
from nanorlhf_tpu_torch.orchestrator.weight_store import VersionedWeightStore
from nanorlhf_tpu_torch.telemetry.lineage import (
    segments_summary as _segments_summary,
    spec_summary as _spec_summary,
)
from nanorlhf_tpu_torch.telemetry.overlap import OverlapMeter

__all__ = ["OverlapMeter", "RolloutOrchestrator", "SnapshotTree", "adopt_payload",
           "device_ready", "note_ready_async", "producer_stream", "reader_wait"]


# --------------------------------------------------------------------- #
# streams, events and snapshots
# --------------------------------------------------------------------- #


class SnapshotTree(dict):
    """A published policy tree: a plain dict of leaves, plus `ready`, the
    event recorded on the publishing stream after its copies (None on the
    CPU, or for a tree that needs no wait)."""

    ready = None


def _cuda_tensors(obj):
    """Every CUDA tensor in a nest of dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _cuda_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _cuda_tensors(v)


@contextlib.contextmanager
def producer_stream(device=None):
    """Run the body on a CUDA stream of its own (when `device` is a CUDA
    device) and without autograd — grad mode, like the current stream, is
    per thread."""
    device = None if device is None else torch.device(device)
    with torch.no_grad():
        if device is not None and device.type == "cuda":
            with torch.cuda.stream(torch.cuda.Stream(device)):
                yield
        else:
            yield


def device_ready(payload) -> None:
    """Wait until the work behind `payload` has finished on the device: an
    event recorded on the current stream of each device the payload's
    tensors live on, then a host wait on it. Nothing on the CPU."""
    for dev in {t.device for t in _cuda_tensors(payload)}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def adopt_payload(payload) -> None:
    """Mark every CUDA tensor of a sample made on another thread's stream
    as used on this thread's current stream (`record_stream`)."""
    for t in _cuda_tensors(payload):
        t.record_stream(torch.cuda.current_stream(t.device))


def reader_wait(tree) -> None:
    """Make this thread's current stream wait for a published snapshot's
    copies (its `ready` event), and mark its CUDA leaves as used here."""
    ready = getattr(tree, "ready", None)
    leaves = list(_cuda_tensors(tree))
    if ready is not None and leaves:
        torch.cuda.current_stream(leaves[0].device).wait_event(ready)
    for t in leaves:
        t.record_stream(torch.cuda.current_stream(t.device))


def note_ready_async(meter: OverlapMeter, payload, t0: float,
                     tracer=None, span_args: Optional[dict] = None) -> None:
    """Record [t0, device-ready] into `meter` without blocking the caller —
    an event is recorded on the current stream now, and a daemon waiter
    thread synchronizes on it (JAX's waiter blocks on the async payload).
    With a `telemetry.SpanTracer` the same window is also a
    `rollout.generate` ASYNC trace event on the "rollout" track."""
    tp0 = tracer.now_us() if tracer is not None and tracer.enabled else None
    events = []
    for dev in {t.device for t in _cuda_tensors(payload)}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)

    def _wait():
        try:
            for ev in events:
                ev.synchronize()
        except Exception:
            return  # the consumer surfaces device errors; meter stays silent
        meter.note_gen(t0, time.perf_counter())
        if tp0 is not None:
            args = span_args or {}
            tracer.add_async(
                "rollout.generate", tp0, tracer.now_us() - tp0,
                aid=args.get("rollout_index", id(payload)), track="rollout",
                **args,
            )

    threading.Thread(target=_wait, daemon=True,
                     name="rollout-ready-watch").start()


# --------------------------------------------------------------------- #
# the single-producer pipeline
# --------------------------------------------------------------------- #


class RolloutOrchestrator:
    """Producer thread + version store + bounded-staleness queue.

    `dispatch_fn(index, params_tree) -> payload` pulls the next prompt
    batch, takes the generation stream for `index`, and generates from
    `params_tree` (a published snapshot — never the live training tree).
    With `inflight_swaps` it is also given `weight_refresh=`, the swap
    callback over the store, starting from the version of `params_tree`
    (as a fleet worker's starts from its lease's): a publish that lands
    after the producer took the tree is installed at the first chunk
    boundary, and every segment is tagged with the version it ran on.
    `initial_params` becomes version 0. `device` (a CUDA device) gives the
    producer thread a stream of its own.
    """

    def __init__(
        self,
        dispatch_fn: Callable[..., dict],
        initial_params: dict,
        start_index: int = 0,
        max_staleness: int = 1,
        policy: str = "wait",
        meter: Optional[OverlapMeter] = None,
        restore: Optional[dict] = None,
        heartbeat: float = 30.0,
        faults=None,
        tracer=None,
        lineage=None,
        latency=None,
        device=None,
        inflight_swaps: bool = False,
    ):
        self.store = VersionedWeightStore()
        self.store.publish(initial_params)  # version 0
        self.queue = BoundedStalenessQueue(
            max_staleness, policy, start_index=start_index, lineage=lineage,
            latency=latency,
        )
        if restore:
            self.queue.restore_counters(restore)
        self.meter = meter if meter is not None else OverlapMeter()
        self.max_staleness = max_staleness
        self._dispatch_fn = dispatch_fn
        self._next_index = start_index
        self._heartbeat = heartbeat
        self._faults = faults  # resilience.FaultInjector ("rollout.produce")
        # telemetry.SpanTracer: generation spans on the producer thread's
        # own track — the trainer-vs-producer overlap picture
        self._tracer = tracer
        # telemetry.LineageLedger: per-index lease + generation provenance
        # (the single producer is "worker 0" with an implicit lease)
        self._lineage = lineage
        # telemetry.LatencyHub: generation-wall + TTFT histograms
        # (dispatch→device-ready is recorded as the TTFT upper bound; exact
        # per-request TTFT comes from the paged scheduler's admissions)
        self._latency = latency
        self._device = device
        self._inflight_swaps = inflight_swaps
        self.producer_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, daemon=True, name="rollout-producer"
        )
        self._thread.start()

    # ---------------------------------------------------------------- #
    # producer loop
    # ---------------------------------------------------------------- #

    def _produce(self):
        try:
            with producer_stream(self._device):
                self._produce_loop()
        except BaseException as e:  # surfaces in the consumer's get()
            self.producer_error = e
            self.queue.fail(e)

    def _produce_loop(self):
        while not self._stop.is_set():
            idx = self._next_index
            if not self.queue.wait_to_produce(idx, self._stop):
                break
            if self._faults is not None:
                # resilience injection point — BEFORE the dispatch touches
                # the data iterator, so a supervised restart redraws from an
                # unburned cursor
                self._faults.fire("rollout.produce")
            version, tree = self.store.latest()
            lin = self._lineage
            if lin is not None and lin.enabled:
                # the single producer IS the lease grant
                lin.lease(idx, worker_id=0, cursor=idx, length=1)
            tr = self._tracer
            span = (
                tr.span("rollout.generate", rollout_index=idx,
                        policy_version=version)
                if tr is not None and tr.enabled
                else contextlib.nullcontext()
            )
            # perf_counter: the consumer's busy windows share this clock
            t0 = time.perf_counter()
            with span:
                kw = {}
                if self._inflight_swaps:
                    kw["weight_refresh"] = weight_store.make_swap_refresh(
                        weight_store.store_poll(self.store), have_version=version,
                        faults=self._faults, worker=0)
                payload = self._dispatch_fn(idx, tree, **kw)
                # wait HERE (producer thread): the consumer receives
                # finished samples, and [t0, t1] is the true window
                device_ready(payload)
            t1 = time.perf_counter()
            self.meter.note_gen(t0, t1)
            if self._latency is not None and self._latency.enabled:
                self._latency.record("latency/generation_s", t1 - t0)
                self._latency.record("latency/ttft_s", t1 - t0)
            if lin is not None and lin.enabled:
                lin.generation(
                    idx, policy_version=version, worker_id=0,
                    gen_s=round(t1 - t0, 6),
                    spec=_spec_summary(payload),
                    segments=_segments_summary(payload),
                    swap_wait_s=payload.get("swap_wait_s"),
                )
            self.queue.put(QueuedSample(idx, version, payload, t0, t1))
            if tr is not None and tr.enabled:
                tr.counter("orchestrator/queue_depth", self.queue.depth())
            self._next_index += 1

    # ---------------------------------------------------------------- #
    # consumer API (the trainer)
    # ---------------------------------------------------------------- #

    @property
    def version(self) -> int:
        return self.store.version

    def get(self) -> QueuedSample:
        """Next sample — waits as long as the producer is making progress
        (no hard deadline: a first generation builds the kernels and
        captures its graphs). A dead producer raises ProducerFailed. The
        sample's CUDA tensors are adopted onto the caller's stream."""
        while True:
            try:
                sample = self.queue.get(timeout=self._heartbeat)
            except TimeoutError:
                if not self._thread.is_alive():
                    raise ProducerFailed(
                        "rollout producer thread died without reporting an "
                        "error through the queue"
                    ) from self.producer_error
                continue
            adopt_payload(sample.payload)
            return sample

    def producer_alive(self) -> bool:
        return self._thread.is_alive()

    def consumed_without_update(self) -> None:
        """A fetched sample was discarded without an optimizer update (a
        sentinel-quarantined batch): credit the producer gate so the
        pipeline doesn't deadlock waiting for a publish that never comes."""
        self.queue.credit_skip()

    def publish(self, tree: dict) -> int:
        """Publish a post-update policy snapshot; wakes the producer gate."""
        v = self.store.publish(tree)
        self.queue.advance_version(v)
        return v

    def stats(self) -> dict:
        return {
            "queue_depth": self.queue.depth(),
            "dropped": self.queue.dropped,
            "staleness_counts": dict(self.queue.staleness_counts),
            # who-waits-on-whom: trainer starved vs producer gated
            "consumer_wait_s": self.queue.consumer_wait_s,
            "producer_gate_wait_s": self.queue.producer_gate_wait_s,
        }

    def status_snapshot(self) -> dict:
        """/statusz seam: queue counters + policy version, JSON-able and
        safe from any thread."""
        return {"queue": {**self.stats(), "version": self.version}}

    def journal(self) -> dict:
        """Checkpoint payload (trainer_state.json "orchestrator" key)."""
        return self.queue.journal()

    def close(self, join_timeout: float = 30.0) -> None:
        self._stop.set()
        self.queue.advance_version(self.queue.version)  # wake any waiter
        self._thread.join(timeout=join_timeout)
