"""Deterministic simulated transport for the multi-node settlement net.

``SimNet`` is the fault-injection harness every ``repro_torch.net`` scenario
runs on: nodes register a message handler, and all traffic flows through
a single event heap ordered by simulated delivery time. The clock is the
same *simulated seconds* timeline as ``core.async_sim.AsyncScheduler``
(monotone floats starting at 0.0, advanced only by ``run``), so one
scenario can interleave worker-arrival events and network deliveries on
one deterministic timeline.

Determinism contract (what makes runs byte-reproducible):

- Every directed link ``(src, dst)`` owns a private ``numpy`` RNG seeded
  from ``(seed, src, dst)``. Latency/jitter/loss draws consume *that
  link's* stream in that link's send order — so one link's schedule is
  independent of global send interleaving, and a scenario replays
  identically for a given seed regardless of how callers order their
  broadcasts.
- The event heap breaks delivery-time ties by a global send sequence
  number; handlers run one at a time.
- ``Date``/wall-clock never enters the sim: ``now`` only moves via
  ``run(until=...)`` and delivered-event timestamps.

Fault-injection knobs:

- ``LinkSpec(latency, jitter, loss)`` — per-link base delay, uniform
  extra jitter, and iid drop probability. Set per directed link with
  ``set_link`` or network-wide via ``default_link``.
- ``Partition(start, stop, groups)`` — during ``[start, stop)`` in
  simulated seconds, messages *sent* between nodes in different groups
  are dropped (nodes absent from every group form one implicit extra
  group). Overlapping windows compose: a send is dropped if any active
  window separates the endpoints.

Counters (``sent``, ``delivered``, ``dropped_loss``,
``dropped_partition``) make reliability benchmarks cheap to assert.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.chain.ledger import sha256

__all__ = ["LinkSpec", "Partition", "SimNet"]


@dataclass(frozen=True)
class LinkSpec:
    """One directed link's fault model: ``latency`` (base simulated
    seconds), ``jitter`` (uniform extra delay in ``[0, jitter)``), and
    ``loss`` (iid drop probability per message)."""

    latency: float = 0.01
    jitter: float = 0.0
    loss: float = 0.0

    def __post_init__(self) -> None:
        if self.latency < 0 or self.jitter < 0:
            raise ValueError("latency/jitter must be >= 0")
        if not 0.0 <= self.loss < 1.0:
            raise ValueError("loss must be in [0, 1)")


@dataclass(frozen=True)
class Partition:
    """A network split active over ``[start, stop)`` simulated seconds:
    ``groups`` are the mutually-unreachable node sets. Nodes listed in no
    group form one implicit extra group (still reachable to each other,
    cut off from every listed group)."""

    start: float
    stop: float
    groups: Tuple[Tuple[int, ...], ...]

    def side(self, node: int) -> int:
        for gi, g in enumerate(self.groups):
            if node in g:
                return gi
        return -1                      # the implicit "everyone else" group

    def separates(self, a: int, b: int, t: float) -> bool:
        return self.start <= t < self.stop and self.side(a) != self.side(b)


class SimNet:
    """Seeded, clocked, in-process message fabric (see module docstring)."""

    def __init__(self, seed: int = 0,
                 default_link: LinkSpec = LinkSpec(),
                 partitions: Tuple[Partition, ...] = ()) -> None:
        self.seed = int(seed)
        self.default_link = default_link
        self.partitions: List[Partition] = list(partitions)
        self.now = 0.0
        self._seq = 0
        # (deliver_time, seq, src, dst, msg)
        self._heap: List[Tuple[float, int, int, int, Any]] = []
        self._handlers: Dict[int, Callable[[int, Any], None]] = {}
        self._links: Dict[Tuple[int, int], LinkSpec] = {}
        self._rngs: Dict[Tuple[int, int], np.random.Generator] = {}
        self.sent = 0
        self.delivered = 0
        self.dropped_loss = 0
        self.dropped_partition = 0

    # -- topology --------------------------------------------------------------

    def register(self, node_id: int,
                 handler: Callable[[int, Any], None]) -> None:
        """Attach ``handler(src, msg)`` as ``node_id``'s inbox."""
        if node_id in self._handlers:
            raise ValueError(f"node {node_id} already registered")
        self._handlers[int(node_id)] = handler

    @property
    def node_ids(self) -> List[int]:
        return sorted(self._handlers)

    def set_link(self, src: int, dst: int, spec: LinkSpec) -> None:
        """Override one directed link's fault model."""
        self._links[(src, dst)] = spec

    def link(self, src: int, dst: int) -> LinkSpec:
        return self._links.get((src, dst), self.default_link)

    def _rng(self, src: int, dst: int) -> np.random.Generator:
        key = (src, dst)
        rng = self._rngs.get(key)
        if rng is None:
            # per-link stream: independent of global send interleaving
            digest = sha256(f"simnet:{self.seed}:{src}->{dst}".encode())
            rng = self._rngs[key] = np.random.default_rng(
                int(digest[:16], 16))
        return rng

    def partitioned(self, a: int, b: int, t: Optional[float] = None) -> bool:
        """Whether any active partition window separates ``a`` and ``b``
        at simulated time ``t`` (default: now)."""
        t = self.now if t is None else t
        return any(p.separates(a, b, t) for p in self.partitions)

    # -- sending ---------------------------------------------------------------

    def send(self, src: int, dst: int, msg: Any) -> bool:
        """Queue one message at the current simulated time. Returns
        whether it was scheduled (partition/loss drops return False).
        Partition semantics are send-time: a message sent inside a
        partition window is lost even if it would have been delivered
        after the heal."""
        if dst not in self._handlers:
            raise KeyError(f"unknown destination node {dst}")
        self.sent += 1
        if self.partitioned(src, dst):
            self.dropped_partition += 1
            return False
        spec = self.link(src, dst)
        rng = self._rng(src, dst)
        # fixed draw order per message keeps the link stream aligned
        # whatever the spec: loss first, then jitter
        u_loss = rng.random()
        delay = spec.latency + (spec.jitter * rng.random()
                                if spec.jitter else 0.0)
        if spec.loss and u_loss < spec.loss:
            self.dropped_loss += 1
            return False
        self._seq += 1
        heapq.heappush(self._heap,
                       (self.now + delay, self._seq, src, dst, msg))
        return True

    def broadcast(self, src: int, msg: Any) -> int:
        """Send to every other registered node (id order). Returns how
        many copies were scheduled."""
        return sum(self.send(src, dst, msg)
                   for dst in self.node_ids if dst != src)

    # -- the clock -------------------------------------------------------------

    def run(self, until: Optional[float] = None,
            max_events: int = 1_000_000) -> int:
        """Deliver queued messages in ``(time, seq)`` order until the
        heap is empty (or past ``until``). Handlers may send more
        messages; those are delivered too if due. Advances ``now`` to
        ``until`` (or the last delivery). Returns deliveries made."""
        n = 0
        while self._heap and n < max_events:
            t = self._heap[0][0]
            if until is not None and t > until:
                break
            t, _, src, dst, msg = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            self._handlers[dst](src, msg)
            self.delivered += 1
            n += 1
        if until is not None:
            self.now = max(self.now, until)
        return n
