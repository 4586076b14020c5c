"""Event-driven asynchronous FL simulator (host level).

Models the paper's §III.E asynchronous functionality faithfully: workers
have heterogeneous speeds, random delays, and failure probability; updates
arrive whenever a worker finishes, and the aggregator folds them in without
waiting for a synchronization barrier.

This module is the *arrival frontier* of the event-driven node
(``core.node.ChainNode.run_events``): each ``FederatedTask`` owns one
``AsyncScheduler`` (its per-task clock), and the node repeatedly pops the
task whose next aggregation event is earliest in simulated time, runs one
staleness-weighted round for that task's arrived cohort, and seals the
cohort on-chain (arrival frontier → staleness-weighted aggregate → cohort
seal). Determinism contract:

- heap ties break on ``(time, round, worker_id)`` — a worker's *earlier*
  local round always lands before any same-instant later round, and worker
  id orders within a round — so event traces are reproducible run-to-run;
- each scheduler draws from a per-task sub-RNG seeded from
  ``(seed, sha256(task_id))``, so co-tenant tasks on one node have
  independent but reproducible arrival streams regardless of the order the
  node interleaves them.

``next_aggregation()`` yields (time, participation mask, staleness
snapshot) per aggregation tick; ``advance_until(t)`` folds every arrival up
to an externally-chosen instant into the pending buffer without
aggregating. The jit path (``async_agg``) consumes the masks this simulator
produces; ``arrival_times()`` exposes per-update arrival instants so
benchmarks can measure settlement latency (seal time − arrival time) per
update rather than per round.
"""
from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class WorkerProfile:
    speed: float              # mean seconds per local training round
    jitter: float = 0.2       # lognormal sigma on the duration
    failure_prob: float = 0.0  # chance a round's update is lost entirely


def _task_key(task_id: str) -> int:
    """Stable 64-bit integer key for a task id (independent of PYTHONHASHSEED)."""
    return int.from_bytes(hashlib.sha256(task_id.encode()).digest()[:8], "big")


class AsyncScheduler:
    """Simulates arrival times; yields (time, participation mask, staleness
    snapshot) per aggregation tick.

    Arrivals accumulate in a pending buffer (at most one counted arrival per
    worker per tick — a worker finishing twice inside one window just
    refreshes nothing and keeps training). ``next_aggregation`` drains the
    event heap until the buffer holds ``buffer_size`` distinct updates or
    ``max_wait`` simulated seconds pass, then flushes the buffer as one
    aggregation event.
    """

    def __init__(self, profiles: List[WorkerProfile], *, seed: int = 0,
                 buffer_size: int = 8, max_wait: float = float("inf"),
                 task_id: Optional[str] = None) -> None:
        self.profiles = profiles
        self.task_id = task_id
        # per-task sub-RNG: co-tenant tasks sharing one node seed still get
        # independent, reproducible arrival streams
        self.rng = (np.random.default_rng(seed) if task_id is None
                    else np.random.default_rng((seed, _task_key(task_id))))
        self.buffer_size = buffer_size
        self.max_wait = max_wait
        self.now = 0.0
        # heap entries are (time, round, worker): ties resolve round-first
        # then worker id, so traces are deterministic run-to-run
        self._heap: List[Tuple[float, int, int]] = []
        W = len(profiles)
        self._pending = np.zeros(W, bool)
        self._pending_count = 0
        self._arrival_time = np.full(W, np.nan)
        self.last_arrival_times = np.full(W, np.nan)
        self.staleness = np.zeros(W, np.int64)
        self.agg_round = 0
        for w in range(W):
            self._schedule(w, 0)

    def _schedule(self, w: int, rnd: int) -> None:
        prof = self.profiles[w]
        dur = prof.speed * float(self.rng.lognormal(0.0, prof.jitter))
        heapq.heappush(self._heap, (self.now + dur, rnd, w))

    def _pop_arrival(self) -> None:
        """Pop the earliest arrival, apply the loss draw, fold into pending."""
        t, rnd, w = heapq.heappop(self._heap)
        self.now = t
        lost = self.rng.random() < self.profiles[w].failure_prob
        if not lost and not self._pending[w]:
            self._pending[w] = True
            self._arrival_time[w] = t
            self._pending_count += 1
        # the worker starts its next local round immediately
        self._schedule(w, rnd + 1)

    def advance_until(self, deadline: float) -> int:
        """Advance the clock to ``deadline`` (finite), folding every arrival
        with time <= deadline into the pending buffer without aggregating.
        Returns the pending-update count."""
        if not np.isfinite(deadline):
            raise ValueError("advance_until needs a finite deadline")
        while self._heap and self._heap[0][0] <= deadline:
            self._pop_arrival()
        self.now = max(self.now, deadline)
        return self._pending_count

    def next_aggregation(self) -> Tuple[float, np.ndarray, np.ndarray]:
        """Advance until ``buffer_size`` updates are pending (or max_wait
        passes), then flush the buffer as one aggregation event.
        Returns (time, participation mask (W,), staleness snapshot (W,))."""
        W = len(self.profiles)
        deadline = self.now + self.max_wait
        # at most W distinct arrivals exist per tick: a buffer_size > W with
        # infinite max_wait would otherwise spin forever (heap never drains —
        # every pop reschedules the worker)
        need = min(self.buffer_size, W)
        while self._pending_count < need and self._heap:
            if self._heap[0][0] > deadline:
                break
            self._pop_arrival()
        if self._pending_count < need and np.isfinite(deadline):
            # max_wait elapsed before the buffer filled: the aggregator
            # waited the full window, so the clock advances to the deadline
            self.now = max(self.now, deadline)
        mask = self._pending.astype(np.int64)
        self.last_arrival_times = np.where(self._pending, self._arrival_time,
                                           np.nan)
        snap = self.staleness.copy()
        self.staleness = np.where(mask > 0, 0, self.staleness + 1)
        self.agg_round += 1
        self._pending[:] = False
        self._pending_count = 0
        self._arrival_time[:] = np.nan
        return self.now, mask, snap

    def arrival_times(self) -> np.ndarray:
        """Per-worker arrival instant of the update included in the *last*
        aggregation event (NaN for workers not in the cohort)."""
        return self.last_arrival_times

    def sync_round_time(self) -> float:
        """For comparison: a synchronous round waits for the *slowest*
        worker (expected duration)."""
        durs = [p.speed * float(self.rng.lognormal(0.0, p.jitter))
                for p in self.profiles]
        return max(durs)


def heterogeneous_profiles(W: int, *, straggler_frac: float = 0.25,
                           straggler_slowdown: float = 4.0,
                           base_speed: float = 1.0, failure_prob: float = 0.0,
                           seed: int = 0) -> List[WorkerProfile]:
    rng = np.random.default_rng(seed)
    profiles = []
    n_strag = int(round(W * straggler_frac))
    slow = set(rng.choice(W, size=n_strag, replace=False).tolist())
    for w in range(W):
        s = base_speed * (straggler_slowdown if w in slow else 1.0)
        profiles.append(WorkerProfile(speed=s * float(rng.uniform(0.8, 1.2)),
                                      failure_prob=failure_prob))
    return profiles


def heavy_tailed_profiles(W: int, *, shape: float = 1.5,
                          base_speed: float = 1.0, jitter: float = 0.3,
                          failure_prob: float = 0.0,
                          seed: int = 0) -> List[WorkerProfile]:
    """Pareto(shape) heavy-tailed worker speeds plus dropout: most workers
    run near ``base_speed``, a long tail runs arbitrarily slower — the churn
    regime where a sync barrier's round time is dominated by the tail."""
    rng = np.random.default_rng(seed)
    slowdown = 1.0 + rng.pareto(shape, size=W)
    return [WorkerProfile(speed=base_speed * float(s), jitter=jitter,
                          failure_prob=failure_prob) for s in slowdown]
