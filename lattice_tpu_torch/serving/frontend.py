"""Dynamic micro-batching frontend: coalesce concurrent queries into one
device call (torch port).

Port of `lattice_tpu/serving/frontend.py`. Callers `submit()` query
vectors from any thread and get futures; one worker drains the queue into
padded batches and dispatches each as one `ChunkStore.search_device`
call, whose (scores, ids) come back as tensors on the store's device and
are read back with one `.cpu()` each.

Batch shapes are padded up to a power-of-two bucket (capped at
`max_batch`), as in the reference. On the card nothing is compiled per
shape, but the store's plan table chooses by batch size (at
`IVF_SMALL_BATCH` and below a large clustered store serves "ivf"), so
padding as the reference pads keeps every dispatch on the reference's
plan. A "cold compile" (`FrontendStats.cold_compiles`, a name the
`/v1/stats` and `/metrics` surfaces keep) is here the first dispatch at a
pad bucket that `warmup()` did not cover: the first kernel launches at
that shape, plus any one-time IVF or PQ build the plan triggers.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

logger = logging.getLogger(__name__)


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before the worker dispatched it."""


class Overloaded(RuntimeError):
    """The frontend's queue is at max_queue depth; shed load upstream."""


# log2 histogram bucket upper bounds, milliseconds: 0.25 ms .. 8.192 s,
# plus a +inf overflow bucket. 17 counters cover the whole latency range a
# serving process can see.
HIST_BOUNDS_MS: tuple[float, ...] = tuple(0.25 * 2 ** i for i in range(16))


@dataclass
class FrontendStats:
    """Counters a serving harness can scrape (reference keeps analogous
    DB-derived counters, `src/lattice/query/engine.py:281-309`)."""

    queries: int = 0
    batches: int = 0
    padded_rows: int = 0
    errors: int = 0
    deadline_expired: int = 0
    rejected_overload: int = 0
    # dispatches that landed on a pad bucket warmup had not covered (each
    # such first dispatch pays its first launches, and any one-time IVF or
    # PQ build, as tail latency — the signal that warm-on-mint coverage is
    # incomplete)
    cold_compiles: int = 0
    # bounded: a long-lived server dispatches millions of batches
    batch_sizes: deque = field(default_factory=lambda: deque(maxlen=1024))
    # submit->result wall clock of recent queries, milliseconds
    latencies_ms: deque = field(default_factory=lambda: deque(maxlen=4096))
    # LIFETIME log2-bucketed latency counts: hist[i] counts latencies
    # <= HIST_BOUNDS_MS[i]; the final slot is the +inf overflow. Unlike
    # the deque window this never forgets — a long-lived server's tail
    # behaviour stays visible in /v1/stats after millions of queries.
    latency_hist: list = field(
        default_factory=lambda: [0] * (len(HIST_BOUNDS_MS) + 1))
    # lifetime sum of observed latencies (Prometheus histogram `_sum`)
    latency_sum_ms: float = 0.0

    @property
    def mean_batch(self) -> float:
        return (self.queries / self.batches) if self.batches else 0.0

    def observe_latency(self, ms: float) -> None:
        self.latencies_ms.append(ms)
        self.latency_sum_ms += ms
        for i, bound in enumerate(HIST_BOUNDS_MS):
            if ms <= bound:
                self.latency_hist[i] += 1
                return
        self.latency_hist[-1] += 1

    def latency_percentile(self, pct: float) -> float | None:
        """p50/p95/... over the recent-latency window, or None before
        any traffic."""
        if not self.latencies_ms:
            return None
        return float(np.percentile(np.asarray(self.latencies_ms), pct))

    def histogram(self) -> dict[str, int]:
        """Lifetime latency histogram as {upper_bound_ms: count}, only
        non-empty buckets (the overflow bucket keys as "+inf")."""
        out: dict[str, int] = {}
        for i, bound in enumerate(HIST_BOUNDS_MS):
            if self.latency_hist[i]:
                out[f"{bound:g}"] = self.latency_hist[i]
        if self.latency_hist[-1]:
            out["+inf"] = self.latency_hist[-1]
        return out

    def lifetime_percentile(self, pct: float) -> float | None:
        """Percentile estimated from the lifetime histogram (bucket upper
        bound, so it over-reports by at most one log2 step)."""
        total = sum(self.latency_hist)
        if not total:
            return None
        target = total * pct / 100.0
        running = 0
        for i, bound in enumerate(HIST_BOUNDS_MS):
            running += self.latency_hist[i]
            if running >= target:
                return bound
        return float("inf")


class _Item:
    __slots__ = ("vec", "k", "future", "t_submit", "deadline")

    def __init__(self, vec: np.ndarray, k: int, future: Future,
                 deadline: float | None = None):
        self.vec = vec
        self.k = k
        self.future = future
        self.t_submit = time.monotonic()
        self.deadline = deadline  # absolute monotonic seconds, or None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class BatchingFrontend:
    """Coalesces concurrent `submit()` calls into single device searches.

    Parameters
    ----------
    store:
        A `ChunkStore` (or anything with `search_device(queries, k)` and
        a `dim` attribute).
    max_batch:
        Hard cap on coalesced batch size (also the largest pad bucket).
    max_wait_ms:
        How long the worker holds an open batch waiting for more queries
        after the first one arrives. 0 disables waiting (each drain takes
        whatever is already queued). Co-located serving wants 1-2 ms.
    filters / method:
        Forwarded to `search_device`. One frontend serves one (filters,
        method) configuration; run several frontends for several (or use
        `FrontendRouter`, which manages one per configuration).
    max_queue:
        Backpressure bound: when more than this many queries are already
        waiting, `submit()` fails fast with `Overloaded` instead of
        growing the queue without limit (a stalled device would otherwise
        accumulate every client's requests in host memory while their
        deadlines silently rot). None disables the bound.
    """

    def __init__(self, store, *, max_batch: int = 256,
                 max_wait_ms: float = 2.0,
                 filters: dict | None = None,
                 method: str = "auto",
                 max_queue: int | None = None,
                 stats: FrontendStats | None = None,
                 warmed_buckets: set | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 or None")
        self.store = store
        self.max_batch = int(max_batch)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self.filters = filters
        self.method = method
        self.max_queue = max_queue
        # callers may hand in an existing FrontendStats so lifetime
        # counters survive frontend recycling (FrontendRouter eviction
        # re-mints a config's frontend around the same stats object)
        self.stats = stats if stats is not None else FrontendStats()
        # buckets warmup() has run; a dispatch outside this set counts as
        # a cold compile in stats. While a background warmup runs, its
        # wall-clock window [_warm_start, _warm_end] is CREDITED to queued
        # requests' deadlines (they waited behind an unavoidable one-time
        # cost): extended, not waived.
        self._warmed_buckets: set[int] = (
            set(warmed_buckets) if warmed_buckets is not None else set())
        self.warming = False
        self.warmup_failed = False
        self._warm_start: float | None = None
        self._warm_end: float | None = None
        self._warm_thread: threading.Thread | None = None
        self._queue: queue.Queue[_Item | None] = queue.Queue()
        self._pending = 0  # queued-but-not-dispatched, guarded by _submit_lock
        self._busy = False  # worker inside _dispatch (device call in flight)
        self._closed = False
        # makes the closed-check + enqueue atomic against close(): without
        # it a submit racing close() could enqueue after the worker exits
        # and hang its future forever
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="lattice-serving-frontend")
        self._worker.start()

    # ---- client side ----------------------------------------------------

    def submit(self, vec: np.ndarray, k: int = 10,
               deadline_ms: float | None = None) -> Future:
        """Enqueue one query vector; resolves to (scores, ids) numpy
        arrays of length k (ids -1-padded when the corpus is smaller).

        deadline_ms bounds how long the request may WAIT: if the worker
        has not started dispatching it within that budget it fails with
        `DeadlineExceeded` instead of riding a batch whose result nobody
        wants anymore. (A dispatch already in flight is never aborted —
        the device call is shared with other requests.)
        """
        fut: Future = Future()
        v = np.asarray(vec, dtype=np.float32).reshape(-1)
        dim = getattr(self.store, "dim", None) or v.shape[0]
        if v.shape[0] != dim:
            fut.set_exception(ValueError(
                f"dim mismatch: got {v.shape[0]}, store is {dim}"))
            return fut
        if k < 1:
            fut.set_exception(ValueError("k must be >= 1"))
            return fut
        if deadline_ms is not None and deadline_ms <= 0:
            fut.set_exception(ValueError("deadline_ms must be > 0"))
            return fut
        deadline = (time.monotonic() + deadline_ms / 1000.0
                    if deadline_ms is not None else None)
        with self._submit_lock:
            if self._closed:
                fut.set_exception(RuntimeError("frontend is closed"))
                return fut
            if self.max_queue is not None and self._pending >= self.max_queue:
                self.stats.rejected_overload += 1
                fut.set_exception(Overloaded(
                    f"queue depth {self._pending} >= max_queue "
                    f"{self.max_queue}"))
                return fut
            self._pending += 1
            self._queue.put(_Item(v, int(k), fut, deadline))
        return fut

    def search(self, vec: np.ndarray, k: int = 10):
        """Blocking convenience wrapper around `submit`."""
        return self.submit(vec, k).result()

    def warmup(self, k: int = 10, buckets=None) -> int:
        """Run every pad bucket this frontend will serve once before
        traffic: the store's real search path at this frontend's
        (filters, method) config for every power-of-two bucket up to
        max_batch (or the `buckets` given), with a host readback per shape
        (the kernels are built, their first launches made and any
        one-time IVF or PQ build paid off the request path). Returns the
        number of shapes warmed.
        """
        store = self.store
        if self._closed or store is None:
            raise RuntimeError("frontend is closed")
        dim = getattr(store, "dim", None)
        if not dim:
            return 0
        try:
            if len(store) == 0:
                return 0  # empty store has no device path to warm
        except TypeError:
            pass
        if buckets is None:
            # derive from the dispatch-time policy so the warmed shapes
            # can never desync from what _dispatch actually pads to
            buckets = {self._bucket(n, self.max_batch)
                       for n in range(1, self.max_batch + 1)}
        rng = np.random.default_rng(0)
        unit = rng.standard_normal(dim).astype(np.float32)
        unit /= np.linalg.norm(unit)
        warmed = 0
        # caller-supplied buckets are clamped to shapes dispatch can
        # actually produce: 0/negatives would build a (0, dim) query
        # batch, and anything past max_batch warms a shape no dispatch
        # will ever use
        for b in sorted({int(x) for x in buckets
                         if 1 <= int(x) <= self.max_batch}):
            if self._closed or self.store is None:
                break  # shutdown mid-warm: stop at the bucket boundary
            q = np.broadcast_to(unit, (b, dim)).copy()
            _, ids = store.search_device(torch.from_numpy(q), int(k),
                                         filters=self.filters,
                                         method=self.method)
            ids.cpu()
            self._warmed_buckets.add(b)
            warmed += 1
        return warmed

    def warmup_async(self, k: int = 10) -> threading.Thread:
        """Run `warmup()` on a background thread (a router-minted config
        warms OFF the request path). While it runs, the warm window's
        wall clock is credited to queued requests' deadlines
        (`_warm_credit`): they queue with an extended deadline instead of
        504ing against a one-time cost they cannot avoid, and deadlines
        beyond that credit still enforce.
        Idempotent while a warm is running; `warmup_failed` records a
        raise (readiness flags must not report a failed warm as warm)."""
        with self._submit_lock:
            if self._warm_thread is not None and self._warm_thread.is_alive():
                return self._warm_thread
            self.warming = True
            self.warmup_failed = False
            self._warm_start = time.monotonic()
            self._warm_end = None

            def _warm() -> None:
                try:
                    self.warmup(k=k)
                except Exception:  # noqa: BLE001 — serve cold, don't die
                    self.warmup_failed = True
                    logger.exception("async warmup failed; serving cold")
                finally:
                    self._warm_end = time.monotonic()
                    self.warming = False

            self._warm_thread = threading.Thread(
                target=_warm, daemon=True, name="lattice-frontend-warm")
            self._warm_thread.start()
            return self._warm_thread

    def _warm_credit(self, t_submit: float, now: float) -> float:
        """Seconds of the async-warm window that overlapped this
        request's wait — added to its deadline, so waiting behind the
        mint-time compile never burns the caller's budget, while time
        spent waiting OUTSIDE the window still counts."""
        ws = self._warm_start
        if ws is None:
            return 0.0
        we = self._warm_end if self._warm_end is not None else now
        return max(0.0, min(we, now) - max(ws, t_submit))

    def join_warmup(self, timeout: float | None = None) -> bool:
        """Wait for a running async warmup; True when not/no-longer
        warming."""
        th = self._warm_thread
        if th is not None:
            th.join(timeout)
        return not self.warming

    def close(self, timeout: float | None = 5.0) -> None:
        """Stop the worker after draining already-submitted queries.
        Idempotent; later `submit()` calls resolve to an error."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # wake + stop sentinel
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            # a large backlog can outlive the timeout; the drain is
            # finite (the closed flag stops new submits), so wait it out
            # rather than nulling the store under the worker's feet
            logger.warning("frontend still draining after %.1fs; waiting",
                           timeout or 0.0)
            self._worker.join()
        # a submit() racing close() can pass the closed-check yet enqueue
        # after the worker exits; fail those futures instead of hanging
        while True:
            try:
                it = self._queue.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                self._dec_pending(1)
                if not it.future.done():
                    it.future.set_exception(RuntimeError("frontend is closed"))
        # drop the store reference: a closed frontend must not pin the
        # corpus's device memory past the owner's `del store`
        self.store = None

    def __enter__(self) -> "BatchingFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- worker side -----------------------------------------------------

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return min(b, max(cap, n))

    def _drain(self, first: _Item) -> list[_Item]:
        """Collect up to max_batch items: everything already queued, then
        keep the batch open max_wait_s for stragglers."""
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            try:
                item = (self._queue.get_nowait() if timeout <= 0
                        else self._queue.get(timeout=timeout))
            except queue.Empty:
                break
            if item is None:           # stop sentinel: put it back for _run
                self._queue.put(None)
                break
            batch.append(item)
        return batch

    def _dec_pending(self, n: int) -> None:
        if n:
            with self._submit_lock:
                self._pending -= n

    @property
    def idle(self) -> bool:
        """No queued work AND no dispatch in flight. `_pending` alone is
        not idleness — it is decremented when a batch LEAVES the queue,
        which is exactly when the (possibly long) device call begins."""
        return self._pending == 0 and not self._busy

    def _dispatch(self, batch: list[_Item]) -> None:
        self._busy = True
        try:
            self._dispatch_inner(batch)
        finally:
            self._busy = False

    def _dispatch_inner(self, batch: list[_Item]) -> None:
        # these items leave the backpressure window now, whatever happens
        self._dec_pending(len(batch))
        # claim each future first: after set_running_or_notify_cancel()
        # returns True, fut.cancel() can no longer succeed, so the
        # set_result/set_exception below cannot raise InvalidStateError
        # (a cancel() landing between a cancelled() check and set_result
        # would otherwise kill the worker thread and hang every later
        # submit)
        batch = [it for it in batch
                 if it.future.set_running_or_notify_cancel()]
        # expire overdue requests BEFORE paying for the device call: by
        # now their caller has given up (HTTP thread timed out), so a
        # slot in the batch would compute a result nobody reads. Time a
        # request spent waiting behind the mint-time warmup window is
        # credited to its deadline (`_warm_credit`) — extended, not
        # waived: queue-backlog lateness still expires during a warm,
        # and a request that waited out the warm is not killed the
        # moment warming flips false.
        now = time.monotonic()
        live: list[_Item] = []
        for it in batch:
            if (it.deadline is not None
                    and now >= it.deadline
                    + self._warm_credit(it.t_submit, now)):
                self.stats.deadline_expired += 1
                it.future.set_exception(DeadlineExceeded(
                    f"waited {(now - it.t_submit) * 1e3:.1f} ms"))
            else:
                live.append(it)
        batch = live
        if not batch:
            return
        try:
            # EVERYTHING from here on is guarded: the futures are claimed,
            # so an exception anywhere (batch assembly included — e.g. a
            # mixed-dim batch when the store exposes no `dim`) must fan
            # out to them or their callers hang forever
            n = len(batch)
            k_max = max(it.k for it in batch)
            bucket = self._bucket(n, self.max_batch)
            if bucket not in self._warmed_buckets:
                # first traffic on a shape warmup never covered: this
                # dispatch pays its one-time costs as tail latency.
                # Counted once per bucket.
                self.stats.cold_compiles += 1
                self._warmed_buckets.add(bucket)
            q = np.zeros((bucket, batch[0].vec.shape[0]), dtype=np.float32)
            for i, it in enumerate(batch):
                q[i] = it.vec
            if bucket > n:              # pad rows repeat a real query so
                q[n:] = q[0]            # normalization never sees zeros
            scores, ids = self.store.search_device(
                torch.from_numpy(q), k_max, filters=self.filters,
                method=self.method)
            scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
            if ids.shape[1] < k_max:
                # the kernel clamps k to the store capacity; keep the
                # documented contract (length-k, -1-padded)
                pad = k_max - ids.shape[1]
                ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
                scores = np.pad(scores, ((0, 0), (0, pad)),
                                constant_values=-np.inf)
        except Exception as exc:        # noqa: BLE001 — fan the failure out
            self.stats.errors += 1
            for it in batch:
                if not it.future.done():
                    it.future.set_exception(exc)
            return
        self.stats.batches += 1
        self.stats.queries += n
        self.stats.padded_rows += bucket - n
        self.stats.batch_sizes.append(n)
        t_done = time.monotonic()
        for i, it in enumerate(batch):
            self.stats.observe_latency((t_done - it.t_submit) * 1e3)
            it.future.set_result((scores[i, :it.k], ids[i, :it.k]))

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                # drain anything that raced in behind the sentinel
                leftovers: list[_Item] = []
                while True:
                    try:
                        it = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if it is not None:
                        leftovers.append(it)
                for i in range(0, len(leftovers), self.max_batch):
                    try:
                        self._dispatch(leftovers[i:i + self.max_batch])
                    except Exception:  # noqa: BLE001 — drain the rest
                        logger.exception("close-drain dispatch failed")
                return
            try:
                self._dispatch(self._drain(item))
            except Exception:  # noqa: BLE001 — the worker must survive
                logger.exception("frontend dispatch failed")
