"""Background compaction scheduler: flush and compaction off the write path.

Counterpart of ``repro.core.scheduler``.  Foreground writes only *rotate* a
full memtable into the immutable queue and submit a :class:`FlushJob`; a
worker thread turns it into an L0 run on the device, installs the new
version, and chains :class:`CompactJob` continuations until the tree is
shaped — exactly the sequence the synchronous store runs inline, which is
what makes the synchronous store a bit-for-bit oracle after
``wait_for_quiesce``.

Determinism contract
    Jobs run strictly one at a time in queue order (a turnstile: a worker
    pops only when no job is in flight), and a job's compaction
    continuations go to the *front* of the queue, so the apply order for
    any op sequence is flush 1, its compactions, flush 2, ...  Extra
    workers are hot standbys (each plan depends on the previous apply).

Safety
    The worker is the only thread that mutates levels (copy-on-write list
    swaps; readers are lock-free on the captured reference), every version
    installs through the mutex-guarded ``Manifest``, and an in-flight
    compaction pins its input version, so a concurrent snapshot release can
    never free its runs mid-merge.  ``abort_and_drain`` (the crash path)
    stops the in-flight job at its next safe point, clears the queue and
    returns only when nothing runs.

On the device
    A worker sets its thread's current CUDA device to the store's, and
    launches on that device's default stream, the stream every foreground
    read of the store uses too: a run the worker installs is ordered before
    any read that finds it, with no event.  A failed job is retried
    ``bg_max_retries`` times and then turns the store read-only, as in the
    reference; a kernel failure on the worker therefore ends in a degraded
    store, which ``degraded``, ``bg_retries`` and ``bg_gave_up`` report.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Callable, Deque, Optional

import torch

from .memtable import ImmutableMemtable


def _pin_worker_to_spare_core(offset: int = 0, pin: bool = True) -> None:
    """Best-effort: move the calling worker thread onto one of the trailing
    cores of the process affinity set, leaving the first core to the
    foreground, and lower its priority so it loses scheduling ties to the
    writer (Linux only: there ``who=0`` scopes setpriority to the calling
    thread).  No-op on single-core affinities and without the syscalls.

    ``pin=False`` keeps the affinity: a CPU store's worker runs the plain
    kernels as torch CPU ops, whose intra-op threads inherit the worker's
    affinity and would all spin on its one core."""
    try:
        aff = sorted(os.sched_getaffinity(0))
        if pin and len(aff) > 1:
            os.sched_setaffinity(0, {aff[-1 - (offset % len(aff))]})
    except (AttributeError, OSError):
        pass
    try:
        if sys.platform.startswith("linux"):
            os.setpriority(os.PRIO_PROCESS, 0, 10)
    except (AttributeError, OSError):
        pass


class WorkerBudget:
    """Resizable counting semaphore bounding concurrent background jobs
    across sibling schedulers.  Growing mints permits; shrinking retires
    only free permits and returns False, changing nothing, if one is held."""

    def __init__(self, n: int):
        self._size = max(1, int(n))
        self._sem = threading.Semaphore(self._size)
        self._mu = threading.Lock()

    @property
    def size(self) -> int:
        return self._size

    def acquire(self, *args, **kwargs):
        return self._sem.acquire(*args, **kwargs)

    def release(self) -> None:
        self._sem.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def resize(self, n: int) -> bool:
        """Retarget the budget to ``n`` permits; True iff it landed."""
        n = max(1, int(n))
        with self._mu:
            delta = n - self._size
            if delta > 0:
                for _ in range(delta):
                    self._sem.release()
            elif delta < 0:
                got = 0
                for _ in range(-delta):
                    if not self._sem.acquire(blocking=False):
                        for _ in range(got):   # roll back: all-or-nothing
                            self._sem.release()
                        return False
                    got += 1
            self._size = n
            return True


class FlushJob:
    """Turn one immutable memtable into an L0 run + version install."""

    __slots__ = ("imm", "retries")

    def __init__(self, imm: ImmutableMemtable):
        self.imm = imm
        self.retries = 0

    def run(self, store) -> Optional["CompactJob"]:
        return store._bg_flush(self.imm)

    def __repr__(self):
        return f"FlushJob(entries={len(self.imm.memtable)})"


class CompactJob:
    """Plan and apply one compaction task against the *current* tree; while
    the tree is unshaped it returns another CompactJob, which the scheduler
    front-queues, keeping every compaction of a flush ahead of the next
    flush."""

    __slots__ = ("last_task", "retries")

    def __init__(self):
        self.last_task = None
        self.retries = 0

    def run(self, store) -> Optional["CompactJob"]:
        task = store._bg_compact_one()
        self.last_task = task
        if task is not None:
            return CompactJob()
        # The tree is shaped: refresh the range view here, on the worker,
        # never on the write path (a no-op without use_range_views).
        store._bg_refresh_view()
        return None

    def __repr__(self):
        return f"CompactJob(last={self.last_task})"


class CompactionScheduler:
    def __init__(self, store, workers: int = 1,
                 budget: Optional[threading.Semaphore] = None,
                 worker_offset: int = 0):
        # A weak reference only: parked workers must not root the store.  A
        # store dropped without close() stays collectable; the workers see
        # the dead reference on their idle-wait heartbeat and exit.
        self._store = weakref.ref(store)
        self._device = store.device
        self._budget = budget
        self._worker_offset = int(worker_offset)
        self.workers = max(1, int(workers))
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._queue: Deque = deque()
        self._inflight = 0
        self._paused = False
        self._abort = False
        self._stop = False
        self._failure: Optional[BaseException] = None
        self._threads = []
        for i in range(self.workers):
            t = threading.Thread(target=self._loop, daemon=True,
                                 name=f"autumn-compaction-{i}")
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------ submission
    @property
    def lock(self) -> threading.Condition:
        """The scheduler condition: guards the queue AND the store's
        immutable-memtable list (rotation appends and flush-install pops
        are both read-modify-write on it; readers capture it lock-free)."""
        return self._cv

    def submit(self, job) -> None:
        with self._cv:
            if self._stop:
                raise RuntimeError("scheduler is shut down")
            if self._failure is not None:
                raise RuntimeError(
                    "background compaction failed; the store's durable "
                    "state is intact — crash()+recover() to resume"
                ) from self._failure
            self._queue.append(job)
            self._cv.notify_all()

    # --------------------------------------------------------------- workers
    def _loop(self) -> None:
        _pin_worker_to_spare_core(self._worker_offset,
                                  pin=self._device.type == "cuda")
        if self._device.type == "cuda":
            # the current device is per host thread: launch on the store's
            try:
                torch.cuda.set_device(self._device)
            except BaseException as e:
                self._fail(e)     # a dead worker must not hang the writers
                return
        while True:
            with self._cv:
                # turnstile: one job at a time, in queue order
                while (not self._queue or self._inflight or self._paused) \
                        and not self._stop:
                    # timed wait = GC heartbeat for a store dropped unclosed
                    self._cv.wait(timeout=1.0)
                    if self._store() is None:
                        return
                if self._stop:
                    return
                job = self._queue.popleft()
                self._inflight += 1
            store = self._store()
            cont = None
            try:
                if not self._abort and store is not None:
                    if self._budget is None:
                        cont = job.run(store)
                    else:
                        with self._budget:
                            if not self._abort:
                                cont = job.run(store)
            except BaseException as e:    # the worker survives a failed job
                cfg = store.config if store is not None else None
                tel = cfg.telemetry if cfg is not None else None
                job.retries += 1
                if cfg is not None and job.retries <= cfg.bg_max_retries \
                        and not self._abort and not self._stop:
                    # bounded exponential backoff, then the same job re-runs
                    # from the front of the queue (its turnstile slot)
                    store._stats.local().bg_retries += 1
                    if tel is not None:
                        tel.emit("bg_retry", job=type(job).__name__,
                                 attempt=job.retries, error=repr(e))
                    time.sleep(min(0.001 * (1 << (job.retries - 1)), 0.05))
                    with self._cv:
                        self._queue.appendleft(job)
                else:
                    if tel is not None:
                        tel.emit("bg_failure", job=type(job).__name__,
                                 error=repr(e), retries=job.retries - 1)
                    if store is not None:
                        store._stats.local().bg_gave_up += 1
                    self._fail(e, store)
            finally:
                store = None   # don't root the store across the idle wait
                with self._cv:
                    self._inflight -= 1
                    if cont is not None and not self._abort \
                            and self._failure is None:
                        self._queue.appendleft(cont)
                    self._cv.notify_all()

    def _fail(self, e: BaseException, store=None) -> None:
        """Poison the pipeline and turn the store read-only: degraded
        BEFORE the failure is published, so submit() refuses only after
        the flag is visible to writers; the queue is dropped (nothing will
        drain it) and waiters wake."""
        store = store if store is not None else self._store()
        if store is not None:
            store._enter_degraded(e)
        with self._cv:
            if self._failure is None:
                self._failure = e
            self._queue.clear()
            self._cv.notify_all()

    # ------------------------------------------------------------- lifecycle
    @property
    def aborting(self) -> bool:
        """Checked by jobs between pipeline stages (plan/merge/install)."""
        return self._abort

    def pending(self) -> int:
        with self._cv:
            return len(self._queue) + self._inflight

    def idle(self) -> bool:
        """Queue empty and nothing in flight, or the pipeline is dead.
        Lock-free: exact inside ``wait_until`` predicates, which hold the
        (non-reentrant) condition."""
        return self._failure is not None or \
            (not self._queue and self._inflight == 0)

    def wait_until(self, pred: Callable[[], bool],
                   timeout: Optional[float] = None) -> bool:
        """Block the calling (foreground) thread until ``pred()`` holds;
        re-evaluated after every job completion (write-stall control)."""
        with self._cv:
            return self._cv.wait_for(pred, timeout)

    def wait_for_quiesce(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is drained and nothing is in flight.
        Raises RuntimeError if a background job failed: a quiesce after a
        dead pipeline must be loud, not a plausible-looking settled tree."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._failure is not None
                or (not self._queue and self._inflight == 0), timeout)
            if self._failure is not None:
                raise RuntimeError(
                    "background compaction failed; the store's durable "
                    "state is intact — crash()+recover() to resume"
                ) from self._failure
            return ok

    def pause(self) -> None:
        """Stop popping new jobs (the in-flight job finishes); holds the
        immutable-memtable window open for tests.  A paused scheduler with
        queued work is not idle, so writes at the hard stall trigger block
        until :meth:`resume`."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def abort_and_drain(self) -> None:
        """Crash path: discard all queued work and wait out the in-flight
        job, which bails at its next safe point.  Returns with the
        scheduler idle and reusable."""
        store = self._store()
        tel = store.config.telemetry if store is not None else None
        if tel is not None:
            tel.emit("bg_abort", dropped=len(self._queue))
        with self._cv:
            self._abort = True
            self._queue.clear()
            self._cv.notify_all()
            self._cv.wait_for(lambda: self._inflight == 0)
            self._queue.clear()   # a bailing job may have pushed its cont
            self._abort = False
            self._failure = None  # the pipeline is reusable after recover()

    def shutdown(self) -> None:
        """Stop the worker threads (final; the scheduler is not reusable)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
