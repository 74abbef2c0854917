"""Process-wide elastic executor worker pool (ROADMAP "elastic sweep
execution").

Before the session server, every :class:`~repro_torch.core.session.IterativeSession`
spawned its own ``max_workers`` threads per ``execute()`` call, so K
concurrent sessions × M workers oversubscribed the host with K·M runnable
threads. :class:`SharedWorkerPool` caps the *process-wide* total instead:

* every session's calling thread always runs one executor worker inline —
  a session can never be starved to zero workers, which also makes the
  scheme deadlock-free (no session ever blocks waiting for a pool slot);
* workers beyond that are *borrowed* from the pool non-blockingly, up to
  ``max_workers`` across all sessions at once. When the host is busy a
  session simply runs narrower; when it is quiet one session can use the
  whole pool. That is elastic execution: K sessions share M workers
  instead of pooling independently.

Fairness comes from the borrow granularity: slots are returned when an
``execute()`` call finishes, so long-running sessions cannot hold the pool
across iterations, and the inline-worker floor guarantees progress for
every session regardless of who currently holds the slots.
"""
from __future__ import annotations

import threading
from typing import Callable


class SharedWorkerPool:
    """Bounded pool of executor worker slots shared by all sessions.

    ``run(fn, want)`` runs ``fn`` (an executor worker loop) on the calling
    thread and on up to ``want - 1`` borrowed threads, returning when all
    of them have finished. Borrowing is non-blocking: if the pool is
    saturated the call proceeds with fewer workers rather than waiting.
    """

    def __init__(self, max_workers: int):
        self.max_workers = max(1, int(max_workers))
        self._lock = threading.Lock()
        self.in_use = 0          # borrowed slots right now
        self.peak_in_use = 0     # high-water mark (observability/tests)

    def _try_borrow(self) -> bool:
        with self._lock:
            if self.in_use >= self.max_workers:
                return False
            self.in_use += 1
            self.peak_in_use = max(self.peak_in_use, self.in_use)
            return True

    def _return_slot(self) -> None:
        with self._lock:
            self.in_use -= 1

    def run(self, fn: Callable[[], None], want: int) -> int:
        """Run ``fn`` inline plus on up to ``want - 1`` borrowed workers.

        Returns the number of workers that actually ran (≥ 1). Exceptions
        from the inline worker propagate; borrowed workers run the same
        executor loop, which routes its failures through the executor's
        own error channel.
        """
        threads: list[threading.Thread] = []
        for _ in range(max(0, int(want) - 1)):
            if not self._try_borrow():
                break

            def slot() -> None:
                try:
                    fn()
                finally:
                    self._return_slot()

            t = threading.Thread(target=slot, name="helix-pool-worker",
                                 daemon=True)
            try:
                t.start()
            except RuntimeError:      # thread exhaustion: give the slot
                self._return_slot()   # back instead of leaking capacity
                break
            threads.append(t)
        try:
            fn()   # the caller always contributes one worker
        finally:
            for t in threads:
                t.join()
        return 1 + len(threads)

    def stats(self) -> dict:
        """Current pool occupancy (JSON-safe, for server status RPC)."""
        with self._lock:
            return {"max_workers": self.max_workers,
                    "in_use": self.in_use,
                    "peak_in_use": self.peak_in_use}
