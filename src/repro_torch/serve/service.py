"""Async request-queue front end over the continuous-batching engine.

``SolveService`` owns a background worker thread: callers ``submit()``
requests from any thread and later ``result()`` (or ``gather()``) the
responses; the worker drains the inbox into the engine and ticks it while
work remains.  Only the worker touches the engine, so every cache and
parity property of the inline engine holds under the async boundary.

The engine is built in the caller's thread and holds its executor, which
every call on the worker's path takes explicitly: a new thread does not
inherit the caller's :func:`repro_torch.core.use_executor` context.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Dict, List, Optional

from repro_torch.serve.engine import ContinuousBatchEngine, ServeConfig
from repro_torch.serve.request import SolveRequest, SolveResponse

__all__ = ["SolveService"]


class SolveService:
    """Threaded solve server: async queue in, responses out.

    Use as a context manager::

        with SolveService(config, executor=ex) as svc:
            rid = svc.submit(request)
            resp = svc.result(rid, timeout=30)
    """

    def __init__(self, config: ServeConfig = ServeConfig(), *, executor=None,
                 idle_sleep_s: float = 1e-4):
        self.engine = ContinuousBatchEngine(config, executor=executor)
        self._inbox: "queue.Queue[SolveRequest]" = queue.Queue()
        self._results: Dict[int, SolveResponse] = {}
        self._done = threading.Condition()
        self._ids = itertools.count()
        self._idle_sleep_s = idle_sleep_s
        self._stop_flag = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "SolveService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._thread = threading.Thread(target=self._run, name="solve-serve",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_flag.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "SolveService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API -----------------------------------------------------------
    def submit(self, req: SolveRequest) -> int:
        """Enqueue a request; returns its id at once."""
        if self._thread is None:
            raise RuntimeError("service not started")
        if req.request_id is None:
            req.request_id = next(self._ids)
        if req.submitted_s is None:
            req.submitted_s = time.perf_counter()
        self._inbox.put(req)
        return req.request_id

    def result(self, request_id: int,
               timeout: Optional[float] = None) -> SolveResponse:
        """Block until the response for ``request_id`` arrives."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._done:
            while request_id not in self._results:
                if self._error is not None:
                    raise RuntimeError("solve-serve worker died") from self._error
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"no response for request {request_id} "
                                       f"within {timeout}s")
                self._done.wait(timeout=remaining)
            return self._results.pop(request_id)

    def gather(self, request_ids: List[int],
               timeout: Optional[float] = None) -> List[SolveResponse]:
        return [self.result(rid, timeout=timeout) for rid in request_ids]

    # -- worker ---------------------------------------------------------------
    def _run(self) -> None:
        try:
            while not self._stop_flag.is_set():
                moved = False
                while True:
                    try:
                        req = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                    # ids were assigned at submit(); the engine keeps them
                    self.engine.submit(req)
                    moved = True
                if self.engine.has_work:
                    responses = self.engine.tick()
                    if responses:
                        with self._done:
                            for resp in responses:
                                self._results[resp.request_id] = resp
                            self._done.notify_all()
                elif not moved:
                    time.sleep(self._idle_sleep_s)
        except BaseException as e:  # hand the worker's death to the callers
            with self._done:
                self._error = e
                self._done.notify_all()
            raise
