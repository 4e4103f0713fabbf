"""Async job DAG manager (a copy of the JAX package's
`service/job_manager.py`, which imports nothing of JAX).

Parity with the reference's GradioJobManager
(reference: webapp/webapps/gradio_job_manager.py): jobs wrap HTTP calls to
backend services, callbacks fire when their dependency jobs complete, and a
poll loop drains everything with per-job timeouts raising TimeoutError
(reference :27-28, 62-64). Built on concurrent.futures instead of
gradio_client's job objects.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence


class Job:
    """A unit of work with gradio_client-Job-like surface
    (reference: gradio_job_manager.py:8-28)."""

    def __init__(self, fn: Callable[[], object],
                 timeout: Optional[float] = None):
        self.fn = fn
        self.timeout = timeout
        self.future: Optional[Future] = None
        self._start_time: Optional[float] = None

    def start(self, executor: ThreadPoolExecutor) -> None:
        self._start_time = time.time()
        self.future = executor.submit(self.fn)

    def done(self) -> bool:
        return self.future is not None and self.future.done()

    def timed_out(self) -> bool:
        return (self.timeout is not None and self._start_time is not None
                and not self.done()
                and time.time() - self._start_time > self.timeout)

    def outputs(self):
        if self.future is None or not self.future.done():
            return None
        return self.future.result()


class JobManager:
    """Run jobs concurrently; fire callbacks when dependency sets finish
    (reference: gradio_job_manager.py:30-64)."""

    def __init__(self, max_workers: int = 8, poll_interval: float = 0.1):
        self.poll_interval = poll_interval
        self._executor = ThreadPoolExecutor(max_workers=max_workers)
        self._jobs: List[Job] = []
        self._callbacks: List[tuple] = []

    def add_job(self, job: Job) -> Job:
        self._jobs.append(job)
        job.start(self._executor)
        return job

    def add_callback(self, when_jobs_done: Sequence[Job],
                     callback: Callable[..., None]) -> None:
        self._callbacks.append((list(when_jobs_done), callback))

    def run(self) -> None:
        """Poll until all jobs and callbacks have completed.

        Raises TimeoutError when a job exceeds its timeout
        (reference :62-64).
        """
        while self._jobs or self._callbacks:
            for job in self._jobs:
                if job.timed_out():
                    raise TimeoutError(
                        f"Job did not complete within {job.timeout}s.")
            done = [j for j in self._jobs if j.done()]
            for j in done:
                if j.future is not None and j.future.exception():
                    raise j.future.exception()
            fired = []
            for deps, callback in self._callbacks:
                if all(d.done() for d in deps):
                    fired.append((deps, callback))
            for item in fired:
                self._callbacks.remove(item)
                item[1](*item[0])
            self._jobs = [j for j in self._jobs if not j.done()]
            if self._jobs or self._callbacks:
                time.sleep(self.poll_interval)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False)
