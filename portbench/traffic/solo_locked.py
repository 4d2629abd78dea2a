"""solo.py's closed loop (one user through the online executor, the next
job sent when the last one's final image arrives), its window closed
under the program's device lock.

Closing a traced window stops the benchmark's profiler
(harness/session.py). A captured graph launched from the program's worker
thread while it stopped deadlocked the two: the profiler's stop on this
thread, ``cudaGraphLaunch`` of the card step's accept graph on the
worker, in 3 of 9 traced 2048 px runs. Every capture and replay of a
captured graph in the program holds its device lock
(engine/graphs.py ``device_lock``), so holding it over the close lets the
close run alone: the worker waits for the lock at its next launch, and
the window still ends at the session's seconds. A program without the
lock cannot run this entry: its import fails the run.

Traffic keys: those of solo.py.
"""

from __future__ import annotations

import dataclasses

from portbench.harness.entry import Context
from portbench.harness.record import RunRecord
from portbench.traffic import solo


class LockedClose:
    """A session whose close() holds `lock`; the rest is the session's."""

    def __init__(self, session, lock):
        self._session, self._lock = session, lock

    def __getattr__(self, name):
        return getattr(self._session, name)

    def close(self) -> float:
        with self._lock:
            return self._session.close()


def program_lock(device):
    """The program's lock over its graph launches on `device`."""
    from artstyletransfer_tpu_torch.engine.graphs import device_lock

    return device_lock(device)


def run(ctx: Context) -> RunRecord:
    lock = program_lock(ctx.device)
    ctx = dataclasses.replace(ctx, session=LockedClose(ctx.session, lock))
    return solo.run(ctx)
