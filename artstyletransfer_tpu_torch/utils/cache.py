"""The in-process bound on the port's cached runners.

The port of the JAX package's ``utils/cache.py::BoundedCache``. The JAX
package keeps one jitted executable per (shape, config); the port keeps
one captured CUDA graph per (bucket shape, lanes, config, weights)
(engine/graphs.py, cached in engine/transfer.py's ``_COMPILE_CACHE``).
Each graph holds its static buffers and its share of the graph memory
pool, so a long-lived process that meets many shapes must not keep all of
them: the cache evicts the least recently used entry beyond its bound. A
job that still holds an evicted graph keeps using it, and a later request
of that key captures it again.

The JAX package's other half, the persistent XLA compilation cache
(``enable_compilation_cache``), has no counterpart: a CUDA graph cannot
outlive its process, and the kernels' build directory
(``kernels/build/``) already persists the one compile the port pays.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Optional


class BoundedCache:
    """A tiny LRU map for captured runner bundles.

    maxsize None/0 = unbounded (opt out). Reads refresh recency; inserts
    evict the least-recently-used entry beyond maxsize. The default bound
    comes from ASTT_RUNNER_CACHE_SIZE (32, the JAX package's default)."""

    def __init__(self, maxsize: Optional[int] = None):
        if maxsize is None:
            maxsize = int(os.environ.get("ASTT_RUNNER_CACHE_SIZE", "32"))
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __getitem__(self, key) -> Any:
        value = self._d[key]
        self._d.move_to_end(key)
        return value

    def __setitem__(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        if self.maxsize and self.maxsize > 0:
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def pop(self, key, default=None) -> Any:
        return self._d.pop(key, default)

    def clear(self) -> None:
        self._d.clear()
