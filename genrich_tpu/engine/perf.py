"""Per-analysis device-path accounting shared by the device engines.

The decomposition the serve/bench protocol records: the platform and
number of devices the engine runs on, bytes and wall time of
host->device uploads, dispatch count and host wall of program
submissions (asynchronous), and count/wall of blocking device->host
pulls.  The reference has no analog (single process, no device,
Genrich.c throughout).
"""

from __future__ import annotations

import time

import numpy as np


class PerfMixin:
    """upload/dispatch/fetch counters; engines call the helpers."""

    def begin_run(self) -> None:
        """Reset the per-analysis accounting (serve calls per line)."""
        self.perf = {"platform": self.devices[0].platform,
                     "devices": len(self.devices),
                     "upload_bytes": 0, "upload_n": 0,
                     "upload_s": 0.0, "dispatch_n": 0,
                     "dispatch_s": 0.0, "fetch_n": 0, "fetch_s": 0.0}

    def _put(self, arr):
        """Host array -> device, accounted."""
        t0 = time.perf_counter()
        out = self.jnp.asarray(arr)
        p = self.perf
        p["upload_n"] += 1
        p["upload_bytes"] += getattr(arr, "nbytes", 0)
        p["upload_s"] += time.perf_counter() - t0
        return out

    def _call(self, fn, *args, **kw):
        """Dispatch a jitted program, accounted (async submission)."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        p = self.perf
        p["dispatch_n"] += 1
        p["dispatch_s"] += time.perf_counter() - t0
        return out

    def _fetch(self, x):
        """Device value -> numpy (blocking), accounted."""
        t0 = time.perf_counter()
        out = np.asarray(x)
        p = self.perf
        p["fetch_n"] += 1
        p["fetch_s"] += time.perf_counter() - t0
        return out

    def _fetch_many(self, xs):
        """One blocking pull for a whole tuple of device arrays.

        jax.device_get batches the transfers into one blocking wait
        instead of one per array.  Counted as one fetch."""
        t0 = time.perf_counter()
        out = self.jax.device_get(tuple(xs))
        p = self.perf
        p["fetch_n"] += 1
        p["fetch_s"] += time.perf_counter() - t0
        return out
