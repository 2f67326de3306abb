"""The 95th percentile of every request's latency in the traced run's
window, from the call to `predict_files` until its predictions return:
the tail the files cell serves, read per layer since its runs spread too
widely for an end-to-end bound (PERF.md §2)."""

import numpy as np

LAYER = "request (KeyEstimator.predict_files)"
UNIT = "ms"
MOVES = "served_audio_min_per_s"
SOURCE = "host_clock"
READS = "the host clock around each request of the window"


def read(r):
    if not r.latencies_s:
        return None
    return 1e3 * float(np.percentile(r.latencies_s, 95))
