"""Render synthetic polyphonic songs in a pool of processes.

    python -m audio_key_estimation_torch.data.render_pool JOBS WORKERS

JOBS is a pickle of (path, segments, seed, timbre_id) tuples, each
rendered by `synthetic.polyphonic_wav(path, segments, seed=seed,
timbre_id=timbre_id)` in one of WORKERS spawned processes. Every song
comes from its own seed, so the files equal a serial render's byte for
byte. The pool runs in an interpreter of its own: a spawned worker
re-imports its parent's main module, and this one loads numpy and the
synthetic writer only, where a caller's (a training harness, chip_smoke)
would load torch and the whole port in every worker.
"""
import multiprocessing
import pickle
import sys
from concurrent.futures import ProcessPoolExecutor

from . import synthetic


def render(job) -> None:
    path, segments, seed, timbre = job
    synthetic.polyphonic_wav(path, segments, seed=seed, timbre_id=timbre)


def main(argv=None) -> None:
    jobs_path, workers = argv if argv is not None else sys.argv[1:]
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    with ProcessPoolExecutor(
            int(workers),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for _ in pool.map(render, jobs):
            pass


if __name__ == "__main__":
    main()
