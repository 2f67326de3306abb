"""Oracle ceiling for the local (per-window) convergence benchmark.

The port of the JAX package's `scripts/local_ceiling_analysis.py`, on the
host only (numpy and torch on the CPU; no card needed). Each prediction
window spans loc_window_size seconds of audio, and windows that straddle
a modulation boundary contain TWO keys but carry ONE label (the
reference's half-window majority-overlap rule, KeyDataset.py:379-412,
reproduced in utils/labels.py::local_segment_repeats). An acoustically
perfect model can only predict the key that dominates the window's
actual content; wherever that disagrees with the assigned label, even
the oracle scores the MIREX partial credit, not 1.0.

Oracle: for every valid window j (trimmed-mel frames [j, j+W), absolute
frames [start_cut+j, start_cut+j+W)), predict the annotation segment key
with maximum frame overlap, then score it with train/metrics.py's
mirex_categories against the window's assigned label, as validation
scores the model (per-song mean over valid windows, then mean over
songs).

Usage:
    python -m audio_key_estimation_torch.scripts.local_ceiling_analysis \
        [corpus_root]

Defaults to the port's local val corpus (`local_va` under
scripts/train_converge_hard.py's corpus root; written by
`python -m audio_key_estimation_torch.scripts.train_converge_hard local`).
AKX_LOC_WINDOW sets the window in seconds (default 10): each window size
has its own ceiling.
"""
import os
import sys
import tempfile

import numpy as np
import torch

from ..data.loaders import SchubertWinterreiseLoader
from ..train.metrics import mirex_categories
from ..utils import labels as L

FRAMES = 5
LOC_WINDOW_SIZE = int(os.environ.get("AKX_LOC_WINDOW", 10))
# train_converge_hard.CORPUS_ROOT (not imported: this script needs no card)
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "akx_hard_corpus_torch",
                            "local_va")


def song_oracle(segments, loader, window: int = LOC_WINDOW_SIZE):
    """Per-window oracle categories for one song. Returns (cats, n_mixed,
    n_mismatch, n_windows) where mixed = window spans >1 segment and
    mismatch = oracle majority key != assigned label key."""
    W = FRAMES * window
    key_rows, sig_rows, tonic_rows, start_cut, _ = L.local_labels(
        segments, loader.keys, loader.signature, FRAMES, window)
    n_windows = key_rows.shape[0]

    # acoustic segment spans in frame units
    spans = [(int(s * FRAMES), int(e * FRAMES), k) for s, e, k in segments]
    seg_labels = [L.global_labels(k, loader.keys, loader.signature)
                  for _, _, k in spans]

    oracle_key = np.zeros((n_windows, 12), np.float32)
    oracle_tonic = np.zeros((n_windows, 12), np.float32)
    n_mixed = n_mismatch = 0
    for j in range(n_windows):
        lo, hi = start_cut + j, start_cut + j + W
        overlaps = [max(0, min(hi, e) - max(lo, s)) for s, e, _ in spans]
        best = int(np.argmax(overlaps))
        if sum(o > 0 for o in overlaps) > 1:
            n_mixed += 1
        k, _, t = seg_labels[best]
        oracle_key[j], oracle_tonic[j] = k, t
        if not np.array_equal(k, key_rows[j]):
            n_mismatch += 1

    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    cats = mirex_categories(as_t(key_rows), as_t(oracle_key),
                            as_t(tonic_rows), as_t(oracle_tonic),
                            as_t(sig_rows))
    cats = {k: float(v.mean()) for k, v in cats.items()}
    return cats, n_mixed, n_mismatch, n_windows


def main(root: str = DEFAULT_ROOT, window: int = LOC_WINDOW_SIZE) -> dict:
    loader = SchubertWinterreiseLoader(root, local=True)
    files = loader.get_filenames()
    if not files:
        raise SystemExit(f"no songs under {root}: write them with "
                         "python -m audio_key_estimation_torch.scripts."
                         "train_converge_hard local")
    per_song, tot_mixed = [], [0, 0, 0]
    for fn in files:
        cats, n_mixed, n_mismatch, n_win = song_oracle(
            loader.get_key_signature(fn), loader, window)
        per_song.append(cats)
        tot_mixed[0] += n_mixed
        tot_mixed[1] += n_mismatch
        tot_mixed[2] += n_win
    agg = {k: float(np.mean([c[k] for c in per_song])) for k in per_song[0]}
    n_mixed, n_mismatch, n_win = tot_mixed
    print(f"corpus: {root}  ({len(files)} songs, {n_win} windows, "
          f"W={window}s)")
    print(f"mixed windows (span >1 key): {n_mixed}/{n_win} "
          f"= {n_mixed / n_win:.3f}")
    print(f"oracle-vs-label mismatch   : {n_mismatch}/{n_win} "
          f"= {n_mismatch / n_win:.3f}")
    print("oracle ceiling (song-mean, as validation aggregates):")
    for k in ("mirex", "correct", "fifths", "relative", "parallel", "other"):
        print(f"  {k:9s} {agg[k]:.4f}")
    return agg


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_ROOT)
