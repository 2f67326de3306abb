"""Label construction from key-string annotations.

Reproduces the reference's label semantics (KeyDataset.py:345-466) exactly,
including its quirks, without any TensorFlow dependency:

* ``key_label``      — 12-dim diatonic multi-hot: the first index of the key
  string in the loader's 42-slot ``keys`` vocabulary, modulo 21, selects a
  KEY_SIGNATURE_MAP row (KeyDataset.py:443-444). An *unmatched* string maps to
  index 0 (Cb major) because argmax of an all-False vector is 0 — preserved.
* ``key_signature_id`` — 24-dim one-hot of the first index in the loader's
  ``signature`` vocabulary (KeyDataset.py:446-447). For 48-slot vocabularies
  (flat spellings live at 24..47) tf.one_hot(idx, 24) yields an ALL-ZERO
  vector for out-of-range indices — preserved (it feeds the MIREX "fifths"
  quirk downstream).
* ``tonic_label``    — one-hot( first signature index % 12 ) (KeyDataset.py:449-450).

Local (per-window) mode reproduces the Winterreise segment-overlap logic
(KeyDataset.py:357-439) with one documented divergence: the reference
concatenates segment label blocks along ``axis=1``, which only type-checks
when all segments have equal length (a latent bug); we concatenate along the
time axis (axis=0), which is the intended behavior (the reference's own
assert at KeyDataset.py:439 expects time-major stacking).
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np

from .key_signatures import KEY_SIGNATURE_MAP


def vocab_index(value: str, vocab: Sequence[str]) -> int:
    """First index of `value` in `vocab`; 0 if absent (argmax-of-False quirk,
    reference KeyDataset.py:443 — an unmatched key string silently labels
    the song as vocab row 0). The mapping is preserved bit-for-bit for
    parity, but unlike the reference it WARNS: silently-garbage labels cap
    training accuracy with no visible error (matching is case-sensitive —
    'c major' does not match 'C major')."""
    for i, v in enumerate(vocab):
        if value == v:
            return i
    warnings.warn(
        f"key string {value!r} not in the loader's vocabulary — labeled as "
        f"row 0 ({vocab[0]!r}), the reference's unmatched-key behavior",
        stacklevel=2)
    return 0


def one_hot(idx: int, depth: int) -> np.ndarray:
    """tf.one_hot semantics: out-of-range index -> all-zeros vector."""
    v = np.zeros(depth, dtype=np.float32)
    if 0 <= idx < depth:
        v[idx] = 1.0
    return v


def key_multihot(key_string: str, keys_vocab: Sequence[str]) -> np.ndarray:
    """12-dim diatonic multi-hot (KeyDataset.py:443-444)."""
    return KEY_SIGNATURE_MAP[vocab_index(key_string, keys_vocab) % 21].copy()


def signature_onehot(key_string: str, signature_vocab: Sequence[str]) -> np.ndarray:
    """24-dim tonic+mode one-hot (KeyDataset.py:446-447), zeros if idx >= 24."""
    return one_hot(vocab_index(key_string, signature_vocab), 24)


def tonic_onehot(key_string: str, signature_vocab: Sequence[str]) -> np.ndarray:
    """12-dim tonic one-hot (KeyDataset.py:449-450)."""
    return one_hot(vocab_index(key_string, signature_vocab) % 12, 12)


def global_labels(key_string: str, keys_vocab: Sequence[str],
                  signature_vocab: Sequence[str]):
    """(key_multihot[12], key_signature_id[24], tonic[12]) for one song."""
    return (key_multihot(key_string, keys_vocab),
            signature_onehot(key_string, signature_vocab),
            tonic_onehot(key_string, signature_vocab))


# ----------------------------------------------------------------------------
# Local (per-window) mode — Winterreise time-interval annotations
# ----------------------------------------------------------------------------

def local_segment_repeats(i: int, n_segments: int, start_index: int,
                          end_index: int, window_frames: int) -> int:
    """Frames contributed by annotation segment i (KeyDataset.py:379-412).

    ``window_frames`` = loc_window_size * frames. Each prediction consumes a
    full window, so a segment contributes its frame span minus (window-1),
    plus half-window "majority overlap" into each adjacent segment. The first
    segment gets no overlap at all (the reference's second `if i==0` branch
    overwrites the overlap computed in the first — preserved).
    """
    complete = int((end_index - start_index) - (window_frames - 1))
    half = int(window_frames / 2)
    if i == 0:
        return complete
    if i == n_segments - 1:
        return half + complete
    return half + complete + half


def _assigned_segment_spans(segments: Sequence[tuple], frames: int,
                            window_frames: int):
    """One (start_idx, end_idx, segment_i) per label row, in the exact row
    order `local_labels` emits (the reference's half-window majority rule,
    KeyDataset.py:379-412). Single source of truth for the row→segment
    assignment so labels and window-coverage can never drift apart."""
    n = len(segments)
    spans = []
    for i, (start, end, _key) in enumerate(segments):
        si, ei = int(start * frames), int(end * frames)
        r = max(local_segment_repeats(i, n, si, ei, window_frames), 0)
        spans.extend([(si, ei, i)] * r)
    return spans


def local_labels(segments: Sequence[tuple], keys_vocab: Sequence[str],
                 signature_vocab: Sequence[str], frames: int,
                 loc_window_size: int):
    """Per-frame label sequences for local key estimation.

    Parameters
    ----------
    segments : sequence of (start_sec: float, end_sec: float, key_string: str)

    Returns
    -------
    (key_labels[T,12], key_signature_id[T,24], tonic[T,12],
     start_cut: int, keep_len: int)
    where the caller must trim the feature array to
    ``mel[..., start_cut:][..., :keep_len]`` with
    keep_len = T + (loc_window_size*frames - 1)   (KeyDataset.py:429-430).
    """
    window_frames = loc_window_size * frames
    spans = _assigned_segment_spans(segments, frames, window_frames)
    start_cut = int(segments[0][0] * frames)
    per_seg = [global_labels(key_string, keys_vocab, signature_vocab)
               for _start, _end, key_string in segments]
    idx = np.array([i for _si, _ei, i in spans], np.intp)
    key_labels = np.stack([k for k, _s, _t in per_seg])[idx]
    sig_ids = np.stack([s for _k, s, _t in per_seg])[idx]
    tonics = np.stack([t for _k, _s, t in per_seg])[idx]
    keep_len = key_labels.shape[0] + (window_frames - 1)
    return key_labels, sig_ids, tonics, start_cut, keep_len


def local_window_coverage(segments: Sequence[tuple], frames: int,
                          loc_window_size: int) -> np.ndarray:
    """Per-window coverage fraction of each window's ASSIGNED label segment.

    Window j of the trimmed feature array spans absolute frames
    [start_cut + j, start_cut + j + W), W = loc_window_size * frames, and
    carries the label `local_labels` assigned it via the reference's
    half-window majority rule (KeyDataset.py:379-412). Coverage is the
    fraction of those W frames inside the assigned segment's span: 1.0 for
    windows entirely within one annotation segment, < 1.0 for windows that
    straddle a modulation boundary (whose label is therefore partly wrong
    about the audio content — see scripts/local_ceiling_analysis.py).
    Aligned row-for-row with `local_labels`' outputs.
    """
    W = loc_window_size * frames
    start_cut = int(segments[0][0] * frames)
    spans = _assigned_segment_spans(segments, frames, W)
    cov = np.empty(len(spans), np.float32)
    for j, (si, ei, _i) in enumerate(spans):
        a, b = start_cut + j, start_cut + j + W
        cov[j] = max(0, min(b, ei) - max(a, si)) / W
    return cov


def tiled_local_labels(key_string: str, keys_vocab: Sequence[str],
                       signature_vocab: Sequence[str], time_length: int):
    """Global label tiled per frame (non-Winterreise local mode,
    KeyDataset.py:458-463)."""
    k, s, t = global_labels(key_string, keys_vocab, signature_vocab)
    return (np.tile(k, (time_length, 1)), np.tile(s, (time_length, 1)),
            np.tile(t, (time_length, 1)))
