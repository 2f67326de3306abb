"""Music-theory constants: the key-signature map.

A copy of the JAX package's `utils/key_signatures.py` (pinned to it by
tests/test_torch_imports.py). A key signature is the diatonic pitch-class
set of its major key, rows ordered along the circle of fifths from Cb
major (7 flats) to C# major (7 sharps), followed by six "theoretical"
enharmonic keys (Cb/Db/Gb minor, D#/G#/A# major).

Pitch classes are indexed chromatically: C=0, C#=1, ..., B=11.
"""

from __future__ import annotations

import numpy as np

_MAJOR_STEPS = (0, 2, 4, 5, 7, 9, 11)  # ionian scale degrees in semitones


def _major_set(tonic: int) -> np.ndarray:
    row = np.zeros(12, dtype=np.float32)
    row[[(tonic + s) % 12 for s in _MAJOR_STEPS]] = 1.0
    return row


def _build_map() -> np.ndarray:
    # circle of fifths: row i has i-7 sharps; the tonic walks by fifths
    # from Cb (= B)
    rows = [_major_set((11 + 7 * i) % 12) for i in range(15)]
    # theoretical keys, each the signature of its enharmonic equivalent:
    # Cb minor -> D major, Db minor -> E major, Gb minor -> A major,
    # D# major -> Eb major, G# major -> Ab major, A# major -> Bb major
    rows += [_major_set(tonic) for tonic in (2, 4, 9, 3, 8, 10)]
    return np.stack(rows)


KEY_SIGNATURE_MAP: np.ndarray = _build_map()
NUM_SIGNATURE_ROWS: int = KEY_SIGNATURE_MAP.shape[0]  # 21
