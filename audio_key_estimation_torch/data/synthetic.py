"""Hermetic synthetic fixtures: no-audio CQT blobs and tiny corpus trees.

`custom_cqt` reproduces the reference equivariance fixture
(equivariance_test.py:266-277); the corpus builders generate miniature
on-disk dataset layouts (sine-wave WAVs + annotations) so the loader and
pipeline stack is testable without any real corpora (SURVEY.md §4 item 3).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from .audio_io import write_wav


def custom_cqt(octaves: int = 10, with_border: bool = True,
               frames_t: int = 592) -> np.ndarray:
    """Deterministic zeros+blobs CQT (equivariance_test.py:266-277)."""
    shape = octaves * 3 * 12
    mel = np.zeros((shape, frames_t), np.float32)
    mel[100:150, 20:50] = 1.0
    if with_border:
        mel[30:40, 400] = 10.0
        mel[10:15, 200] = 8.0
    mel[50, 320:350] = 20.0
    return mel


def sine_wav(path: str, freq: float, seconds: float = 2.0, sr: int = 22050):
    t = np.arange(int(seconds * sr)) / sr
    write_wav(path, 0.5 * np.sin(2 * np.pi * freq * t), sr)


from ..utils.key_signatures import _MAJOR_STEPS


def scale_wav(path: str, tonic_pc: int, minor: bool, seconds: float = 2.0,
              sr: int = 22050, seed: int = 0):
    """A song whose AUDIO determines its key: a random walk of sine notes
    over the key's diatonic pitch classes (natural minor = the relative
    major's set rotated), octaves 3-5, with the tonic sounded first, last,
    and 3x as often — so key signature AND tonic are learnable from sound
    alone. Used by the TPU convergence run (scripts/train_converge_tpu.py),
    where single-tone fixtures would make the labels unlearnable."""
    rng = np.random.default_rng(seed)
    rel_major = (tonic_pc + 3) % 12 if minor else tonic_pc
    pcs = [(rel_major + s) % 12 for s in _MAJOR_STEPS]
    weights = np.array([3.0 if pc == tonic_pc else 1.0 for pc in pcs])
    weights /= weights.sum()
    note_len = int(0.25 * sr)      # integer note grid: note i starts at
    n_notes = max(2, int(seconds * sr) // note_len)  # exactly i * note_len
    choices = rng.choice(len(pcs), size=n_notes, p=weights)
    octs = rng.integers(3, 6, size=n_notes)
    choices[0] = choices[-1] = pcs.index(tonic_pc)
    y = np.zeros(int(seconds * sr), np.float32)
    env = np.minimum(1.0, np.minimum(np.arange(note_len) / 200.0,
                     (note_len - np.arange(note_len)) / 200.0))
    for i, (ci, oc) in enumerate(zip(choices, octs)):
        f0 = 440.0 * 2.0 ** ((pcs[ci] - 9) / 12.0 + (int(oc) - 4))
        s0 = i * note_len
        seg = min(len(env), len(y) - s0)
        if seg <= 0:
            break
        t = np.arange(seg) / sr
        y[s0:s0 + seg] += (0.5 * env[:seg] * np.sin(2 * np.pi * f0 * t)
                           ).astype(np.float32)
    write_wav(path, y, sr)


# ---------------------------------------------------------------------------
# Hard synthetic benchmark: polyphonic songs (round-1 verdict item 1).
#
# scale_wav's monophonic sine walks turned out linearly separable from the
# CQT (val MIREX 1.00 at epoch 0). These songs are calibrated so an
# untrained model scores near chance and learning takes real epochs:
#   * polyphony: diatonic TRIADS (functional chord walk + bass) plus a
#     melody line — pitch classes overlap between keys, so single-frame
#     energy peaks no longer identify the key;
#   * timbre: per-song instrument with its own harmonic stack (overtones
#     land on OTHER pitch classes' bins), attack/release and detune —
#     train/val use DISJOINT timbre ids, so shortcuts through timbre
#     features do not generalize;
#   * distractors: colored-noise bed at randomized SNR and percussive
#     noise bursts on the beat grid — energy that carries no key
#     information;
#   * jitter: per-song tempo, per-note velocity, rests.
# Modulation support (segments with different keys) feeds the local-mode
# convergence run (reference models.py:861-876 / KeyDataset.py:357-439).
# ---------------------------------------------------------------------------

def _timbre(timbre_id: int) -> dict:
    """Deterministic instrument parameters for a timbre id."""
    rng = np.random.default_rng(987_001 + timbre_id)
    n_h = int(rng.integers(4, 11))
    amps = np.arange(1, n_h + 1, dtype=np.float64) ** -rng.uniform(0.6, 2.2)
    amps[1::2] *= rng.uniform(0.4, 1.8)   # odd/even harmonic balance
    amps /= amps.sum()
    return {"amps": amps,
            "attack": float(rng.uniform(0.004, 0.04)),
            "release": float(rng.uniform(0.05, 0.25)),
            "detune": float(rng.uniform(0.0, 0.002))}


def _render_note(y: np.ndarray, sr: int, f0: float, t0: float, dur: float,
                 vel: float, tim: dict, rng) -> None:
    n0 = int(t0 * sr)
    n1 = min(len(y), int((t0 + dur) * sr))
    if n1 <= n0 or f0 <= 0:
        return
    n = n1 - n0
    t = np.arange(n) / sr
    a = min(max(1, int(tim["attack"] * sr)), n)
    r = max(1, int(tim["release"] * sr))
    env = np.ones(n)
    env[:a] = np.linspace(0.0, 1.0, a, endpoint=False)
    tail = min(r, n)
    env[n - tail:] *= np.linspace(1.0, 0.0, tail)
    f = f0 * (1.0 + rng.normal(0.0, tim["detune"]))
    # wavetable synthesis: one cycle of the harmonic stack (random phases),
    # then a phase-accumulator lookup — ~10x cheaper than per-sample sins
    ks = np.arange(1, len(tim["amps"]) + 1)
    keep = ks * f <= 0.45 * sr
    if not keep.any():
        return
    ks, amps = ks[keep], tim["amps"][keep]
    tbl_n = 4096
    x = np.arange(tbl_n)[:, None] / tbl_n
    tbl = np.sin(2 * np.pi * x * ks + rng.uniform(0, 2 * np.pi, len(ks))) @ amps
    idx = (np.arange(n) * (f * tbl_n / sr)).astype(np.int64) % tbl_n
    y[n0:n1] += vel * env * tbl[idx]


# functional chord-walk transition weights over scale degrees 0..6
# (I ii iii IV V vi vii): tonal moves dominate, everything reachable
_CHORD_TRANS = np.array([
    #  I   ii  iii  IV   V   vi  vii
    [0.10, .15, .05, .25, .25, .15, .05],   # from I
    [0.10, .05, .05, .15, .45, .10, .10],   # from ii
    [0.10, .10, .05, .25, .15, .30, .05],   # from iii
    [0.25, .10, .05, .10, .30, .10, .10],   # from IV
    [0.50, .05, .05, .10, .10, .15, .05],   # from V
    [0.15, .25, .05, .20, .20, .10, .05],   # from vi
    [0.55, .05, .05, .05, .15, .10, .05],   # from vii
])


def polyphonic_wav(path: str, segments, *, sr: int = 22050, seed: int = 0,
                   timbre_id: int = 0, snr_db: float | None = None) -> None:
    """A polyphonic song over key ``segments``: list of
    (start_s, end_s, tonic_pc, minor). Global songs pass one segment;
    local-mode songs pass several (mid-song modulations)."""
    rng = np.random.default_rng(seed)
    total = float(max(e for _, e, _, _ in segments))
    y = np.zeros(int(total * sr), np.float64)
    tim = _timbre(timbre_id)
    beat = 60.0 / rng.uniform(60.0, 160.0)   # per-song tempo jitter
    # per-song global mistuning (±40 cents): real corpora are not at
    # A440, and at 36 bins/octave this smears every partial across CQT
    # bins — the model must learn tuning invariance, not bin lookup
    tune = 2.0 ** (rng.uniform(-0.4, 0.4) / 12.0)

    for (s0, s1, tonic_pc, minor) in segments:
        rel_major = (tonic_pc + 3) % 12 if minor else tonic_pc
        pcs = [(rel_major + st) % 12 for st in _MAJOR_STEPS]
        deg_tonic = pcs.index(tonic_pc)
        lead_deg = (deg_tonic + 6) % 7          # scale step below the tonic
        # chord track: FUNCTIONAL walk — _CHORD_TRANS is indexed by degree
        # RELATIVE TO THE TONIC (0 = home chord), so minor songs center on
        # their own tonic, not the relative major. Minor mode is marked the
        # way real music marks it: the dominant chord carries the raised
        # leading tone (harmonic minor) — the one pitch class that
        # distinguishes a minor key from its relative major.
        rel = 0                                 # start on the tonic chord
        t = s0
        while t < s1:
            dur = beat * int(rng.integers(1, 3))
            if t + dur >= s1 - beat:            # cadence: close on tonic
                rel = 0
            deg = (deg_tonic + rel) % 7
            root = pcs[deg]
            third = pcs[(deg + 2) % 7]
            fifth = pcs[(deg + 4) % 7]
            if minor and rel == 4:              # V of minor: leading tone
                third = (third + 1) % 12
            shift = 0
            if rel not in (0,) and rng.uniform() < 0.12:
                # borrowed/chromatic-planing chord: whole triad off-key by
                # a semitone — key-neutral harmonic distractor
                shift = int(rng.choice([-1, 1]))
            vel = rng.uniform(0.10, 0.22)
            for pc, octave in ((root, 2), (root, 3), (third, 3), (fifth, 3)):
                f0 = (440.0 * tune
                      * 2.0 ** (((pc + shift) - 9) / 12.0 + (octave - 4)))
                _render_note(y, sr, f0, t, dur * rng.uniform(0.85, 1.0),
                             vel * rng.uniform(0.8, 1.2), tim, rng)
            w = _CHORD_TRANS[rel] / _CHORD_TRANS[rel].sum()
            rel = int(rng.choice(7, p=w))
            t += dur
        # melody: scale-degree random walk on the half-beat grid, with the
        # harmonic-minor leading tone raised most of the time
        mdeg = deg_tonic + 7                    # around octave 5
        t = s0
        while t < s1:
            if rng.uniform() < 0.7:
                mdeg += int(rng.choice([-2, -1, -1, 1, 1, 2]))
                mdeg = int(np.clip(mdeg, 3, 17))
                pc = pcs[mdeg % 7]
                if minor and mdeg % 7 == lead_deg and rng.uniform() < 0.7:
                    pc = (pc + 1) % 12
                elif rng.uniform() < 0.06:      # chromatic passing tone
                    pc = (pc + int(rng.choice([-1, 1]))) % 12
                octave = 4 + mdeg // 7
                f0 = 440.0 * tune * 2.0 ** ((pc - 9) / 12.0 + (octave - 4))
                _render_note(y, sr, f0, t, 0.5 * beat * rng.uniform(0.7, 1.0),
                             rng.uniform(0.08, 0.20), tim, rng)
            t += 0.5 * beat

    # percussion: key-free noise bursts on the beat grid
    t = 0.0
    while t < total:
        n0 = int(t * sr)
        dur = int(rng.uniform(0.02, 0.05) * sr)
        n1 = min(len(y), n0 + dur)
        if n1 > n0:
            burst = rng.standard_normal(n1 - n0)
            burst *= np.exp(-np.arange(n1 - n0) / (0.008 * sr))
            y[n0:n1] += rng.uniform(0.05, 0.25) * burst
        t += beat * (0.5 if rng.uniform() < 0.3 else 1.0)

    # colored-noise bed at randomized SNR (1-pole lowpassed white noise)
    from scipy.signal import lfilter
    white = rng.standard_normal(len(y))
    a = 0.98
    pink = lfilter([1.0 - a], [1.0, -a], white)
    sig_rms = np.sqrt(np.mean(y ** 2)) + 1e-12
    snr = snr_db if snr_db is not None else rng.uniform(4.0, 14.0)
    noise_rms = sig_rms / (10.0 ** (snr / 20.0))
    pink *= noise_rms / (np.sqrt(np.mean(pink ** 2)) + 1e-12)
    y = y + pink
    peak = np.max(np.abs(y)) + 1e-12
    write_wav(path, (0.7 * y / peak).astype(np.float32), sr)


NOTE_PC = {"c": 0, "db": 1, "c#": 1, "d": 2, "eb": 3, "d#": 3, "e": 4,
           "f": 5, "gb": 6, "f#": 6, "g": 7, "ab": 8, "g#": 8, "a": 9,
           "bb": 10, "a#": 10, "b": 11, "cb": 11}


def key_to_pc(key: str) -> tuple:
    """'Eb minor' -> (3, True)."""
    note, mode = key.split()
    return NOTE_PC[note.lower()], mode == "minor"


def make_giantsteps_corpus(root: str, songs, seconds: float = 2.0,
                           scale_audio: bool = False, seed_offset: int = 0,
                           audio_fn=None):
    """songs: list of (name, freq, key_string, genre_string).

    scale_audio=True synthesizes diatonic scale-walk audio derived from
    key_string (see scale_wav) instead of a single sine at `freq`;
    seed_offset decorrelates the walks of corpora sharing key lists
    (train vs val). audio_fn(wav_path, key_string, idx), when given,
    overrides audio synthesis entirely (the hard polyphonic benchmark
    plugs in here)."""
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations", "key"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations", "genre"), exist_ok=True)
    note_pc = NOTE_PC
    for idx, (name, freq, key, genre) in enumerate(songs):
        wav = os.path.join(root, "audio", f"{name}.wav")
        if audio_fn is not None:
            audio_fn(wav, key, idx)
        elif scale_audio:
            note, mode = key.split()
            scale_wav(wav, note_pc[note.lower()], mode == "minor",
                      seconds=seconds, seed=seed_offset + idx)
        else:
            sine_wav(wav, freq, seconds=seconds)
        with open(os.path.join(root, "annotations", "key", f"{name}.key"), "w") as f:
            f.write(key)
        with open(os.path.join(root, "annotations", "genre", f"{name}.genre"), "w") as f:
            f.write(genre)
    return root


def make_winterreise_corpus(root: str, songs, local_segments=None,
                            seconds: float = 3.0, audio_fn=None):
    """songs: list of (performance, song, freq, key). Song names are
    '<performance>_<song>' as in the reference CSV join (KeyDataset.py:659).
    audio_fn(wav_path, name, segs), when given, synthesizes the audio from
    the local key segments (modulating polyphonic songs for the local-mode
    convergence run)."""
    os.makedirs(os.path.join(root, "01_RawData", "audio_wav"), exist_ok=True)
    ann = os.path.join(root, "02_Annotations")
    os.makedirs(os.path.join(ann, "ann_audio_localkey-ann3"), exist_ok=True)
    with open(os.path.join(ann, "ann_audio_globalkey.csv"), "w", newline="") as f:
        w = csv.writer(f, delimiter=";")
        w.writerow(["performance", "song", "key"])
        for perf, song, freq, key in songs:
            w.writerow([perf, song, key])
    for perf, song, freq, key in songs:
        name = f"{perf}_{song}"
        segs = (local_segments or {}).get(name,
                                          [(0.0, seconds, key)])
        wav_path = os.path.join(root, "01_RawData", "audio_wav",
                                f"{name}.wav")
        if audio_fn is not None:
            audio_fn(wav_path, name, segs)
        else:
            sine_wav(wav_path, freq, seconds=seconds)
        with open(os.path.join(ann, "ann_audio_localkey-ann3", f"{name}.csv"),
                  "w", newline="") as f:
            w = csv.writer(f, delimiter=";")
            w.writerow(["start", "end", "key"])
            for s, e, k in segs:
                w.writerow([s, e, k])
    return root


def make_gtzan_corpus(root: str, songs):
    """songs: list of (genre_dir, name, freq, lerch_key_string)."""
    for genre_dir, name, freq, key in songs:
        adir = os.path.join(root, "genres_original", genre_dir)
        kdir = os.path.join(root, "gtzan_key", "genres", genre_dir)
        os.makedirs(adir, exist_ok=True)
        os.makedirs(kdir, exist_ok=True)
        sine_wav(os.path.join(adir, f"{name}.wav"), freq)
        with open(os.path.join(kdir, f"{name}.lerch.txt"), "w") as f:
            f.write(key)
    return root


def make_scraped_corpus(root: str, songs, threshold_scores=None):
    """songs: list of (name, score, key). Writes placeholder .mp3 files plus
    the similarity csv (decode is not exercised — discovery/labels only)."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "__youtube_similarities.csv"), "w",
              newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        for name, score, key in songs:
            w.writerow([name, score, key])
    for name, score, key in songs:
        with open(os.path.join(root, f"{name}.mp3"), "wb") as f:
            f.write(b"\x00" * 128)
    return root


def make_guitarset_corpus(root: str, songs):
    """songs: list of (name, freq, key)."""
    import json
    os.makedirs(os.path.join(root, "audio_mono-mic"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for name, freq, key in songs:
        sine_wav(os.path.join(root, "audio_mono-mic", f"{name}_mic.wav"), freq)
        with open(os.path.join(root, "annotations", f"{name}.jams"), "w") as f:
            json.dump({"annotations": [
                {"data": [{"value": key}]}]}, f)
    return root
