"""Files in, keys out, in plain NumPy and PyTorch: the WAV reader, the
bucketing of a request's clips, the hop and the true lengths, the
features, the model and the naming of each clip's key.

The serving rules are those of the reference's data pipeline
(KeyDataset.py:485,490: the hop is round(sr / frames)) and of the
system's serving API, worked out here again: a request's clips of one
sample rate are zero-padded to the first bucket (60, 180 or 420 s) that
holds its longest clip, or else to whole minutes; a clip's true length
is 1 + samples // hop frames. A 12-dim key output names the nearest
key-signature row of the circle of fifths by cosine similarity (as the
MIREX scorer of models.py:1083-1085 does), and the tonic reads that
signature as its major or relative-minor key.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from . import cqt as ref_cqt
from . import of

BUCKET_SECONDS = (60, 180, 420)
NOTE_NAMES = ['C', 'C#', 'D', 'D#', 'E', 'F', 'F#', 'G', 'G#', 'A', 'A#', 'B']
_MAJOR_STEPS = (0, 2, 4, 5, 7, 9, 11)
# major tonics of the circle-of-fifths rows (Cb .. C#), then the six
# enharmonic "theoretical" keys' signatures
ROW_MAJOR_TONIC = [(11 + 7 * i) % 12 for i in range(15)] + [2, 4, 9, 3, 8, 10]


def signature_map() -> np.ndarray:
    """(21, 12) pitch-class sets of each row's major key."""
    rows = np.zeros((len(ROW_MAJOR_TONIC), 12), np.float32)
    for r, tonic in enumerate(ROW_MAJOR_TONIC):
        rows[r, [(tonic + s) % 12 for s in _MAJOR_STEPS]] = 1.0
    return rows


def key_name(key: np.ndarray, tonic_logits: np.ndarray) -> str:
    """The named key of one clip's outputs."""
    ksm = signature_map()
    v = key / max(np.linalg.norm(key), 1e-8)
    sims = (ksm @ v) / np.linalg.norm(ksm, axis=1)
    row = int(np.argmax(sims))
    tonic = int(np.argmax(tonic_logits))
    major = ROW_MAJOR_TONIC[row]
    if tonic == major:
        return f"{NOTE_NAMES[tonic]} major"
    if tonic == (major + 9) % 12:
        return f"{NOTE_NAMES[tonic]} minor"
    return f"{NOTE_NAMES[tonic]} (signature {NOTE_NAMES[major]} major)"


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """(int16 samples of channel 0, sample rate) of a PCM16 RIFF/WAVE."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    at, fmt, samples = 12, None, None
    while at + 8 <= len(data):
        cid, size = data[at:at + 4], struct.unpack("<I", data[at + 4:at + 8])[0]
        body = data[at + 8:at + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            samples = body
        at += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt or data chunk")
    encoding, channels, rate, _, _, bits = fmt
    if encoding != 1 or bits != 16:
        raise ValueError(f"{path}: not PCM16")
    x = np.frombuffer(samples, "<i2")
    return x[:len(x) // channels * channels:channels].copy(), rate


def bucket_samples(longest: int, sr: int) -> int:
    seconds = longest / sr
    for b in BUCKET_SECONDS:
        if seconds <= b:
            return int(b * sr)
    return int(math.ceil(seconds / 60.0) * 60 * sr)


def hop_of(sr: int, frames: int) -> int:
    return int(round(sr / frames))


def bins_of(cfg: dict) -> tuple:
    """Bins/octave of each CQT the model reads."""
    return (36, 12) if cfg.get("multi_scale") else (cfg["bins_per_octave"],)


def features(batch: torch.Tensor, sr: int, hop: int, cfg: dict) -> list:
    """The model's log1p-CQTs of a padded (B, L) batch, float32."""
    return [ref_cqt.cqt(batch, sr=sr, hop=hop, bins_per_octave=bpo,
                        octaves=cfg["octaves"],
                        stream_dtype=getattr(torch, cfg["cqt_stream_dtype"]))
            for bpo in bins_of(cfg)]


def model_outputs(sd: dict, cfg: dict, feats: list, seq: torch.Tensor,
                  rows: int = 32) -> tuple:
    """(key, tonic) of a batch's features, `rows` rows at a time."""
    forward = of(cfg).forward
    outs = [forward(sd, cfg, [f[i:i + rows] for f in feats], seq[i:i + rows])
            for i in range(0, seq.shape[0], rows)]
    return tuple(torch.cat([o[k] for o in outs]) for k in range(2))


def outputs(sd: dict, cfg: dict, batch: torch.Tensor, seq: torch.Tensor,
            sr: int, hop: int, rows: int = 32) -> tuple:
    """(features, (key, tonic)) of a padded batch."""
    feats = features(batch, sr, hop, cfg)
    return feats, model_outputs(sd, cfg, feats, seq, rows)


def read_request(cfg: dict, paths, device) -> tuple:
    """(padded int16 batch on `device`, true lengths, sr, hop) of one
    request's files: zero-padded to their bucket."""
    waves = [read_wav(p) for p in paths]
    rates = {sr for _, sr in waves}
    if len(rates) != 1:
        raise ValueError("the reference serves one sample rate a request")
    sr = rates.pop()
    hop = hop_of(sr, cfg["frames"])
    pad = bucket_samples(max(len(w) for w, _ in waves), sr)
    batch = np.zeros((len(waves), pad), np.int16)
    for i, (w, _) in enumerate(waves):
        batch[i, :len(w)] = w
    seq = torch.tensor([1 + len(w) // hop for w, _ in waves],
                       dtype=torch.int32, device=device)
    return torch.from_numpy(batch).to(device), seq, sr, hop


def serve_files(sd: dict, cfg: dict, paths, device) -> dict:
    """One request, worked out from the files: the padded batch's
    geometry, each clip's true length, features and outputs."""
    batch, seq, sr, hop = read_request(cfg, paths, device)
    feats, (key, tonic) = outputs(sd, cfg, batch, seq, sr, hop)
    return {"pad": batch.shape[1], "hop": hop, "seq": seq.cpu().numpy(),
            "features": feats, "key": key.cpu().numpy(),
            "tonic": tonic.cpu().numpy()}
