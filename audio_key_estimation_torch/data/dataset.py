"""In-RAM key dataset with batched CQT preprocessing on the card.

The port of the JAX package's `data/dataset.py`: files on disk -> decode
on the host (raw PCM16 stays int16; every other encoding float32) -> one
batched log1p-CQT per group of decoded songs of one sample rate, padded
to the group's longest (kernels A and B on a CUDA device, the plain
PyTorch CQT with use_pallas_cqt="off" or on the CPU) -> `.npz` feature
cache -> key, signature, tonic and genre labels (utils/labels.py, global
or local) -> bucket-padded `batches()`.

`KeyDataset` computes on the card unless the caller asks for the CPU
(device="cpu"); without CUDA the default raises. Under a data-parallel
process group every rank imports the same corpus: with the cache on,
rank 0 imports first and writes the cache, and the other ranks read it
after a barrier (no two ranks write one file).
"""

from __future__ import annotations

import concurrent.futures as futures
import os
import random
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..ops.cqt import CQTParams, reference_hop
from ..ops.frontend import compute_cqt, feature_bins, use_cuda_kernels
from ..parallel.mesh import barrier, data_world
from ..utils import labels as L
from ..utils.precision import ieee_float32
from ..utils.profiling import span
from . import audio_io
from .loaders import DatasetLoader


def cache_path(file_path: str, cfg: Config, bins_per_octave: int,
               cuda_kernels: bool = False) -> str:
    """Feature-cache sidecar path, keyed by every knob that changes the
    computed features: octaves, frames, bins/octave and the front-end
    implementation, so features from one implementation are never
    silently reused by another. The plain path's name is the JAX
    package's (`_bf16cq` for bf16 streams); features the CUDA kernels
    computed add `_cuda` where that package adds `_pallas`."""
    stem = os.path.splitext(file_path)[0]
    fe = ""
    if cfg.cqt_conv_dtype != "float32":
        fe += "_bf16cq" if cfg.cqt_conv_dtype == "bfloat16" \
            else f"_{cfg.cqt_conv_dtype}cq"
    if cuda_kernels:
        fe += "_cuda"
    return (f"{stem}.akx_{cfg.octaves}oct_{cfg.frames}f_"
            f"{bins_per_octave}bpo{fe}.npz")


# Known-bad (too short) training files, matched by basename against every
# loader's filenames. Shipped with the package so the default blacklist is
# never silently empty.
PACKAGED_BLACKLIST = os.path.join(os.path.dirname(__file__), "short_songs.txt")


class KeyDataset:
    """Map-style in-RAM dataset of (log-CQT, labels) per song."""

    def __init__(self, genre: bool, cfg: Config, *,
                 blacklist_path: Optional[str] = PACKAGED_BLACKLIST,
                 use_cache: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r}: CUDA is not available "
                               "(pass device='cpu' to preprocess on the CPU)")
        self.cfg = cfg
        self.genre = genre
        self.use_cache = use_cache
        self.use_kernels = use_cuda_kernels(cfg.use_pallas_cqt, self.device)
        self.blacklist = self._load_blacklist(blacklist_path)
        self.items: List[Dict] = []
        self.seq_length_max = 0

    @staticmethod
    def _load_blacklist(path: Optional[str]) -> List[str]:
        """Empty/None disables the blacklist; a configured-but-missing file
        is an error."""
        if not path:
            return []
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"blacklist file configured but missing: {path!r} "
                "(pass blacklist_path='' to disable the blacklist)")
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]

    def cache_path(self, file_path: str, bins_per_octave: int) -> str:
        return cache_path(file_path, self.cfg, bins_per_octave,
                          self.use_kernels)

    # ------------------------------------------------------------------
    def import_data(self, *loaders: DatasetLoader, seed: int = 0,
                    progress: bool = True):
        """Collect, shuffle, decode, CQT and label every file."""
        rank, world = data_world()
        shared = world > 1 and self.use_cache
        if shared and rank != 0:
            barrier()   # rank 0 has written the feature cache
        work = []
        for loader in loaders:
            if not isinstance(loader, DatasetLoader):
                continue
            for fn in loader.get_filenames():
                if any(os.path.basename(fn) in b or fn in b
                       for b in self.blacklist):
                    continue
                work.append((fn, loader))
        rng = random.Random(seed)
        rng.shuffle(work)
        self._preprocess(work, progress=progress)
        if shared and rank == 0:
            barrier()
        self.seq_length_max = max((it["mel"].shape[-1] for it in self.items),
                                  default=0)
        if progress:
            print(f"Length of Data: {len(self.items)}; "
                  f"Max. Seq. Length: {self.seq_length_max}", flush=True)

    # ------------------------------------------------------------------
    def _preprocess(self, work, progress=True, decode_batch: int = 16):
        # stage 1: parallel cache probe
        with futures.ThreadPoolExecutor(max_workers=8) as pool:
            cached = list(pool.map(self._try_cache, work))
        done = 0
        for (fn, loader), hit in zip(work, cached):
            if hit is not None:
                self._finish_item(fn, loader, *hit)
                done += 1
                if progress and done % 50 == 0:
                    print(f"loaded {done} files", flush=True)
        misses = [wl for wl, hit in zip(work, cached) if hit is None]
        # stage 2: decode misses (raw PCM16 -> host I/O only, the device
        # normalizes; other encodings through the C++ decoders to float32)
        # into groups of decode_batch songs, each group's CQT batched
        pending = []  # (file, loader, samples, sr)
        for (fn, loader), (samples, sr) in zip(
                misses, audio_io.decode_many((fn for fn, _ in misses),
                                             raw=True)):
            pending.append((fn, loader, samples, sr))
            if len(pending) >= decode_batch:
                self._flush_cqt(pending)
                pending = []
            done += 1
            if progress and done % 50 == 0:
                print(f"loaded {done} files", flush=True)
        if pending:
            self._flush_cqt(pending)
        # import order == shuffled work order regardless of cache/batch path
        order = {fn: i for i, (fn, _) in enumerate(work)}
        self.items.sort(key=lambda it: order[it["file"]])

    def _try_cache(self, item):
        fn, loader = item
        cfg = self.cfg
        if not self.use_cache:
            return None
        try:
            mel = np.load(self.cache_path(fn, cfg.bins_per_octave))["mel"]
            mel2 = None
            if cfg.multi_scale:
                mel2 = np.load(self.cache_path(fn, 12))["mel"]
            if mel.shape[0] == cfg.pitches:
                return mel, mel2
        except Exception:  # any unreadable sidecar is a miss: recompute
            pass
        return None

    def _batch(self, waves, pad_len: int) -> torch.Tensor:
        """The group's zero-padded (B, pad_len) batch on the dataset's
        device: int16 when every song is raw PCM16, else float32."""
        return torch.from_numpy(audio_io.pack_batch(waves, pad_len)).to(
            self.device)

    def _features(self, y: torch.Tensor, p: CQTParams) -> np.ndarray:
        """(B, L) signal batch on the device -> (B, n_bins, T) log1p-CQT
        read back to the host, float32 in IEEE float32
        (utils/precision.ieee_float32)."""
        with torch.inference_mode(), ieee_float32("KeyDataset._features"):
            return compute_cqt(y, p, use_kernels=self.use_kernels,
                               conv_dtype=self.cfg.cqt_conv_dtype
                               ).cpu().numpy()

    def _flush_cqt(self, pending):
        """Batched CQT over a group of decoded songs of one sample rate."""
        cfg = self.cfg
        by_sr: Dict[tuple, list] = {}
        for fn, loader, samples, sr in pending:
            if cfg.frames == 0:
                # hop depends on each file's length (window_size mode) —
                # only songs of one length share a batch
                by_sr.setdefault((sr, len(samples)), []).append(
                    (fn, loader, samples))
            else:
                by_sr.setdefault((sr, 0), []).append((fn, loader, samples))
        for (sr, _), group in by_sr.items():
            max_len = max(len(s) for _, _, s in group)
            hop = reference_hop(sr, cfg.frames, cfg.window_size, max_len)
            y = self._batch((s for _, _, s in group), max_len)
            bpos = feature_bins(cfg)  # multi_scale: the semitone CQT too
            mels_by_bpo = {}
            for bpo in bpos:
                params = CQTParams(sr=sr, hop=hop, bins_per_octave=bpo,
                                   octaves=cfg.octaves)
                mels_by_bpo[bpo] = self._features(y, params)
            for i, (fn, loader, s) in enumerate(group):
                t = 1 + len(s) // hop
                mel = mels_by_bpo[bpos[0]][i][:, :t]
                mel2 = (mels_by_bpo[12][i][:, :t] if cfg.multi_scale else None)
                if cfg.frames == 0:
                    mel = mel[:, :cfg.window_size]
                    if mel2 is not None:
                        mel2 = mel2[:, :cfg.window_size]
                if self.use_cache and data_world()[0] == 0:
                    try:
                        np.savez_compressed(
                            self.cache_path(fn, cfg.bins_per_octave), mel=mel)
                        if mel2 is not None:
                            np.savez_compressed(self.cache_path(fn, 12),
                                                mel=mel2)
                    except OSError:
                        pass
                self._finish_item(fn, loader, mel, mel2)

    # ------------------------------------------------------------------
    def _finish_item(self, fn: str, loader: DatasetLoader, mel: np.ndarray,
                     mel2: Optional[np.ndarray] = None):
        cfg = self.cfg
        key_sig = loader.get_key_signature(fn)
        genre = (loader.get_genre(fn) if self.genre
                 else np.zeros(11, np.float32))
        coverage = None
        if cfg.local and isinstance(key_sig, (list, tuple)):
            key, sig, tonic, cut, keep = L.local_labels(
                key_sig, loader.keys, loader.signature, cfg.frames,
                cfg.loc_window_size)
            mel = mel[:, cut:][:, :keep]
            coverage = L.local_window_coverage(key_sig, cfg.frames,
                                               cfg.loc_window_size)
        elif cfg.local:
            t = mel.shape[-1] - (cfg.loc_window_size * cfg.frames - 1)
            key, sig, tonic = L.tiled_local_labels(
                key_sig, loader.keys, loader.signature, max(t, 0))
            coverage = np.ones(max(t, 0), np.float32)  # single-key song
        else:
            key, sig, tonic = L.global_labels(key_sig, loader.keys,
                                              loader.signature)
        item_extra = {}
        if mel2 is not None:
            item_extra["mel2"] = mel2.astype(np.float32)
        if coverage is not None:
            item_extra["window_coverage"] = coverage.astype(np.float32)
        self.items.append({
            **item_extra,
            "file": fn, "dataset": loader.name, "mel": mel.astype(np.float32),
            "key_labels": key.astype(np.float32),
            "key_signature_id": sig.astype(np.float32),
            "tonic_labels": tonic.astype(np.float32),
            "genre": genre.astype(np.float32),
            "seq_length": np.int32(mel.shape[-1]),
        })

    # ------------------------------------------------------------------
    def _bucket_len(self, t: int) -> int:
        for b in self.cfg.bucket_sizes:
            if t <= b:
                return b
        return -(-t // 64) * 64

    def batches(self, batch_size: int, *, shuffle=False, seed=0,
                drop_last=False):
        """Yield padded numpy batches (NHWC mel + labels + seq_length)."""
        idx = list(range(len(self.items)))
        if shuffle:
            random.Random(seed).shuffle(idx)
        for i in range(0, len(idx), batch_size):
            chunk = idx[i:i + batch_size]
            if len(chunk) < batch_size:
                if drop_last:
                    return
                # repeat-pad the final batch to keep shapes static;
                # `valid` marks real samples for metric averaging
                chunk = chunk + [chunk[-1]] * (batch_size - len(chunk))
                valid = np.array([True] * (len(idx) - i)
                                 + [False] * (batch_size - (len(idx) - i)))
            else:
                valid = np.ones(len(chunk), bool)
            items = [self.items[j] for j in chunk]
            t_max = self._bucket_len(max(it["mel"].shape[-1] for it in items))
            with span("akx.pad",
                      frames=sum(int(it["seq_length"]) for it in items),
                      frames_padded=len(items) * t_max):
                mel = np.zeros((len(items), self.cfg.pitches, t_max, 1),
                               np.float32)
                for k, it in enumerate(items):
                    t = it["mel"].shape[-1]
                    mel[k, :, :t, 0] = it["mel"]
                mel2 = None
                if self.cfg.multi_scale and "mel2" in items[0]:
                    rows2 = items[0]["mel2"].shape[0]
                    mel2 = np.zeros((len(items), rows2, t_max, 1), np.float32)
                    for k, it in enumerate(items):
                        t = it["mel2"].shape[-1]
                        mel2[k, :, :t, 0] = it["mel2"]
            batch = {
                **({"mel2": mel2} if mel2 is not None else {}),
                "mel": mel,
                "seq_length": np.array([it["seq_length"] for it in items],
                                       np.int32),
                "genre": np.stack([it["genre"] for it in items]),
                "valid": valid,
            }
            if self.cfg.local:
                lab_t = max(it["key_labels"].shape[0] for it in items)
                lab_t = max(lab_t, t_max - (self.cfg.loc_window_size
                                            * self.cfg.frames - 1))
                for name in ("key_labels", "key_signature_id", "tonic_labels"):
                    dim = items[0][name].shape[-1]
                    arr = np.zeros((len(items), lab_t, dim), np.float32)
                    for k, it in enumerate(items):
                        arr[k, :it[name].shape[0]] = it[name]
                    batch[name] = arr
                if "window_coverage" in items[0]:
                    cov = np.zeros((len(items), lab_t), np.float32)
                    for k, it in enumerate(items):
                        c = it["window_coverage"]
                        cov[k, :c.shape[0]] = c
                    batch["window_coverage"] = cov
            else:
                for name in ("key_labels", "key_signature_id", "tonic_labels"):
                    batch[name] = np.stack([it[name] for it in items])
            yield batch
