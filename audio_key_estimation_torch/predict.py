"""Serving API: waveforms/files -> key, tonic, genre predictions.

PyTorch port of the JAX package's predict.py: a `KeyEstimator` holds a
PitchClassNet (or, with `Config.multi_scale`, the two-tower
PitchClassNetMulti fed a second CQT at 12 bins/octave) on an explicit
device, batches audio through the CQT front-end and the network, and
names the result, one key per clip (`predict_files`) or one per local
window (`predict_files_local`, the same weights run in local mode). On a
CUDA device each CQT runs through kernels A and B
(`Config.use_pallas_cqt` "auto"/"on") and, with `Config.fused_convstack`,
every stack with a hand kernel (`models/blocks.ConvStack.kernel`,
ops/stack_kernels.py) through it. With a mesh
(`parallel.mesh.make_mesh`) serving is data-parallel over its devices,
as the JAX estimator's is over a jax Mesh: one replica of the model per
device, each batch's rows split evenly, shard i's CQT and model on
device i.

Key naming: the 12-dim sigmoid output is matched to the nearest
KEY_SIGNATURE_MAP row (circle of fifths) exactly like the MIREX scorer
(models.py:1083-1085); the predicted tonic then selects the major or
relative-minor reading of that signature.
"""

from __future__ import annotations

import concurrent.futures as futures
import os
import threading
from contextlib import nullcontext
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .config import Config
from .data import audio_io
from .data.loaders import A_GENRES
from .models.convert import load_state_dict
from .models.multi_scale import build_model
from .ops.cqt import CQTParams, reference_hop
from .ops.frontend import compute_cqt, feature_bins, use_cuda_kernels
from .parallel.mesh import Mesh, replicate, shard_batch
from .train import checkpoints as ckpt_lib
from .utils.key_signatures import KEY_SIGNATURE_MAP
from .utils.precision import ieee_float32
from .utils.profiling import span

NOTE_NAMES = ['C', 'C#', 'D', 'D#', 'E', 'F', 'F#', 'G', 'G#', 'A', 'A#', 'B']
# major tonic of circle-of-fifths row i (0 = Cb); theoretical rows 15..20
# map to their enharmonic base signatures (utils/key_signatures.py)
_ROW_MAJOR_TONIC = [(11 + 7 * i) % 12 for i in range(15)] + [2, 4, 9, 3, 8, 10]
# A batch larger than this goes to the card by the pageable path, so that
# the page-locked staging buffer never grows past it (a 12-song album in
# the 420 s bucket is 222 MB of int16; a 256-file library request 4.7 GB)
STAGING_CAP_BYTES = 1 << 30
# the most threads that pack a staged batch's rows
PACK_THREADS = 8


def key_name(key_sigmoid: np.ndarray, tonic_logits: np.ndarray) -> dict:
    """Interpret model outputs as a named key."""
    ksm = KEY_SIGNATURE_MAP
    v = key_sigmoid / max(np.linalg.norm(key_sigmoid), 1e-8)
    sims = (ksm @ v) / np.linalg.norm(ksm, axis=1)
    row = int(np.argmax(sims))
    tonic = int(np.argmax(tonic_logits))
    major_tonic = _ROW_MAJOR_TONIC[row]
    if tonic == major_tonic:
        name = f"{NOTE_NAMES[tonic]} major"
    elif tonic == (major_tonic + 9) % 12:  # relative minor
        name = f"{NOTE_NAMES[tonic]} minor"
    else:
        # tonic disagrees with the signature; report tonic with the
        # signature's accidentals as context
        name = f"{NOTE_NAMES[tonic]} (signature {NOTE_NAMES[major_tonic]} major)"
    return {"key": name, "signature_row": row, "tonic": NOTE_NAMES[tonic],
            "confidence": float(sims[row])}


@dataclass
class Prediction:
    key: str
    tonic: str
    confidence: float
    genre: Optional[str] = None
    key_probs: Optional[np.ndarray] = None
    tonic_logits: Optional[np.ndarray] = None


@dataclass
class WindowPrediction:
    """One local-mode window: key over [start, end) seconds."""
    start: float
    end: float
    key: str
    tonic: str
    confidence: float
    genre: Optional[str] = None


@dataclass
class LocalPrediction:
    windows: list
    key_probs: Optional[np.ndarray] = None   # (T', 12) per-window sigmoids
    tonic_logits: Optional[np.ndarray] = None


class _PinnedStaging:
    """A CUDA estimator's page-locked host buffer: each batch and its seq
    lengths are packed into it in place (on `pool`) and copied to the card
    from it without blocking the host. It grows to the largest batch up
    to STAGING_CAP_BYTES and is reused; `lock` keeps one batch in it at
    a time, and `take` waits for the last copy out of it to end before
    the buffer is written again."""

    def __init__(self):
        self.lock = threading.Lock()
        self.pool = futures.ThreadPoolExecutor(
            max_workers=min(PACK_THREADS, os.cpu_count() or 1),
            thread_name_prefix="akx-pack")
        self._host = None          # the page-locked uint8 tensor
        self._copied = None        # event after the last copy out of it

    def take(self, n_rows: int, pad_len: int, dtype):
        """(batch, seq): views of the buffer as an (n_rows, pad_len) batch
        of `dtype` and an (n_rows,) int32 array, or None for a batch over
        the cap."""
        batch_bytes = n_rows * pad_len * np.dtype(dtype).itemsize
        seq_at = -(-batch_bytes // 64) * 64
        nbytes = seq_at + 4 * n_rows
        if nbytes > STAGING_CAP_BYTES:
            return None
        if self._copied is not None:
            self._copied.synchronize()
        if self._host is None or self._host.numel() < nbytes:
            self._host = None          # freed before the larger one
            self._host = torch.empty(nbytes, dtype=torch.uint8,
                                     pin_memory=True)
        host = self._host.numpy()
        return (host[:batch_bytes].view(dtype).reshape(n_rows, pad_len),
                host[seq_at:nbytes].view(np.int32))

    def holds(self, a: np.ndarray) -> bool:
        return (self._host is not None
                and np.may_share_memory(a, self._host.numpy()))

    def copied(self, device: torch.device) -> None:
        """Mark the copies just queued on `device`'s current stream as the
        last out of the buffer."""
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(device))


class KeyEstimator:
    """Batched inference over arbitrary audio.

    >>> est = KeyEstimator.from_checkpoint(
    ...     "Model_logs/lightning_logs/version_0")   # a port training run
    >>> est = KeyEstimator.from_torch_checkpoint("best_model.pt", cfg,
    ...                                          device="cuda")
    >>> est.predict_files(["song.wav"])  # -> [Prediction(key='A minor', ...)]
    """

    def __init__(self, cfg: Config, state_dict: Mapping, *,
                 device: Union[str, torch.device] = "cuda",
                 bucket_seconds=(60, 180, 420),
                 mesh: Optional[Mesh] = None):
        """state_dict: the port's / the reference's torch state_dict or
        `models.convert.state_dict_from_jax` of JAX variables (numpy
        arrays or tensors). Serving runs on the card; the CPU only when
        the caller asks for it (device="cpu"). Without CUDA the default
        raises, and so do weights of the other architecture than
        cfg.multi_scale names (the ensemble's `model1.`/`model2.` keys).

        mesh: serve data-parallel over mesh.devices (then `device` is the
        mesh's first; without one, a mesh of `device` alone): one
        replica per device, each batch padded with zero rows of
        seq_length 1 to a multiple of the mesh size (the JAX estimator's
        _mesh_pad) and split evenly; every shard is launched before any
        is read back, and the pad rows dropped."""
        if mesh is not None:
            device = mesh.devices[0]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r}: CUDA is not available "
                               "(pass device='cpu' to serve on the CPU)")
        self.mesh = Mesh((self.device,)) if mesh is None else mesh
        # the global model; predict_*_local run local_model, the same
        # weights in local mode (as the JAX estimator applies one set of
        # variables to both)
        self.cfg = cfg.replace(local=False)
        # serving builds the architecture the weights were trained with;
        # a weights/config mismatch is refused, as the JAX estimator does
        has_multi = any(str(k).startswith("model1.") for k in state_dict)
        if has_multi != bool(cfg.multi_scale):
            raise ValueError(
                f"checkpoint/config mismatch: config.multi_scale="
                f"{cfg.multi_scale} but the weights "
                f"{'have' if has_multi else 'lack'} the model1/model2 "
                "ensemble structure")
        self.use_kernels = use_cuda_kernels(self.cfg.use_pallas_cqt,
                                            self.device)
        model = build_model(self.cfg)
        load_state_dict(model, state_dict)
        local_model = build_model(self.cfg.replace(local=True))
        local_model.load_state_dict(model.state_dict())
        self.replicas = replicate(model, self.mesh)
        self.local_replicas = replicate(local_model, self.mesh)
        self.model, self.local_model = self.replicas[0], \
            self.local_replicas[0]
        self.bucket_seconds = bucket_seconds
        # off CUDA a copy to the device would hand back the staging buffer
        # itself, and callers keep the batches they get
        self._staging = (_PinnedStaging() if self.device.type == "cuda"
                         else None)

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, run_dir: str, name: str = "best_model", **kw):
        """Load one of the port's run directories (train/checkpoints.py):
        run_dir/name.pt with the Config of its config.json (the default
        Config where there is none)."""
        sd, cfg = ckpt_lib.load(run_dir, name)
        return cls(cfg or Config(), sd, **kw)

    @classmethod
    def from_torch_checkpoint(cls, path: str, cfg: Config, **kw):
        """Load a reference `best_model.pt` (a torch state_dict) into the
        model `cfg` describes."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return cls(cfg, sd, **kw)

    # ------------------------------------------------------------------
    def _bucket_len(self, seconds: float) -> float:
        for b in self.bucket_seconds:
            if seconds <= b:
                return b
        return float(np.ceil(seconds / 60.0) * 60)

    def host_batch(self, waveforms, sr: int,
                   stage: Optional[_PinnedStaging] = None):
        """Bucket-padded signal batch + true seq lengths on the host,
        padded by zero rows of seq_length 1 to a multiple of the mesh
        size: packed in place into `stage`'s buffer where it takes the
        batch, else into fresh arrays."""
        cfg = self.cfg
        longest = max(len(w) for w in waveforms)
        hop = reference_hop(sr, cfg.frames, cfg.window_size, longest)
        pad_len = int(self._bucket_len(longest / sr) * sr)
        n = len(waveforms)
        n_rows = -(-n // self.mesh.size) * self.mesh.size
        # int16 when every waveform is raw PCM16 (half the H2D bytes;
        # normalization runs inside the CQT), else float32
        with span("akx.pack", samples=sum(len(w) for w in waveforms),
                  samples_padded=n_rows * pad_len):
            out = None if stage is None else stage.take(
                n_rows, pad_len, audio_io.batch_dtype(waveforms))
            if out is None:
                batch = audio_io.pack_batch(waveforms, pad_len, n_rows=n_rows)
                seq = np.empty(n_rows, np.int32)
            else:
                batch = audio_io.pack_batch(waveforms, pad_len, n_rows=n_rows,
                                            out=out[0], pool=stage.pool)
                seq = out[1]
            seq[:] = 1
            seq[:n] = [1 + len(w) // hop for w in waveforms]
        return batch, seq, hop

    def make_batch(self, waveforms, sr: int):
        """host_batch's signal batch and seq lengths on the device (the
        mesh's first). On CUDA both are packed into the page-locked
        staging buffer and copied without blocking, so the host goes
        straight on to launch the CQT behind the copy on the same stream;
        a batch over STAGING_CAP_BYTES, and every batch off CUDA, is
        packed into fresh arrays and copied as they are."""
        stage = self._staging
        with nullcontext() if stage is None else stage.lock:
            batch, seq, hop = self.host_batch(waveforms, sr, stage)
            pinned = stage is not None and stage.holds(batch)
            nbytes = batch.nbytes + seq.nbytes
            with span("akx.h2d", bytes=nbytes,
                      pinned_bytes=nbytes if pinned else 0):
                out = (torch.from_numpy(batch).to(self.device,
                                                  non_blocking=pinned),
                       torch.from_numpy(seq).to(self.device,
                                                non_blocking=pinned), hop)
                if pinned:
                    stage.copied(self.device)
            return out

    def features(self, batch: torch.Tensor, sr: int, hop: int) -> tuple:
        """(B, L) signal batch -> the model's inputs: (mel,), or (mel1,
        mel2) for the multi-scale ensemble, each a (B, rows, T, 1)
        log1p-CQT, one CQT per `feature_bins` entry."""
        cfg = self.cfg
        with span("akx.features"):
            return tuple(
                compute_cqt(batch, CQTParams(sr=sr, hop=hop,
                                             bins_per_octave=bpo,
                                             octaves=cfg.octaves),
                            use_kernels=self.use_kernels,
                            conv_dtype=cfg.cqt_conv_dtype)[..., None]
                for bpo in feature_bins(cfg))

    @torch.inference_mode()
    @ieee_float32("KeyEstimator.outputs")
    def outputs(self, waveforms: Sequence[np.ndarray], sr: int,
                local: bool = False) -> tuple:
        """(the model's outputs as numpy arrays, one row per waveform,
        the seq lengths): the global model, or the local one (which takes
        no lengths). The batch goes to the mesh's first device and each
        shard on to its own, where its CQT and replica run, all launched
        before the first read-back; a one-device mesh runs the whole
        batch as one shard. float32 work runs in IEEE float32
        (utils/precision.ieee_float32), whatever the caller's TF32
        settings."""
        batch, seq, hop = self.make_batch(waveforms, sr)
        models = self.local_replicas if local else self.replicas
        shards = [model(*self.features(b, sr, hop), *(() if local else (s,)))
                  for model, b, s in zip(models,
                                         shard_batch(batch, self.mesh),
                                         shard_batch(seq, self.mesh))]
        n = len(waveforms)
        with span("akx.readback"):
            out = [torch.cat([o[k].cpu() for o in shards]).numpy()[:n]
                   for k in range(len(shards[0]))]
            return out, seq[:n].cpu().numpy()

    # Each public predict_* call is one request: one `akx.request` span,
    # its own root (one directly inside it records nothing more)
    @torch.inference_mode()
    def predict_waveforms(self, waveforms: Sequence[np.ndarray], sr: int,
                          return_raw: bool = False) -> List[Prediction]:
        with span("akx.request", request=True):
            out, _ = self.outputs(waveforms, sr)
            key, tonic = out[0], out[1]
            genre = out[2] if len(out) > 2 else None
            preds = []
            with span("akx.name"):
                for i in range(len(waveforms)):
                    info = key_name(key[i], tonic[i])
                    preds.append(Prediction(
                        key=info["key"], tonic=info["tonic"],
                        confidence=info["confidence"],
                        genre=(A_GENRES[int(np.argmax(genre[i]))]
                               if genre is not None else None),
                        key_probs=key[i] if return_raw else None,
                        tonic_logits=tonic[i] if return_raw else None))
            return preds

    def predict_files(self, paths: Sequence[Union[str, os.PathLike]],
                      **kw) -> List[Prediction]:
        return self._predict_files(paths, self.predict_waveforms, **kw)

    def _predict_files(self, paths, fn, **kw):
        with span("akx.request", request=True):
            # raw: PCM16 stays int16 (the CQT normalizes on the device);
            # MP3 and every other WAV encoding decode to float32
            with span("akx.decode"):
                decoded = list(audio_io.decode_many((str(p) for p in paths),
                                                    raw=True))
            by_sr = {}
            for i, (w, sr) in enumerate(decoded):
                by_sr.setdefault(sr, []).append((i, w))
            results: list = [None] * len(decoded)
            for sr, group in by_sr.items():
                preds = fn([w for _, w in group], sr, **kw)
                for (i, _), p in zip(group, preds):
                    results[i] = p
            return results

    # ------------------------------------------------------------------
    # local (per-window) key sequences, the serving face of local mode
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict_waveforms_local(self, waveforms: Sequence[np.ndarray],
                                sr: int, return_raw: bool = False
                                ) -> List[LocalPrediction]:
        """Per-window key estimates: each window spans loc_window_size
        seconds, advancing 1/frames seconds per step (the local head's
        sliding max over frame windows)."""
        with span("akx.request", request=True):
            cfg = self.cfg
            out, seq = self.outputs(waveforms, sr, local=True)
            key, tonic = out[0], out[1]                  # (N, T', 12)
            genre = out[2] if len(out) > 2 else None
            win_s, step_s = cfg.loc_window_size, 1.0 / cfg.frames
            preds = []
            for i in range(len(waveforms)):
                n_windows = min(max(int(seq[i]) - cfg.loc_window_size
                                    * cfg.frames + 1, 0), key.shape[1])
                windows = []
                for t in range(n_windows):
                    info = key_name(key[i, t], tonic[i, t])
                    windows.append(WindowPrediction(
                        start=t * step_s, end=t * step_s + win_s,
                        key=info["key"], tonic=info["tonic"],
                        confidence=info["confidence"],
                        genre=(A_GENRES[int(np.argmax(genre[i, t]))]
                               if genre is not None else None)))
                preds.append(LocalPrediction(
                    windows=windows,
                    key_probs=key[i, :n_windows] if return_raw else None,
                    tonic_logits=tonic[i, :n_windows] if return_raw else None))
            return preds

    def predict_files_local(self, paths: Sequence[Union[str, os.PathLike]],
                            **kw) -> List[LocalPrediction]:
        return self._predict_files(paths, self.predict_waveforms_local, **kw)
