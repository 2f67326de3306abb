"""The plain reference put in the system's place, for the check's control
and for the faults it is held against.

A run with a stand-in (`harness.run_cell(..., stand_in=<name>)`) drives
the cell's own traffic, window and check with the system under test
replaced by the reference, so the harness's own comparison decides
whether it is `correct`:
  tf32    the reference in TF32 where the configurations state IEEE
          float32 (the bf16 parts stay bf16): the control;
  half    (training) half of each micro-batch left out, the mean taken
          over the rest;
  frozen  (training) a step that returns its state unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from . import precision
from .reference import serve as ref_serve
from .reference import train as ref_train

STAND_INS = {"tf32": (precision.tf32, {}),
             "half": (contextlib.nullcontext, {"half": True}),
             "frozen": (contextlib.nullcontext, {"frozen": True})}
SERVING = ("tf32",)
BATCH_KEYS = ("mel", "seq_length", "key_labels", "tonic_labels")


@dataclasses.dataclass
class Prediction:
    key: str
    key_probs: np.ndarray
    tonic_logits: np.ndarray


class Estimator:
    """The KeyEstimator calls the serving kinds drive (`features`,
    `model`, `predict_files`), worked out by the reference under the
    stand-in's precision. Features carry the system's trailing channel
    axis."""

    def __init__(self, ctx, sd: dict, name: str):
        self.ctx, self.sd, self.m = ctx, sd, ctx.model
        self.run = STAND_INS[name][0]

    def features(self, batch, sr: int, hop: int) -> list:
        with self.run():
            return [f[..., None] for f in
                    ref_serve.features(batch, sr, hop, self.m)]

    def model(self, *args) -> tuple:
        *feats, seq = args
        with self.run():
            return ref_serve.model_outputs(self.sd, self.m,
                                           [f[..., 0] for f in feats], seq)

    def predict_files(self, paths, return_raw: bool = True) -> list:
        batch, seq, sr, hop = ref_serve.read_request(self.m, paths,
                                                     self.ctx.device)
        key, tonic = self.model(*self.features(batch, sr, hop), seq)
        key, tonic = key.cpu().numpy(), tonic.cpu().numpy()
        return [Prediction(ref_serve.key_name(k, t), k, t)
                for k, t in zip(key, tonic)]


class Trainer:
    """A training step the train kind drives (`__call__`, `first_moment`,
    `params`), worked out by the reference's step and Adam from the same
    weights, with the stand-in's precision or fault."""

    def __init__(self, ctx, sd: dict, name: str):
        self.m = ctx.model
        self.run, self.fault = STAND_INS[name]
        self.sd = {k: v.detach().clone() for k, v in sd.items()}
        self.adam = ref_train.Adam(
            {k: v for k, v in self.sd.items() if ref_train.is_parameter(k)},
            ctx.program_config().lr)

    def __call__(self, batch: dict) -> float:
        b = {k: batch[k] for k in BATCH_KEYS}
        with self.run(), torch.enable_grad():
            loss, _ = ref_train.step(self.sd, self.m, b, self.adam,
                                     **self.fault)
        return float(loss)

    def first_moment(self) -> dict:
        return dict(self.adam.m)

    def params(self) -> dict:
        return {k: self.sd[k].clone() for k in self.adam.m}
