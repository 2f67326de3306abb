"""One configuration dataclass for every entry point of the port.

A copy of the JAX package's `config.py` (`Config`, `RUNTIME_FIELDS`,
`merge_eval_config`, `add_config_args`, `config_from_args`): same fields,
defaults and JSON form, so a `config.json` written by either package
loads in the other and command-line flags are the same. The copy leaves
out `Config.pallas_cqt_enabled`, which asks JAX for its platform; the
port resolves `use_pallas_cqt` against the torch device instead
(`ops/frontend.use_cuda_kernels`). tests/test_torch_imports.py pins the
copy to the original.

Fields beyond the reference's flags: mesh_shape / mesh_axes (data
parallel), dtype (bf16 compute), remat, bucket_sizes, use_pallas_cqt (the
hand-written CQT kernels), cqt_conv_dtype (the decimated streams'
storage), fused_convstack (the fused ConvStack kernel), early_stop_patience,
seed, data_root, log_dir.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Config:
    # ---- optimization ----
    batch_size: int = 8
    lr: float = 3e-4
    drop: float = 0.0
    reg: float = 0.0            # Adam weight decay
    gamma: float = 0.96         # exponential LR decay per epoch
    acc_grad: int = 8           # gradient accumulation (microbatches per step)
    epochs: int = 100
    early_stop_patience: int = 10

    # ---- front-end / CQT ----
    window_size: int = 592      # time frames when frames == 0
    octaves: int = 8
    frames: int = 5             # CQT frames per second (hop = round(sr/frames))
    only_semitones: bool = False  # 12 bins/octave instead of 36
    multi_scale: bool = False     # run 36-bin and 12-bin models, merge outputs

    # ---- architecture ----
    conv_layers: int = 3
    n_filters: int = 4
    num_layers: int = 2
    kernel_size: int = 7
    head_layers: int = 2
    time_pool_size: int = 2
    resblock: bool = False
    denseblock: bool = False
    stay_sixth: bool = False
    p2pc_conv: bool = False
    pc2p_mem: bool = False
    max_pool: bool = False      # global max-pool at heads instead of mean
    linear_reg_multi: bool = False

    # ---- tasks & loss ----
    local: bool = False         # per-window (local) key estimation
    loc_window_size: int = 10   # seconds per local prediction
    # training-loss weight on windows that straddle a modulation boundary;
    # 1.0 = reference behavior, 0.0 masks them out of the local loss
    straddle_weight: float = 1.0
    genre: bool = False         # add genre head/loss
    key_weight: float = 1.0
    tonic_weight: float = 1.0
    genre_weight: float = 0.1
    use_cos: bool = False       # extra cosine-similarity key loss term

    # ---- run control ----
    no_test: bool = False
    debug: bool = False
    no_ckpt: bool = False
    seed: int = 0

    # ---- knobs with no reference counterpart ----
    dtype: str = "float32"         # compute dtype: float32 | bfloat16
    mesh_shape: tuple = ()          # data-parallel mesh; () = all devices
    mesh_axes: tuple = ("data",)
    remat: bool = False             # recompute the trunk in the backward pass
    bucket_sizes: tuple = (512, 1024, 2048, 4096)  # time-frame padding buckets
    # CQT front-end: "auto" = the hand-written kernels on an accelerator,
    # the plain path elsewhere; "on" / "off" force them (booleans load too)
    use_pallas_cqt: Any = "auto"    # "auto" | "on" | "off" (bool accepted)
    # storage dtype of the decimated CQT streams
    cqt_conv_dtype: str = "bfloat16"  # bfloat16 | float32
    # eval-only fused ConvStack kernel for plain Pitch2Pitch stacks
    fused_convstack: bool = False
    data_root: str = "../Data"
    log_dir: str = "Model_logs"

    # ------------------------------------------------------------------
    @property
    def bins_per_octave(self) -> int:
        return 12 if self.only_semitones else 36

    @property
    def pitches(self) -> int:
        """Input CQT height."""
        return self.octaves * self.bins_per_octave

    @property
    def pitch_classes(self) -> int:
        return 12

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    # ---- (de)serialization: stored inside every checkpoint ----
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, tuple):
                d[k] = list(v)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k not in fields:
                continue
            if fields[k].type == "tuple" or isinstance(fields[k].default, tuple):
                v = tuple(v)
            kw[k] = v
        return cls(**kw)


# Fields that belong to the RUN, not to the trained model: when evaluating
# a checkpoint these come from the command line, every architecture /
# feature / loss field from the checkpoint's saved config.
RUNTIME_FIELDS = frozenset({
    "data_root", "log_dir", "batch_size", "no_test", "debug",
    "bucket_sizes", "mesh_shape", "mesh_axes", "use_pallas_cqt",
    "cqt_conv_dtype", "dtype", "remat", "fused_convstack", "no_ckpt", "epochs",
    "early_stop_patience", "seed",
})


def merge_eval_config(cli_cfg: "Config", saved_cfg: "Config") -> "Config":
    """Checkpoint config wins for model-defining fields; CLI wins for
    runtime fields."""
    kw = {f.name: getattr(saved_cfg, f.name)
          for f in dataclasses.fields(Config)}
    for name in RUNTIME_FIELDS:
        kw[name] = getattr(cli_cfg, name)
    return Config(**kw)


def add_config_args(parser) -> None:
    """Expose every Config field as a --flag on an argparse parser."""
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if f.name == "use_pallas_cqt":
            # tri-state: a bare `--use_pallas_cqt` means "on"; otherwise
            # it takes auto|on|off
            parser.add_argument(name, nargs="?", const="on",
                                default=f.default,
                                choices=["auto", "on", "off"])
        elif f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(name, action="store_true", default=f.default)
        elif isinstance(f.default, tuple):
            # element type from the default when non-empty (mesh_axes is a
            # tuple of strings), int for empty tuples (mesh_shape)
            elem = (type(f.default[0]) if f.default else int)
            parser.add_argument(
                name,
                type=lambda s, e=elem: tuple(e(x) for x in s.split(","))
                if s else (),
                default=f.default)
        else:
            parser.add_argument(name, type=type(f.default), default=f.default)


def config_from_args(args) -> Config:
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(Config)
          if hasattr(args, f.name)}
    return Config(**kw)
