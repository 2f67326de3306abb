"""The plain reference the benchmark checks the system against.

Each configuration names its reference model in its file, as
`"reference": "<name>"`: the module `reference/<name>.py`. Everything that
needs the model (the weights, the check, the FLOP count, the kernels'
geometry) reaches it through `of(cfg)`, never by a fixed import. A
reference module provides:

  spec(cfg)             the state dict's layout, [(key, shape, kind,
                        fan_in)] in state-dict order;
  init_weights(cfg, seed, device)
                        the state dict drawn from `seed` on `device`;
  forward(sd, cfg, mels, seq, *, mode)
                        (key sigmoid, tonic logits) of a batch of
                        log1p-CQTs and true lengths, `mode` one of
                        "eval", "train" and "calibrate";
  layer_channels(layer, n_filters)
                        (prev_p, prev_pc, out_p, out_pc) of a trunk layer.

It is plain PyTorch: it imports nothing of the system under test and no
JAX, and computes in float32 at the precision the configuration states.
"""

from __future__ import annotations

import importlib

INTERFACE = ("spec", "init_weights", "forward", "layer_channels")


def of(cfg: dict):
    """The reference module `cfg["reference"]` names. LookupError where
    the key is missing or names no module that provides INTERFACE."""
    name = cfg.get("reference")
    if not isinstance(name, str) or not name.isidentifier():
        raise LookupError(f"the configuration names no reference model "
                          f"(\"reference\": {name!r})")
    try:
        mod = importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise LookupError(f"no reference model {name!r} "
                          f"(benchmark/reference/{name}.py)") from None
    missing = [f for f in INTERFACE if not callable(getattr(mod, f, None))]
    if missing:
        raise LookupError(f"reference/{name}.py is no reference model: it "
                          f"lacks {missing}")
    return mod
