"""Weights across frameworks: JAX variables -> state_dict, and loading.

`state_dict_from_jax` is a pure-numpy copy of the JAX package's
`models/torch_port.py::variables_to_state_dict` (that module imports
flax): the same key mapping and layout transposes (flax HWIO -> torch
OIHW; the (3, I, O) third-upsample matrix -> ConvTranspose2d (I, O, 3, 1)).
tests/test_torch_model.py pins the two together exactly.

`load_state_dict` fills a port model from such a dict or from a reference
`best_model.pt`: the export writes an equivariant conv as `X.weight` and
the p2pc_conv pool's conv as `pool.weight`, the reference (and the port's
modules) as `X.conv2d.weight` and `pool.conv.weight`; both load.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_HEADS = ("tonic_classifier", "key_classifier", "genre_classifier")
_LEAF_SUFFIX = {"scale": "weight", "bias": "bias", "kernel": "weight",
                "mean": "running_mean", "var": "running_var"}


def _torch_base(path: tuple) -> str:
    """Translate a flax module path (sans leaf) to a torch key prefix."""
    segs = list(path)
    if segs and segs[-1] == "bn":  # unwrap the inner nn.BatchNorm
        segs.pop()
    parts = []
    for s in segs:
        if s.startswith("model_"):
            parts += ["model", s[len("model_"):]]
        elif s.startswith("seq_"):
            idx = s[len("seq_"):]
            # heads hold their Sequential directly (tonic_classifier.0.*)
            if parts and parts[-1] in _HEADS:
                parts.append(idx)
            else:
                parts += ["layer", idx]
        else:
            parts.append(s)
    return ".".join(parts)


def _from_flax(arr, leaf: str) -> np.ndarray:
    a = np.asarray(arr)
    if leaf == "kernel" and a.ndim == 4:                # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if leaf == "kernel" and a.ndim == 3:                # (3,I,O) -> (I,O,3,1)
        return a.transpose(1, 2, 0)[:, :, :, None]
    return a


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(variables: Mapping) -> dict:
    """{"params", "batch_stats"} nested dicts of arrays -> torch-named
    numpy state_dict (flax -> torch naming and layouts)."""
    sd = {}
    for tree in variables.values():
        for path, value in _flatten(tree):
            *mods, leaf = path
            base = _torch_base(tuple(mods))
            if not base:
                key = _LEAF_SUFFIX.get(leaf, leaf) \
                    if leaf not in ("kernel", "bias") else leaf
            else:
                key = f"{base}.{_LEAF_SUFFIX.get(leaf, leaf)}"
            sd[key] = _from_flax(value, leaf)
    return sd


def load_state_dict(model: torch.nn.Module, state_dict: Mapping) -> None:
    """Load numpy arrays or tensors into `model`, strictly.

    Accepts either naming of an equivariant conv (`X.conv2d.weight` or
    `X.weight`) and of the p2pc_conv pool (`pool.conv.weight` or
    `pool.weight`) and ignores `num_batches_tracked`; any other missing
    or unused key raises KeyError.
    """
    used, sd, missing = set(), {}, []
    for key in model.state_dict():
        cands = [key, key.replace(".conv2d.", "."),
                 key.replace(".conv.", ".")]
        found = next((c for c in cands if c in state_dict), None)
        if found is None:
            missing.append(key)
            continue
        used.add(found)
        v = state_dict[found]
        sd[key] = (v.detach().float() if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.array(v, np.float32)))
    leftovers = sorted(k for k in state_dict if k not in used
                       and not k.endswith("num_batches_tracked"))
    if missing or leftovers:
        raise KeyError(f"state_dict mismatch: missing {missing[:8]}, "
                       f"unexpected {leftovers[:8]}")
    model.load_state_dict(sd, strict=True)
