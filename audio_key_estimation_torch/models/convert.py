"""Weights across frameworks: JAX variables -> state_dict, and loading.

`state_dict_from_jax` is a pure-numpy copy of the JAX package's
`models/torch_port.py::variables_to_state_dict` (that module imports
flax): the same key mapping and layout transposes (flax HWIO -> torch
OIHW; the (3, I, O) third-upsample matrix -> ConvTranspose2d (I, O, 3, 1)).
The multi-scale ensemble's towers come out under `model1.` and `model2.`,
its regression weights (`wk`, `bk`, `wt`, `bt`, `wg`, `bg`) at the top
level. tests/test_torch_model.py and tests/test_torch_multi_scale.py pin
the two together exactly.

`load_state_dict` fills a port model from such a dict or from a reference
`best_model.pt`: the export writes an equivariant conv as `X.weight` and
the p2pc_conv pool's conv as `pool.weight`, the reference (and the port's
modules) as `X.conv2d.weight` and `pool.conv.weight`; both load.

`adam_state_from_jax` maps an optax Adam state (mu, nu, count) the same
way, and `load_adam_state` puts it into a torch.optim.Adam, so a run can
continue in the port from a JAX training state.
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


def match_names(keys, state_dict: Mapping) -> dict:
    """{key of `keys`: its key in state_dict}, accepting either naming of
    an equivariant conv (`X.conv2d.weight` or `X.weight`) and of the
    p2pc_conv pool (`pool.conv.weight` or `pool.weight`) and ignoring
    `num_batches_tracked`; any other missing or unused key raises
    KeyError."""
    found, missing = {}, []
    for key in keys:
        cands = [key, key.replace(".conv2d.", "."),
                 key.replace(".conv.", ".")]
        hit = next((c for c in cands if c in state_dict), None)
        if hit is None:
            missing.append(key)
        else:
            found[key] = hit
    used = set(found.values())
    leftovers = sorted(k for k in state_dict if k not in used
                       and not k.endswith("num_batches_tracked"))
    if missing or leftovers:
        raise KeyError(f"state_dict mismatch: missing {missing[:8]}, "
                       f"unexpected {leftovers[:8]}")
    return found


def _tensor(v) -> torch.Tensor:
    return (v.detach().float() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v, np.float32)))


def load_state_dict(model: torch.nn.Module, state_dict: Mapping) -> None:
    """Load numpy arrays or tensors into `model`, strictly (either naming
    of an equivariant conv and of the p2pc_conv pool, see `match_names`)."""
    names = match_names(model.state_dict(), state_dict)
    model.load_state_dict({k: _tensor(state_dict[v])
                           for k, v in names.items()}, strict=True)


def _adam_state(tree):
    """The first node of an optax state tree that carries Adam's
    moments (a ScaleByAdamState: count, mu, nu)."""
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _adam_state(t)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state) -> dict:
    """optax Adam state -> {torch parameter name: {"step", "exp_avg",
    "exp_avg_sq"}} as numpy arrays, in torch's names and layouts (mu ->
    exp_avg, nu -> exp_avg_sq, count -> step), for `load_adam_state`."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam moments (mu, nu) in this optax state")
    mu = state_dict_from_jax({"params": adam.mu})
    nu = state_dict_from_jax({"params": adam.nu})
    step = np.float32(np.asarray(adam.count))
    return {k: {"step": step, "exp_avg": mu[k], "exp_avg_sq": nu[k]}
            for k in mu}


def load_adam_state(optimizer: torch.optim.Optimizer,
                    model: torch.nn.Module, named_state: Mapping) -> None:
    """Set `optimizer`'s per-parameter Adam state from
    `adam_state_from_jax`'s dict (strictly, names resolved as in
    load_state_dict)."""
    params = dict(model.named_parameters())
    names = match_names(params, named_state)
    for key, src in names.items():
        p = params[key]
        st = named_state[src]
        optimizer.state[p] = {
            "step": torch.tensor(float(st["step"]), dtype=torch.float32),
            "exp_avg": _tensor(st["exp_avg"]).to(p.device, p.dtype),
            "exp_avg_sq": _tensor(st["exp_avg_sq"]).to(p.device, p.dtype)}
