"""PyTorch port: float32 means IEEE float32 inside every entry point.

Under torch's defaults cuDNN runs float32 convolutions as TF32, while the
JAX package computes IEEE float32 and every parity bar is a float32 bar.
`KeyEstimator.outputs`, the trainer's `train_step` and `eval_step` and
`KeyDataset._features` enter `utils/precision.ieee_float32`. The flags
are process-wide settings of torch's context, the same on the CPU as on
a card, so what each entry point runs under is checked here: a hook
inside the call reads them; the caller's cuDNN switches are left alone;
the caller's precision settings come back after the call and after an
exception raised inside it; a bfloat16 model's results are those it
gives with no pin at all. Which of these settings cuDNN and cuBLAS obey
on the card, and by how much TF32 moves the results, `chip_smoke.py`'s
[4p precision] phase measures.
"""

import numpy as np
import pytest
import torch

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import dataset as dataset_mod
from audio_key_estimation_torch.data.dataset import KeyDataset
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.ops.cqt import CQTParams
from audio_key_estimation_torch.predict import KeyEstimator
from audio_key_estimation_torch.train import trainer
from audio_key_estimation_torch.utils import precision
from audio_key_estimation_torch.utils.precision import ieee_float32

TINY = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
            kernel_size=3, head_layers=1, bucket_sizes=(32,), batch_size=2,
            acc_grad=2, frames=5)
SR = 8000
T = 32
CUDNN = torch.backends.cudnn
MATMUL = torch.backends.cuda.matmul
PINNED = {"cudnn.conv": "ieee", "cudnn.rnn": "ieee", "cuda.matmul": "ieee"}


def _reset_defaults():
    """torch's own defaults: cuDNN TF32 for convolutions and RNNs,
    cuBLAS matmuls in IEEE float32, no parent setting."""
    torch.backends.fp32_precision = "none"
    CUDNN.fp32_precision = "none"
    CUDNN.allow_tf32 = True
    MATMUL.allow_tf32 = False
    MATMUL.fp32_precision = "none"


@pytest.fixture(autouse=True)
def torch_defaults():
    switches = (CUDNN.enabled, CUDNN.benchmark, CUDNN.deterministic)
    _reset_defaults()
    yield
    _reset_defaults()
    CUDNN.enabled, CUDNN.benchmark, CUDNN.deterministic = switches


def _set_legacy_all_tf32():
    CUDNN.allow_tf32 = True
    MATMUL.allow_tf32 = True


def _set_generic_tf32():
    torch.backends.fp32_precision = "tf32"


def _set_mixed():
    # the new interface on convolutions alone: the legacy cuDNN flag
    # then cannot be read
    CUDNN.conv.fp32_precision = "ieee"


# how a user's process may have set TF32 before calling the port
CALLERS = {"torch defaults": lambda: None,
           "legacy flags, TF32 everywhere": _set_legacy_all_tf32,
           "fp32_precision tf32 for every backend": _set_generic_tf32,
           "matmul precision high": lambda:
               torch.set_float32_matmul_precision("high"),
           "legacy TF32 off": lambda: setattr(CUDNN, "allow_tf32", False),
           "interfaces mixed": _set_mixed}


def _safe(fn):
    try:
        return fn()
    except RuntimeError:     # a legacy getter under mixed settings
        return "raises"


def snapshot() -> tuple:
    """Every precision setting a caller can read, legacy getters too."""
    return (precision.flags(), torch.backends.fp32_precision,
            CUDNN.fp32_precision, _safe(lambda: CUDNN.allow_tf32),
            _safe(lambda: MATMUL.allow_tf32),
            _safe(torch.get_float32_matmul_precision))


def seen_now() -> dict:
    return {"flags": precision.flags(),
            "switches": (CUDNN.enabled, CUDNN.benchmark,
                         CUDNN.deterministic)}


# ---------------------------------------------------------------------------
# the entry points, each run with a hook inside it
# ---------------------------------------------------------------------------

def _model_weights(cfg):
    return build_model(cfg, generator=torch.Generator().manual_seed(0)
                       ).state_dict()


def _waves(rng, n=3):
    return [(0.3 * rng.standard_normal(int(SR * s))).astype(np.float32)
            for s in (2.5, 1.7, 3.0)[:n]]


def _train_batch(rng, cfg):
    acc, bs = cfg.acc_grad, cfg.batch_size
    seq = rng.integers(T // 2, T + 1, (acc, bs)).astype(np.int32)
    return {"mel": rng.normal(size=(acc, bs, cfg.pitches, T, 1)).astype(
                np.float32),
            "seq_length": seq,
            "key_labels": np.eye(12, dtype=np.float32)[
                rng.integers(0, 12, (acc, bs))],
            "tonic_labels": np.eye(12, dtype=np.float32)[
                rng.integers(0, 12, (acc, bs))],
            "genre": np.zeros((acc, bs, 11), np.float32)}


def _eval_batch(rng, cfg):
    b = {k: v[0] for k, v in _train_batch(rng, cfg).items()}
    b["key_signature_id"] = np.eye(24, dtype=np.float32)[
        rng.integers(0, 24, cfg.batch_size)]
    b["valid"] = np.ones(cfg.batch_size, np.float32)
    return b


def run_outputs(cfg, rng, hook, direct=False):
    est = KeyEstimator(cfg, _model_weights(cfg), device="cpu",
                       bucket_seconds=(4,))
    waves = _waves(rng)
    h = est.model.register_forward_pre_hook(lambda m, a: hook())
    try:
        if direct:    # the same work with no pin at all
            with torch.inference_mode():
                batch, seq, hop = est.make_batch(waves, SR)
                return [o.numpy() for o in est.model(
                    *est.features(batch, SR, hop), seq)]
        return est.outputs(waves, SR)[0]
    finally:
        h.remove()


def run_train_step(cfg, rng, hook, direct=False):
    state = trainer.create_train_state(cfg, 0, "cpu")
    batch = trainer.to_device(_train_batch(rng, cfg), "cpu")
    state.model.register_forward_pre_hook(lambda m, a: hook())
    if direct:
        state.model.train()
        loss = sum(trainer.compute_loss(
            cfg, trainer.forward(state.model, cfg,
                                 {k: v[i] for k, v in batch.items()}),
            {k: v[i] for k, v in batch.items()})[0]
            for i in range(cfg.acc_grad)) / cfg.acc_grad
        return [loss.detach().numpy()]
    loss = trainer.make_train_step(cfg, 1, seed=0)(state, batch)["loss"]
    return [loss.numpy()]


def run_eval_step(cfg, rng, hook, direct=False):
    state = trainer.create_train_state(cfg, 0, "cpu")
    batch = trainer.to_device(_eval_batch(rng, cfg), "cpu")
    state.model.register_forward_pre_hook(lambda m, a: hook())
    if direct:
        state.model.eval()
        with torch.inference_mode():
            outputs = trainer.forward(state.model, cfg, batch)
            loss, _ = trainer.compute_loss(cfg, outputs, batch,
                                           sample_weights=batch["valid"],
                                           train=False)
    else:
        outputs = []
        state.model.register_forward_hook(
            lambda m, a, out: outputs.extend(out))
        loss, _ = trainer.make_eval_step(cfg)(state, batch)
    return [loss.numpy()] + [o.numpy() for o in outputs]


def run_features(cfg, rng, hook, direct=False):
    ds = KeyDataset(False, cfg, blacklist_path="", device="cpu")
    y = torch.from_numpy(np.stack(_waves(rng, 1)))
    p = CQTParams(sr=SR, hop=SR // cfg.frames, octaves=cfg.octaves)
    if direct:
        with torch.inference_mode():
            return [dataset_mod.compute_cqt(
                y, p, conv_dtype=cfg.cqt_conv_dtype).numpy()]
    compute = dataset_mod.compute_cqt

    def hooked(*args, **kw):
        hook()
        return compute(*args, **kw)
    dataset_mod.compute_cqt = hooked
    try:
        return [ds._features(y, p)]
    finally:
        dataset_mod.compute_cqt = compute


ENTRY_POINTS = {"KeyEstimator.outputs": run_outputs,
                "train_step": run_train_step,
                "eval_step": run_eval_step,
                "KeyDataset._features": run_features}


@pytest.mark.parametrize("caller", CALLERS)
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_runs_in_ieee_float32(entry, caller, rng):
    """Inside the call cuDNN convolutions and RNNs and cuBLAS matmuls are
    pinned to IEEE float32 (the legacy flags read False where the
    caller's settings let them be read); cuDNN's enabled, benchmark and
    deterministic stay as the caller set them; every setting the caller
    can read comes back after the call and after an exception raised
    inside it."""
    run = ENTRY_POINTS[entry]
    cfg = Config(**TINY)
    CUDNN.benchmark, CUDNN.deterministic = True, True
    CALLERS[caller]()
    before = snapshot()
    seen = []
    run(cfg, rng, lambda: seen.append(seen_now()))
    assert seen, f"{entry}: the hook never ran"
    legacy = None if caller == "interfaces mixed" else False
    for s in seen:
        assert s["flags"] == PINNED | {"cudnn.allow_tf32": legacy,
                                       "cuda.matmul.allow_tf32": False}, s
        assert s["switches"] == (CUDNN.enabled, True, True)
    assert snapshot() == before

    def boom():
        raise KeyError("raised inside the entry point")
    with pytest.raises(KeyError):
        run(cfg, rng, boom)
    assert snapshot() == before
    assert (CUDNN.benchmark, CUDNN.deterministic) == (True, True)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_bfloat16_model_served_unchanged(entry):
    """A bfloat16 model (for the dataset, bfloat16 CQT streams): what the
    entry point gives, with the caller's TF32 allowed or not, equals the
    same work done with no pin at all."""
    run = ENTRY_POINTS[entry]
    cfg = Config(**TINY, dtype="bfloat16", cqt_conv_dtype="bfloat16")
    results = []
    for setup in (lambda: None, lambda: setattr(CUDNN, "allow_tf32", False)):
        _reset_defaults()
        setup()
        results.append(run(cfg, np.random.default_rng(0), lambda: None))
    _reset_defaults()
    direct = run(cfg, np.random.default_rng(0), lambda: None, direct=True)
    for got in results:
        for a, b in zip(got, direct):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))


@pytest.mark.parametrize("caller", CALLERS)
def test_pin_nests_and_restores(caller):
    """ieee_float32 inside ieee_float32 restores the outer pin, then the
    caller's settings."""
    CALLERS[caller]()
    before = snapshot()
    with ieee_float32():
        outer = snapshot()
        with ieee_float32("nested"):
            assert precision.flags()["cudnn.conv"] == "ieee"
        assert snapshot() == outer
    assert snapshot() == before
