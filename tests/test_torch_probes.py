"""PyTorch port: the probe and experiment kernels against the TPU probes.

Each kernel of audio_key_estimation_torch/ops/probes_cuda.py and the stage
split of kernel B (cqt_cuda.octave_response_stage) runs its plain PyTorch
version here (CPU tensors) and is held against the JAX package's Pallas
kernel in scripts/ run in interpret mode, on the same numpy inputs. The
CUDA kernels are held against these plain versions on the card by
chip_smoke.py. The scripts are imported as modules (they set JAX's
compilation cache on import); their pl.pallas_call runs with
interpret=True through a monkeypatch.

Bars: exact for the copies (#5, #7, #8, #9 and the load / realign
stages); rtol/atol 1e-4 for the GEMM stages (f32 sums of n_fft products
in another order), 1e-3 for the raw GEMM of an int16 stream (the repo's
int16 bar: its sums run over samples up to 2^15, unnormalized).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from audio_key_estimation_tpu.ops import cqt_pallas as jax_cqt_pallas

from audio_key_estimation_torch.ops import cqt, cqt_cuda
from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.scripts import (experiment_transpose_kernel,
                                                probe_cqt_kernel_stages,
                                                probe_dma_rate,
                                                probe_pallas_overhead,
                                                probe_pallas_primitives,
                                                profile_cqt_frontend)


def _script(name):
    return importlib.import_module(f"scripts.{name}")


@pytest.fixture
def tpu_outputs(monkeypatch):
    """Run every pl.pallas_call in interpret mode; collect its outputs."""
    outs = []
    orig = pl.pallas_call

    def call(*a, **k):
        f = orig(*a, **dict(k, interpret=True))

        def run(*args):
            r = f(*args)
            outs.append(np.asarray(r))
            return r
        return run

    monkeypatch.setattr(pl, "pallas_call", call)
    return outs


# ---------------------------------------------------------------------------
# #9 primitives, #8 launch overhead
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PC.PRIMITIVES))
def test_primitive_matches_tpu_probe(tpu_outputs, name):
    """The probe asserts its own numpy reference; its kernel's output and
    the port's plain version (and the entry point's reference) agree
    exactly."""
    getattr(_script("probe_pallas_primitives"), name)()
    ref = tpu_outputs[-1]
    x = PC.primitive_input(name)
    got = PC.primitive(name, x).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        probe_pallas_primitives.expected(name, x.numpy()), ref)


@pytest.mark.parametrize("grid_n", [1, 25])
def test_launch_probe_matches_tpu(tpu_outputs, grid_n):
    x = np.zeros((64, 512), np.int16)
    ref = np.asarray(_script("probe_pallas_overhead").build(grid_n)(
        jnp.asarray(x)))
    got = PC.launch_probe(torch.from_numpy(x), grid_n).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# #5 window copy
# ---------------------------------------------------------------------------

def test_response_plan_is_the_tpu_plan():
    for n_fft in (128, 512, 1024, 8192):
        for b in (1, 4, 16, 128, 512, 1024):
            for item in (2, 4):
                assert (PC.response_plan(n_fft, b, item)
                        == jax_cqt_pallas._response_plan(n_fft, b, item))
    assert PC.ALIGN == jax_cqt_pallas._ALIGN_TM


@pytest.fixture(scope="module")
def dma_geometry():
    """44.1 kHz, 3 s, B = 4: 16 frames, tile_t 8, two steps; 8816 spacing
    keeps every dma3_static window inside the stream."""
    n_fft, hop, L, tile_t, starts, length = probe_dma_rate.geometry(
        44100, 3, 4)
    rng = np.random.default_rng(5)
    x = rng.integers(-8000, 8000, (4, length)).astype(np.int16)
    return n_fft, hop, tile_t, starts, x


@pytest.mark.parametrize("variant", PC.WINDOW_VARIANTS)
def test_window_copy_matches_tpu(tpu_outputs, dma_geometry, variant):
    n_fft, hop, tile_t, starts, x = dma_geometry
    win = n_fft + PC.ALIGN
    t_pad = len(starts)
    stride = PC.static_stride(hop, t_pad, win, x.shape[1])
    assert stride == 8816 and t_pad // tile_t == 2
    f = _script("probe_dma_rate").build(
        variant, n_fft=n_fft, t_pad=t_pad, tile_t=tile_t, Bc=x.shape[0],
        Lpad=x.shape[1])
    ref = np.asarray(f(jnp.asarray(starts, jnp.int32), jnp.asarray(x.T)))
    got = PC.window_copy(torch.from_numpy(x),
                         torch.tensor(starts, dtype=torch.int32), variant,
                         tile_t, win, stride).numpy()
    assert got.shape == ref.shape == (2, tile_t, 1)
    np.testing.assert_array_equal(got, ref)


def test_window_copy_big_clamps_and_static_stride_fits():
    """dma3_big's offset is clamped to Lpad - tile_t * win - 16 before the
    16-alignment; static_stride shrinks until the last window fits."""
    x = torch.arange(4000, dtype=torch.int16)[None].repeat(2, 1)
    starts = torch.tensor([5, 40, 3000, 3990], dtype=torch.int32)
    got = PC.window_copy(x, starts, "dma3_big", 2, 1000)
    top = (4000 - 2000 - 16) // 16 * 16
    np.testing.assert_array_equal(got[:, :, 0].numpy(),
                                  [[0, 1], [top, top + 1]])
    s = PC.static_stride(8820, 602, 1040, 5_293_040)
    assert s % 16 == 0 and s < 8816 and 601 * s + 1040 <= 5_293_040
    assert PC.static_stride(8820, 16, 1040, 1 << 20) == 8816


# ---------------------------------------------------------------------------
# #6 stage split of kernel B
# ---------------------------------------------------------------------------

def _tpu_stage(variant, ypadT, starts, kmat_t, scales, n_fft, tile_t):
    """The pallas_call of probe_cqt_kernel_stages.py:118-130 around its
    variant_kernel (run_variant returns only a time)."""
    mod = _script("probe_cqt_kernel_stages")
    Lpad, Bc = ypadT.shape
    bpo = kmat_t.shape[0] // 2
    win = n_fft + jax_cqt_pallas._ALIGN_TM
    t_pad = starts.shape[0]
    kern = mod.variant_kernel(variant, n_fft=n_fft, t_pad=t_pad,
                              tile_t=tile_t, Bc=Bc, bpo=bpo,
                              in_dtype=ypadT.dtype)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(t_pad // tile_t,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((tile_t, bpo, Bc), lambda t, s, l: (t, 0, 0)),
        scratch_shapes=[pltpu.VMEM((tile_t, win, Bc), ypadT.dtype),
                        pltpu.SemaphoreType.DMA((tile_t,))],
    )
    f = pl.pallas_call(
        kern, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((t_pad, bpo, Bc), jnp.float32),
        interpret=True)
    return np.asarray(f(starts, jnp.asarray([0], jnp.int32), ypadT, kmat_t,
                        scales))


@pytest.fixture(scope="module")
def stage_inputs():
    """22050 Hz, hop 4410, B = 4, 2 s: an int16 octave-0 stream and a
    bf16 octave-1 stream, padded by the TPU's _pad_signal_for_starts."""
    p = cqt.CQTParams(sr=22050, hop=4410)
    bank = cqt.kernel_bank(p)
    n_fft = bank["n_fft"]
    L = 2 * 22050
    n_frames = 1 + L // p.hop
    rng = np.random.default_rng(6)
    streams = {
        "int16 octave 0": (0, (rng.standard_normal((L, 4)) * 8000)
                           .astype(np.int16)),
        "bf16 octave 1": (1, torch.from_numpy(
            rng.standard_normal(((L - 1) // 2 + 1, 4)).astype(np.float32)
            * 0.3).bfloat16().float().numpy()),
    }
    out = {}
    for name, (o, curT) in streams.items():
        cur = jnp.asarray(curT, jnp.bfloat16 if o else jnp.int16)
        item = cur.dtype.itemsize
        tile_t, _ = jax_cqt_pallas._response_plan(n_fft, 4, item)
        t_pad = -(-n_frames // tile_t) * tile_t
        starts = jax_cqt_pallas._frame_starts(p.hop, o, n_frames)
        starts = starts + [starts[-1]] * (t_pad - n_frames)
        ypadT = jax_cqt_pallas._pad_signal_for_starts(cur, starts, n_fft)
        in_scale = 1 / 32768.0
        out[name] = dict(
            ypadT=ypadT, starts=starts, tile_t=tile_t, n_fft=n_fft,
            n_frames=n_frames, scales=cqt.octave_scales(p, o, in_scale),
            kmat_t=np.ascontiguousarray(cqt.bank_matrix(p).T))
    return out


@pytest.mark.parametrize("stream", ["int16 octave 0", "bf16 octave 1"])
@pytest.mark.parametrize("stage,tpu_variant", [
    ("load", "dma"), ("realign", "rotate"), ("gemm", "matmul"),
    ("full", "full")])
def test_stage_matches_tpu_variant(stage_inputs, stream, stage, tpu_variant):
    g = stage_inputs[stream]
    n = g["n_frames"]
    ref = _tpu_stage(tpu_variant, g["ypadT"],
                     jnp.asarray(g["starts"], jnp.int32),
                     jnp.asarray(g["kmat_t"]),
                     jnp.asarray(g["scales"][:, None], jnp.float32),
                     g["n_fft"], g["tile_t"])
    ref = ref[:n].transpose(2, 1, 0)                   # (B, bpo, T)
    x = torch.from_numpy(np.asarray(g["ypadT"].astype(jnp.float32)).T
                         .copy())
    x = x.to(torch.int16) if stream.startswith("int16") else x.bfloat16()
    got = cqt_cuda.octave_response_stage(
        x, torch.tensor(g["starts"][:n], dtype=torch.int32),
        cqt_cuda.make_bank(g["kmat_t"], "cpu"),
        torch.from_numpy(g["scales"]), stage).numpy()
    assert got.shape == ref.shape == (4, 36, n)
    if stage in ("load", "realign"):
        np.testing.assert_array_equal(got, ref)
    else:
        tol = 1e-3 if (stage, stream) == ("gemm", "int16 octave 0") else 1e-4
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    assert cqt_cuda.octave_response_stage.launches == 0


def test_full_stage_is_kernel_b(stage_inputs):
    """The full stage's plain version is kernel B's (same geometry): the
    stream as a one-octave layout of kernel B."""
    g = stage_inputs["int16 octave 0"]
    n = g["n_frames"]
    x = torch.from_numpy(np.asarray(g["ypadT"]).T.copy())
    starts = torch.tensor(g["starts"][:n], dtype=torch.int32)
    bank = cqt_cuda.make_bank(g["kmat_t"], "cpu")
    scales = torch.from_numpy(g["scales"])
    layout = cqt_cuda.ArenaLayout((0,), (x.shape[1],), (0,), 0)
    out = torch.zeros(4, 36, n)
    cqt_cuda.octave_response(x, torch.empty(4, 0), layout, starts[None],
                             bank, scales[None], out)
    got = cqt_cuda.octave_response_stage(x, starts, bank, scales, "full")
    assert torch.equal(got, out)


# ---------------------------------------------------------------------------
# #7 transpose-pad
# ---------------------------------------------------------------------------

def test_tp_plan_is_the_tpu_plan():
    mod = _script("experiment_transpose_kernel")
    assert PC._TP_SUP == mod._TP_SUP
    for L in (3000, 4096, 9001, 30001, 2_646_000):
        for half in (64, 256, 384, 4096):
            for sup in (2048, 4096):
                need = (L // 4410) * 4410 + 2 * half + 16
                assert (PC.tp_plan(L, half, need, sup)
                        == mod._tp_plan(L, half, need, sup))


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_transpose_pad_matches_tpu(rng, dtype):
    mod = _script("experiment_transpose_kernel")
    L, n_fft = 9001, 512
    y = rng.uniform(-0.5, 0.5, (8, L)) * 32767
    y = y.astype(dtype)
    last_start = (L // 4410) * 4410
    ref = np.asarray(mod.transpose_pad_tm(jnp.asarray(y), last_start, n_fft,
                                          interpret=True))
    got = PC.transpose_pad_tm(torch.from_numpy(y), last_start, n_fft)
    assert got.dtype == torch.from_numpy(y).dtype
    assert got.shape == ref.shape and ref.shape[1] == 8
    np.testing.assert_array_equal(got.numpy(), ref)
    # short geometry the TPU plan refuses: both sides give None
    ys = y[:, :2000]
    assert mod.transpose_pad_tm(jnp.asarray(ys), 0, n_fft,
                                interpret=True) is None
    assert PC.transpose_pad_tm(torch.from_numpy(ys), 0, n_fft) is None
    assert PC.transpose_pad.launches == 0


# ---------------------------------------------------------------------------
# wrappers and entry points off the card
# ---------------------------------------------------------------------------

def test_probe_wrappers_never_fall_back_off_cpu():
    """A tensor on neither the CPU nor a CUDA device reaches no plain
    version: each wrapper raises."""
    m16 = torch.empty(2, 4096, dtype=torch.int16, device="meta")
    st = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        PC.window_copy(m16, st, "dma3", 8, 528)
    with pytest.raises(ValueError):
        PC.transpose_pad(m16, 256, 8192)
    with pytest.raises(ValueError):
        PC.launch_probe(m16, 3)
    with pytest.raises(ValueError):
        PC.primitive("p3_int16", torch.empty(8, 128, dtype=torch.int16,
                                             device="meta"))
    with pytest.raises(ValueError):
        cqt_cuda.octave_response_stage(
            m16, st, cqt_cuda.Bank(*(torch.empty(72, 512, device="meta"),)
                                   * 3),
            torch.empty(36, device="meta"), "gemm")
    assert (PC.window_copy.launches, PC.transpose_pad.launches,
            PC.launch_probe.launches, PC.primitive.launches,
            cqt_cuda.octave_response_stage.launches) == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("entry", [
    probe_pallas_primitives.main, probe_pallas_overhead.main,
    probe_dma_rate.main, probe_cqt_kernel_stages.main,
    experiment_transpose_kernel.main, profile_cqt_frontend.main])
def test_entry_points_refuse_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(SystemExit, match="CUDA"):
        entry()


def test_entry_points_read_the_tpu_scripts_defaults():
    """Same environment variables, same defaults as the TPU scripts."""
    for name, mod in (("probe_dma_rate", probe_dma_rate),
                      ("probe_cqt_kernel_stages", probe_cqt_kernel_stages)):
        tpu = _script(name)
        assert (mod.SR, mod.CLIP_SECONDS, mod.B, mod.REPS) == (
            tpu.SR, tpu.CLIP_SECONDS, tpu.B, tpu.REPS)
    tpu = _script("probe_cqt_kernel_stages")
    assert (probe_cqt_kernel_stages.OCTAVE,
            probe_cqt_kernel_stages.STREAM_DTYPE) == (tpu.OCTAVE,
                                                      tpu.STREAM_DTYPE)
    assert probe_pallas_overhead.REPS == _script("probe_pallas_overhead").REPS
