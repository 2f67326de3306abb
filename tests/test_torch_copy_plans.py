"""PyTorch port: the host-side plans of the two copy kernels, #5
window_copy (csrc/probe_window_copy.cu) and #7 transpose_pad
(csrc/transpose_pad.cu), held to their rules on the CPU.

The kernels run only on the card: chip_smoke.py phase 7 holds them
exactly against their plain versions at odd strides, views, tiny batches
and B in {13, 16, 40, 256}. Here `window_plan` and `transpose_plan`
(ops/probes_cuda.py) are checked for coverage (every (window, clip) and
every (output row, clip) exactly once), shared memory (<= 227 KB a
block), the bulk copies' rules (sizes and addresses on 16 bytes, spans
that fit their slots and stay inside the stream) and a grid that fills
the SMs.
"""

import numpy as np
import pytest
import torch

from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.scripts import probe_dma_rate

N_SM = 132


# ---------------------------------------------------------------------------
# #7 transpose_pad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("B", [1, 8, 13, 16, 40, 256])
def test_transpose_plan_covers_rows_and_clips_once(B, dtype):
    """Work items w < n_runs * n_chunks: runs of run_rows rows times
    chunks of `chunk` clips tile the (lfull, B) output exactly."""
    item = np.dtype(dtype).itemsize
    lfull = 2_650_112 if B <= 16 else 41_011   # serving; odd for wide B
    p = PC.transpose_plan(B, lfull, item, N_SM)
    rows = np.zeros(lfull, np.int32)
    for run in range(p.n_runs):
        rows[run * p.run_rows:(run + 1) * p.run_rows] += 1
    cols = np.zeros(B, np.int32)
    for ch in range(p.n_chunks):
        cols[ch * p.chunk:ch * p.chunk + p.chunk] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert p.chunk <= PC.TP_MAX_CHUNK and p.run_rows * item % 128 == 0
    assert p.row_bytes == p.run_rows * item + PC.TP_SLOT_PAD


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("B", [1, 8, 13, 16, 40, 256])
@pytest.mark.parametrize("n_sm", [132, 114, 16])
def test_transpose_plan_fits_and_fills(B, dtype, n_sm):
    item = np.dtype(dtype).itemsize
    p = PC.transpose_plan(B, 2_650_112, item, n_sm)
    assert p.smem == 2 * p.chunk * p.row_bytes <= PC.SMEM_PER_BLOCK
    per_sm = -(-p.grid // n_sm)
    assert per_sm * (p.smem + 1024) <= PC.SMEM_PER_SM
    work = p.n_runs * p.n_chunks
    assert min(work, n_sm) <= p.grid <= work
    # one bulk phase of a stage stays under the mbarrier's 2^20 bytes
    assert p.chunk * (p.run_rows * item + 16) < 1 << 20


SERVING_L, SERVING_LFULL, HALF = 2_646_000, 2_650_112, 256


@pytest.fixture(scope="module")
def serving_sources():
    """Output row -> source sample of the serving geometry, read off
    transpose_pad_plain itself (samples numbered from 1; 0: a zero row)."""
    y = torch.arange(1, SERVING_L + 1, dtype=torch.float64)[None]
    return PC.transpose_pad_plain(y, HALF, SERVING_LFULL)[:, 0].long() - 1


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("B", [1, 8, 13, 16, 40, 256])
def test_transpose_runs_fit_their_slots(B, dtype, serving_sources):
    """Each run's rows draw on one span of at most run_rows samples a
    clip; widened to 16-byte lines (at most 16 bytes more) and shifted
    for banks (at most TP_SLOT_PAD - 16 bytes) it fits its clip's slot,
    and a stage's bulk bytes stay under an mbarrier phase's 2^20."""
    item = np.dtype(dtype).itemsize
    p = PC.transpose_plan(B, SERVING_LFULL, item, N_SM)
    src = torch.full((p.n_runs * p.run_rows,), -1, dtype=torch.long)
    src[:SERVING_LFULL] = serving_sources
    src = src.view(p.n_runs, p.run_rows)
    has = src >= 0
    big = torch.iinfo(torch.long).max
    lo = torch.where(has, src, big).min(1).values
    hi = src.max(1).values
    live = has.any(1)
    span = (hi - lo + 1)[live]
    assert int(live.sum()) == -(-(2 * HALF + SERVING_L + 1) // p.run_rows)
    assert int(span.max()) <= p.run_rows
    assert p.run_rows * item % 16 == 0
    widened = p.run_rows * item + 16
    assert widened + PC.TP_SLOT_PAD - 16 <= p.row_bytes
    assert p.chunk * widened < 1 << 20


# ---------------------------------------------------------------------------
# #5 window_copy
# ---------------------------------------------------------------------------

GEOMETRIES = {"44.1 kHz 3 s": (44100, 3), "22050 Hz 120 s": (22050, 120)}


def blocks_of(plan, variant, grid_n, batch):
    """The (steps, clips) each block of the kernel's grid stages."""
    for x in range(plan.x_blocks):
        steps = (range(x * PC.DB_STEPS, min(grid_n, (x + 1) * PC.DB_STEPS))
                 if variant == "dma3_db" else [x])
        for y in range(plan.n_chunks):
            c0 = y * batch // plan.n_chunks
            c1 = (y + 1) * batch // plan.n_chunks
            yield steps, range(c0, c1)


@pytest.mark.parametrize("variant", PC.WINDOW_VARIANTS)
@pytest.mark.parametrize("B", [1, 8, 13, 16, 40, 256])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_window_plan_covers_windows_and_clips_once(variant, B, geometry):
    sr, clip = GEOMETRIES[geometry]
    n_fft, hop, L, tile_t, starts, length = probe_dma_rate.geometry(
        sr, clip, B)
    win = n_fft + PC.ALIGN
    grid_n = len(starts) // tile_t
    plan = PC.window_plan(variant, B, grid_n, tile_t, win, N_SM)
    n_win = 1 if variant in ("dma1", "dma3_big") else tile_t
    seen = np.zeros((grid_n, n_win, B), np.int32)
    sizes = set()
    for steps, cl in blocks_of(plan, variant, grid_n, B):
        assert 1 <= len(cl) <= plan.chunk
        sizes.add(len(cl))
        for s in steps:
            seen[s, :, cl.start:cl.stop] += 1
    assert (seen == 1).all()
    assert max(sizes) - min(sizes) <= 1            # even chunks


@pytest.mark.parametrize("variant", PC.WINDOW_VARIANTS)
@pytest.mark.parametrize("B", [1, 8, 13, 16, 40, 256])
@pytest.mark.parametrize("n_sm", [132, 16])
def test_window_plan_fits_and_fills(variant, B, n_sm):
    n_fft, hop, L, tile_t, starts, length = probe_dma_rate.geometry(
        22050, 120, B)
    win = n_fft + PC.ALIGN
    grid_n = len(starts) // tile_t
    plan = PC.window_plan(variant, B, grid_n, tile_t, win, n_sm)
    assert plan.smem <= min(PC.SMEM_PER_BLOCK, PC._SMEM_BUDGET)
    assert plan.smem < 1 << 20             # one mbarrier phase's bytes
    if variant == "grid":
        assert plan.smem == 0
        assert plan == PC.window_plan("dma3", B, grid_n, tile_t, win,
                                      n_sm)._replace(smem=0)
    assert (plan.x_blocks * plan.n_chunks >= PC.BLOCKS_PER_SM * n_sm
            or plan.chunk == 1)


@pytest.mark.parametrize("variant", PC.WINDOW_VARIANTS[1:])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_window_copies_are_bulk_copies_inside_the_stream(variant, geometry):
    """Each copy: a 16-byte multiple from a 16-byte address (rows of a
    multiple of 8 samples, offsets on 16 samples) inside its row of the
    stream, into a 16-byte slot offset."""
    sr, clip = GEOMETRIES[geometry]
    n_fft, hop, L, tile_t, starts, length = probe_dma_rate.geometry(
        sr, clip, 4)
    win = n_fft + PC.ALIGN
    t_pad = len(starts)
    st = torch.tensor(starts, dtype=torch.int32)
    stride = PC.static_stride(hop, t_pad, win, length)
    span = tile_t * win if variant == "dma3_big" else win
    assert (span * 2) % 16 == 0 and length % 8 == 0
    first = PC.window_offsets(st, variant, tile_t, win, length, stride)
    n_win = 1 if variant in ("dma1", "dma3_big") else tile_t
    for step, off0 in enumerate(first.tolist()):
        for j in range(n_win):
            t = step * tile_t + j
            if variant == "dma3_static":
                off = t * stride // PC.ALIGN * PC.ALIGN
            elif j == 0:
                off = off0
            else:
                off = starts[t] // PC.ALIGN * PC.ALIGN
            assert off % PC.ALIGN == 0 and 0 <= off and off + span <= length
    plan = PC.window_plan(variant, 4, t_pad // tile_t, tile_t, win, N_SM)
    assert plan.smem % 16 == 0 and (span * 2) % 16 == 0
