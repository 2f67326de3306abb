"""PyTorch port: kernel C's schedule and the stack's layouts, on the CPU.

Kernel C (csrc/conv7.cu) runs on the card only (chip_smoke.py). Here a
torch emulation of its schedule — the halo staged with the circular wrap
as index arithmetic (NCHW input rounded to bf16 on load, channels
zero-filled), one ldmatrix A fragment per (input row, time-tap pair; tap
6 alone, an m16n8k8) fed to the mma of every output row it reaches, the
B fragments read from
the packed weight by lane, bf16 operands, float32 sums, the bf16 epilogue
— must equal conv7_layer_plain within 1 bf16 ulp at ragged geometries;
that pins pack_weight's order as the kernel reads it. The plain stack
(NCHW in and out, float32 or bf16) is held against the JAX package's
fused Pallas stack in interpret mode at tests/test_convstack_pallas.py's
bars (max rel < 5e-2, mean rel < 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.ops import convstack_pallas as CP

from audio_key_estimation_torch.ops import convstack_cuda as CS

# csrc/conv7.cu's kRows (output pitch rows per warp) and kWarps (16 time
# positions each)
ROWS, WARPS = 8, 8
HALO_H, HALO_T = ROWS + 6, 16 * WARPS + 6


def _fragment_maps():
    """Where each operand element of one mma comes from, by the PTX rules.

    ldmatrix.x4: lane 8i + j gives the address of matrix i's row j; lane l
    receives row l >> 2, elements 2(l & 3) and 2(l & 3) + 1 of each
    matrix, in register i. m16n8k16 A (row-major 16 x 16): register i of
    lane l holds A[g + 8(i & 1)][8(i >> 1) + 2q + e], g = l >> 2, q = l & 3.
    B (16 x 8): register h of lane l holds B[8h + 2q + e][g].
    Returns (a_lane, a_col): A[m][k] = row of lane a_lane[m, k], channel
    a_col[m, k]; and (b_lane, b_elem): B[k][n] = weight word b_lane[k, n]
    of half k >> 3, element b_elem[k, n]."""
    a_lane = torch.empty(16, 16, dtype=torch.long)
    a_col = torch.empty(16, 16, dtype=torch.long)
    b_lane = torch.empty(16, 8, dtype=torch.long)
    b_elem = torch.empty(16, 8, dtype=torch.long)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for i in range(4):
            for e in range(2):
                m, k = g + 8 * (i & 1), 8 * (i >> 1) + 2 * q + e
                a_lane[m, k] = 8 * i + g         # the lane that gave row g
                a_col[m, k] = 2 * q + e
        for h in range(2):
            for e in range(2):
                b_lane[8 * h + 2 * q + e, g] = lane
                b_elem[8 * h + 2 * q + e, g] = e
    return a_lane, a_col, b_lane, b_elem


def _stage(x, nchw_in, b, h0, t0):
    """One tile's halo (HALO_H, HALO_T, 8) bf16, as the kernel stages it."""
    H, T = (x.shape[2:] if nchw_in else x.shape[1:3])
    rows = (h0 - 3 + torch.arange(HALO_H)) % H
    times = (t0 - 3 + torch.arange(HALO_T)) % T
    if nchw_in:
        v = x[b][:, rows][:, :, times].to(torch.bfloat16).permute(1, 2, 0)
        return torch.nn.functional.pad(v, (0, CS.C - v.shape[-1]))
    return x[b][rows][:, times]


def emulate_kernel(x, wp, bias, nchw_in=False, nchw_out=None):
    """Kernel C's schedule in torch, warp by warp of every tile."""
    B = x.shape[0]
    H, T = (x.shape[2:] if nchw_in else x.shape[1:3])
    a_lane, a_col, b_lane, b_elem = _fragment_maps()
    words = wp.reshape(7, 4, 2, 32, 2)           # [dh][p][half][lane][elem]
    half = (torch.arange(16) // 8)[:, None].expand(16, 8)
    bmat = words[:, :, half, b_lane, b_elem].float()      # (7, 4, 16, 8)
    lane = torch.arange(32)
    mi = lane >> 3
    out = torch.empty(B, H, T, CS.C, dtype=torch.bfloat16)
    for b in range(B):
        for h0 in range(0, H, ROWS):
            for t0 in range(0, T, 16 * WARPS):
                halo = _stage(x, nchw_in, b, h0, t0)
                for w in range(WARPS):
                    if t0 + 16 * w >= T:
                        continue
                    pos = 16 * w + (lane & 7) + 8 * (mi & 1)
                    acc = torch.zeros(ROWS, 16, 8)
                    for r in range(HALO_H):
                        for p in range(4):
                            addr = pos + 2 * p + ((mi >> 1) if p < 3 else 0)
                            assert int(addr.max()) < HALO_T
                            rows = halo[r, addr]           # (32 lanes, 8)
                            a = rows[a_lane, a_col].float()
                            k = 16 if p < 3 else 8         # tap 6: m16n8k8
                            for h in range(ROWS):
                                if 0 <= r - h < 7:
                                    acc[h] += a[:, :k] @ bmat[r - h, p, :k]
                    y = acc + bias.float()
                    y = torch.where(y >= 0, y, CS.LEAKY_SLOPE * y)
                    t1 = min(16, T - t0 - 16 * w)
                    h1 = min(ROWS, H - h0)
                    out[b, h0:h0 + h1, t0 + 16 * w:t0 + 16 * w + t1] = \
                        y[:h1, :t1].to(torch.bfloat16)
    return out if nchw_out is None else out.permute(0, 3, 1, 2).to(nchw_out)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in bf16 units in the last place (chip_smoke.py's)."""
    def ordered(v):
        i = v.to(torch.bfloat16).contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _inputs(seed, B, ci, H, T, in_dtype):
    """x in the layer's input layout; packed bf16 weight; float32 bias."""
    g = np.random.default_rng(seed)
    w = torch.tensor(g.standard_normal((8, ci, 7, 7)) * (0.5 / np.sqrt(49 * ci)),
                     dtype=torch.float32)
    b = torch.tensor(g.standard_normal(8) * 0.1, dtype=torch.float32)
    x = torch.tensor(g.standard_normal((B, ci, H, T)), dtype=torch.float32)
    if in_dtype is None:                         # channels-last bf16, 8 wide
        x = torch.nn.functional.pad(x.permute(0, 2, 3, 1), (0, 8 - ci))
        x = x.to(torch.bfloat16).contiguous()
    else:
        x = x.to(in_dtype)
    return x, CS.pack_weight(w.to(torch.bfloat16)), b


# (B, ci, H, T, NCHW input dtype or None for channels-last, NCHW output)
SCHEDULE_CASES = [
    (1, 5, 3, 3, torch.float32, torch.float32),
    (3, 8, 11, 65, None, None),
    (1, 5, 11, 130, torch.float32, None),
    (3, 8, 3, 130, None, torch.float32),
    (1, 8, 19, 3, None, torch.bfloat16),
    (3, 5, 9, 65, torch.bfloat16, None),
    (1, 5, 16, 129, torch.bfloat16, torch.bfloat16),
]


@pytest.mark.parametrize("B,ci,H,T,in_dtype,nchw_out", SCHEDULE_CASES)
def test_schedule_emulation_matches_plain(B, ci, H, T, in_dtype, nchw_out):
    x, wp, b = _inputs(B * 100 + H * 10 + T, B, ci, H, T, in_dtype)
    nchw_in = in_dtype is not None
    got = emulate_kernel(x, wp, b, nchw_in, nchw_out)
    ref = CS.conv7_layer_plain(x, wp, b, nchw_in, nchw_out)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert ref.shape == ((B, 8, H, T) if nchw_out else (B, H, T, 8))
    assert ref.dtype == (nchw_out or torch.bfloat16)
    assert bf16_ulps(got, ref) <= 1


def test_fragment_maps_cover_each_element_once():
    a_lane, a_col, b_lane, b_elem = _fragment_maps()
    assert len({(int(l), int(c)) for l, c in zip(a_lane.flatten(),
                                                 a_col.flatten())}) == 256
    # A's columns 0-7 are the pair's first tap (matrices 0, 1: lanes 0-15),
    # 8-15 its second (matrices 2, 3: lanes 16-31), rows the positions
    assert (a_lane[:, :8] < 16).all() and (a_lane[:, 8:] >= 16).all()
    assert torch.equal(a_lane[:8, :8] % 8, torch.arange(8)[:, None]
                       .expand(8, 8))
    assert torch.equal(b_lane // 4, torch.arange(8).expand(16, 8))


def test_packed_weight_as_the_kernel_reads_it(rng):
    """Word l of row (dh, p, half) holds output channel l >> 2, input
    channels 2(l & 3) and 2(l & 3) + 1 of tap dt = 2p + half."""
    w = torch.from_numpy(rng.standard_normal((8, 8, 7, 7)).astype(np.float32))
    words = CS.pack_weight(w).reshape(7, 4, 2, 32, 2)
    for dh, p, half, lane, e in [(0, 0, 0, 0, 0), (6, 3, 0, 31, 1),
                                 (2, 1, 1, 13, 0), (5, 2, 1, 22, 1)]:
        co, ci = lane >> 2, 2 * (lane & 3) + e
        assert words[dh, p, half, lane, e] == w[co, ci, dh, 2 * p + half]
    assert not words[:, 3, 1].any()


def test_stack_dtypes_and_layouts(rng):
    """NCHW in, NCHW out in the input's dtype; bf16 input runs the same
    numerics as its float32 value (rounding on load is the identity);
    any other dtype raises."""
    layers = [(torch.from_numpy(rng.standard_normal((8, ci, 7, 7))
                                .astype(np.float32) * 0.05),
               torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
              for ci in (5, 8, 8)]
    x = torch.from_numpy(rng.standard_normal((2, 5, 9, 11)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    y32 = CS.fused_convstack_plain(xb.float(), layers)
    y16 = CS.fused_convstack_plain(xb, layers)
    assert y32.shape == y16.shape == (2, 8, 9, 11)
    assert (y32.dtype, y16.dtype) == (torch.float32, torch.bfloat16)
    assert torch.equal(y32.to(torch.bfloat16), y16)
    assert torch.equal(CS.fused_convstack(xb, layers), y16)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtype"):
            CS.fused_convstack(x.to(dtype), layers)


def test_stack_packs_its_weights_once(rng, monkeypatch):
    """fused_convstack packs the whole stack once per call (pack_stack),
    whose cached gather gives pack_weight's order for every layer."""
    layers = [(torch.from_numpy(rng.standard_normal((8, ci, 7, 7))
                                .astype(np.float32)),
               torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
              for ci in (5, 8, 8)]
    for dtype in (torch.bfloat16, torch.float32):
        wp, bias = CS.pack_stack(layers, dtype)
        assert wp.shape == (3, *CS.PACKED) and wp.dtype == dtype
        assert bias.shape == (3, 8) and bias.dtype == torch.float32
        for i, (w, b) in enumerate(layers):
            assert torch.equal(wp[i], CS.pack_weight(w.to(dtype)))
            assert torch.equal(bias[i], b)
    calls = []
    orig = CS.pack_stack
    monkeypatch.setattr(CS, "pack_stack",
                        lambda *a: calls.append(len(a[0])) or orig(*a))
    CS.fused_convstack(torch.zeros(1, 5, 4, 4), layers)
    assert calls == [3]


@pytest.mark.parametrize("cin,n", [(5, 2), (5, 3), (8, 4)])
def test_chip_smoke_bytes_are_the_layers_tensors(rng, monkeypatch, cin, n):
    """chip_smoke.py's byte bounds of kernel C: each layer's is the bytes
    of the tensors that layer of fused_convstack reads and writes (float32
    NCHW in, bf16 channels-last between, float32 NCHW out), and they sum
    to the stack's."""
    import chip_smoke
    layers = [(torch.from_numpy(rng.standard_normal((8, ci, 7, 7))
                                .astype(np.float32)),
               torch.zeros(8)) for ci in (cin,) + (8,) * (n - 1)]
    moved = []
    orig = CS.conv7_layer

    def layer(x, *args):
        y = orig(x, *args)
        moved.append(x.numel() * x.element_size()
                     + y.numel() * y.element_size())
        return y
    monkeypatch.setattr(CS, "conv7_layer", layer)
    B, H, T = 2, 5, 9
    CS.fused_convstack(torch.zeros(B, cin, H, T), layers)
    assert moved == chip_smoke.layer_bytes(B, H, T, cin, n)
    assert sum(moved) == chip_smoke.stack_bytes(B, H, T, cin, n)


def _jax_stack(x_nchw, layers, chunk):
    """The JAX package's fused Pallas stack (interpret mode), NCHW."""
    folded = [(w.permute(2, 3, 1, 0).numpy(), b.numpy(),
               np.ones(8, np.float32), np.zeros(8, np.float32))
              for w, b in layers]
    x = jnp.asarray(x_nchw.permute(0, 2, 3, 1).float().numpy()).astype(
        jnp.bfloat16 if x_nchw.dtype == torch.bfloat16 else jnp.float32)
    y = CP.fused_convstack(x, folded, chunk=chunk, interpret=True)
    return np.asarray(y, np.float32).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("cin,H,T,dtype", [(5, 12, 65, torch.float32),
                                           (8, 8, 21, torch.float32),
                                           (5, 8, 30, torch.bfloat16)])
def test_plain_stack_nchw_matches_pallas_interpret(cin, H, T, dtype):
    """fused_convstack_plain, NCHW in and out in the stack's dtype,
    against CP.fused_convstack (B a multiple of 128, H of 4)."""
    g = np.random.default_rng(cin * 1000 + T)
    layers = [(torch.tensor(g.standard_normal((8, ci, 7, 7))
                            * (0.5 / np.sqrt(49 * ci)), dtype=torch.float32),
               torch.tensor(g.standard_normal(8) * 0.1, dtype=torch.float32))
              for ci in (cin, 8, 8)]
    x = torch.tensor(g.standard_normal((128, cin, H, T)), dtype=torch.float32)
    x = x.to(dtype)
    got = CS.fused_convstack_plain(x, layers)
    assert got.shape == (128, 8, H, T) and got.dtype == dtype
    got = got.float().numpy()
    ref = _jax_stack(x, layers, chunk=8)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    mean_rel = np.abs(got - ref).mean() / np.abs(ref).mean()
    assert rel < 5e-2, rel
    assert mean_rel < 1e-2, mean_rel
