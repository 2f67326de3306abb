"""librosa-algorithm CQT oracle in torch float64 (test-only).

The PyTorch counterpart of the JAX package's `ops/librosa_ref.py`, on an
explicit device and batched over clips (rows of a (B, L) input). The
original repository computed its training features with ``librosa.cqt``
under librosa 0.9.2 + resampy 0.3.1; neither is a dependency here, so
this module transcribes that algorithm — ``cqt`` == ``vqt(gamma=0)`` in
0.9.2 — step for step:

  * recursive multirate evaluation: the top octave's filter bank is built
    at the current rate, the signal is halved per octave with resampy's
    kaiser windowed-sinc resampler (``kaiser_fast``/``kaiser_best``
    selected by the same filter-cutoff rule), hop halved alongside;
  * optional early downsampling by the same count rule (BW_FASTEST=0.85);
  * per octave: L1-normalized hann-windowed complex filters on the
    ``arange(-ilen//2, ilen//2)`` sample grid, padded to a pow2 n_fft,
    scaled by ``lengths/n_fft``, FFT'd, row-sparsified at quantile 0.01,
    then dotted with a rectangular-window reflect-padded STFT;
  * ``fft_basis *= sqrt(sr/my_sr)`` downsampling compensation, trim-stack,
    and the ``scale=True`` division by ``sqrt(constant_q_lengths)``.

Each resampling step returns its input's dtype, as librosa's does, so a
float32 clip is rounded to float32 after every halving; everything else
is float64 (complex128). It pins ops/cqt.py's multirate front-end against
the specific algorithm that produced the original features (frame
alignment, boundary behaviour, downsample filtering), beside the textbook
oracle in ops/cqt_oracle.py. No product module imports it.

Faithfulness caveats:
  * resampy's inner loop accumulates ``time_register += 1/ratio``; this
    transcription computes ``t / ratio`` vectorized. For the
    integer-factor resampling cqt performs (ratio 1/2**k) both are exact.
  * librosa 0.9.2 *raises* unless ``hop % 2**(n_octaves-1) == 0``
    (reproduced here), so the served geometry — hop 4410 with 8
    octaves — cannot run under it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .cqt import C1_HZ

BW_FASTEST = 0.85          # librosa.core.audio.BW_FASTEST

# resampy 0.3.1 precomputed filter parameters (resampy/filters.py data
# generation: sinc_window(num_zeros, precision, kaiser(beta), rolloff)).
_RESAMPY_FILTERS = {
    "kaiser_best": dict(num_zeros=64, precision=9,
                        rolloff=0.9475937167399596,
                        beta=14.769656459379492),
    "kaiser_fast": dict(num_zeros=16, precision=9,
                        rolloff=0.85,
                        beta=8.555504641634386),
}

class ParameterError(ValueError):
    pass


def _pad_index(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """np.pad(x, pad, mode) along the last axis for the index modes
    (reflect, symmetric, edge, wrap), repeated reflection included."""
    idx = np.pad(np.arange(x.shape[-1]), pad, mode=mode)
    return x[..., torch.as_tensor(idx, device=x.device)]


# ---------------------------------------------------------------------------
# resampy 0.3.1: kaiser windowed-sinc resampler
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _resampy_filter(name: str, device: torch.device):
    """Right half (incl. centre) of the interpolation window + num_bits."""
    p = _RESAMPY_FILTERS[name]
    num_bits = 2 ** p["precision"]
    n = num_bits * p["num_zeros"]
    t = torch.linspace(-p["num_zeros"], p["num_zeros"], 2 * n + 1,
                       dtype=torch.float64)
    sinc_win = p["rolloff"] * torch.sinc(p["rolloff"] * t)
    taper = torch.kaiser_window(2 * n + 1, periodic=False, beta=p["beta"],
                                dtype=torch.float64)
    return (taper * sinc_win)[n:].to(device), num_bits


def resampy_resample(x, sr_orig: int, sr_new: float,
                     filt: str = "kaiser_best", *, device=None
                     ) -> torch.Tensor:
    """resampy.resample along the last axis of (..., L) (core.resample_f,
    vectorized over output samples and rows), in x's dtype."""
    x = torch.as_tensor(x, device=device)
    sample_ratio = float(sr_new) / sr_orig
    n_orig = x.shape[-1]
    n_out = int(n_orig * sample_ratio)
    if n_out < 1:
        raise ParameterError("input too short to resample")
    interp_win, num_bits = _resampy_filter(filt, x.device)
    if sample_ratio < 1:
        interp_win = interp_win * sample_ratio
    interp_delta = torch.zeros_like(interp_win)
    interp_delta[:-1] = torch.diff(interp_win)

    scale = min(1.0, sample_ratio)
    index_step = int(scale * num_bits)
    nwin = interp_win.shape[0]
    xf = x.to(torch.float64)
    y = torch.zeros(*x.shape[:-1], n_out, dtype=torch.float64,
                    device=x.device)

    time_register = torch.arange(n_out, dtype=torch.float64,
                                 device=x.device) / sample_ratio
    n = time_register.to(torch.int64)
    frac = scale * (time_register - n)

    for invert in (False, True):
        wing_frac = scale - frac if invert else frac
        index_frac = wing_frac * num_bits
        offset = index_frac.to(torch.int64)
        eta = index_frac - offset
        reach = (nwin - offset) // index_step
        i_max = torch.minimum(n_orig - n - 1 if invert else n + 1, reach)
        for i in range(max(int(i_max.max()), 0)):
            # samples whose wing still reaches tap i; the others add 0
            m = i < i_max
            idx = torch.where(m, offset + i * index_step, 0)
            w = torch.where(m, interp_win[idx] + eta * interp_delta[idx], 0.0)
            src = torch.where(m, n + i + 1 if invert else n - i, 0)
            y += w * xf[..., src]
    return y.to(x.dtype)


def librosa_resample(y, orig_sr: float, target_sr: float,
                     res_type: str = "kaiser_best", fix: bool = True,
                     scale: bool = False, *, device=None) -> torch.Tensor:
    """librosa.core.audio.resample (0.9.2), resampy branch only, along
    the last axis; returns y's dtype."""
    y = torch.as_tensor(y, device=device)
    if orig_sr == target_sr:
        return y
    ratio = float(target_sr) / orig_sr
    n_samples = int(np.ceil(y.shape[-1] * ratio))
    y_hat = resampy_resample(y, orig_sr, target_sr, filt=res_type)
    if fix:  # util.fix_length: pad with zeros / truncate to n_samples
        y_hat = F.pad(y_hat, (0, n_samples - y_hat.shape[-1]))
    if scale:
        y_hat = y_hat.to(torch.float64) / np.sqrt(ratio)
    return y_hat.to(y.dtype)


# ---------------------------------------------------------------------------
# librosa 0.9.2 filter construction
# ---------------------------------------------------------------------------

def window_bandwidth_hann() -> float:
    return 1.50018310546875  # librosa.filters.WINDOW_BANDWIDTHS['hann']


def _frequencies(fmin: float, n_bins: int,
                 bins_per_octave: int) -> torch.Tensor:
    """Bin centre frequencies, computed on the host so every device
    builds the same filters."""
    return fmin * 2.0 ** (torch.arange(n_bins, dtype=torch.float64)
                          / bins_per_octave)


def constant_q_lengths(sr: float, fmin: float, n_bins: int,
                       bins_per_octave: int, filter_scale: float = 1.0, *,
                       device=None) -> torch.Tensor:
    """librosa.filters.constant_q_lengths (gamma=0): fractional lengths."""
    alpha = 2.0 ** (1.0 / bins_per_octave) - 1.0
    Q = float(filter_scale) / alpha
    freq = _frequencies(fmin, n_bins, bins_per_octave)
    if float(freq[-1]) * (1 + 0.5 * window_bandwidth_hann() / Q) > sr / 2.0:
        raise ParameterError("Filter pass-band lies beyond Nyquist")
    return (Q * sr / freq).to(device)


def constant_q(sr: float, fmin: float, n_bins: int, bins_per_octave: int,
               filter_scale: float = 1.0, *, device=None):
    """librosa.filters.constant_q (norm=1, hann, pad_fft=True).

    Returns (filters (n_bins, n_fft) complex128, float64 lengths)."""
    lengths = constant_q_lengths(sr, fmin, n_bins, bins_per_octave,
                                 filter_scale)
    freqs = _frequencies(fmin, n_bins, bins_per_octave)
    filts = []
    for ilen, freq in zip(lengths.tolist(), freqs.tolist()):
        # exact grid: arange(-ilen//2, ilen//2) on the FLOAT length
        t = torch.arange(-ilen // 2, ilen // 2, dtype=torch.float64)
        sig = torch.exp(1j * (t * 2 * np.pi * freq / sr))
        sig = sig * torch.hann_window(len(t), periodic=True,
                                      dtype=torch.float64)
        filts.append(sig / sig.abs().sum())  # util.normalize(norm=1)
    max_len = int(2.0 ** np.ceil(np.log2(max(len(f) for f in filts))))
    out = torch.zeros(n_bins, max_len, dtype=torch.complex128)
    for i, f in enumerate(filts):  # util.pad_center
        off = (max_len - len(f)) // 2
        out[i, off:off + len(f)] = f
    return out.to(device), lengths.to(device)


def sparsify_rows(x, quantile: float = 0.01, *, device=None) -> torch.Tensor:
    """librosa.util.sparsify_rows, returned dense: per row, zero the
    smallest-magnitude entries whose cumulative L1 share is < quantile."""
    x = torch.as_tensor(x, device=device)
    mags = x.abs()
    norms = mags.sum(dim=1, keepdim=True)
    mag_sort = mags.sort(dim=1).values
    cumulative = torch.cumsum(mag_sort / norms, dim=1)
    # the first index reaching the quantile (cumulative is non-decreasing)
    threshold_idx = (cumulative < quantile).sum(dim=1, keepdim=True)
    keep = mags >= mag_sort.gather(1, threshold_idx)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _cqt_filter_fft(sr: float, fmin: float, n_bins: int,
                    bins_per_octave: int, filter_scale: float,
                    sparsity: float, device):
    """librosa.core.constantq.__cqt_filter_fft (gamma=0, no hop clamp)."""
    basis, lengths = constant_q(sr, fmin, n_bins, bins_per_octave,
                                filter_scale, device=device)
    n_fft = basis.shape[1]
    basis = basis * (lengths[:, None] / float(n_fft))
    fft_basis = torch.fft.fft(basis, n=n_fft, dim=1)[:, : (n_fft // 2) + 1]
    return sparsify_rows(fft_basis, quantile=sparsity), n_fft, lengths


def _stft_ones(y: torch.Tensor, n_fft: int, hop: int,
               pad_mode: str = "reflect") -> torch.Tensor:
    """librosa.stft(window='ones', center=True): rectangular window,
    padded by n_fft//2, (1 + L//hop) frames, the full FFT's non-negative
    half (== rfft): (..., n_fft//2 + 1, T)."""
    yp = _pad_index(y.to(torch.float64), n_fft // 2, pad_mode)
    frames = yp.unfold(-1, n_fft, hop)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def _cqt_response(y, n_fft, hop, fft_basis, pad_mode) -> torch.Tensor:
    return fft_basis @ _stft_ones(y, n_fft, hop, pad_mode)


# ---------------------------------------------------------------------------
# librosa 0.9.2 cqt == vqt(gamma=0)
# ---------------------------------------------------------------------------

def _num_two_factors(x: int) -> int:
    if x <= 0:
        return 0
    n = 0
    while x % 2 == 0:
        n += 1
        x //= 2
    return n


def _early_downsample_count(nyquist, filter_cutoff, hop_length, n_octaves):
    c1 = max(0, int(np.ceil(np.log2(BW_FASTEST * nyquist / filter_cutoff))
                    - 1) - 2)
    c2 = max(0, _num_two_factors(hop_length) - n_octaves + 1)
    return min(c1, c2)


def librosa_cqt(y, sr: int, hop_length: int, n_bins: int,
                bins_per_octave: int, fmin: float = C1_HZ,
                filter_scale: float = 1.0, sparsity: float = 0.01,
                scale: bool = True, pad_mode: str = "reflect",
                res_type: str | None = None, *, device=None) -> torch.Tensor:
    """librosa.cqt 0.9.2 on (L,) or (B, L) signals -> (n_bins, T) or
    (B, n_bins, T) complex128 on `device` (the input's when None).

    tuning=0 (the original call site), norm=1, hann window. Raises
    ParameterError exactly where 0.9.2 does (Nyquist overflow, hop
    two-factor shortfall, too-short input).
    """
    y = torch.as_tensor(y, device=device)
    dev = y.device
    n_octaves = int(np.ceil(float(n_bins) / bins_per_octave))
    n_filters = min(bins_per_octave, n_bins)
    len_orig = y.shape[-1]
    alpha = 2.0 ** (1.0 / bins_per_octave) - 1.0

    freqs = fmin * 2.0 ** (np.arange(n_bins, dtype=float) / bins_per_octave)
    freqs_top = freqs[-bins_per_octave:]
    fmin_t = np.min(freqs_top)
    fmax_t = np.max(freqs_top)

    Q = float(filter_scale) / alpha
    filter_cutoff = fmax_t * (1 + 0.5 * window_bandwidth_hann() / Q)
    nyquist = sr / 2.0

    auto_resample = False
    if not res_type:
        auto_resample = True
        res_type = ("kaiser_fast" if filter_cutoff < BW_FASTEST * nyquist
                    else "kaiser_best")

    # __early_downsample (only ever fires on the kaiser_fast path)
    downsample_count = _early_downsample_count(nyquist, filter_cutoff,
                                               hop_length, n_octaves)
    if downsample_count > 0 and res_type == "kaiser_fast":
        downsample_factor = 2 ** downsample_count
        hop_length //= downsample_factor
        if y.shape[-1] < downsample_factor:
            raise ParameterError(
                f"Input signal length={len_orig} is too short")
        new_sr = sr / float(downsample_factor)
        y = librosa_resample(y, sr, new_sr, res_type=res_type, scale=True)
        if not scale:
            y = y.to(torch.float64) * np.sqrt(downsample_factor)
        sr = new_sr

    cqt_resp = []

    if auto_resample and res_type != "kaiser_fast":
        # top octave at kaiser_best quality, then drop to kaiser_fast
        fft_basis, n_fft, _ = _cqt_filter_fft(sr, fmin_t, n_filters,
                                              bins_per_octave, filter_scale,
                                              sparsity, dev)
        cqt_resp.append(_cqt_response(y, n_fft, hop_length, fft_basis,
                                      pad_mode))
        fmin_t /= 2
        fmax_t /= 2
        n_octaves -= 1
        filter_cutoff = fmax_t * (1 + 0.5 * window_bandwidth_hann() / Q)
        res_type = "kaiser_fast"

    if _num_two_factors(hop_length) < n_octaves - 1:
        raise ParameterError(
            f"hop_length must be a positive integer multiple of "
            f"2^{n_octaves - 1:d} for {n_octaves:d}-octave CQT")

    my_y, my_sr, my_hop = y, float(sr), hop_length
    for i in range(n_octaves):
        if i > 0:
            if my_y.shape[-1] < 2:
                raise ParameterError(
                    f"Input signal length={len_orig} is too short for "
                    f"{n_octaves:d}-octave CQT")
            my_y = librosa_resample(my_y, 2, 1, res_type=res_type,
                                    scale=True)
            my_sr /= 2.0
            my_hop //= 2
        fft_basis, n_fft, _ = _cqt_filter_fft(my_sr, fmin_t * 2.0 ** -i,
                                              n_filters, bins_per_octave,
                                              filter_scale, sparsity, dev)
        fft_basis = fft_basis * np.sqrt(sr / my_sr)
        cqt_resp.append(_cqt_response(my_y, n_fft, my_hop, fft_basis,
                                      pad_mode))

    # __trim_stack
    max_col = min(r.shape[-1] for r in cqt_resp)
    V = torch.empty(*y.shape[:-1], n_bins, max_col, dtype=torch.complex128,
                    device=dev)
    end = n_bins
    for r in cqt_resp:
        n_oct = r.shape[-2]
        if end < n_oct:
            V[..., :end, :] = r[..., -end:, :max_col]
        else:
            V[..., end - n_oct:end, :] = r[..., :max_col]
        end -= n_oct

    if scale:
        lengths = constant_q_lengths(sr, fmin, n_bins, bins_per_octave,
                                     filter_scale, device=dev)
        V = V / torch.sqrt(lengths)[:, None]
    return V
