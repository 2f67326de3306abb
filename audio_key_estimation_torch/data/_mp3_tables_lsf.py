"""MPEG-2 / MPEG-2.5 (LSF) Layer III constants (ISO/IEC 13818-3).

Extends the MPEG-1 decoder (data/mp3.py) to the lower-sampling-frequency
profile: 576-sample frames, one granule, 9-bit scalefac_compress with the
slen-quadruple / scalefactor-partition arithmetic below, and no preflag
bit (preflag is implied by the 500..512 scalefac_compress range).

The slen arithmetic and NR_OF_SFB partition table are spec-defined
integer arithmetic written from ISO 13818-3 2.4.3.4 (every row
self-checks: long partitions sum to 21 transmitted sfb, short to 36,
mixed to 33). The scalefactor-band boundary tables (SFB_LONG_LSF /
SFB_SHORT_LSF) are reconstructed BEHAVIORALLY from an independent
reference decoder — scripts/extract_mp3_lsf_bands.py probes libavcodec
with single-line frames under per-band scalefactor ladders and reads the
boundaries off the decoded amplitudes (same protocol and provenance as
the MPEG-1 Huffman tables, scripts/extract_mp3_tables.py) — and land in
the generated data/_mp3_bands_lsf.py. Everything is cross-validated by
the randomized differential tests in tests/test_mp3.py (MPEG-1 section)
/ test_mp3_lsf.py.

The reference consumes LSF mp3 via torchaudio (KeyDataset.py:341); this
module completes the in-tree replacement's format surface (the scraped
corpora themselves are 44.1 kHz MPEG-1).
"""

from __future__ import annotations

SR_TABLE_V2 = (22050, 24000, 16000)     # version bits 0b10
SR_TABLE_V25 = (11025, 12000, 8000)     # version bits 0b00
BITRATE_TABLE_LSF = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80,
                     96, 112, 128, 144, 160)

# scalefactor partition sizes: NR_OF_SFB[blocknumber][class] with class
# 0 = long, 1 = short, 2 = mixed (ISO 13818-3 2.4.3.4). blocknumber 0-2
# are the normal-channel ranges of scalefac_compress, 3-5 the
# intensity-stereo-channel ranges.
NR_OF_SFB = (
    ((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)),
    ((6, 5, 7, 3), (9, 9, 12, 6), (6, 9, 12, 6)),
    ((11, 10, 0, 0), (18, 18, 0, 0), (15, 18, 0, 0)),
    ((7, 7, 7, 0), (12, 12, 12, 0), (6, 15, 12, 0)),
    ((6, 6, 6, 3), (12, 9, 9, 6), (6, 12, 9, 6)),
    ((8, 8, 5, 0), (15, 12, 9, 0), (6, 18, 9, 0)),
)

for _blk in NR_OF_SFB:  # spec self-check: transmitted sfb counts
    assert sum(_blk[0]) == 21 and sum(_blk[1]) == 36 and sum(_blk[2]) == 33


def lsf_scalefactor_layout(scalefac_compress: int, is_intensity_ch: bool,
                           short: bool, mixed: bool):
    """(slens[4], nsfb[4], preflag) for one LSF granule-channel.

    `is_intensity_ch` = the right channel of an intensity-stereo frame
    (its scalefactors carry intensity positions and use the >>1'd
    compress value and blocknumbers 3-5).
    """
    cls = 2 if (short and mixed) else (1 if short else 0)
    if is_intensity_ch:
        isc = scalefac_compress >> 1
        if isc < 180:
            slens = (isc // 36, (isc % 36) // 6, isc % 6, 0)
            blk = 3
        elif isc < 244:
            i = isc - 180
            slens = (i >> 4, (i >> 2) & 3, i & 3, 0)
            blk = 4
        elif isc < 255:
            i = isc - 244
            slens = (i // 3, i % 3, 0, 0)
            blk = 5
        else:
            raise ValueError("intensity scalefac_compress out of range")
        preflag = 0
    else:
        sfc = scalefac_compress
        if sfc < 400:
            slens = ((sfc >> 4) // 5, (sfc >> 4) % 5, (sfc % 16) >> 2,
                     sfc & 3)
            blk, preflag = 0, 0
        elif sfc < 500:
            i = sfc - 400
            slens = ((i >> 2) // 5, (i >> 2) % 5, i & 3, 0)
            blk, preflag = 1, 0
        else:
            i = sfc - 500
            slens = (i // 3, i % 3, 0, 0)
            blk, preflag = 2, 1
    return slens, NR_OF_SFB[blk][cls], preflag


def lsf_sr(version_bits: int, sr_index: int) -> int:
    table = SR_TABLE_V2 if version_bits == 2 else SR_TABLE_V25
    return table[sr_index]


# behaviorally probed boundary tables (generated module); import errors
# surface as a clear message at LSF decode time, not at package import
try:
    from ._mp3_bands_lsf import SFB_LONG_LSF, SFB_SHORT_LSF  # noqa: F401
except ImportError:                                    # pragma: no cover
    SFB_LONG_LSF = None
    SFB_SHORT_LSF = None
