"""PyTorch port: the corpus loaders, label builders and synthetic corpora
against the JAX package's.

Every loader that `data/synthetic.py` builds a corpus for must list the
same files and give the same key annotations, genre vectors and
vocabularies as its JAX counterpart; the label functions must give the
same arrays; the port's synthetic writers must write the same bytes.
"""

import filecmp
import os
import warnings

import numpy as np
import pytest

from audio_key_estimation_tpu.data import loaders as jax_loaders
from audio_key_estimation_tpu.data import synthetic as jax_synth
from audio_key_estimation_tpu.utils import labels as jax_labels

from audio_key_estimation_torch.data import loaders, synthetic
from audio_key_estimation_torch.utils import labels

GS_SONGS = [("a", 440, "C major", "techno"), ("b", 523, "A minor", "hip-hop"),
            ("c", 330, "Eb minor", "trance"), ("d", 392, "G major", "house"),
            ("e", 294, "F# major", "unknown-genre"),
            ("f", 349, "Bb/Eb major", "techno")]
MTG_SONGS = [(n, f, k.lower(), g) for n, f, k, g in GS_SONGS]
W_SONGS = [("HU33", "D911-01", 440, "D:min"), ("SC06", "D911-02", 330,
                                                 "Bb:maj")]
W_SEGS = {"HU33_D911-01": [(0.0, 1.5, "D:min"), (1.5, 3.0, "A:maj")]}


def _corpora(root: str) -> dict:
    """One tree per loader family, built by the JAX package's writers;
    loader name -> (JAX loader, port loader) on it."""
    j = lambda *p: os.path.join(root, *p)  # noqa: E731
    jax_synth.make_giantsteps_corpus(j("gs"), GS_SONGS)
    jax_synth.make_giantsteps_corpus(j("mtg"), MTG_SONGS)
    jax_synth.make_winterreise_corpus(j("w"), W_SONGS, local_segments=W_SEGS)
    jax_synth.make_gtzan_corpus(j("gtzan"), [
        ("blues", "blues.00000", 440, "3"), ("rock", "rock.00001", 300, "-1"),
        ("jazz", "jazz.00002", 262, "14")])
    jax_synth.make_scraped_corpus(j("scraped"), [
        ("good song", 0.9, "Am"), ("bad song", 0.3, "C"),
        ("Eb song", 0.7, "Eb:mino"), ("Phaeleh Fallen Light", 0.95, "F")])
    jax_synth.make_guitarset_corpus(j("gset"), [
        ("02_BN1-129-Eb_solo", 311, "Eb:major"),
        ("03_Jazz2-110-Bb_comp", 233, "C:minor")])
    pairs = {
        "giantsteps_key": ("GiantStepsKeyLoader", (j("gs"),), {}),
        "winterreise": ("SchubertWinterreiseLoader", (j("w"),), {}),
        "winterreise_local": ("SchubertWinterreiseLoader", (j("w"),),
                              {"local": True}),
        "gtzan": ("GTZANLoader", (j("gtzan"),), {}),
        "keyfinder": ("KeyFinderLoader", (j("scraped"),), {}),
        "mcgill_billboard": ("McGillBillboardLoader", (j("scraped"),), {}),
        "tonality": ("TonalityClassicalDBLoader", (j("scraped"),), {}),
        "beatles": ("BeatlesLoader", (j("scraped"),), {}),
        "king_carole": ("KingCaroleLoader", (j("scraped"),), {}),
        "queen": ("QueenLoader", (j("scraped"),), {}),
        "zweieck": ("ZweieckLoader", (j("scraped"),), {}),
        "guitarset": ("GuitarSetLoader", (j("gset"),), {}),
    }
    for split in ("train", "val", "debug", "all"):
        pairs[f"giantsteps_mtg_{split}"] = (
            "GiantStepsMTGKeyLoader", (j("mtg"),), {"data_type": split})
    return {name: (getattr(jax_loaders, cls)(*a, **kw),
                   getattr(loaders, cls)(*a, **kw))
            for name, (cls, a, kw) in pairs.items()}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    return _corpora(str(tmp_path_factory.mktemp("corpora")))


LOADERS = ["giantsteps_key", "winterreise", "winterreise_local", "gtzan",
           "keyfinder", "mcgill_billboard", "tonality", "beatles",
           "king_carole", "queen", "zweieck", "guitarset",
           "giantsteps_mtg_train", "giantsteps_mtg_val",
           "giantsteps_mtg_debug", "giantsteps_mtg_all"]


@pytest.mark.parametrize("name", LOADERS)
def test_loader_matches_jax(corpora, name):
    ref, got = corpora[name]
    files = got.get_filenames()
    assert files == ref.get_filenames() and files
    assert got.size == ref.size == len(files)
    assert (got.name, list(got.keys), list(got.signature)) == (
        ref.name, list(ref.keys), list(ref.signature))
    for fn in files:
        assert got.get_key_signature(fn) == ref.get_key_signature(fn)
        g, r = got.get_genre(fn), ref.get_genre(fn)
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)


def test_loader_registry_and_vocabularies_match_jax():
    assert list(loaders.REGISTRY) == list(jax_loaders.REGISTRY)
    for key, cls in loaders.REGISTRY.items():
        ref = jax_loaders.REGISTRY[key]("/nonexistent")
        got = cls("/nonexistent")
        assert cls.__name__ == type(ref).__name__
        assert (got.name, list(got.keys), list(got.signature)) == (
            ref.name, list(ref.keys), list(ref.signature))
    fmt = (lambda n: f"{n}:maj", lambda n: f"{n}:min")
    assert loaders.keys_table(*fmt) == jax_loaders.keys_table(*fmt)
    assert loaders.A_GENRES == jax_loaders.A_GENRES
    assert "Eb:mino" in loaders.BeatlesLoader("/x").keys


def _label_cases():
    gs = loaders.GiantStepsKeyLoader("/x")
    w = loaders.SchubertWinterreiseLoader("/x")
    return [(k, gs.keys, gs.signature) for k in
            ("C major", "A minor", "Eb minor", "F# major", "Db minor",
             "G# major", "c major")] + \
        [(k, w.keys, w.signature) for k in ("D:min", "Bb:maj", "Eb:min")]


@pytest.mark.parametrize("case", range(len(_label_cases())))
def test_global_labels_match_jax(case):
    key, keys, sig = _label_cases()[case]
    with warnings.catch_warnings(record=True) as wg:
        warnings.simplefilter("always")
        got = labels.global_labels(key, keys, sig)
    with warnings.catch_warnings(record=True) as wr:
        warnings.simplefilter("always")
        ref = jax_labels.global_labels(key, keys, sig)
    assert len(wg) == len(wr)      # an unmatched key warns in both
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("segments", [
    [(0.0, 20.0, "D:min"), (20.0, 40.0, "A:maj")],
    [(1.4, 13.0, "C:maj"), (13.0, 27.5, "G:maj"), (27.5, 41.0, "E:min")],
    [(0.0, 41.0, "F:maj")],
], ids=["two", "three_offset", "one"])
@pytest.mark.parametrize("frames,window", [(5, 2), (5, 10), (2, 3)])
def test_local_labels_match_jax(segments, frames, window):
    w = loaders.SchubertWinterreiseLoader("/x")
    got = labels.local_labels(segments, w.keys, w.signature, frames, window)
    ref = jax_labels.local_labels(segments, w.keys, w.signature, frames,
                                  window)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g, r)
    assert got[3:] == ref[3:]
    np.testing.assert_array_equal(
        labels.local_window_coverage(segments, frames, window),
        jax_labels.local_window_coverage(segments, frames, window))
    for g, r in zip(labels.tiled_local_labels("D:min", w.keys, w.signature,
                                              17),
                    jax_labels.tiled_local_labels("D:min", w.keys,
                                                  w.signature, 17)):
        np.testing.assert_array_equal(g, r)


def test_synthetic_corpora_are_byte_equal(tmp_path):
    """The port's synthetic writers write the JAX package's files: sine,
    scale-walk and polyphonic (modulating) audio and the annotations."""
    def build(mod, root):
        mod.make_giantsteps_corpus(
            os.path.join(root, "gs"), MTG_SONGS[:3], scale_audio=True,
            seconds=1.5, seed_offset=3)
        mod.make_giantsteps_corpus(
            os.path.join(root, "poly"), GS_SONGS[:2],
            audio_fn=lambda p, key, i: mod.polyphonic_wav(
                p, [(0.0, 2.0, *mod.key_to_pc(key))], seed=i, timbre_id=i))
        mod.make_winterreise_corpus(
            os.path.join(root, "w"), W_SONGS, local_segments=W_SEGS,
            audio_fn=lambda p, name, segs: mod.polyphonic_wav(
                p, [(s, e, *mod.key_to_pc(k.replace(":maj", " major")
                                         .replace(":min", " minor")))
                    for s, e, k in segs], seed=7))
        mod.make_gtzan_corpus(os.path.join(root, "gtzan"),
                              [("blues", "blues.00000", 440, "3")])
        mod.make_scraped_corpus(os.path.join(root, "s"),
                                [("good song", 0.9, "Am")])
        mod.make_guitarset_corpus(os.path.join(root, "g"),
                                  [("02_BN1-129-Eb_solo", 311, "Eb:major")])
    build(synthetic, str(tmp_path / "port"))
    build(jax_synth, str(tmp_path / "jax"))
    n = 0
    for root, _, names in os.walk(tmp_path / "jax"):
        for name in names:
            ref = os.path.join(root, name)
            got = ref.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
            assert filecmp.cmp(got, ref, shallow=False), got
            n += 1
    assert n == sum(len(f) for _, _, f in os.walk(tmp_path / "port")) > 20
    np.testing.assert_array_equal(synthetic.custom_cqt(8),
                                  jax_synth.custom_cqt(8))
