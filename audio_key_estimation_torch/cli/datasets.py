"""Shared corpus wiring for the train/eval entry points: every corpus
loader rooted at cfg.data_root, and the reference's train/val/test
splits as `KeyDataset`s computed on `device` (the card by default;
without CUDA it raises unless device="cpu"). Under a data-parallel
process group every rank imports the same splits (rank 0 writes the
feature cache first, data/dataset.py) and rank 0 alone reports
progress."""

from __future__ import annotations

import os

from ..config import Config
from ..data import loaders as L
from ..data.dataset import KeyDataset
from ..parallel.mesh import data_world


def build_loaders(cfg: Config):
    root = cfg.data_root
    j = lambda *p: os.path.join(root, *p)  # noqa: E731
    return {
        "giantsteps_key": L.GiantStepsKeyLoader(j("giantsteps-key-dataset")),
        "giantsteps_mtg_key": L.GiantStepsMTGKeyLoader(
            j("giantsteps-mtg-key-dataset"), data_type="train"),
        "giantsteps_mtg_debug": L.GiantStepsMTGKeyLoader(
            j("giantsteps-mtg-key-dataset"), data_type="debug"),
        "winterreise": L.SchubertWinterreiseLoader(
            j("Schubert_Winterreise_Dataset_v1-1"), cfg.local),
        "gtzan": L.GTZANLoader(j("GTZAN")),
        "guitarset": L.GuitarSetLoader(j("GuitarSet")),
        "fsl10k": L.FSL10KLoader(j("FSL10K")),
        "tonality": L.TonalityClassicalDBLoader(j("Tonality")),
        "keyfinder": L.KeyFinderLoader(j("KeyFinder")),
        "beatles": L.BeatlesLoader(j("Beatles_Isophonics")),
        "king_carole": L.KingCaroleLoader(j("King_Carole_Isophonics")),
        "queen": L.QueenLoader(j("Queen_Isophonics")),
        "zweieck": L.ZweieckLoader(j("Zweieck_Isophonics")),
        "ultimate_songs": L.UltimateSongsLoader(j("UltimateSongs")),
        "mcgill_billboard": L.McGillBillboardLoader(j("McGill-Billboard")),
    }


def build_train_val(cfg: Config, device="cuda"):
    """The reference's train/val split."""
    ld = build_loaders(cfg)
    train = KeyDataset(genre=cfg.genre, cfg=cfg, device=device)
    val = KeyDataset(genre=cfg.genre, cfg=cfg, device=device)
    progress = data_world()[0] == 0
    if cfg.debug:
        train.import_data(ld["giantsteps_mtg_debug"], progress=progress)
        val.import_data(ld["giantsteps_mtg_debug"], progress=progress)
    else:
        train.import_data(ld["giantsteps_mtg_key"], ld["gtzan"],
                          ld["keyfinder"], ld["tonality"], ld["guitarset"],
                          ld["ultimate_songs"], progress=progress)
        val.import_data(ld["winterreise"], ld["giantsteps_key"],
                        progress=progress)
    return train, val


def build_test_sets(cfg: Config, device="cuda"):
    """The reference's evaluation sets."""
    ld = build_loaders(cfg)
    sets = {}
    for name, members in (
            ("Winterreise", ["winterreise"]),
            ("GiantSteps", ["giantsteps_key"]),
            ("Beatles", ["beatles"]),
            ("McGillBillboard", ["mcgill_billboard"]),
            ("Isophonics", ["beatles", "king_carole", "queen", "zweieck"])):
        ds = KeyDataset(genre=cfg.genre, cfg=cfg, device=device)
        ds.import_data(*[ld[m] for m in members],
                       progress=data_world()[0] == 0)
        sets[name] = ds
    return sets
