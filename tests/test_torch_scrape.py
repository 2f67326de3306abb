"""PyTorch port: the corpus scraper (scrape/youtube.py, scrape/song_lists.py,
cli/scrape.py, byte copies of the JAX package's, pinned by
tests/test_torch_imports.py) with tests/test_cli.py:62-110's fake
backend. The live backend (yt_dlp / youtube_dl) is not installed: it
stays gated and raises, before any network use."""

import csv
import importlib.util
import os

import pytest

from audio_key_estimation_torch.cli import scrape as scrape_cli
from audio_key_estimation_torch.scrape import song_lists
from audio_key_estimation_torch.scrape.youtube import (Candidate,
                                                       best_candidate,
                                                       jaccard, scrape,
                                                       ytdlp_backend)


def test_jaccard_and_best_candidate():
    assert jaccard("Hey Jude Beatles", "beatles hey jude") == 1.0
    cands = [
        Candidate("Hey Jude (live cover)", "someone", 300, "u1"),
        Candidate("Hey Jude", "The Beatles", 240, "u2"),
        Candidate("totally different", "x", 100, "u3"),
    ]
    best, score = best_candidate("The Beatles Hey Jude", cands)
    assert best.url == "u2" and score == 1.0


def test_scrape_resume_and_threshold(tmp_path):
    dest = str(tmp_path / "out")
    searched, downloaded = [], []

    def search(song):
        searched.append(song)
        good = song.startswith("good")
        return [Candidate(song if good else "unrelated title xyz",
                          "chan", 120, f"url:{song}")]

    def download(cand, out_path):
        downloaded.append(out_path)
        with open(out_path, "wb") as f:
            f.write(b"x")

    songs = [("good one", "C"), ("bad one", "Am"), ("good two", "G")]
    n = scrape(songs, dest, search=search, download=download)
    assert n == 3
    assert len(downloaded) == 2  # 'bad one' below threshold
    with open(os.path.join(dest, "__youtube_similarities.csv")) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 3 and rows[1][2] == "Am"
    # resume: nothing new processed
    searched.clear()
    assert scrape(songs, dest, search=search, download=download) == 0
    assert searched == []


def test_song_lists_generic_and_isophonics(tmp_path):
    p = tmp_path / "list.csv"
    p.write_text('Artist One Song,C\nArtist Two Song,Am\n')
    assert song_lists.generic_csv(str(p)) == [("Artist One Song", "C"),
                                              ("Artist Two Song", "Am")]
    lab = tmp_path / "labs" / "album"
    lab.mkdir(parents=True)
    (lab / "My_Song.lab").write_text(
        "0.0 10.0 Key A\n10.0 100.0 Key E\n")
    out = song_lists.isophonics_lab_walk(str(tmp_path / "labs"))
    assert out == [("My Song", "E")]


def test_live_backend_stays_gated(tmp_path):
    """Without yt_dlp and youtube_dl the backend and the CLI raise,
    naming them, after listing the songs and before any download."""
    if any(importlib.util.find_spec(m) for m in ("yt_dlp", "youtube_dl")):
        pytest.skip("this check needs a machine without yt_dlp/youtube_dl")
    with pytest.raises(RuntimeError, match="yt_dlp"):
        ytdlp_backend()
    p = tmp_path / "list.csv"
    p.write_text("Artist One Song,C\n")
    with pytest.raises(RuntimeError, match="yt_dlp"):
        scrape_cli.main(["--source", str(p), "--destination",
                         str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
