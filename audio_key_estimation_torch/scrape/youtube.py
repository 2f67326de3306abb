"""YouTube corpus scraper (reference youtube_scraper.py).

Searches YouTube per (song, key) pair, scores candidate titles by Jaccard
token similarity (uploader name included), downloads the best match as mp3
when the score clears the threshold, and appends every decision to
``__youtube_similarities.csv`` — the file the scraped-corpus loaders gate on
(KeyDataset.py:783-787). Resume = skip the first len(csv) songs
(youtube_scraper.py:248-250).

The YouTube backend (yt_dlp / youtube_dl) is gated: this module is fully
testable with an injected fake backend, and raises a clear error when used
live without the dependency.
"""

from __future__ import annotations

import csv
import os
import re
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple


def tokenize(title: str) -> set:
    return {t for t in re.split(r"[^a-z0-9]+", title.lower()) if t}


def jaccard(a: str, b: str) -> float:
    ta, tb = tokenize(a), tokenize(b)
    if not ta or not tb:
        return 0.0
    return len(ta & tb) / len(ta | tb)


@dataclass
class Candidate:
    title: str
    uploader: str
    duration: float
    url: str
    filesize: Optional[int] = None


def best_candidate(song: str, candidates: Sequence[Candidate],
                   max_bytes: int = 10_000_000) -> Tuple[Optional[Candidate], float]:
    """Pick the most similar candidate (youtube_scraper.py:128-167):
    score = max(jaccard(song, title), jaccard(song, uploader + ' ' + title));
    on near-ties (both >= 0.9) prefer the shorter video; size-capped."""
    best, best_score = None, -1.0
    for c in candidates:
        if c.filesize and c.filesize > max_bytes:
            continue
        score = max(jaccard(song, c.title),
                    jaccard(song, f"{c.uploader} {c.title}"))
        if score > best_score or (score >= 0.9 and best_score >= 0.9
                                  and best is not None
                                  and c.duration < best.duration):
            best, best_score = c, score
    return best, max(best_score, 0.0)


def scrape(songs: Sequence[Tuple[str, str]], destination: str, *,
           search: Callable[[str], List[Candidate]],
           download: Callable[[Candidate, str], None],
           threshold: float = 0.6, max_retries: int = 5,
           csv_name: str = "__youtube_similarities.csv") -> int:
    """Run the scrape loop; returns number of songs processed this call.

    search/download are injected (live backend: `ytdlp_backend()`).
    """
    os.makedirs(destination, exist_ok=True)
    csv_path = os.path.join(destination, csv_name)
    done = 0
    if os.path.exists(csv_path):
        with open(csv_path, newline='', encoding='utf-8') as f:
            done = sum(1 for _ in csv.reader(f))
    processed = 0
    for song, key in list(songs)[done:]:
        candidates = search(song)
        cand, score = best_candidate(song, candidates)
        with open(csv_path, "a", newline='', encoding='utf-8') as f:
            csv.writer(f).writerow([song, f"{score:.4f}", key])
        if cand is not None and score > threshold:
            for attempt in range(max_retries):
                try:
                    download(cand, os.path.join(destination, f"{song}.mp3"))
                    break
                except Exception as e:  # retry loop (youtube_scraper.py:196-210)
                    print(f"download failed ({e}); retry {attempt + 1}",
                          flush=True)
                    time.sleep(1.0)
        processed += 1
    return processed


def ytdlp_backend():
    """Live backend using yt_dlp/youtube_dl (gated import)."""
    try:
        import yt_dlp as ytd
    except ImportError:
        try:
            import youtube_dl as ytd
        except ImportError as e:
            raise RuntimeError(
                "scraping requires yt_dlp or youtube_dl (not installed in "
                "this environment)") from e

    def search(song: str) -> List[Candidate]:
        with ytd.YoutubeDL({"quiet": True}) as y:
            info = y.extract_info(f"ytsearch2:{song}", download=False)
        out = []
        for e in info.get("entries", []):
            out.append(Candidate(
                title=e.get("title", ""), uploader=e.get("uploader", ""),
                duration=e.get("duration", 1e9) or 1e9,
                url=e.get("webpage_url", ""), filesize=e.get("filesize")))
        return out

    def download(cand: Candidate, out_path: str):
        opts = {
            "format": "bestaudio/best",
            "outtmpl": os.path.splitext(out_path)[0] + ".%(ext)s",
            "postprocessors": [{"key": "FFmpegExtractAudio",
                                "preferredcodec": "mp3",
                                "preferredquality": "192"}],
            "quiet": True,
        }
        with ytd.YoutubeDL(opts) as y:
            y.download([cand.url])

    return search, download
