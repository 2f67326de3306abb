"""Song-list + key extractors feeding the scraper.

Pure-Python equivalent of the reference's dataset_utility.py (tf/pandas based)
— each function returns a list of (song_title, key_string) pairs for a corpus
whose audio must be fetched from YouTube.
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple

Pair = Tuple[str, str]


def keyfinder_csv(path: str) -> List[Pair]:
    """KeyFinder list: 'Artist - Title' column + key (dataset_utility.py:10-23)."""
    out = []
    with open(path, newline='', encoding='utf-8') as f:
        for row in csv.reader(f):
            if len(row) >= 2 and row[0].strip():
                out.append((row[0].strip(), row[1].strip()))
    return out


def billboard_index(root: str) -> List[Pair]:
    """McGill Billboard: per-song salami_chords.txt headers
    (dataset_utility.py:26-49): '# title:', '# artist:', '# tonic:'."""
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        if "salami_chords.txt" not in files:
            continue
        title = artist = tonic = None
        with open(os.path.join(dirpath, "salami_chords.txt"),
                  encoding="utf-8") as f:
            for line in f:
                if line.startswith("# title:"):
                    title = line.split(":", 1)[1].strip()
                elif line.startswith("# artist:"):
                    artist = line.split(":", 1)[1].strip()
                elif line.startswith("# tonic:") and tonic is None:
                    tonic = line.split(":", 1)[1].strip()
        if title and artist and tonic:
            out.append((f"{artist} {title}", tonic))
    return out


def tonality_folder(root: str) -> List[Pair]:
    """Tonality classicalDB: key encoded in annotation filenames
    (dataset_utility.py:69-87): '<name>.key' files containing the key."""
    out = []
    keydir = os.path.join(root, "keys") if os.path.isdir(
        os.path.join(root, "keys")) else root
    for fn in sorted(os.listdir(keydir)):
        if fn.endswith(".key"):
            with open(os.path.join(keydir, fn), encoding="utf-8") as f:
                key = f.read().strip()
            out.append((os.path.splitext(fn)[0].replace("_", " "), key))
    return out


def isophonics_lab_walk(root: str) -> List[Pair]:
    """Beatles/KingCarole/Queen/Zweieck: walk keylab trees, song = file stem,
    key = majority 'Key' segment label (dataset_utility.py:89-167)."""
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if not fn.endswith(".lab"):
                continue
            best_key, best_span = None, -1.0
            with open(os.path.join(dirpath, fn), encoding="utf-8",
                      errors="replace") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 4 and parts[2] == "Key":
                        span = float(parts[1]) - float(parts[0])
                        if span > best_span:
                            best_span, best_key = span, parts[3]
                    elif len(parts) == 4 and parts[2].lower() == "key":
                        span = float(parts[1]) - float(parts[0])
                        if span > best_span:
                            best_span, best_key = span, parts[3]
            if best_key:
                title = os.path.splitext(fn)[0].replace("_", " ").strip()
                out.append((title, best_key))
    return out


def generic_csv(path: str, title_col: int = 0, key_col: int = 1) -> List[Pair]:
    """Generic two-column csv (dataset_utility.py:169-183)."""
    out = []
    with open(path, newline='', encoding='utf-8') as f:
        for row in csv.reader(f):
            if len(row) > max(title_col, key_col) and row[title_col].strip():
                out.append((row[title_col].strip(), row[key_col].strip()))
    return out
