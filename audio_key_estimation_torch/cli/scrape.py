"""Scraper CLI (reference youtube_scraper.py:273-305).

    python -m audio_key_estimation_tpu.cli.scrape \
        --source songlist.csv --destination Dataset [--kind keyfinder|csv|...]
"""

from __future__ import annotations

import argparse

from ..scrape import song_lists
from ..scrape.youtube import scrape, ytdlp_backend

KINDS = {
    "csv": song_lists.generic_csv,
    "keyfinder": song_lists.keyfinder_csv,
    "billboard": song_lists.billboard_index,
    "tonality": song_lists.tonality_folder,
    "isophonics": song_lists.isophonics_lab_walk,
}


def main(argv=None):
    parser = argparse.ArgumentParser(description="YouTube corpus scraper")
    parser.add_argument("--source", required=True,
                        help="song list csv / corpus annotation root")
    parser.add_argument("--destination", required=True)
    parser.add_argument("--kind", choices=sorted(KINDS), default="csv")
    parser.add_argument("--threshold", type=float, default=0.6)
    args = parser.parse_args(argv)

    songs = KINDS[args.kind](args.source)
    print(f"{len(songs)} songs listed from {args.source}")
    search, download = ytdlp_backend()
    n = scrape(songs, args.destination, search=search, download=download,
               threshold=args.threshold)
    print(f"processed {n} songs")


if __name__ == "__main__":
    main()
