"""Dataset loaders: filename discovery + key/genre annotation parsing.

Pure-Python re-implementation of the reference's 13 tf.strings-based loaders
(KeyDataset.py:514-1234) plus the base protocol (:268-509). Each loader
carries the reference's exact `keys` (42-slot, circle-of-fifths + theoretical
spellings) and `signature` (24- or 48-slot chromatic) vocabularies — label
indices flow through `% 21` / `% 12` tricks (utils/labels.py), so slot
positions are parity-critical. The 'Eb:mino' typo in the Isophonics tables
(KeyDataset.py:1045) is preserved deliberately.

Loader protocol:
  get_filenames() -> list[str]          (sorted; shuffling is the dataset's job)
  get_key_signature(path) -> str        (or list of (start,end,key) in local mode)
  get_genre(path) -> np.ndarray (11,)   (one-hot, or zeros = missing label)
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import List, Sequence

import numpy as np

A_GENRES = ['Classical', 'Rock', 'Pop', 'Folk', 'Metal', 'Electronic',
            'Hip-Hop', 'R&B', 'Blues', 'Jazz', 'Country']

# note spellings around the circle of fifths (reference table ordering)
_CIRCLE_MAJ = ['Cb', 'Gb', 'Db', 'Ab', 'Eb', 'Bb', 'F', 'C', 'G', 'D', 'A',
               'E', 'B', 'F#', 'C#']
_THEO_MAJ = ['D#', 'G#', 'A#']
_CIRCLE_MIN = ['Ab', 'Eb', 'Bb', 'F', 'C', 'G', 'D', 'A', 'E', 'B', 'F#',
               'C#', 'G#', 'D#', 'A#']
_THEO_MIN = ['Cb', 'Db', 'Gb']
_CHROM_SHARP = ['C', 'C#', 'D', 'D#', 'E', 'F', 'F#', 'G', 'G#', 'A', 'A#', 'B']
_CHROM_FLAT = ['C', 'Db', 'D', 'Eb', 'E', 'F', 'Gb', 'G', 'Ab', 'A', 'Bb', 'B']


def keys_table(fmt_major, fmt_minor) -> List[str]:
    """42-slot keys vocabulary in the reference's ordering."""
    return ([fmt_major(n) for n in _CIRCLE_MAJ] + [''] * 3
            + [fmt_major(n) for n in _THEO_MAJ]
            + [fmt_minor(n) for n in _CIRCLE_MIN]
            + [fmt_minor(n) for n in _THEO_MIN] + [''] * 3)


def one_hot11(idx: int) -> np.ndarray:
    v = np.zeros(len(A_GENRES), np.float32)
    v[idx] = 1.0
    return v


def no_genre() -> np.ndarray:
    return np.zeros(len(A_GENRES), np.float32)


class DatasetLoader:
    """Base protocol (reference KeyDataset.py:268-316)."""

    name = "base"

    def __init__(self, dataset_loc: str):
        self.dataset_loc = dataset_loc
        self.size = -1
        self.keys: Sequence[str] = []
        self.signature: Sequence[str] = []

    def get_filenames(self) -> List[str]:
        raise NotImplementedError

    def get_key_signature(self, file_path: str):
        raise NotImplementedError

    def get_genre(self, file_path: str) -> np.ndarray:
        return no_genre()

    def _glob(self, pattern: str) -> List[str]:
        return sorted(glob.glob(os.path.join(self.dataset_loc, pattern)))


# ==========================================================================
class GiantStepsKeyLoader(DatasetLoader):
    """GiantSteps Key (KeyDataset.py:514-575)."""

    name = 'GiantSteps Key'

    GENRES = ['breaks', 'techno', 'hip-hop', 'progressive-house',
              'drum-and-bass', 'minimal', 'house', 'chill-out', 'deep-house',
              'electro-house', 'trance', 'dubstep', 'tech-house', 'hard-dance',
              'electronica', 'psy-trance', 'dj-tools', 'funk r&b',
              'glitch-hop', 'hardcore hard-techno', 'indie-dance nu-disco',
              'pop rock', 'reggae dub']
    # map subgenre index -> broad genre slot (KeyDataset.py:534)
    GENRE_IDS = [[], [], [21], [], [],
                 [0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 18, 19, 20],
                 [2], [16, 17, 22], [], [], []]

    def __init__(self, dataset_loc):
        super().__init__(dataset_loc)
        self.keys = keys_table(lambda n: f'{n} major', lambda n: f'{n} minor')
        self.signature = ([f'{n} minor' for n in _CHROM_FLAT]
                          + [f'{n} major' for n in _CHROM_FLAT])

    def get_filenames(self):
        files = self._glob('audio/*.wav')
        self.size = len(files)
        return files

    def _annotation(self, file_path, kind, ext):
        stem = os.path.splitext(os.path.basename(file_path))[0]
        root = os.path.dirname(os.path.dirname(file_path))
        return os.path.join(root, 'annotations', kind, stem + ext)

    def get_key_signature(self, file_path):
        with open(self._annotation(file_path, 'key', '.key')) as f:
            return f.read().split('\t')[0]

    def get_genre(self, file_path):
        with open(self._annotation(file_path, 'genre', '.genre')) as f:
            sub = f.read().split('\t')[0].split('\n')[0]
        sub_idx = self.GENRES.index(sub) if sub in self.GENRES else 0
        for a_idx, ids in enumerate(self.GENRE_IDS):
            if sub_idx in ids:
                return one_hot11(a_idx)
        return no_genre()


# ==========================================================================
class GiantStepsMTGKeyLoader(GiantStepsKeyLoader):
    """GiantSteps MTG Key with 70/30 train/val split (KeyDataset.py:579-621)."""

    name = 'GiantSteps MTG Key'

    GENRES = ['breaks', 'techno', 'hip-hop', 'progressive house',
              'drum & bass', 'minimal', 'house', 'chill out', 'deep house',
              'electro house', 'trance', 'dubstep', 'tech house', 'hard dance',
              'electronica', 'psy-trance', '', '', '', '', '', '', '']
    GENRE_IDS = [[], [], [], [], [],
                 [0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
                 [2], [], [], [], []]

    def __init__(self, dataset_loc, data_type='train', seed=0):
        super().__init__(dataset_loc)
        self.keys = keys_table(lambda n: f'{n.lower()} major',
                               lambda n: f'{n.lower()} minor')
        self.signature = ([f'{n.lower()} minor' for n in _CHROM_SHARP]
                          + [f'{n.lower()} major' for n in _CHROM_SHARP])
        self.type = data_type
        self.seed = seed

    def get_filenames(self):
        files = self._glob('audio/*.wav')
        # drop ambiguous annotations containing '/' (KeyDataset.py:608-611)
        files = [f for f in files if '/' not in self.get_key_signature(f)]
        rng = np.random.default_rng(self.seed)
        files = list(np.array(files)[rng.permutation(len(files))])
        cut = round(len(files) * 0.7)
        if self.type == 'train':
            files = files[:cut]
        elif self.type == 'val':
            files = files[cut:]
        elif self.type == 'debug':
            files = files[:4]
        self.size = len(files)
        return files


# ==========================================================================
class SchubertWinterreiseLoader(DatasetLoader):
    """Schubert Winterreise, global + local keys (KeyDataset.py:624-708)."""

    name = 'Schubert Winterreise'

    def __init__(self, dataset_loc, local=False):
        super().__init__(dataset_loc)
        self.keys = keys_table(lambda n: f'{n}:maj', lambda n: f'{n}:min')
        self.signature = ([f'{n}:min' for n in _CHROM_SHARP]
                          + [f'{n}:maj' for n in _CHROM_SHARP]
                          + [f'{n}:min' for n in _CHROM_FLAT]
                          + [f'{n}:maj' for n in _CHROM_FLAT])
        self.local = local
        self._global = None
        self._local = None

    def _load_global(self):
        if self._global is None:
            path = os.path.join(self.dataset_loc, '02_Annotations',
                                'ann_audio_globalkey.csv')
            table = {}
            with open(path) as f:
                for row in list(csv.reader(f, delimiter=';'))[1:]:
                    row = [c.replace('"', '').replace('\r', '') for c in row]
                    if len(row) >= 3:
                        table['_'.join(row[:2])] = row[-1]
            self._global = table
        return self._global

    def _load_local(self):
        if self._local is None:
            folder = os.path.join(self.dataset_loc, '02_Annotations',
                                  'ann_audio_localkey-ann3')
            table = {}
            for fn in sorted(os.listdir(folder)) if os.path.isdir(folder) else []:
                song = fn.replace('.csv', '')
                segs = []
                with open(os.path.join(folder, fn)) as f:
                    for row in list(csv.reader(f, delimiter=';'))[1:]:
                        row = [c.replace('"', '').replace('\r', '') for c in row]
                        if len(row) >= 3:
                            segs.append((float(row[0]), float(row[1]), row[-1]))
                table[song] = segs
            self._local = table
        return self._local

    def get_filenames(self):
        files = self._glob('01_RawData/audio_wav/*.wav')
        self.size = len(files)
        return files

    def get_key_signature(self, file_path):
        song = os.path.splitext(os.path.basename(file_path))[0]
        if self.local:
            return self._load_local()[song]
        return self._load_global()[song]

    def get_genre(self, file_path):
        return one_hot11(0)  # Classical


# ==========================================================================
class GTZANLoader(DatasetLoader):
    """GTZAN with lerch numeric key annotations (KeyDataset.py:712-775)."""

    name = 'GTZAN'

    # numeric lerch ids laid out on the reference's 39-slot circle table
    KEYS = ['', '', '', '', '', '', '8', '3', '10', '5', '0', '7', '2', '9',
            '4', '', '', '', '6', '11', '1', '', '', '', '20', '15', '22',
            '17', '12', '19', '14', '21', '16', '23', '18', '13', '', '', '']
    SIGNATURE = ['15', '16', '17', '18', '19', '20', '21', '22', '23', '12',
                 '13', '14', '3', '4', '5', '6', '7', '8', '9', '10', '11',
                 '0', '1', '2']
    GENRE_MAP = {'classical': 0, 'country': 10, 'disco': 5, 'hiphop': 6,
                 'blues': 8, 'jazz': 9, 'metal': 4, 'pop': 2, 'reggae': 7,
                 'rock': 1}

    def __init__(self, dataset_loc):
        super().__init__(dataset_loc)
        self.keys = self.KEYS
        self.signature = self.SIGNATURE

    def _keypath(self, file_path):
        genre = os.path.basename(os.path.dirname(file_path))
        name = os.path.basename(file_path).replace('.wav', '.lerch.txt')
        return os.path.join(self.dataset_loc, 'gtzan_key', 'genres', genre, name)

    def get_filenames(self):
        files = self._glob('genres_original/*/*.wav')
        files = [f for f in files if os.path.exists(self._keypath(f))
                 and self.get_key_signature(f) != '-1']
        self.size = len(files)
        return files

    def get_key_signature(self, file_path):
        with open(self._keypath(file_path)) as f:
            return f.read().strip()

    def get_genre(self, file_path):
        genre = os.path.basename(os.path.dirname(file_path))
        if genre not in self.GENRE_MAP:
            raise AssertionError('False Label!')
        return one_hot11(self.GENRE_MAP[genre])


# ==========================================================================
class YouTubeScrapedLoader(DatasetLoader):
    """Base for corpora fetched by the scraper: similarity-csv gated mp3s
    (KeyDataset.py:779-833)."""

    name = 'YouTube Scraped'
    threshold = 0.6
    max_bytes = 10_000_000
    TOO_LONG = ['Daft Punk Solar Sailer', 'The Chemical Brothers Dig Your Own Hole',
                'Phaeleh Fallen Light']

    def __init__(self, dataset_loc):
        super().__init__(dataset_loc)
        self.keys = keys_table(lambda n: n, lambda n: f'{n}m')
        self.signature = (_CHROM_SHARP + _CHROM_FLAT
                          + [f'{n}m' for n in _CHROM_SHARP]
                          + [f'{n}m' for n in _CHROM_FLAT])
        self._table = None

    def _load_table(self):
        if self._table is None:
            table = {}
            path = os.path.join(self.dataset_loc, '__youtube_similarities.csv')
            if os.path.exists(path):
                with open(path, newline='', encoding='utf-8') as f:
                    for row in csv.reader(f):
                        if len(row) >= 3:
                            table[row[0]] = (float(row[1]), row[2])
            self._table = table
        return self._table

    def _song_name(self, file_path):
        return os.path.basename(file_path).replace('.mp3', '')

    def get_filenames(self):
        files = self._glob('*.mp3')
        if self.max_bytes:
            files = [f for f in files if os.path.getsize(f) < self.max_bytes]
        table = self._load_table()
        files = [f for f in files
                 if self._song_name(f) in table
                 and table[self._song_name(f)][0] >= self.threshold
                 and self._song_name(f) not in self.TOO_LONG]
        self.size = len(files)
        return files

    def get_key_signature(self, file_path):
        return self._load_table()[self._song_name(file_path)][1]


class KeyFinderLoader(YouTubeScrapedLoader):
    name = 'KeyFinder'


class McGillBillboardLoader(YouTubeScrapedLoader):
    name = 'McGill Billboard'
    max_bytes = None  # no size filter (KeyDataset.py:894-907)


class TonalityClassicalDBLoader(YouTubeScrapedLoader):
    name = 'Tonality Classical DB'

    def get_genre(self, file_path):
        return one_hot11(0)  # Classical


def _isophonics_vocab(loader):
    """Beatles-family spellings: plain majors, ':minor' minors with the
    reference's 'Eb:mino' typo preserved (KeyDataset.py:1043-1050)."""
    loader.keys = keys_table(lambda n: n, lambda n: f'{n}:minor')
    loader.keys[loader.keys.index('Eb:minor')] = 'Eb:mino'
    loader.signature = (_CHROM_SHARP + _CHROM_FLAT
                        + [f'{n}:minor' for n in _CHROM_SHARP]
                        + [f'{n}:minor' for n in _CHROM_FLAT])


class BeatlesLoader(YouTubeScrapedLoader):
    name = 'The Beatles Dataset'

    def __init__(self, dataset_loc):
        super().__init__(dataset_loc)
        _isophonics_vocab(self)

    def get_genre(self, file_path):
        return one_hot11(1)  # Rock


class KingCaroleLoader(BeatlesLoader):
    name = 'King Carole Dataset'


class QueenLoader(BeatlesLoader):
    name = 'Queen Dataset'


class ZweieckLoader(BeatlesLoader):
    name = 'Zweieck Dataset'


# ==========================================================================
class GuitarSetLoader(DatasetLoader):
    """GuitarSet with JAMS annotations (KeyDataset.py:938-981)."""

    name = 'GuitarSet'

    def __init__(self, dataset_loc):
        super().__init__(dataset_loc)
        self.keys = keys_table(lambda n: f'{n}:major', lambda n: f'{n}:minor')
        self.signature = ([f'{n}:minor' for n in _CHROM_SHARP]
                          + [f'{n}:major' for n in _CHROM_SHARP]
                          + [f'{n}:minor' for n in _CHROM_FLAT]
                          + [f'{n}:major' for n in _CHROM_FLAT])

    def get_filenames(self):
        files = self._glob('audio_mono-mic/*.wav')
        self.size = len(files)
        return files

    def get_key_signature(self, file_path):
        name = os.path.basename(file_path).replace('_mic.wav', '.jams')
        with open(os.path.join(self.dataset_loc, 'annotations', name)) as f:
            data = json.load(f)
        return data['annotations'][-1]['data'][0]['value']


# ==========================================================================
class FSL10KLoader(DatasetLoader):
    """FSL10K loops with ac_analysis tonality (KeyDataset.py:984-1036)."""

    name = 'FSL10K'

    def __init__(self, dataset_loc):
        super().__init__(dataset_loc)
        self.keys = keys_table(lambda n: f'{n} major', lambda n: f'{n} minor')
        self.signature = ([f'{n} minor' for n in _CHROM_SHARP]
                          + [f'{n} major' for n in _CHROM_SHARP])

    def get_filenames(self):
        files = self._glob('audio/wav/*.wav')
        files = [f for f in files
                 if 400_000 < os.path.getsize(f) < 8_000_000]
        self.size = len(files)
        return files

    def get_key_signature(self, file_path):
        name = os.path.basename(file_path)
        if 'aiff' in name:
            name = name.replace('.aiff.wav', '_analysis.json')
        else:
            name = name.replace('.wav.wav', '_analysis.json')
        with open(os.path.join(self.dataset_loc, 'ac_analysis', name)) as f:
            return json.load(f)['tonality']


# ==========================================================================
class UltimateSongsLoader(DatasetLoader):
    """UltimateSongs genre/key folder tree (KeyDataset.py:1115-1234)."""

    name = 'Ultimate Songs Dataset'
    threshold = 0.8
    max_bytes = 5_000_000

    SUBFOLDERS = ["SubA", "SubA#m", "SubAb", "SubAbm", "SubAm", "SubB",
                  "SubBb", "SubBbm", "SubBm", "SubC", "SubC#", "SubC#m",
                  "SubCb", "SubCm", "SubD", "SubD#m", "SubDb", "SubDm",
                  "SubE", "SubEb", "SubEbm", "SubEm", "SubF", "SubF#",
                  "SubF#m", "SubFm", "SubG", "SubG#m", "SubGb", "SubGm"]
    GENRE_DIRS = ["Rock", "Pop", "Classical", "Metal", "Folk", "RandB",
                  "Hip-Hop"]
    PATH_GENRES = ['Classical', 'Rock', 'Pop', 'Folk', 'Metal', 'Electronic',
                   'Hip-Hop', 'RandB', 'Blues', 'Jazz', 'Country']

    def __init__(self, dataset_loc):
        super().__init__(dataset_loc)
        self.keys = keys_table(lambda n: n, lambda n: f'{n}m')
        self.signature = (_CHROM_SHARP + _CHROM_FLAT
                          + [f'{n}m' for n in _CHROM_SHARP]
                          + [f'{n}m' for n in _CHROM_FLAT])
        self._table = None

    def _csv_dirs(self):
        dirs = []
        for g in self.GENRE_DIRS:
            if g in ("Rock", "Pop"):
                dirs += [os.path.join(self.dataset_loc, g, sub)
                         for sub in self.SUBFOLDERS]
            elif g == "Classical":
                dirs.append(os.path.join(self.dataset_loc, g))
            else:
                dirs += [os.path.join(self.dataset_loc, g, f"{g}{i}")
                         for i in range(1, 4)]
        return dirs

    def _load_table(self):
        if self._table is None:
            table = {}
            for d in self._csv_dirs():
                path = os.path.join(d, '__youtube_similarities.csv')
                if os.path.exists(path):
                    with open(path, newline='', encoding='utf-8') as f:
                        for row in csv.reader(f):
                            if len(row) >= 3:
                                table[row[0]] = (float(row[1]), row[2])
            self._table = table
        return self._table

    def get_filenames(self):
        files = []
        for d in self._csv_dirs():
            files += sorted(glob.glob(os.path.join(d, '*.mp3')))
        files = [f for f in files if os.path.getsize(f) < self.max_bytes]
        table = self._load_table()
        name = lambda f: os.path.basename(f).replace('.mp3', '')  # noqa: E731
        files = [f for f in files if name(f) in table
                 and table[name(f)][0] >= self.threshold]
        self.size = len(files)
        return files

    def get_key_signature(self, file_path):
        return self._load_table()[
            os.path.basename(file_path).replace('.mp3', '')][1]

    def get_genre(self, file_path):
        for i, g in enumerate(self.PATH_GENRES):
            if g in file_path:
                return one_hot11(i)
        return no_genre()


REGISTRY = {
    'giantsteps_key': GiantStepsKeyLoader,
    'giantsteps_mtg_key': GiantStepsMTGKeyLoader,
    'winterreise': SchubertWinterreiseLoader,
    'gtzan': GTZANLoader,
    'keyfinder': KeyFinderLoader,
    'mcgill_billboard': McGillBillboardLoader,
    'tonality': TonalityClassicalDBLoader,
    'guitarset': GuitarSetLoader,
    'fsl10k': FSL10KLoader,
    'beatles': BeatlesLoader,
    'king_carole': KingCaroleLoader,
    'queen': QueenLoader,
    'zweieck': ZweieckLoader,
    'ultimate_songs': UltimateSongsLoader,
}
