"""Hard-benchmark convergence runs on the CUDA card.

The port of the JAX package's `scripts/train_converge_hard_tpu.py`, on
the port's Trainer, KeyDataset, loaders, labels and metrics. Four
phases over the polyphonic corpus (synthetic.polyphonic_wav: diatonic
triad walks + melody, per-song timbres with train/val DISJOINT timbre
ids, colored-noise bed, percussive distractors, tempo/velocity jitter):

  global        flagship PitchClassNet, one key per song (GiantSteps
                layout)
  local         per-window keys on MODULATING songs (Winterreise layout
                with 2-3 key segments per song)
  local_masked  local, with straddling windows masked out of the
                training loss (straddle_weight=0)
  multi_scale   two-scale ensemble on the global corpus

Success bar (per phase): untrained (epoch -1) val MIREX near chance
(< 0.2), best > 0.9, with the full correct/fifths/relative/parallel/
other breakdown per epoch. Writes converge_cuda/CONVERGE_<PHASE>
[_BF16][_W<n>][_PILOT].md (the JAX script's names, in a directory of
their own). Run on the card, one phase a process:

    python -m audio_key_estimation_torch.scripts.train_converge_hard \
        global [--pilot] [--seed 0] [--device cpu]

AKX_DTYPE=bfloat16 trains in bf16 (float32 weights and optimizer),
AKX_LOC_WINDOW sets the local window in seconds (default 10),
AKX_PILOT_EPOCHS the pilot's epochs (default 6). Without CUDA it
raises unless the CPU is asked for (--device cpu). --seed is the fit's
seed (default 0, the JAX script's).

Corpora are cached under `akx_hard_corpus_torch` in the temporary
directory (/tmp unless TMPDIR says otherwise), each split written once
and marked `.done`; the songs are rendered by a pool of processes
(data/render_pool.py), byte for byte as a serial render writes them. The
same seeds, keys, timbres and segments as the JAX script's give the same
WAVs.
"""
import argparse
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..config import Config
from ..data import loaders, synthetic
from ..data.dataset import KeyDataset
from ..train.trainer import Trainer, resolve_device
from .harness import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(REPO, "converge_cuda")

NOTE = ["C", "Db", "D", "Eb", "E", "F", "Gb", "G", "Ab", "A", "Bb", "B"]
KEYS_GLOBAL = [f"{n} {m}" for m in ("major", "minor") for n in NOTE]
# Winterreise-format spellings present in the loader vocabulary
_WR_MAJ = ["C", "Db", "D", "Eb", "E", "F", "F#", "G", "Ab", "A", "Bb", "B"]
_WR_MIN = ["C", "C#", "D", "Eb", "E", "F", "F#", "G", "G#", "A", "Bb", "B"]
KEYS_WR = ([f"{n}:maj" for n in _WR_MAJ], [f"{n}:min" for n in _WR_MIN])

# the port's own root: on the plain path its feature sidecars carry the
# JAX package's names, so a shared root would mix the packages' features
CORPUS_ROOT = os.path.join(tempfile.gettempdir(), "akx_hard_corpus_torch")
SECONDS = 60.0
TRAIN_TIMBRES = list(range(8))         # train instruments
VAL_TIMBRES = [100, 101, 102, 103, 104, 105]  # val — DISJOINT
PHASES = ("global", "local", "local_masked", "multi_scale")
CATEGORIES = ("correct", "fifths", "relative", "parallel", "other")


def _wr_key_to_pc(key: str):
    note, mode = key.split(":")
    return synthetic.NOTE_PC[note.lower()], mode == "min"


def _workers() -> int:
    return len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else os.cpu_count() or 1


def render_songs(jobs, workers=None) -> None:
    """synthetic.polyphonic_wav(path, segments, seed=, timbre_id=) for
    each (path, segments, seed, timbre_id) job: by data/render_pool.py's
    pool of `workers` spawned processes (default: one per CPU this
    process may run on), in an interpreter of its own, or here when one
    worker is asked for. Every song is rendered from its own seed, so the
    files equal a serial render's byte for byte."""
    workers = min(len(jobs), workers or _workers())
    if workers <= 1:
        for path, segs, seed, timbre in jobs:
            synthetic.polyphonic_wav(path, segs, seed=seed, timbre_id=timbre)
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "jobs.pkl")
        with open(path, "wb") as f:
            pickle.dump(jobs, f)
        subprocess.run([sys.executable, "-m",
                        "audio_key_estimation_torch.data.render_pool", path,
                        str(workers)], check=True, env=env)


def build_global_corpus(pilot: bool, root: str = CORPUS_ROOT,
                        per_key=None, seconds=None):
    """One key per song over all 24 keys: per_key (train, val) copies of
    each key, (10, 2) or (2, 1) for a pilot, of `seconds` (60, pilot 30).
    Returns the train and val roots."""
    per_tr, per_va = per_key or ((2, 1) if pilot else (10, 2))
    sec = seconds or (30.0 if pilot else SECONDS)
    roots = {}
    for tag, n_per_key, timbres, seed0 in (
            ("tr", per_tr, TRAIN_TIMBRES, 0),
            ("va", per_va, VAL_TIMBRES, 500_000)):
        split = os.path.join(root, f"global_{tag}{'_p' if pilot else ''}")
        done = os.path.join(split, ".done")
        roots[tag] = split
        if os.path.exists(done):
            continue
        songs = [(f"{tag}{i}", 0.0, KEYS_GLOBAL[i % 24], "techno")
                 for i in range(n_per_key * 24)]
        jobs = []

        def audio(path, key, idx, _s0=seed0, _tim=timbres, _sec=sec):
            pc, minor = synthetic.key_to_pc(key)
            # timbre index DECORRELATED from key: idx % 24 is the key, and
            # len(timbres) divides 24, so a plain idx % len(timbres) would
            # render every song of a key with one fixed instrument; idx +
            # idx // 24 walks the timbre list across the copies of each key
            jobs.append((path, [(0.0, _sec, pc, minor)], _s0 + idx,
                         _tim[(idx + idx // 24) % len(_tim)]))

        t0 = time.time()
        synthetic.make_giantsteps_corpus(split, songs, audio_fn=audio)
        render_songs(jobs)
        open(done, "w").close()
        print(f"generated {len(songs)} songs at {split} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return roots["tr"], roots["va"]


def build_local_corpus(pilot: bool, root: str = CORPUS_ROOT, songs=None,
                       seconds=None):
    """Modulating polyphonic songs with per-segment key CSVs: songs
    (train, val), (240, 32) or (12, 6) for a pilot, of `seconds` (90,
    pilot 30). The rng draws come in the JAX script's order, so the
    keys, segments, seeds and timbres are its own."""
    n_tr, n_va = songs or ((12, 6) if pilot else (240, 32))
    # longer songs + widely separated boundaries: a 10s window overlapping
    # a modulation is intrinsically ambiguous, so segment length controls
    # the achievable ceiling, not the task's difficulty
    sec = seconds or (30.0 if pilot else 90.0)
    maj, mnr = KEYS_WR
    roots = {}
    for tag, n_songs, timbres, seed0 in (
            ("tr", n_tr, TRAIN_TIMBRES, 0),
            ("va", n_va, VAL_TIMBRES, 700_000)):
        split = os.path.join(root, f"local_{tag}{'_p' if pilot else ''}")
        done = os.path.join(split, ".done")
        roots[tag] = split
        if os.path.exists(done):
            continue
        rng = np.random.default_rng(seed0 + 12345)
        song_list, segments = [], {}
        for i in range(n_songs):
            name = ("HU33", f"D911-{tag}{i:03d}")
            base_minor = bool(rng.integers(0, 2))
            base_pc = int(rng.integers(0, 12))
            # modulation chain: fifth up/down, relative, or parallel
            n_seg = int(rng.integers(2, 4))
            # boundaries in the middle band, separated by >= 2/9 of the
            # song (20 s at the full 90 s length)
            min_sep = sec * 2.0 / 9.0
            while True:
                bounds = np.sort(rng.uniform(0.22, 0.78, n_seg - 1)) * sec
                if n_seg < 3 or np.diff(bounds).min() >= min_sep:
                    break
            times = [0.0] + [float(b) for b in bounds] + [sec]
            segs, pc, minor = [], base_pc, base_minor
            for s in range(n_seg):
                if s > 0:
                    move = rng.choice(["fifth_up", "fifth_down", "relative",
                                       "parallel"])
                    if move == "fifth_up":
                        pc = (pc + 7) % 12
                    elif move == "fifth_down":
                        pc = (pc + 5) % 12
                    elif move == "relative":
                        pc, minor = ((pc + 9) % 12, True) if not minor \
                            else ((pc + 3) % 12, False)
                    else:
                        minor = not minor
                key = mnr[pc] if minor else maj[pc]
                segs.append((times[s], times[s + 1], key))
            song_list.append((*name, 0.0, segs[0][2]))
            segments["_".join(name)] = segs
        tim = {f"{p}_{s}": timbres[i % len(timbres)]
               for i, (p, s, _, _) in enumerate(song_list)}
        seeds = {f"{p}_{s}": seed0 + i
                 for i, (p, s, _, _) in enumerate(song_list)}
        jobs = []

        def audio(path, name, segs, _tim=tim, _seeds=seeds):
            psegs = [(s0, s1, *_wr_key_to_pc(k)) for s0, s1, k in segs]
            jobs.append((path, psegs, _seeds[name], _tim[name]))

        t0 = time.time()
        synthetic.make_winterreise_corpus(split, song_list,
                                          local_segments=segments,
                                          seconds=sec, audio_fn=audio)
        render_songs(jobs)
        open(done, "w").close()
        print(f"generated {len(song_list)} modulating songs at {split} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return roots["tr"], roots["va"]


def make_config(phase: str, pilot: bool, epochs=None, **overrides) -> Config:
    """The JAX script's Config for `phase`, with fused_convstack on (the
    validation runs kernel C where its gate takes a stack, as serving
    does); `overrides` replace fields (the tests' narrow widths)."""
    # local: early stop monitors val_loss, which bottoms out ~10 epochs
    # before val MIREX stops climbing on the modulating corpus
    is_local = phase.startswith("local")
    if epochs is None:
        epochs = (int(os.environ.get("AKX_PILOT_EPOCHS", 6)) if pilot
                  else (80 if is_local else 30))
    cfg = Config(octaves=8, num_layers=2, conv_layers=3, n_filters=4,
                 kernel_size=7, head_layers=2,
                 batch_size=8 if pilot else 16, acc_grad=1,
                 epochs=epochs, frames=5, bucket_sizes=(512,), no_ckpt=True,
                 early_stop_patience=(epochs if pilot
                                      else 25 if is_local else 10),
                 lr=3e-4, reg=1e-4,
                 local=is_local,
                 # local_masked: straddling windows out of the TRAINING
                 # loss; validation still scores every valid window
                 straddle_weight=0.0 if phase == "local_masked" else 1.0,
                 multi_scale=(phase == "multi_scale"),
                 dtype=os.environ.get("AKX_DTYPE", "float32"),
                 loc_window_size=int(os.environ.get("AKX_LOC_WINDOW", 10)),
                 fused_convstack=True)
    return cfg.replace(**overrides)


def report_path(phase: str, cfg: Config, pilot: bool,
                out_dir: str = OUT_DIR) -> str:
    return os.path.join(out_dir, f"CONVERGE_{phase.upper()}"
                        + ("_BF16" if cfg.dtype == "bfloat16" else "")
                        + (f"_W{cfg.loc_window_size}"
                           if cfg.local and cfg.loc_window_size != 10 else "")
                        + ("_PILOT" if pilot else "") + ".md")


def device_line(device) -> str:
    """The card's name and power limit (nvidia-smi), or `cpu`."""
    return card_line() if device.type == "cuda" else "cpu"


def run_phase(phase: str, pilot: bool = False, *, device="cuda",
              corpus_root: str = CORPUS_ROOT, out_dir: str = OUT_DIR,
              sizes=None, seconds=None, epochs=None, seed: int = 0,
              **overrides) -> dict:
    """Write the phase's corpus (unless marked done), import it, fit from
    `seed` with the epoch -1 evaluation and write the report. `sizes`
    are per-key copies (global) or songs (local) for train and val;
    `seconds`, `epochs` and Config `overrides` shrink a run for the
    tests. Returns the history, the report's path and the walls."""
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} is not one of {PHASES}")
    device = resolve_device(device)
    cfg = make_config(phase, pilot, epochs, **overrides)
    dev = device_line(device)
    print(f"[{phase}] training on {dev} ({device})", flush=True)
    is_local = cfg.local

    t0 = time.time()
    if is_local:
        tr_root, va_root = build_local_corpus(pilot, corpus_root, sizes,
                                              seconds)
        tr_loader = loaders.SchubertWinterreiseLoader(tr_root, local=True)
        va_loader = loaders.SchubertWinterreiseLoader(va_root, local=True)
    else:
        tr_root, va_root = build_global_corpus(pilot, corpus_root, sizes,
                                               seconds)
        tr_loader = loaders.GiantStepsKeyLoader(tr_root)
        va_loader = loaders.GiantStepsKeyLoader(va_root)
    gen_s = time.time() - t0

    t0 = time.time()
    train_ds = KeyDataset(genre=False, cfg=cfg, blacklist_path="",
                          use_cache=True, device=device)
    train_ds.import_data(tr_loader, progress=False)
    val_ds = KeyDataset(genre=False, cfg=cfg, blacklist_path="",
                        use_cache=True, device=device)
    val_ds.import_data(va_loader, progress=False)
    prep_s = time.time() - t0
    print(f"[{phase}] corpus gen {gen_s:.0f}s, preprocess {prep_s:.0f}s "
          f"for {len(train_ds)}+{len(val_ds)} songs", flush=True)

    trainer = Trainer(cfg, train_ds, val_ds, device=device, use_mesh=False)
    t0 = time.time()
    _, history = trainer.fit(seed=seed, eval_at_start=True)
    fit_s = time.time() - t0

    best = max(h.get("val_mirex", 0.0) for h in history)
    ep0 = history[0].get("val_mirex", float("nan"))  # epoch -1: untrained
    sec = seconds or (30.0 if pilot else 90.0 if is_local else SECONDS)
    lines = [
        f"# Hard-benchmark convergence: {phase}",
        "",
        f"Device: **{dev}** (`{device}`)"
        + (" — PILOT RUN (reduced corpus/epochs)" if pilot else ""),
        f"Corpus: {len(train_ds)} train / {len(val_ds)} val polyphonic "
        f"songs ({sec:.0f}s), "
        "diatonic triad walks + melody + "
        "colored-noise bed + percussion, per-song tempo/velocity jitter, "
        f"train timbres {TRAIN_TIMBRES} vs val timbres {VAL_TIMBRES} "
        "(disjoint; within each split the timbre walks across the copies "
        "of every key, so timbre is decorrelated from key). "
        + ("Songs modulate mid-song (2-3 key segments, per-window labels)."
           if is_local else "One key per song, all 24 keys."),
        *(["Training loss MASKS straddling windows (straddle_weight=0); "
           "validation scores all valid windows."]
          if phase == "local_masked" else []),
        f"Flagship geometry, bs {cfg.batch_size}, lr {cfg.lr}, "
        f"{cfg.epochs} epochs"
        + (", bf16 compute (f32 weights/optimizer)"
           if cfg.dtype == "bfloat16" else "")
        + (", two-scale ensemble (36+12 bins/oct)."
           if phase == "multi_scale" else "."),
        "",
        "| epoch | train_loss | val_loss | val_mirex | correct | fifths "
        "| relative | parallel | other |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for h in history:
        lines.append(
            f"| {h['epoch']} | {h.get('train_loss', float('nan')):.4f} | "
            f"{h.get('val_loss', float('nan')):.4f} | "
            f"{h.get('val_mirex', 0.0):.4f} | "
            + " | ".join(f"{h.get('val_' + c, 0.0):.3f}" for c in CATEGORIES)
            + " |")
    lines += [
        "",
        f"Untrained (epoch -1) val MIREX **{ep0:.4f}** "
        "(chance ≈ 0.104 over 24 keys); "
        f"best **{best:.4f}**. Wall: fit {fit_s / 60:.1f} min, "
        f"preprocess {prep_s:.0f}s, corpus render {gen_s:.0f}s ({dev}).",
        "",
        f"The port (PyTorch) on `{device}`, seed {seed}; validation "
        "through kernel C where its gate takes a stack (fused_convstack). "
        "Two fits on a CUDA card differ in the last bits (cuDNN's backward "
        "sums in a run-dependent order), so a rerun reproduces the curve, "
        "not its digits.",
    ]
    out = report_path(phase, cfg, pilot, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"[{phase}] epoch0 {ep0:.4f} best {best:.4f}; wrote {out}",
          flush=True)
    return {"history": history, "report": out, "cfg": cfg, "ep0": ep0,
            "best": best, "gen_s": gen_s, "prep_s": prep_s, "fit_s": fit_s,
            "train": len(train_ds), "val": len(val_ds), "device": dev}


def parse_report(path: str) -> list:
    """The epoch table of a report written by run_phase, as rows of
    floats keyed as the history's (epoch, train_loss, val_loss,
    val_mirex, val_correct, ...)."""
    keys = ("epoch", "train_loss", "val_loss", "val_mirex",
            *(f"val_{c}" for c in CATEGORIES))
    rows = []
    for line in open(path):
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == len(keys) and cells[0].lstrip("-").isdigit():
            rows.append({k: (int(v) if k == "epoch" else float(v))
                         for k, v in zip(keys, cells)})
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("phase", nargs="?", default="global", choices=PHASES)
    p.add_argument("--pilot", action="store_true",
                   help="reduced corpus and epochs (AKX_PILOT_EPOCHS)")
    p.add_argument("--seed", type=int, default=0, help="the fit's seed")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    a = p.parse_args(argv)
    run_phase(a.phase, a.pilot, device=a.device, seed=a.seed)


if __name__ == "__main__":
    main(sys.argv[1:])
