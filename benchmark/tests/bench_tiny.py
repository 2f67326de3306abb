"""Tiny cells for the CPU tests: the real cells' configurations, limits
and code on a few short clips."""

import json
import shutil
from pathlib import Path

TINY_MIXES = {
    "tiny_resident": {"kind": "resident", "sr": 22050, "batch": 3,
                      "batches": 2, "seconds_min": 50, "seconds_max": 60,
                      "bucket_seconds": 60},
    "tiny_files": {"kind": "files", "sr": 22050, "corpus": 4, "album": 2,
                   "seconds_min": 40, "seconds_max": 60,
                   "sample_every": 2},
    "tiny_train": {"kind": "train", "sr": 22050, "songs": 8,
                   "seconds": [6, 9], "batch_size": 2, "acc_grad": 2,
                   "check_steps": 3},
}
# tiny cell: (configuration, mix, the real cell whose limits it takes)
TINY_CELLS = {
    "tiny.default.resident": ("pcn_default", "tiny_resident",
                              "default.resident"),
    "tiny.multi_scale.resident": ("pcn_multi_scale", "tiny_resident",
                                  "multi_scale.resident"),
    "tiny.default.files": ("pcn_default", "tiny_files", "default.files"),
    "tiny.default.train": ("pcn_default", "tiny_train", "default.train"),
}


def add_tiny_cells(root: Path) -> None:
    """Add the tiny cells, their mixes and limits to a checkout copy; each
    reports the metrics of the real cell it stands for."""
    home = root / "benchmark"
    for name, mix in TINY_MIXES.items():
        (home / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, (config, mix, real) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1, "why": "t"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
        shutil.copy(home / "limits" / f"{real}.json",
                    home / "limits" / f"{cell}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
