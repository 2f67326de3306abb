"""The command line: it names the cell it cannot find, refuses a machine
without the card, and fails in a checkout that holds only the benchmark."""

import json
import shutil
import subprocess
import sys


def run(cwd, *args):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def no_result(out) -> bool:
    last = (out.stdout.strip().splitlines() or [""])[-1]
    try:
        json.loads(last)
    except ValueError:
        return True
    return False


def test_unknown_workload_fails_with_a_message(repo):
    out = run(repo, "--workload", "no.such.cell", "--seed", "1",
              "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and no_result(out)
    assert "unknown workload 'no.such.cell'" in out.stderr


def test_no_card_no_result(repo, monkeypatch):
    import torch
    if torch.cuda.is_available():
        return   # the refusal is for machines without the card
    out = run(repo, "--workload", "default.resident", "--seed", "1",
              "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and no_result(out)
    assert "CUDA" in out.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(repo, tmp_path):
    shutil.copy(repo / "BENCHMARK.json", tmp_path)
    shutil.copytree(repo / "benchmark", tmp_path / "benchmark")
    out = run(tmp_path, "--workload", "default.resident", "--seed",
              "2147483659", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and no_result(out)
