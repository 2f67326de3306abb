"""PyTorch port: parallel/mesh.py against the JAX package's, the process
group's guards, and utils/profiling.py.

 * fit_data_mesh picks the JAX rule's device count for micro-batches
   1-16 over 8 devices, and the caller's with an explicit mesh_shape;
 * shard_batch puts on device i the rows the JAX P('data') sharding puts
   on the mesh's device i (batch_dim 0 and 1), and raises where the rows
   do not divide; replicate gives eval-mode copies of one state_dict;
 * rank_rows, check_mesh_shape and init_data_parallel raise where DDP
   cannot follow (a world that does not divide the micro-batch, a
   mesh_shape the group does not have, nccl or CUDA without CUDA, a
   rendezvous that never completes);
 * trace() writes a Chrome trace naming the operators it saw.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.parallel import mesh as jax_mesh

from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.parallel import mesh
from audio_key_estimation_torch.utils.profiling import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


@pytest.mark.parametrize("batch_size", range(1, 17))
def test_fit_data_mesh_matches_jax(batch_size):
    """The largest device count that divides the micro-batch, over 8."""
    want = jax_mesh.fit_data_mesh(batch_size).devices.size
    assert mesh.fit_data_mesh(batch_size, devices=CPU8).size == want


def test_fit_data_mesh_explicit_shape():
    assert jax_mesh.fit_data_mesh(6, (4,)).devices.size == 4
    got = mesh.fit_data_mesh(6, (4,), devices=CPU8)
    assert got.size == 4 and got.axis_names == ("data",)


@pytest.mark.parametrize("batch_dim", [0, 1])
def test_shard_batch_rows_match_jax(batch_dim, rng):
    """Each device's block of every array, against the JAX P('data')
    sharding over the 8-device mesh; a scalar goes whole to every
    device."""
    shape = (2, 16, 3) if batch_dim == 1 else (16, 5)
    batch = {"x": rng.normal(size=shape).astype(np.float32),
             "n": np.float32(3.0)}
    jm = jax_mesh.make_mesh()
    ours = mesh.shard_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                            mesh.make_mesh(devices=CPU8),
                            batch_dim=batch_dim)
    ref = jax_mesh.shard_batch(batch, jm, batch_dim=batch_dim)
    devices = list(jm.devices.flat)
    assert len(ours) == 8
    for shard in ref["x"].addressable_shards:
        i = devices.index(shard.device)
        np.testing.assert_array_equal(ours[i]["x"].numpy(),
                                      np.asarray(shard.data))
    for s in ours:
        assert float(s["n"]) == 3.0


def test_shard_batch_refuses_uneven_rows():
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_batch(torch.zeros(6, 2), mesh.make_mesh(devices=CPU8))


def test_make_mesh_needs_cuda_or_devices():
    """The default mesh is every CUDA device: without CUDA it raises
    rather than serving on the CPU; one axis only."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()
    with pytest.raises(ValueError, match="one 'data' axis"):
        mesh.make_mesh((2, 2), ("data", "model"), devices=CPU8)
    with pytest.raises(ValueError):
        mesh.make_mesh((9,), devices=CPU8)
    assert mesh.make_mesh((3,), devices=CPU8).size == 3


def test_replicate_gives_eval_copies_of_one_state():
    cfg = Config(octaves=3, num_layers=2, conv_layers=1, n_filters=2,
                 kernel_size=3, head_layers=1)
    model = build_model(cfg).train()
    reps = mesh.replicate(model, mesh.make_mesh(devices=CPU8[:3]))
    assert len(reps) == 3 and len({id(r) for r in reps + [model]}) == 4
    for r in reps:
        assert not r.training
        for k, v in model.state_dict().items():
            assert torch.equal(r.state_dict()[k], v), k


def test_rank_rows_and_mesh_shape():
    """Contiguous equal blocks; a world that does not divide the
    micro-batch raises (a DDP rank cannot sit out), as does a
    Config.mesh_shape the group does not have."""
    assert [mesh.rank_rows(8, r, 4) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="divide"):
        mesh.rank_rows(6, 0, 4)
    mesh.check_mesh_shape((), 4)
    mesh.check_mesh_shape((4,), 4)
    with pytest.raises(ValueError, match="mesh_shape"):
        mesh.check_mesh_shape((8,), 4)
    assert mesh.data_world() == (0, 1)


def test_init_data_parallel_refuses_without_cuda():
    """nccl, or a CUDA device, on a machine without CUDA raises before
    any rendezvous."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="nccl"):
        mesh.init_data_parallel("cpu", backend="nccl", rank=0,
                                world_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_data_parallel("cuda", rank=0, world_size=1)
    assert not torch.distributed.is_initialized()


def test_failed_rendezvous_raises_within_its_limit(tmp_path):
    """Rank 0 of 2 alone on a file:// store: init_data_parallel raises
    once its 3 s limit has passed (in a fresh interpreter, so no group
    is left behind here)."""
    code = textwrap.dedent(f"""
        import time
        from audio_key_estimation_torch.parallel.mesh import \\
            init_data_parallel
        t0 = time.monotonic()
        try:
            init_data_parallel("cpu", init_method="file://{tmp_path}/store",
                               rank=0, world_size=2, timeout_s=3)
        except RuntimeError as e:
            print("raised", time.monotonic() - t0, e)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("raised")]
    assert line, res.stdout + res.stderr
    assert 3 <= float(line[0].split()[1]) < 60


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with trace(str(tmp_path / "prof")):
        torch.mm(x, x)
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
