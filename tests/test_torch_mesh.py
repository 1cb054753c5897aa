"""The port's device mesh and cluster join against the JAX package's
``parallel/mesh.py``, on the CPU.

``make_mesh(n, "cpu")`` has the (data, seq) shape of the JAX package's
``make_mesh(n)`` on conftest's virtual CPU devices, and of its grid rule
(``_grid_mesh``) past their count; a device may repeat; asking for more
CUDA devices than are visible raises instead of narrowing;
``init_distributed`` does nothing without ``AM_*`` and refuses a
half-configured cluster, as the JAX one does.
"""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.parallel import mesh as jax_mesh  # noqa: E402

from audio_matcher_tpu_torch.parallel import mesh  # noqa: E402


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_matches_jax(n, monkeypatch):
    got = mesh.make_mesh(n, "cpu")
    if n <= len(jax.devices()):
        want = jax_mesh.make_mesh(n).devices.shape
    else:  # the JAX grid rule on n stand-in devices
        monkeypatch.setattr(jax_mesh, "Mesh", lambda grid, names: grid)
        want = jax_mesh._grid_mesh(list(range(n)), ("data", "seq")).shape
    assert got.shape == want
    assert got.size == n and got.axis_names == ("data", "seq")
    assert got.flat == [torch.device("cpu")] * n


def test_mesh_of_a_repeated_device_is_row_major():
    m = mesh.Mesh.of(["cpu", "cuda:0", "cuda:0", "cuda:1"])
    assert m.shape == (2, 2)
    assert m.flat == [torch.device(d)
                      for d in ("cpu", "cuda:0", "cuda:0", "cuda:1")]
    assert m.devices[1] == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert m.describe() == "mesh 2 x 2 (cpu, cuda:0, cuda:0, cuda:1)"
    assert mesh.Mesh.of([torch.device("cuda", 0)] * 2).shape == (2, 1)
    with pytest.raises(ValueError, match="at least one"):
        mesh.Mesh.of([])


def test_make_mesh_refuses_devices_that_are_not_there(monkeypatch):
    """On CUDA, more devices than are visible raise naming both counts
    (the JAX package warns and narrows); nothing is allocated."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_mesh(device="cuda").flat == [torch.device("cuda", 0),
                                                  torch.device("cuda", 1)]
    assert mesh.make_local_mesh().shape == (2, 1)
    assert mesh.make_mesh(1).flat == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="4 CUDA devices.* 2 are visible"):
        mesh.make_mesh(4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    for bad in (0, -1):
        with pytest.raises(ValueError, match="positive"):
            mesh.make_mesh(bad, "cpu")
        with pytest.raises(ValueError, match="positive"):
            jax_mesh.make_mesh(bad)
    assert mesh.make_local_mesh("cpu").flat == [torch.device("cpu")]


def test_init_distributed_like_jax(monkeypatch):
    for var in ("AM_COORDINATOR", "AM_NUM_PROCESSES", "AM_PROCESS_ID",
                "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jax_mesh, "_DISTRIBUTED_INITIALIZED", False)
    assert mesh.init_distributed() is jax_mesh.init_distributed() is False
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    monkeypatch.setenv("AM_COORDINATOR", "127.0.0.1:1")
    for init in (mesh.init_distributed, jax_mesh.init_distributed):
        with pytest.raises(ValueError, match="AM_NUM_PROCESSES/AM_PROCESS_ID"):
            init()
    monkeypatch.setenv("AM_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="AM_NUM_PROCESSES/AM_PROCESS_ID"):
        mesh.init_distributed()
    assert not torch.distributed.is_initialized()
    mesh.shutdown_distributed()  # no group: nothing to leave


def test_one_process_cluster_joins_and_leaves():
    """A cluster of one process over loopback: joined, counted, left."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert mesh.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert mesh.init_distributed()  # already joined
        assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    finally:
        mesh.shutdown_distributed()
    assert not torch.distributed.is_initialized()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
