"""Device meshes and the process cluster of the port (``parallel/mesh.py``).

A :class:`Mesh` is a ``(data, seq)`` grid of torch devices, shaped as the
JAX package shapes its meshes: a wide ``data`` axis, ``seq`` = 2 when the
device count is even and at least 4. The resident scan shards a group's
episode rows over the flattened mesh (``Mesh.flat``, row-major, the order
of JAX's ``P(axes)``), and the legacy windows path places block (i, j) of
its [E, C, W] window tensor on ``devices[i][j]``. A device may repeat
(:meth:`Mesh.of`), so the sharded paths run on one card too.

Several processes form a cluster through :func:`init_distributed`, from the
same ``AM_*`` variables as the JAX package, over ``torch.distributed``'s
gloo backend: the archive sweep assigns whole files to processes and each
scans its share on its own mesh, with no collective on a device.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Sequence

import torch

log = logging.getLogger("audio_matcher_torch.mesh")

AXIS_NAMES = ("data", "seq")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, seq)`` grid of torch devices (``devices[i][j]``)."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str] = AXIS_NAMES

    @classmethod
    def of(cls, devices: Sequence) -> "Mesh":
        """The grid of ``devices`` (names or ``torch.device``; one may
        repeat), shaped as :func:`make_mesh` shapes it."""
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        n = len(devices)
        seq = 2 if n % 2 == 0 and n >= 4 else 1
        return cls(tuple(tuple(devices[i * seq : (i + 1) * seq])
                         for i in range(n // seq)))

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def flat(self) -> list[torch.device]:
        """The devices in row-major order: shard i of the flattened mesh."""
        return [d for row in self.devices for d in row]

    def describe(self) -> str:
        """The mesh's shape and devices, for the log."""
        return (f"mesh {self.shape[0]} x {self.shape[1]} "
                f"({', '.join(str(d) for d in self.flat)})")


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` devices of ``device``'s type: the first
    ``n_devices`` visible CUDA devices (default all of them), or
    ``n_devices`` shards of the one CPU device (default 1; the counterpart
    of the JAX tests' forced host device count). Asking for more CUDA
    devices than are visible raises, naming both counts: the JAX package
    warns and uses fewer, but a sweep that asked for several cards must
    not run on fewer unannounced."""
    dev = torch.device(device)
    if n_devices is not None and n_devices <= 0:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    if dev.type != "cuda":
        return Mesh.of([dev] * (n_devices or 1))
    visible = torch.cuda.device_count()
    if visible == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible")
    n = visible if n_devices is None else n_devices
    if n > visible:
        raise ValueError(f"make_mesh: {n} CUDA devices were asked for, "
                         f"{visible} are visible")
    return Mesh.of([torch.device("cuda", i) for i in range(n)])


def make_local_mesh(device="cuda") -> Mesh:
    """A mesh over this process's own devices: every CUDA device it sees
    (on a host of several cards, give each process of a cluster its own
    ``CUDA_VISIBLE_DEVICES``), or one CPU shard. The archive sweep of a
    cluster scans each process's share of the files on it."""
    return make_mesh(None, device)


def _dist():
    """``torch.distributed`` when a process group has been joined."""
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    """This process's rank in the cluster; 0 when none was joined."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def process_count() -> int:
    """The processes of the cluster; 1 when none was joined."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join a cluster of processes (BASELINE config #5 over several hosts
    or several processes of one host).

    Arguments default from ``AM_COORDINATOR`` (``host:port`` of process
    0), ``AM_NUM_PROCESSES`` and ``AM_PROCESS_ID``, as in the JAX package.
    Returns False, doing nothing, when no coordinator is configured, and
    True once the process group is up (or was already). A coordinator
    without the other two raises: a half-configured member would scan the
    whole archive alone. The group is ``torch.distributed``'s gloo backend
    over TCP on the host: the scan needs no device collective. The JAX
    package's Cloud TPU auto-detection has no counterpart. Leave the
    group with :func:`shutdown_distributed`."""
    if _dist() is not None:
        return True
    coordinator = coordinator or os.environ.get("AM_COORDINATOR")
    num_processes = num_processes or int(
        os.environ.get("AM_NUM_PROCESSES", "0"))
    process_id_env = os.environ.get("AM_PROCESS_ID")
    if process_id is None and process_id_env is not None:
        process_id = int(process_id_env)
    if not coordinator:
        return False
    if num_processes < 1 or process_id is None:
        raise ValueError(
            "AM_COORDINATOR is set but AM_NUM_PROCESSES/AM_PROCESS_ID "
            "are missing — every process in the cluster needs all three"
        )
    if "://" not in coordinator:
        coordinator = "tcp://" + coordinator
    torch.distributed.init_process_group(
        "gloo", init_method=coordinator, world_size=num_processes,
        rank=process_id,
    )
    log.info("joined distributed cluster: process %d/%d", process_index(),
             process_count())
    return True


def shutdown_distributed() -> None:
    """Leave the process group :func:`init_distributed` joined, if any."""
    if _dist() is not None:
        torch.distributed.destroy_process_group()
