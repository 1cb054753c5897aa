"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` process per
source, all started together, and link into one shared library with a
plain C interface, loaded with :mod:`ctypes` (every pointer and the stream
pass as ``c_void_p``). The library lands in ``_build/`` beside this file,
named by a hash of the sources and flags, so the first call after a change
builds it and later calls reuse it. A missing ``nvcc`` or a failed build
raises: there is no other route to the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = (  # compiling each source to an object
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "am_twiddles": (_P, _I, _P),
    "am_major_fwd_wire": (_I, _P, _LL, _P, _P, _P, _I, _I, _I, _LL, _P),
    "am_major_fwd_wire2": (
        _I, _P, _LL, _P, _LL, _I, _P, _P, _P, _I, _I, _I, _LL, _P
    ),
    "am_major_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "am_major_inverse": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "am_major_clusters": (_I, _I, _I, _PI),
    "am_minor_forward": (_P, _P, _P, _P, _P, _LL, _I, _P),
    "am_minor_inverse": (_P, _P, _P, _P, _P, _LL, _I, _P),
    "am_minor_product": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "am_minor_clusters": (_I, _I, _PI),
    "am_block_reduce_packed": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P
    ),
    "am_block_reduce": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "am_peak_rounds": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I,
        _I, _I, _P
    ),
}


class KernelBuildFailure(RuntimeError):
    """The kernels could not be built or loaded."""


class _Loaded:
    lib: ctypes.CDLL | None = None
    log: str = ""
    seconds: float = 0.0
    # the scan of a mesh issues its shards from one host thread each
    lock = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then
    :data:`DEFAULT_CUDA_HOME`; raises :class:`KernelBuildFailure`."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = DEFAULT_CUDA_HOME / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise KernelBuildFailure(
        "nvcc not found (CUDA_HOME, CUDA_PATH, PATH, "
        f"{DEFAULT_CUDA_HOME}); the CUDA kernels cannot be built"
    )


def sources() -> list[Path]:
    """The sources nvcc compiles, one object each."""
    return sorted(CSRC.glob("*.cu"))


def hashed_sources() -> list[Path]:
    """The sources and their headers, whose bytes name the library (and
    which an installed package must therefore ship)."""
    return sorted(CSRC.glob("*.cu*"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in hashed_sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libam_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> tuple[list[int], str]:
    """Run the commands side by side; their return codes and output."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], "".join(outs)


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        srcs = sources()
        objs = [str(work / f"{src.stem}.o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(srcs, objs)]
        t0 = time.perf_counter()
        rcs, _Loaded.log = _run_all(cmds)
        if not any(rcs):
            lib = str(work / out.name)
            cmds = [[nvcc, *LINK_FLAGS, "-o", lib, *objs]]
            rcs, link_log = _run_all(cmds)
            _Loaded.log += link_log
        _Loaded.seconds = time.perf_counter() - t0
        bad = [(rc, cmd) for rc, cmd in zip(rcs, cmds) if rc]
        if bad:
            rc, cmd = bad[0]
            raise KernelBuildFailure(
                f"nvcc failed ({rc}): {' '.join(cmd)}\n{_Loaded.log}"
            )
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (once, whatever the number
    of threads asking)."""
    if _Loaded.lib is None:
        with _Loaded.lock:
            if _Loaded.lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _Loaded.lib = lib
    return _Loaded.lib


_capturing = threading.local()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches
    (under a lock: the shards of a mesh launch from several threads). In
    a thread inside :func:`recording_launches` the launch is recorded
    there instead: a graph capture enqueues no kernel."""
    recorded = getattr(_capturing, "counts", None)
    if recorded is not None:
        recorded[wrapper] = recorded.get(wrapper, 0) + 1
        return
    with _Loaded.lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording_launches():
    """Within, this thread's launches go to the yielded dict {wrapper:
    count} and not to the wrappers' counts (a CUDA graph's capture: the
    replays add them, :func:`add_launches`)."""
    counts: dict = {}
    _capturing.counts = counts
    try:
        yield counts
    finally:
        _capturing.counts = None


def add_launches(counts: dict) -> None:
    """Add a recorded {wrapper: count} to the wrappers' counts (a replay of
    a captured graph launches them all)."""
    with _Loaded.lock:
        for wrapper, n in counts.items():
            wrapper.launches += n


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the build this process ran, or "" when the library was already built."""
    return _Loaded.log


def build_seconds() -> float:
    return _Loaded.seconds


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
