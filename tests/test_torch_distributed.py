"""The port's archive sweep over a real cluster of 2 processes on the CPU.

Both processes join a ``torch.distributed`` gloo group over loopback
(``parallel.mesh.init_distributed``) and sweep the same archive: each
scans every other file on its own devices. Their merged results equal a
one-process sweep exactly, and no file is scanned twice. The same through
``audio-sweep-torch`` with ``AM_*`` set in both processes: exit code 0,
the one-process run's label files byte for byte, each file Done in exactly
one process's store. The workers import nothing of JAX.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from audio_matcher_tpu_torch.cli import sweep_cli  # noqa: E402
from audio_matcher_tpu_torch.hostio.decode import write_wav  # noqa: E402
from audio_matcher_tpu_torch.models.matcher import MatchConfig  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import sweep_archive  # noqa: E402

SR = 1000
REPO = Path(__file__).resolve().parents[1]
KW = dict(chunk_secs=1.0, distance_secs=2.0, block=256,
          fft_impl="xla_packed", peaks_impl="jnp")

WORKER = textwrap.dedent(
    """
    import json, sys
    sys.modules["jax"] = None  # the cluster path needs no JAX
    import numpy as np
    from audio_matcher_tpu_torch.models.matcher import MatchConfig
    from audio_matcher_tpu_torch.parallel.mesh import (
        init_distributed, process_count, shutdown_distributed)
    from audio_matcher_tpu_torch.parallel.sweep import sweep_archive

    coordinator, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    assert init_distributed(coordinator, 2, pid)
    try:
        assert process_count() == 2
        fx = json.load(open(outdir + "/fixtures.json"))
        snippets = [np.asarray(s, np.float32) for s in fx["snippets"]]
        results = sweep_archive(fx["paths"], snippets, fx["sr"],
                                MatchConfig(**fx["kw"]), device="cpu")
    finally:
        shutdown_distributed()
    out = {path: [[(p.position, p.height, p.prominence) for p in pk]
                  for pk in per_query]
           for path, per_query in results.items()}
    json.dump(out, open(f"{outdir}/proc{pid}.json", "w"))
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(argvs, envs):
    """Start both workers, wait for both (120 s each) and return their
    outputs; a worker that fails or hangs fails the test."""
    procs = [subprocess.Popen(argv, env=env, cwd=REPO, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for argv, env in zip(argvs, envs)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    return outs


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.update(extra)
    return env


def _archive(root):
    """Five wav files, each with one snippet planted, and two snippets."""
    rng = np.random.default_rng(21)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (SR // 2, SR // 3)]
    root.mkdir()
    paths = []
    for e in range(5):
        x = (rng.standard_normal(SR * 5) * 0.05).astype(np.float32)
        at = (e + 1) * SR // 2 + SR // 4
        x[at : at + len(snippets[e % 2])] = snippets[e % 2]
        paths.append(root / f"ep{e}.wav")
        write_wav(paths[-1], SR, x)
    for q, s in enumerate(snippets):
        write_wav(root / f"snippet{q}.wav", SR, s)
    return snippets, paths


def test_two_process_sweep_matches_single_process(tmp_path):
    snippets, paths = _archive(tmp_path / "archive")
    (tmp_path / "fixtures.json").write_text(json.dumps({
        "snippets": [s.tolist() for s in snippets],
        "paths": [str(p) for p in paths], "sr": SR, "kw": KW}))
    coordinator = f"127.0.0.1:{_free_port()}"
    _run_pair([[sys.executable, "-c", WORKER, coordinator, str(pid),
                str(tmp_path)] for pid in (0, 1)], [_env(), _env()])
    merged = {}
    for pid in (0, 1):
        part = json.loads((tmp_path / f"proc{pid}.json").read_text())
        assert list(part) == [str(p) for p in paths[pid::2]]
        assert not set(part) & set(merged), "a file scanned twice"
        merged.update(part)
    single = sweep_archive(paths, snippets, SR, MatchConfig(**KW),
                           device="cpu")
    assert set(merged) == set(single) == {str(p) for p in paths}
    for path, per_query in single.items():
        want = [[[p.position, p.height, p.prominence] for p in pk]
                for pk in per_query]
        assert merged[path] == want, path


def test_two_process_sweep_cli(tmp_path):
    """``audio-sweep-torch --device cpu`` in both processes of a cluster
    set up by ``AM_*``, each with its own ``--progress-file``."""
    _archive(tmp_path / "single")
    shutil.copytree(tmp_path / "single", tmp_path / "cluster")

    def argv(root, done):
        return [str(root / "ep*.wav"), "--snippet", str(root / "snippet0.wav"),
                "--snippet", str(root / "snippet1.wav"), "--distance", "2",
                "--chunk-size", "1", "--device", "cpu", "--progress-file",
                str(done)]

    assert sweep_cli.main(argv(tmp_path / "single",
                               tmp_path / "single.done.txt")) == 0
    coordinator = f"127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-m", "audio_matcher_tpu_torch.cli.sweep_cli"]
    outs = _run_pair(
        [cmd + argv(tmp_path / "cluster", tmp_path / f"proc{pid}.done.txt")
         for pid in (0, 1)],
        [_env(AM_COORDINATOR=coordinator, AM_NUM_PROCESSES="2",
              AM_PROCESS_ID=str(pid)) for pid in (0, 1)])
    for pid, out in enumerate(outs):  # files 0, 2, 4 and 1, 3
        assert f"scanned {3 - pid} file(s) on cpu" in out, out

    def labels(root):
        return {p.name: p.read_bytes() for p in sorted(root.glob("*.q*.txt"))}

    want = labels(tmp_path / "single")
    assert len(want) == 10 and labels(tmp_path / "cluster") == want
    done = [(tmp_path / f"proc{pid}.done.txt").read_text().splitlines()
            for pid in (0, 1)]
    names = [Path(line.rsplit(" ", 1)[0]).name for d in done for line in d]
    assert sorted(names) == [f"ep{e}.wav" for e in range(5)]  # once each
    assert all(line.endswith(" Done") for d in done for line in d)
