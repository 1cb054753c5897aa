"""The port runs without JAX, and its kernel build never falls back."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from audio_matcher_tpu_torch import _build  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

_SCAN_WITHOUT_JAX = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    import numpy as np
    import audio_matcher_tpu_torch as pkg
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(mod.name)
    from audio_matcher_tpu_torch.models.matcher import (
        MatchConfig, quantize_wire)
    from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner

    sr = 8000
    rng = np.random.default_rng(3)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (4000, 3500)]
    ep = (rng.standard_normal(5 * sr) * 0.05).astype(np.float32)
    ep[2 * sr : 2 * sr + 4000] = snippets[0]
    cfg = MatchConfig(chunk_secs=1.0, transfer_dtype="mulaw8")
    scanner = ShardedScanner(snippets, sr, cfg, device="cpu")
    peaks = scanner.scan_resident([quantize_wire(ep, "mulaw8")])
    assert [p.position for p in peaks[0][0]] == [2 * sr], peaks
    one = ShardedScanner(snippets[:1], sr, cfg, device="cpu").scan_resident(
        [ep])
    assert [p.position for p in one[0][0]] == [2 * sr], one
    found = pkg.match(snippets[0], ep, sr, device="cpu", chunk_secs=1.0,
                      transfer_dtype="mulaw8")
    assert [p.position for p in found] == [2 * sr], found
    small = pkg.match(snippets[0][:1000], ep[:3 * sr], sr, device="cpu",
                      chunk_secs=0.25)  # fft_len < 2^14: xla_packed
    assert max(small, key=lambda p: p.height).position == 2 * sr, small
    for fft_impl, peaks_impl in (("vpu", "jnp"), ("xla", "jnp"),
                                 ("xla", "pallas")):
        got = pkg.match(snippets[0], ep, sr, device="cpu", chunk_secs=1.0,
                        fft_impl=fft_impl, peaks_impl=peaks_impl)
        assert [p.position for p in got] == [2 * sr], (fft_impl, got)

    # the sweep CLI over a wav directory, with a resume store
    import tempfile
    from pathlib import Path
    from audio_matcher_tpu_torch.cli import sweep_cli
    from audio_matcher_tpu_torch.hostio.decode import write_wav
    from audio_matcher_tpu_torch.hostio.labels import read_labels
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        write_wav(d / "intro.wav", sr, snippets[0])
        for e in range(3):
            x = (rng.standard_normal(6 * sr) * 0.05).astype(np.float32)
            for at in (1, 4):
                x[at * sr : at * sr + 4000] = snippets[0]
            write_wav(d / f"ep{e}.wav", sr, x)
        argv = [str(d / "ep*.wav"), "--snippet", str(d / "intro.wav"),
                "--chunk-size", "1", "--distance", "2", "--device", "cpu",
                "--progress-file", str(d / ".done.txt"), "--group-size", "2"]
        assert sweep_cli.main(argv) == 0
        for e in range(3):
            got = [(lb.start, lb.end) for lb in read_labels(d / f"ep{e}.txt")]
            assert got == [(4.0, 4.0)], got  # plants 3 s apart: clamped
        assert (d / ".done.txt").read_text().count("Done") == 3

        # spectrogram mode over the same files, one resampled on the CPU
        # device by the torch polyphase path
        from audio_matcher_tpu_torch.hostio.decode import resample
        from audio_matcher_tpu_torch.models.spectrogram import (
            SpectrogramConfig)
        from audio_matcher_tpu_torch.parallel.sweep import sweep_archive
        x = (rng.standard_normal(12 * sr) * 0.05).astype(np.float32)
        x[5 * sr : 5 * sr + 4000] += snippets[0]
        write_wav(d / "ep_16k.wav", 2 * sr, resample(
            x, sr, 2 * sr, impl="device", device="cpu"))
        got = sweep_archive(
            sorted(d.glob("ep*.wav")), snippets[:1], sr, device="cpu",
            mode="spectrogram", resample_mismatched=True,
            spectrogram_config=SpectrogramConfig(
                distance_secs=2.0, resample_impl="device", min_score=0.5))
        assert len(got) == 4, got
        for path, per_query in got.items():
            want = [5 * sr] if "16k" in path else [sr, 4 * sr]
            assert [p.position // 256 for p in per_query[0]] == [
                w // 256 for w in want], (path, per_query)
    # the worker against the port's fake Audacity on those labels' format,
    # then the archive CLI over what it filed
    import contextlib, io, os, shutil
    from audio_matcher_tpu_torch.cli import archive_cli
    from audio_matcher_tpu_torch.cli.common import Inputs
    from audio_matcher_tpu_torch.hostio.labels import TimeLabel, write_labels
    from audio_matcher_tpu_torch.meta.tagger import TaggedFile, Title
    from audio_matcher_tpu_torch.worker.fake_audacity import FakeAudacity
    from audio_matcher_tpu_torch.worker.pipeline import WorkerArgs, run_worker
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        os.environ["AUDACITY_PIPE_DIR"] = str(d / "pipes")
        work, archive = d / "work", d / "archive"
        (archive / "Serie").mkdir(parents=True)
        (archive / "Serie" / "index.txt").write_text("Eins\\nZwei\\n")
        work.mkdir()
        audio = work / "radio-2024_01_06.wav"
        write_wav(audio, sr, ep)
        write_labels([TimeLabel(10.0 * i + 1, 10.0 * i + 9, f"Segment {i}")
                      for i in range(1, 5)], audio.with_suffix(".txt"))
        for name in ("Serie 1 Eins", "Serie 2 Zwei"):
            (work / f"{name}.mp3").write_bytes(b"\\xff\\xfb\\x90\\x00" + bytes(413))
        server = FakeAudacity(d / "pipes")
        try:
            run_worker(WorkerArgs(audio_paths=[audio], index_folder=archive,
                                  timeout=5),
                       inputs=Inputs(script=["", "Serie 1", "Serie 1",
                                             "Serie 2", "Serie 2", "", ""]))
        finally:
            server.stop()
        moved = archive / "Serie" / "Serie 2 Zwei.mp3"
        assert TaggedFile.from_path(moved).get(Title) == "Zwei"
        shutil.copy(audio.with_suffix(".txt"), archive)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert archive_cli.main([str(archive), "--config",
                                     str(d / "a.toml"), "-y",
                                     "--silent"]) == 0
        assert out.getvalue().splitlines() == [
            "Serie", "\\t1 - Eins [radio - 2024-01-06]",
            "\\t2 - Zwei [radio - 2024-01-06]"], out.getvalue()
    # the sharded paths on a mesh of CPU shards
    from audio_matcher_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, "cpu")
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                   for m in sys.modules if sys.modules[m] is not None)
    assert "audio_matcher_tpu" not in sys.modules
    print("OK")
    """
)


def test_port_imports_and_scans_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCAN_WITHOUT_JAX],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_jax_import_in_port_sources():
    for path in (REPO / "audio_matcher_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (
                words[:1] in (["import"], ["from"])
                and len(words) > 1
                and words[1].split(".")[0] in ("jax", "jaxlib",
                                               "audio_matcher_tpu")
            ), f"{path}: {line}"


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """An environment where no nvcc can be found and nothing is built."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("CUDA_PATH", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "none")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build._Loaded, "lib", None)


def test_missing_nvcc_raises(no_nvcc):
    with pytest.raises(_build.KernelBuildFailure, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(_build.KernelBuildFailure):
        _build.load()
    assert not (_build.BUILD_DIR).exists()


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build._Loaded, "lib", None)
    with pytest.raises(_build.KernelBuildFailure, match="no compiler here"):
        _build.load()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_sources_and_flags(monkeypatch):
    name = _build.library_path().name
    assert name.startswith("libam_kernels_") and name.endswith(".so")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path().name != name
    assert {p.name for p in _build.sources()} == {
        "fft_major.cu", "fft_minor.cu", "block_reduce.cu", "peak_rounds.cu"
    }
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_launch_error_raises():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        _build.check(98, "am_minor_forward")
