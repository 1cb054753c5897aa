"""The port's CLIs against the JAX package's, on the CPU.

``audio-matcher-torch`` and ``audio-sweep-torch`` (``--device cpu``)
against ``audio-matcher`` and ``audio-sweep`` on copies of the same wav
fixtures: label files byte for byte, the "Offset i:" log lines, the
``.done.txt`` store (paths aside) and the exit codes, for each
``--transfer``, ``-o``, ``--no-out``, ``--dry-run``, ``--skip-existing``
and several ``--snippet``s. Both CLIs resolve ``auto`` to ``xla_packed`` +
``jnp`` here. Then the port's own behaviour: the whole-second duration tag
does not shorten the overlap, what is not ported fails through the error
boundary naming its ROADMAP item, a missing CUDA device is refused, and
``--xprof`` writes a trace that holds the port's spans, for the matcher
and for a sweep.
"""

import json
import logging
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.cli import matcher_cli as jax_matcher  # noqa: E402
from audio_matcher_tpu.cli import sweep_cli as jax_sweep  # noqa: E402

from audio_matcher_tpu_torch import __version__  # noqa: E402
from audio_matcher_tpu_torch.cli import common, matcher_cli, sweep_cli  # noqa: E402
from audio_matcher_tpu_torch.hostio.decode import write_wav  # noqa: E402

SR = 8000
TOL = 1.2e-5


@pytest.fixture
def fixtures(tmp_path):
    """intro.wav and two episodes (plants at 5 s and 30 s; at 12 s and
    41 s), copied into ``jax/`` and ``port/``."""
    rng = np.random.default_rng(1234)
    snippet = (rng.standard_normal(2 * SR) * 0.2).astype(np.float32)
    src = tmp_path / "src"
    src.mkdir()
    write_wav(src / "intro.wav", SR, snippet)
    for name, plants in (("episode", (5.0, 30.0)), ("second", (12.0, 41.0))):
        episode = (rng.standard_normal(50 * SR) * 0.02).astype(np.float32)
        for off in plants:
            i = int(off * SR)
            episode[i : i + len(snippet)] = snippet
        write_wav(src / f"{name}.wav", SR, episode)
    for side in ("jax", "port"):
        shutil.copytree(src, tmp_path / side)
    return tmp_path


def _offsets(caplog):
    return [r.getMessage() for r in caplog.records if "Offset" in r.getMessage()]


def _split(line):
    """"Offset i: hh:mm:ss with prominence p" → (the text before p, p)."""
    head, prom = line.rsplit(" ", 1)
    return head, float(prom)


def _same_run(got, want):
    """Equal exit codes and offset lines; prominences (printed in full)
    within the reference's 1.2e-5."""
    assert got[0] == want[0]
    assert [_split(a)[0] for a in got[1]] == [_split(b)[0] for b in want[1]]
    for a, b in zip(got[1], want[1]):
        assert abs(_split(a)[1] - _split(b)[1]) <= TOL


def _both_matchers(root, args, caplog):
    """Run the JAX and the port matcher CLI with ``args`` ({d}: the side's
    directory); their exit codes and "Offset" lines."""
    out = {}
    for side, mod, extra in (("jax", jax_matcher, []),
                             ("port", matcher_cli, ["--device", "cpu"])):
        caplog.clear()
        argv = [a.format(d=root / side) for a in args] + extra
        with caplog.at_level(logging.INFO):
            rc = mod.run(mod.build_parser().parse_args(argv))
        out[side] = (rc, _offsets(caplog))
    return out


def _same_files(root, names):
    for name in names:
        jax_file, port_file = root / "jax" / name, root / "port" / name
        assert jax_file.exists() == port_file.exists(), name
        if jax_file.exists():
            assert port_file.read_bytes() == jax_file.read_bytes(), name


@pytest.mark.parametrize("transfer", ["float32", "int16", "mulaw8"])
def test_matcher_cli_matches_jax(fixtures, transfer, caplog):
    got = _both_matchers(fixtures, [
        "{d}/episode.wav", "{d}/second.wav", "--snippet", "{d}/intro.wav",
        "--distance", "10", "--chunk-size", "10", "--transfer", transfer,
    ], caplog)
    _same_run(got["port"], got["jax"])
    rc, offsets = got["port"]
    assert rc == 0 and len(offsets) == 4
    assert "00:00:05" in offsets[0] and "00:00:41" in offsets[3]
    _same_files(fixtures, ["episode.txt", "second.txt"])
    text = (fixtures / "port" / "episode.txt").read_text()
    assert text == "12.000000\t30.000000\tSegment 1\n"


def test_matcher_cli_output_flags_match_jax(fixtures, caplog, capsys):
    """-o (and its one-file rule), --no-out, --dry-run, --skip-existing."""
    common_args = ["--snippet", "{d}/intro.wav", "--distance", "10",
                   "--chunk-size", "10"]
    got = _both_matchers(fixtures, ["{d}/episode.wav", "-o", "{d}/o.txt"]
                         + common_args, caplog)
    _same_run(got["port"], got["jax"])
    assert got["port"][0] == 0
    _same_files(fixtures, ["o.txt", "episode.txt"])
    assert not (fixtures / "port" / "episode.txt").exists()
    got = _both_matchers(fixtures, ["{d}/episode.wav", "{d}/second.wav",
                                    "-o", "{d}/o2.txt"] + common_args, caplog)
    assert got["port"] == got["jax"] == (1, [])
    got = _both_matchers(fixtures, ["{d}/second.wav", "--no-out"]
                         + common_args, caplog)
    _same_run(got["port"], got["jax"])
    assert len(got["port"][1]) == 2
    _same_files(fixtures, ["second.txt"])
    assert not (fixtures / "port" / "second.txt").exists()
    capsys.readouterr()
    got = _both_matchers(fixtures, ["{d}/second.wav", "--dry-run"]
                         + common_args, caplog)
    printed = capsys.readouterr().out
    _same_run(got["port"], got["jax"])
    assert printed.count("19.000000\t41.000000\tSegment 1") == 2
    assert not (fixtures / "port" / "second.txt").exists()
    for side in ("jax", "port"):
        (fixtures / side / "second.txt").write_text("sentinel\n")
    got = _both_matchers(fixtures, ["{d}/second.wav", "--skip-existing"]
                         + common_args, caplog)
    assert got["port"] == got["jax"] == (0, [])
    assert (fixtures / "port" / "second.txt").read_text() == "sentinel\n"


def test_sweep_cli_matches_jax(fixtures):
    """Two snippets (``.q0.txt``, ``.q1.txt``), a progress file, and a
    rerun that resumes with nothing left to scan."""
    for side in ("jax", "port"):
        d = fixtures / side
        outro = np.random.default_rng(9).standard_normal(SR) * 0.2
        write_wav(d / "outro.wav", SR, outro.astype(np.float32))
    rcs = {}
    for side, mod, extra in (("jax", jax_sweep, ["--devices", "1"]),
                             ("port", sweep_cli, ["--device", "cpu"])):
        d = fixtures / side
        argv = [str(d / "*e*.wav"), "--snippet", str(d / "intro.wav"),
                "--snippet", str(d / "outro.wav"), "--distance", "10",
                "--chunk-size", "10", "--progress-file", str(d / ".done.txt"),
                "--group-size", "1"] + extra
        ns = mod.build_parser().parse_args(argv)
        rcs[side] = (mod.run(ns), mod.run(ns))
    assert rcs["port"] == rcs["jax"] == (0, 0)
    _same_files(fixtures, [f"{n}.q{q}.txt" for n in ("episode", "second")
                           for q in (0, 1)])
    assert (fixtures / "port" / "episode.q0.txt").read_text() == (
        "12.000000\t30.000000\tSegment 1\n")
    done = {side: (fixtures / side / ".done.txt").read_text().replace(
        str(fixtures / side), "") for side in ("jax", "port")}
    assert done["port"] == done["jax"] == "/episode.wav Done\n/second.wav Done\n"


def test_matcher_cli_overlap_survives_whole_second_tag(tmp_path, caplog):
    """The snippet's duration tag caches WHOLE seconds, shorter than the
    decoded mp3 (codec delay and padding): the overlap clamps to the
    decoded length, so a match across a chunk boundary keeps its full
    prominence on a warm tag cache."""
    from audio_matcher_tpu_torch.hostio.decode import (
        audio_duration,
        encode_audio,
        native_available,
        read_audio,
    )

    if not native_available("mp3_encode"):
        pytest.skip("no native mp3 encoder")
    rng = np.random.default_rng(1234)
    snippet = (rng.standard_normal(2 * SR) * 0.2).astype(np.float32)
    snip_path = tmp_path / "intro.mp3"
    encode_audio(snip_path, SR, snippet)
    _, snip_decoded = read_audio(snip_path)
    assert len(snip_decoded) > 2 * SR
    audio_duration(snip_path)  # warm the tag cache: 2 whole seconds
    assert audio_duration(snip_path) == 2.0
    episode = (rng.standard_normal(50 * SR) * 0.02).astype(np.float32)
    at = int(29.95 * SR)  # straddles the 30 s chunk boundary
    episode[at : at + len(snip_decoded)] = snip_decoded
    write_wav(tmp_path / "episode.wav", SR, episode)
    with caplog.at_level(logging.INFO):
        rc = matcher_cli.run(matcher_cli.build_parser().parse_args([
            str(tmp_path / "episode.wav"), "--snippet", str(snip_path),
            "--no-out", "--distance", "10", "--chunk-size", "10",
            "--device", "cpu"]))
    assert rc == 0
    offsets = _offsets(caplog)
    assert len(offsets) == 1, offsets
    assert float(offsets[0].rsplit("prominence", 1)[1]) > 0.9, offsets


def test_cli_boundaries(fixtures, monkeypatch, caplog, capsys):
    """``--devices 2`` sweeps on a mesh of two CPU shards and logs it, in
    both modes; a CUDA device that is not there is refused through the
    error boundary (nothing falls back to the CPU); both CLIs log the path
    that ran; --version."""
    monkeypatch.setattr(common, "init_logger", lambda args: None)
    d = fixtures / "port"
    base = [str(d / "episode.wav"), "--snippet", str(d / "intro.wav"),
            "--distance", "10", "--chunk-size", "10"]
    mesh = "mesh 2 x 1 (cpu, cpu)"
    cases = [
        (sweep_cli, base + ["--device", "cpu", "--devices", "2", "--no-out"],
         0, "scanned 1 file(s) on " + mesh),
        (sweep_cli, base + ["--device", "cpu", "--devices", "2", "--mode",
                            "spectrogram", "--no-out"],
         0, f"sweep: {mesh}, spectrogram mode"),
        # same rate: the resampler is never asked
        (matcher_cli, base + ["--device", "cpu", "--resample-impl",
                              "device", "--resample", "--no-out"], 0, None),
    ]
    if not torch.cuda.is_available():
        cases += [(matcher_cli, base, 1, "no CUDA device"),
                  (sweep_cli, base, 1, "no CUDA device")]
    for mod, argv, want_rc, needle in cases:
        caplog.clear()
        with caplog.at_level(logging.INFO):
            rc = mod.main(argv)
        assert rc == want_rc, argv
        if needle is not None:
            assert any(needle in r.getMessage() for r in caplog.records), (
                needle, [r.getMessage() for r in caplog.records])
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert sweep_cli.main(base + ["--device", "cpu", "--no-out"]) == 0
    assert any("device cpu, fft_impl xla_packed, peaks_impl jnp, the "
               "kernels' plain PyTorch versions" in r.getMessage()
               for r in caplog.records)
    for mod, prog in ((matcher_cli, "audio-matcher-torch"),
                      (sweep_cli, "audio-sweep-torch")):
        with pytest.raises(SystemExit):
            mod.main(["--version"])
        assert capsys.readouterr().out.strip() == f"{prog} {__version__}"


def _span_names(trace):
    """The port's spans in a chrome trace: its ``cpu_op`` ranges named
    ``audio_matcher.*``."""
    return {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
            if e.get("cat") == "cpu_op"
            and e.get("name", "").startswith("audio_matcher.")}


def test_matcher_cli_resamples_and_profiles(fixtures, tmp_path, caplog):
    """--resample (scipy) matches a snippet across rates; --xprof writes a
    torch.profiler chrome trace per file, with the port's spans."""
    d = fixtures / "port"
    rng = np.random.default_rng(4)
    snippet = (rng.standard_normal(SR) * 0.2).astype(np.float32)
    write_wav(d / "intro4k.wav", SR // 2, snippet[::2])
    with caplog.at_level(logging.INFO):
        rc = matcher_cli.run(matcher_cli.build_parser().parse_args([
            str(d / "episode.wav"), "--snippet", str(d / "intro4k.wav"),
            "--no-out", "--distance", "10", "--chunk-size", "10",
            "--device", "cpu", "--xprof", str(tmp_path / "trace")]))
    assert rc == 1  # the rates differ and --resample was not given
    caplog.clear()
    with caplog.at_level(logging.INFO):
        rc = matcher_cli.run(matcher_cli.build_parser().parse_args([
            str(d / "episode.wav"), "--snippet", str(d / "intro.wav"),
            "--no-out", "--distance", "10", "--chunk-size", "10",
            "--device", "cpu", "--xprof", str(tmp_path / "trace")]))
    assert rc == 0 and len(_offsets(caplog)) == 2
    trace = tmp_path / "trace" / "episode.trace.json"
    assert trace.stat().st_size > 0
    assert {"audio_matcher.stage", "audio_matcher.collect.peaks"} <= (
        _span_names(trace))
    write_wav(d / "ep4k.wav", SR // 2,
              np.zeros(20 * SR // 2, np.float32))
    caplog.clear()
    with caplog.at_level(logging.INFO):
        rc = matcher_cli.run(matcher_cli.build_parser().parse_args([
            str(d / "ep4k.wav"), "--snippet", str(d / "intro.wav"),
            "--no-out", "--resample", "--device", "cpu"]))
    assert rc == 0
    assert any("matcher at 4000 Hz" in r.getMessage() for r in caplog.records)


def test_sweep_cli_profiles(fixtures, tmp_path):
    """--xprof writes one chrome trace of the whole sweep, with the port's
    spans of each group."""
    d = fixtures / "port"
    rc = sweep_cli.run(sweep_cli.build_parser().parse_args([
        str(d / "*e*.wav"), "--snippet", str(d / "intro.wav"), "--no-out",
        "--distance", "10", "--chunk-size", "10", "--group-size", "1",
        "--device", "cpu", "--xprof", str(tmp_path / "trace")]))
    assert rc == 0
    assert [p.name for p in (tmp_path / "trace").iterdir()] == [
        "sweep.trace.json"]
    names = _span_names(tmp_path / "trace" / "sweep.trace.json")
    assert {"audio_matcher.stage", "audio_matcher.stage.fill",
            "audio_matcher.dispatch", "audio_matcher.collect",
            "audio_matcher.collect.peaks"} <= names
