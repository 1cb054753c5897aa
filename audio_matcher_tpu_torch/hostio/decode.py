"""Host decode: media files → mono PCM numpy arrays (f32 or the int16 wire).

The reference's ``read_mp3`` semantics: mono downmix
``(l+r)*0.5*PCM_FACTOR`` with ``PCM_FACTOR = 1/(2^16-1)``. WAV decodes in
Python; mp3 and opus go through the C++ runtime ``native/am_native.cpp``
(mpg123 and opus, opened at run time), compiled with g++ on first use into
this package's ``_build/`` and loaded with :mod:`ctypes`. Without the
native library, WAV still decodes and mp3/opus raise :class:`DecodeError`.

``resample`` runs scipy's polyphase filter on the host; the device
resampler is ROADMAP P6, and until then ``impl="auto"`` means scipy.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import math
import os
import subprocess
import threading
import wave
from pathlib import Path

import numpy as np

from ..models.matcher import quantize_wire

log = logging.getLogger("audio_matcher_torch.decode")

PCM_FACTOR = np.float32(1.0 / ((1 << 16) - 1))

SRC_PATH = Path(__file__).resolve().parents[2] / "native" / "am_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


class DecodeError(RuntimeError):
    pass


def native_path() -> Path:
    """The native library for this source and these flags."""
    h = hashlib.sha256(SRC_PATH.read_bytes() if SRC_PATH.exists() else b"")
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libam_native_{h.hexdigest()[:16]}.so"


def _build_native(out: Path) -> bool:
    if not SRC_PATH.exists():
        return False
    # a temp name, then an atomic rename: the prefetch threads and other
    # processes must never load a half-written library
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC_PATH), "-ldl"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return True
    except Exception as exc:  # depends on the toolchain
        log.warning("couldn't build the native decoder: %s", exc)
        try:
            tmp.unlink()
        except OSError:
            pass
        return False


class _Native:
    lib = None  # None: not tried yet; False: unavailable
    lock = threading.Lock()


def _native():
    """The native host-IO library (built on first use), or None.
    Thread-safe: the prefetch workers race here on first use."""
    if _Native.lib is None:
        with _Native.lock:
            if _Native.lib is None:
                _Native.lib = _load_native() or False
    return _Native.lib or None


def _load_native():
    path = native_path()
    if not path.exists() and not _build_native(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        log.warning("couldn't load the native decoder: %s", exc)
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.am_last_error.restype = ctypes.c_char_p
    for fn in ("am_decode_mp3", "am_decode_opus"):
        getattr(lib, fn).argtypes = [
            ctypes.c_char_p, ctypes.POINTER(f32p), i64p, i32p]
    for fn in ("am_encode_mp3", "am_encode_opus"):
        getattr(lib, fn).argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int32]
    lib.am_free.argtypes = [f32p]
    lib.am_decode_mp3_i16.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(i16p), i64p, i32p]
    lib.am_free_i16.argtypes = [i16p]
    lib.am_mp3_duration.argtypes = [ctypes.c_char_p, i64p, i32p]
    return lib


def _error(lib) -> DecodeError:
    return DecodeError(lib.am_last_error().decode(errors="replace"))


def native_available(what: str = "mp3") -> bool:
    lib = _native()
    if lib is None:
        return False
    probe = {
        "mp3": lib.am_has_mp3_decode,
        "opus": lib.am_has_opus,
        "mp3_encode": lib.am_has_mp3_encode,
        "mp3_duration": lib.am_has_mp3_duration,
    }[what]
    return bool(probe())


def mp3_duration_probe(path: str | Path) -> float:
    """mp3 duration from a frame-header scan, without decoding (the
    reference's ``mp3-duration`` stage). Raises :class:`DecodeError` when
    the native library is unavailable or the scan fails."""
    lib = _native()
    if lib is None:
        raise DecodeError("native mp3 duration probe unavailable")
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    if lib.am_mp3_duration(str(path).encode(), ctypes.byref(n),
                           ctypes.byref(sr)) != 0:
        raise _error(lib)
    if sr.value <= 0:
        raise DecodeError(f"bad sample rate from duration probe: {sr.value}")
    return n.value / sr.value


def _native_decode(fn_name: str, path: Path, i16: bool = False):
    lib = _native()
    if lib is None:
        raise DecodeError(
            f"native decoder unavailable; can't decode {path} "
            "(build native/am_native.cpp or use .wav)"
        )
    ctype = ctypes.c_int16 if i16 else ctypes.c_float
    out = ctypes.POINTER(ctype)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = getattr(lib, fn_name)(
        str(path).encode(), ctypes.byref(out), ctypes.byref(n),
        ctypes.byref(sr),
    )
    if rc != 0:
        raise _error(lib)
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        (lib.am_free_i16 if i16 else lib.am_free)(out)
    return int(sr.value), arr


def _wav_frames(path: Path):
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width != 2:
        raise DecodeError(f"only 16-bit WAV supported, got {8 * width}-bit")
    if ch not in (1, 2):
        raise DecodeError(f"unsupported channel count {ch}")
    return sr, ch, np.frombuffer(raw, dtype="<i2")


def read_wav(path: Path) -> tuple[int, np.ndarray]:
    """16-bit PCM WAV → mono f32 with the reference's downmix scaling."""
    sr, ch, frames = _wav_frames(path)
    data = frames.astype(np.float32)
    if ch == 2:
        return sr, (data[0::2] + data[1::2]) * np.float32(0.5) * PCM_FACTOR
    return sr, data * PCM_FACTOR


def write_wav(path: Path, sr: int, mono: np.ndarray) -> None:
    """Inverse of :func:`read_wav`, duplicating mono to stereo."""
    i16 = np.clip(
        np.asarray(mono, np.float32) / PCM_FACTOR, -32768, 32767
    ).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.repeat(i16, 2).tobytes())


def read_audio(path: str | Path) -> tuple[int, np.ndarray]:
    """Decode a wav, mp3 or opus file → (sample_rate, f32 mono samples)."""
    path = Path(path)
    ext = path.suffix.lower()
    if not path.exists():
        raise FileNotFoundError(f"couldn't open file at path {path}")
    if ext == ".wav":
        return read_wav(path)
    if ext == ".mp3":
        return _native_decode("am_decode_mp3", path)
    if ext in (".opus", ".ogg"):
        return _native_decode("am_decode_opus", path)
    raise DecodeError(f"unsupported audio format {ext!r} for {path}")


def encode_audio(path: str | Path, sr: int, mono: np.ndarray) -> None:
    """Encode mono f32 (reference scale) to wav, mp3 or opus."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".wav":
        write_wav(path, sr, mono)
        return
    lib = _native()
    if lib is None:
        raise DecodeError("native encoder unavailable")
    data = np.ascontiguousarray(mono, np.float32)
    ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if ext == ".mp3":
        rc = lib.am_encode_mp3(str(path).encode(), ptr, len(data), sr)
    elif ext in (".opus", ".ogg"):
        rc = lib.am_encode_opus(str(path).encode(), ptr, len(data), sr)
    else:
        raise DecodeError(f"unsupported encode format {ext!r}")
    if rc != 0:
        raise _error(lib)


def read_audio_int16(path: str | Path) -> tuple[int, np.ndarray]:
    """Decode to the mono int16 wire grid ((l+r)/2, rounded half away from
    zero, as the native decoder rounds); the ×1/65535 scale is applied on
    the device. Other formats decode to f32 and quantize."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".mp3" and _native() is not None:
        return _native_decode("am_decode_mp3_i16", path, i16=True)
    if ext == ".wav":
        sr, ch, frames = _wav_frames(path)
        data = frames.astype(np.int32)
        if ch == 2:
            v = data[0::2] + data[1::2]
            return sr, (np.sign(v) * ((np.abs(v) + 1) // 2)).astype(np.int16)
        return sr, data.astype(np.int16)
    sr, samples = read_audio(path)
    return sr, quantize_wire(samples, "int16")


RESAMPLE_IMPLS = ("auto", "scipy", "device")


def resample(
    samples: np.ndarray,
    sr_from: int,
    sr_to: int,
    impl: str = "scipy",
    wire_int16: bool = False,
) -> np.ndarray:
    """Polyphase resampling with scipy's ``resample_poly`` (float64 inside,
    f32 out; the int16 wire is read on the reference PCM scale).
    ``wire_int16`` returns the int16 staging wire instead of f32.
    ``impl="device"`` is ROADMAP P6 and raises; ``"auto"`` is scipy until
    then."""
    if impl not in RESAMPLE_IMPLS:
        raise ValueError(f"impl={impl!r}: expected one of {RESAMPLE_IMPLS}")
    if impl == "device":
        raise NotImplementedError(
            "device resampling is ROADMAP P6; use impl='scipy'"
        )
    samples = quantize_wire(samples, "float32")
    if sr_from == sr_to:
        out = samples.astype(np.float32)
    else:
        import scipy.signal

        g = math.gcd(sr_from, sr_to)
        out = scipy.signal.resample_poly(
            samples.astype(np.float64), sr_to // g, sr_from // g
        ).astype(np.float32)
    if wire_int16:
        return quantize_wire(out, "int16")
    return out


def audio_duration(
    path: str | Path,
    use_parallel: bool = False,
    fallback: float | None = None,
) -> float:
    """Duration in seconds, with the tag cache of the reference's
    ``mp3_duration``: the tag's ``Length`` first; else ``fallback`` (a
    duration the caller already knows), the mp3 frame-header scan or a
    decode; the result is written back into the file's tag (whole
    seconds), where the format carries one. ``use_parallel`` is accepted
    for API parity."""
    del use_parallel
    path = Path(path)
    from ..meta.tagger import Length, TaggedFile

    try:
        cached = TaggedFile.from_path(path, default_empty=False).get(Length)
        if cached is not None:
            return float(cached)
    except Exception:
        pass
    if fallback is not None:
        duration = float(fallback)
    else:
        duration = None
        if path.suffix.lower() == ".mp3":
            try:
                duration = mp3_duration_probe(path)
            except DecodeError:
                duration = None
        if duration is None:
            sr, samples = read_audio(path)
            duration = len(samples) / sr
    try:
        tag = TaggedFile.from_path(path, default_empty=True)
        tag.set(Length, duration)
        tag.save_changes()
    except Exception as exc:
        log.debug("couldn't cache duration into %s: %s", path, exc)
    return duration
