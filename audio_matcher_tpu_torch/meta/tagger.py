"""Unified mp3(ID3v2) / opus(VorbisComment) tag layer, the port's copy of
the JAX package's ``meta.tagger``: the same API and the same bytes on disk.

Parity: reference src/worker/tagger.rs — a format-erased ``TaggedFile`` with
typed field markers (Title/Artist/Album/Genre/Year/Track/TotalTracks/Disk/
TotalDisks/Length), dirty tracking, ``save_changes``/``reload_empty``/
``fill_all_from``, chapter comments for opus (``CHAPTERxxx`` +
``CHAPTERxxxNAME``, hh:mm:ss.mmm), and Vorbis multi-key aliases
(ARTIST/AUTHOR etc., tagger.rs:262-338). Both codecs are implemented here
natively (no mutagen in the image): an ID3v2.3/2.4 reader + v2.4 writer,
and an Ogg re-paginator that rewrites the OpusTags packet with correct page
CRCs and sequence renumbering.

Reference quirk preserved for file-format interop: the ``Length`` field is
stored in WHOLE SECONDS in the mp3 TLEN frame (the reference writes
``duration.as_secs()`` into the id3 duration field, tagger.rs:193) and in
the opus DURATIONHINT comment.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import struct
from pathlib import Path

from ..utils.durations import fmt_hmsm

log = logging.getLogger("audio_matcher_torch.tagger")


class TagError(RuntimeError):
    pass


class UnsupportedFormat(TagError):
    def __init__(self, ext):
        super().__init__(f"extension {ext!r} not supported")


# ---------------------------------------------------------------- fields
@dataclasses.dataclass(frozen=True)
class Field:
    key: str
    pytype: type


Title = Field("title", str)
Artist = Field("artist", str)
Album = Field("album", str)
Genre = Field("genre", str)
Year = Field("year", int)
Track = Field("track", int)
TotalTracks = Field("total_tracks", int)
Disk = Field("disk", int)
TotalDisks = Field("total_disks", int)
Length = Field("length", float)  # seconds

ALL_FIELDS = [
    Title, Artist, Album, Genre, Year, Track,
    TotalTracks, Disk, TotalDisks, Length,
]


# ---------------------------------------------------------------- ID3v2
def _syncsafe(n: int) -> bytes:
    return bytes(
        [(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F, n & 0x7F]
    )


def _unsyncsafe(b: bytes) -> int:
    return (b[0] << 21) | (b[1] << 14) | (b[2] << 7) | b[3]


def _decode_text(data: bytes) -> str:
    if not data:
        return ""
    enc, body = data[0], data[1:]
    try:
        if enc == 0:
            text = body.decode("latin-1")
        elif enc == 1:
            text = body.decode("utf-16")
        elif enc == 2:
            text = body.decode("utf-16-be")
        else:
            text = body.decode("utf-8")
    except UnicodeDecodeError:
        text = body.decode("latin-1", errors="replace")
    return text.rstrip("\x00")


def _deunsync(data: bytes) -> bytes:
    """Reverse the ID3v2 unsynchronisation transform (FF 00 → FF)."""
    return data.replace(b"\xff\x00", b"\xff")


# ID3v2.2 3-char frame IDs → v2.3/v2.4 equivalents (text frames convert
# verbatim; PIC/COM need a payload rewrite, handled in read()).
_V22_FRAME_MAP = {
    "TT1": "TIT1", "TT2": "TIT2", "TT3": "TIT3",
    "TP1": "TPE1", "TP2": "TPE2", "TP3": "TPE3", "TP4": "TPE4",
    "TAL": "TALB", "TCO": "TCON", "TYE": "TYER", "TRK": "TRCK",
    "TPA": "TPOS", "TLE": "TLEN", "TBP": "TBPM", "TCM": "TCOM",
    "TCR": "TCOP", "TDY": "TDLY", "TEN": "TENC", "TKE": "TKEY",
    "TLA": "TLAN", "TMT": "TMED", "TOT": "TOAL", "TOA": "TOPE",
    "TOL": "TOLY", "TOR": "TORY", "TPB": "TPUB", "TRC": "TSRC",
    "TSS": "TSSE", "TXT": "TEXT", "TXX": "TXXX",
    "COM": "COMM", "PIC": "APIC", "UFI": "UFID", "ULT": "USLT",
    "WXX": "WXXX", "GEO": "GEOB", "CNT": "PCNT", "POP": "POPM",
}

_PIC_MIME = {"JPG": "image/jpeg", "PNG": "image/png", "GIF": "image/gif"}

# v2.4 frame format-flag bits we can't reinterpret textually
_V4_GROUP = 0x40
_V4_COMPRESSED, _V4_ENCRYPTED, _V4_UNSYNC, _V4_DLI = 0x08, 0x04, 0x02, 0x01


def _convert_v22_payload(fid3: str, fid4: str, payload: bytes) -> bytes:
    """Rewrite v2.2 payload layouts that differ from their v2.3+ frames."""
    if fid3 == "PIC" and len(payload) >= 5:
        # v2.2: enc(1) imageformat(3) type(1) desc\0 data
        # APIC: enc(1) mime\0 type(1) desc\0 data
        enc, fmt, rest = payload[0:1], payload[1:4], payload[4:]
        mime = _PIC_MIME.get(
            fmt.decode("latin-1").upper(), "image/unknown"
        ).encode("latin-1")
        return enc + mime + b"\x00" + rest
    return payload  # text frames / COM / others share the layout


class Id3Tag:
    """In-memory map of text frames (+ CHAP chapters) over a fully-preserved
    frame list: frames this layer doesn't model (APIC, COMM, TXXX, …) are
    kept as raw bytes and re-emitted on render, so a tag edit never destroys
    album art or comments (parity: the reference's id3 crate mutates frames
    on a fully-parsed Tag, tagger.rs:148-229)."""

    FRAME_BY_FIELD = {
        "title": "TIT2",
        "artist": "TPE1",
        "album": "TALB",
        "genre": "TCON",
    }

    def __init__(self):
        self.frames: dict[str, str] = {}
        # chapters: index → (start_ms, title|None); rendered as CHAP frames
        self.chapters: dict[int, tuple[int, str | None]] = {}
        # unmodeled frames preserved verbatim: (frame_id, format_flags, raw)
        self.other_frames: list[tuple[str, int, bytes]] = []

    # -- parsing ---------------------------------------------------------
    @classmethod
    def read(cls, path: Path) -> "Id3Tag":
        data = path.read_bytes()
        tag = cls()
        if len(data) < 10 or data[:3] != b"ID3":
            raise TagError("file has no Tag info")
        major = data[3]
        flags = data[5]
        size = _unsyncsafe(data[6:10])
        body = data[10 : 10 + size]
        if flags & 0x80 and major <= 3:
            # v2.2/v2.3 apply unsynchronisation to the whole tag body;
            # v2.4 applies it per frame (frame format flag, handled below)
            body = _deunsync(body)
        pos = 0
        if flags & 0x40 and major >= 3:  # extended header (not in v2.2)
            if major == 4:
                pos += _unsyncsafe(body[0:4])
            else:
                pos += 4 + struct.unpack(">I", body[0:4])[0]
        head = 6 if major == 2 else 10
        while pos + head <= len(body):
            if major == 2:
                fid = body[pos : pos + 3]
                if fid == b"\x00\x00\x00" or not fid.isalnum():
                    break
                fsize = int.from_bytes(body[pos + 3 : pos + 6], "big")
                fflags = 0
            else:
                fid = body[pos : pos + 4]
                if fid == b"\x00\x00\x00\x00" or not fid.isalnum():
                    break
                if major == 4:
                    fsize = _unsyncsafe(body[pos + 4 : pos + 8])
                else:
                    fsize = struct.unpack(">I", body[pos + 4 : pos + 8])[0]
                fflags = body[pos + 9]  # format-flags byte
            payload = body[pos + head : pos + head + fsize]
            pos += head + fsize
            fid_s = fid.decode("latin-1")
            if major == 2:
                mapped = _V22_FRAME_MAP.get(fid_s)
                if mapped is None:
                    log.warning("dropping unmapped ID3v2.2 frame %s", fid_s)
                    continue
                payload = _convert_v22_payload(fid_s, mapped, payload)
                fid_s = mapped
            keep_flags = 0
            if major == 4:
                if fflags & (_V4_COMPRESSED | _V4_ENCRYPTED | _V4_GROUP):
                    # can't (or shouldn't) interpret; preserve verbatim —
                    # BEFORE any unsync/DLI transform, so the stored flags
                    # still describe the stored bytes and render() emits
                    # the frame byte-exact
                    tag.other_frames.append((fid_s, fflags, payload))
                    continue
                if fflags & _V4_UNSYNC:
                    payload = _deunsync(payload)
                if fflags & _V4_DLI and len(payload) >= 4:
                    payload = payload[4:]  # drop the data-length indicator
            elif major == 3 and fflags:
                # v2.3 format flags: %(compression)(encryption)(grouping)
                # xxxxx — preserve with the extra header data re-ordered to
                # v2.4 layout (v2.3: [size4][method][group] before the
                # data; v2.4: [group][method][syncsafe size4], and
                # compression requires the DLI bit)
                if fflags & 0xE0:
                    data = payload
                    size = method = group = None
                    if fflags & 0x80 and len(data) >= 4:  # compressed
                        size = struct.unpack(">I", data[:4])[0]
                        data = data[4:]
                    if fflags & 0x40 and data:  # encrypted
                        method, data = data[:1], data[1:]
                    if fflags & 0x20 and data:  # grouped
                        group, data = data[:1], data[1:]
                    v4 = (0x08 | 0x01 if size is not None else 0) | (
                        0x04 if method is not None else 0
                    ) | (0x40 if group is not None else 0)
                    payload = (
                        (group or b"") + (method or b"")
                        + (_syncsafe(size) if size is not None else b"")
                        + data
                    )
                    tag.other_frames.append((fid_s, v4, payload))
                    continue
            if (
                fid_s.startswith("T")
                and fid_s != "TXXX"
                and fid_s.isalnum()
            ):
                tag.frames[fid_s] = _decode_text(payload)
            elif fid_s == "CHAP":
                tag._parse_chap(payload, major)
            elif fid_s == "CTOC":
                pass  # regenerated from self.chapters on render
            else:
                tag.other_frames.append((fid_s, keep_flags, payload))
        return tag

    def _parse_chap(self, payload: bytes, major: int = 4) -> None:
        try:
            nul = payload.index(b"\x00")
            element_id = payload[:nul].decode("latin-1")
            start_ms = struct.unpack(">I", payload[nul + 1 : nul + 5])[0]
            sub = payload[nul + 17 :]  # skip end/startoffset/endoffset
            title = None
            if sub[:4] == b"TIT2":
                raw = sub[4:8]
                if major == 4 and not any(b & 0x80 for b in raw):
                    size = _unsyncsafe(raw)
                else:
                    # v2.3 CHAP, or a legacy tag written with plain 32-bit
                    # sub-frame sizes (by this module's earlier versions)
                    size = struct.unpack(">I", raw)[0]
                title = _decode_text(sub[10 : 10 + size])
            idx = int("".join(c for c in element_id if c.isdigit()) or 0)
            self.chapters[idx] = (start_ms, title)
        except (ValueError, struct.error, IndexError):
            log.warning("unparsable CHAP frame, ignoring")

    @staticmethod
    def strip_tag(data: bytes) -> bytes:
        """Remove a leading ID3v2 tag from raw file bytes."""
        if len(data) >= 10 and data[:3] == b"ID3":
            size = _unsyncsafe(data[6:10])
            footer = 10 if data[5] & 0x10 else 0
            return data[10 + size + footer :]
        return data

    def render(self) -> bytes:
        """Serialize as ID3v2.4: UTF-8 text frames + CHAP chapters + every
        preserved unmodeled frame (APIC/COMM/TXXX/… survive verbatim)."""

        def frame(fid: str, payload: bytes, fflags: int = 0) -> bytes:
            return (
                fid.encode("latin-1")
                + _syncsafe(len(payload))
                + bytes([0, fflags])
                + payload
            )

        frames = b""
        for fid, text in sorted(self.frames.items()):
            if text is None or text == "":
                continue
            frames += frame(fid, b"\x03" + text.encode("utf-8"))
        indices = sorted(self.chapters)
        for pos, idx in enumerate(indices):
            start_ms, title = self.chapters[idx]
            if pos + 1 < len(indices):
                end_ms = self.chapters[indices[pos + 1]][0]
            else:
                end_ms = 0xFFFFFFFE  # unknown end: capped sentinel
            payload = f"chp{idx}".encode("latin-1") + b"\x00"
            payload += struct.pack(">IIII", start_ms, end_ms, 0xFFFFFFFF, 0xFFFFFFFF)
            if title is not None:
                sub = b"\x03" + title.encode("utf-8")
                # v2.4 sub-frame sizes are syncsafe (spec-compliant readers
                # of >127-byte chapter titles depend on this)
                payload += b"TIT2" + _syncsafe(len(sub)) + b"\x00\x00" + sub
            frames += frame("CHAP", payload)
        if indices:
            # CTOC table of contents (top-level, ordered) referencing the
            # CHAP element IDs — spec-recommended for chapter navigation.
            # The entry-count field is one byte; clamp instead of letting
            # bytes() raise on a 256+-chapter tag (the CHAP frames
            # themselves are all still written)
            if len(indices) > 255:
                log.warning(
                    "CTOC lists the first 255 of %d chapters "
                    "(1-byte entry count)", len(indices),
                )
            toc_indices = indices[:255]
            toc = b"toc\x00" + bytes([0x03, len(toc_indices)])
            for idx in toc_indices:
                toc += f"chp{idx}".encode("latin-1") + b"\x00"
            frames += frame("CTOC", toc)
        for fid, fflags, payload in self.other_frames:
            frames += frame(fid, payload, fflags)
        return b"ID3\x04\x00\x00" + _syncsafe(len(frames)) + frames

    # -- field access ----------------------------------------------------
    def _pair(self, frame: str) -> tuple[int | None, int | None]:
        raw = self.frames.get(frame, "")
        if not raw:
            return None, None
        head, _, tail = raw.partition("/")
        try:
            first = int(head) if head else None
        except ValueError:
            first = None
        try:
            second = int(tail) if tail else None
        except ValueError:
            second = None
        return first, second

    def _set_pair(self, frame: str, first, second) -> None:
        if first is None and second is None:
            self.frames.pop(frame, None)
        elif second is None:
            self.frames[frame] = str(first)
        else:
            self.frames[frame] = f"{first if first is not None else ''}/{second}"

    def get_field(self, field: Field):
        k = field.key
        if k in self.FRAME_BY_FIELD:
            return self.frames.get(self.FRAME_BY_FIELD[k]) or None
        if k == "year":
            raw = self.frames.get("TDRC") or self.frames.get("TYER")
            if raw:
                m = re.match(r"-?\d+", raw)
                return int(m.group()) if m else None
            return None
        if k == "track":
            return self._pair("TRCK")[0]
        if k == "total_tracks":
            return self._pair("TRCK")[1]
        if k == "disk":
            return self._pair("TPOS")[0]
        if k == "total_disks":
            return self._pair("TPOS")[1]
        if k == "length":
            raw = self.frames.get("TLEN")
            try:
                return float(int(raw)) if raw else None
            except ValueError:
                return None
        raise KeyError(k)

    def set_field(self, field: Field, value) -> None:
        k = field.key
        if k in self.FRAME_BY_FIELD:
            frame = self.FRAME_BY_FIELD[k]
            if value is None:
                self.frames.pop(frame, None)
            else:
                self.frames[frame] = str(value)
        elif k == "year":
            if value is None:
                self.frames.pop("TDRC", None)
                self.frames.pop("TYER", None)
            else:
                self.frames["TDRC"] = str(int(value))
                self.frames["TYER"] = str(int(value))
        elif k == "track":
            self._set_pair("TRCK", value, self._pair("TRCK")[1])
        elif k == "total_tracks":
            self._set_pair("TRCK", self._pair("TRCK")[0], value)
        elif k == "disk":
            self._set_pair("TPOS", value, self._pair("TPOS")[1])
        elif k == "total_disks":
            self._set_pair("TPOS", self._pair("TPOS")[0], value)
        elif k == "length":
            if value is None:
                self.frames.pop("TLEN", None)
            else:
                # reference interop: whole seconds (tagger.rs:193)
                self.frames["TLEN"] = str(int(value))
        else:
            raise KeyError(k)

    def set_chapter(self, index: int, time_secs: float, name=None) -> None:
        # capability the reference lacks (it panics here, tagger.rs:207-209):
        # ID3 CHAP frames with an embedded TIT2 title
        self.chapters[int(index)] = (int(round(time_secs * 1000.0)), name)

    def get_chapters(self) -> list[tuple[int, str, str | None]]:
        return [
            (idx, fmt_hmsm(start_ms / 1000.0), title)
            for idx, (start_ms, title) in sorted(self.chapters.items())
        ]

    def write(self, path: Path) -> None:
        audio = Id3Tag.strip_tag(path.read_bytes())
        path.write_bytes(self.render() + audio)

    ext = "mp3"


# ----------------------------------------------------------- Ogg / opus
def _build_ogg_crc_table() -> tuple:
    out = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7 if r & 0x80000000 else r << 1) & 0xFFFFFFFF
        out.append(r)
    return tuple(out)


# built eagerly: a lazy shared-list build raced under threads (interleaved
# appends scramble the table and every page CRC after)
_OGG_CRC_TABLE = _build_ogg_crc_table()


def _ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _OGG_CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


@dataclasses.dataclass
class _OggPage:
    header_type: int
    granule: int
    serial: int
    seq: int
    segments: list[bytes]
    lacing: list[int]
    offset: int = 0  # byte offset of the page header in the source file

    def render(self, seq: int | None = None) -> bytes:
        seq = self.seq if seq is None else seq
        body = b"".join(self.segments)
        page = bytearray()
        page += b"OggS\x00"
        page.append(self.header_type)
        page += struct.pack("<q", self.granule)
        page += struct.pack("<I", self.serial)
        page += struct.pack("<I", seq)
        page += b"\x00\x00\x00\x00"
        page.append(len(self.lacing))
        page += bytes(self.lacing)
        page += body
        crc = _ogg_crc(bytes(page))
        page[22:26] = struct.pack("<I", crc)
        return bytes(page)


def _ogg_parse_pages(data: bytes) -> list[_OggPage]:
    pages = []
    off = 0
    while off + 27 <= len(data):
        if data[off : off + 4] != b"OggS":
            off += 1
            continue
        header_type = data[off + 5]
        granule = struct.unpack("<q", data[off + 6 : off + 14])[0]
        serial = struct.unpack("<I", data[off + 14 : off + 18])[0]
        seq = struct.unpack("<I", data[off + 18 : off + 22])[0]
        nsegs = data[off + 26]
        lacing = list(data[off + 27 : off + 27 + nsegs])
        body_off = off + 27 + nsegs
        segs = []
        p = body_off
        for l in lacing:
            segs.append(data[p : p + l])
            p += l
        pages.append(
            _OggPage(header_type, granule, serial, seq, segs, lacing, off)
        )
        off = p
    return pages


def _pages_to_packets(pages: list[_OggPage]) -> list[bytes]:
    packets = []
    cur = b""
    for page in pages:
        for seg, l in zip(page.segments, page.lacing):
            cur += seg
            if l < 255:
                packets.append(cur)
                cur = b""
    if cur:
        packets.append(cur)
    return packets


def _make_pages_for_packet(
    packet: bytes, serial: int, seq_start: int
) -> list[_OggPage]:
    """Paginate one packet (no BOS/EOS, granule 0 — header packet rules)."""
    lacing = [255] * (len(packet) // 255) + [len(packet) % 255]
    pages = []
    # max 255 lacing values per page
    pos = 0
    li = 0
    seq = seq_start
    while li < len(lacing):
        chunk = lacing[li : li + 255]
        segs = []
        p = pos
        for l in chunk:
            segs.append(packet[p : p + l])
            p += l
        header_type = 0x01 if li > 0 else 0x00  # continuation flag
        pages.append(_OggPage(header_type, 0, serial, seq, segs, chunk))
        pos = p
        li += 255
        seq += 1
    return pages


class OpusTag:
    """VorbisComment access over an Ogg/Opus file.

    Key aliases follow the reference's table (tagger.rs:262-277): reads try
    each alias in order; writes replace the first existing alias occurrence
    or add under the primary key; removes drop all aliases.
    """

    KEYS = {
        "title": ["TITLE"],
        "artist": ["ARTIST", "AUTHOR"],
        "album": ["ALBUM"],
        "genre": ["GENRE"],
        # DISCNUMBER appended as a READ alias beyond the reference's
        # table (tagger.rs:271 lists DISKNUMBER only, but the de-facto
        # Vorbis spelling is DISC-; writes keep the reference's primary)
        "disk": ["DISKNUMBER", "DISCNUMBER"],
        "track": ["TRACKNUMBER"],
        "year": ["YEAR"],
        "total_disks": ["TOTALDISCS", "DISCTOTAL"],
        "total_tracks": ["TOTALTRACKS", "TRACKTOTAL"],
        "length": ["DURATIONHINT", "DURATION"],
    }

    def __init__(self, vendor: str = "audio_matcher_tpu"):
        self.vendor = vendor
        self.comments: list[tuple[str, str]] = []

    # -- packet codec ----------------------------------------------------
    @classmethod
    def from_packet(cls, packet: bytes) -> "OpusTag":
        if packet[:8] != b"OpusTags":
            raise TagError("not an OpusTags packet")
        tag = cls.__new__(cls)
        pos = 8
        (vlen,) = struct.unpack_from("<I", packet, pos)
        pos += 4
        tag.vendor = packet[pos : pos + vlen].decode("utf-8", "replace")
        pos += vlen
        (n,) = struct.unpack_from("<I", packet, pos)
        pos += 4
        tag.comments = []
        for _ in range(n):
            (clen,) = struct.unpack_from("<I", packet, pos)
            pos += 4
            raw = packet[pos : pos + clen].decode("utf-8", "replace")
            pos += clen
            key, _, value = raw.partition("=")
            tag.comments.append((key, value))
        return tag

    def to_packet(self) -> bytes:
        out = b"OpusTags"
        vend = self.vendor.encode("utf-8")
        out += struct.pack("<I", len(vend)) + vend
        out += struct.pack("<I", len(self.comments))
        for key, value in self.comments:
            raw = f"{key}={value}".encode("utf-8")
            out += struct.pack("<I", len(raw)) + raw
        return out

    # -- comment access --------------------------------------------------
    def find_all(self, keys: list[str]) -> list[str]:
        keyset = {k.upper() for k in keys}
        return [v for k, v in self.comments if k.upper() in keyset]

    def get_first(self, field_key: str) -> str | None:
        values = self.find_all(self.KEYS[field_key])
        if len(values) >= 2:
            log.warning("more than one comment for %s: %s", field_key, values)
        return values[0] if values else None

    def set_first(self, field_key: str, value: str) -> None:
        keys = self.KEYS[field_key]
        keyset = {k.upper() for k in keys}
        existing = [i for i, (k, _) in enumerate(self.comments) if k.upper() in keyset]
        if len(existing) == 1:
            del self.comments[existing[0]]
        elif len(existing) > 1:
            log.warning("multiple comments for %s, appending", field_key)
        self.comments.append((keys[0], str(value)))

    def remove_all(self, field_key: str) -> None:
        keyset = {k.upper() for k in self.KEYS[field_key]}
        self.comments = [
            (k, v) for k, v in self.comments if k.upper() not in keyset
        ]

    # -- field layer -----------------------------------------------------
    def get_field(self, field: Field):
        k = field.key
        raw = self.get_first(k)
        if raw is None:
            return None
        if k == "track":
            head = raw.split("/")[0]
            try:
                return int(head)
            except ValueError:
                return None
        if k == "total_tracks":
            try:
                return int(raw)
            except ValueError:
                return None
        if k in ("year", "disk", "total_disks"):
            try:
                return int(raw)
            except ValueError:
                return None
        if k == "length":
            try:
                return float(int(raw))
            except ValueError:
                return None
        return raw

    def get_field_fallback(self, field: Field):
        # TRACKNUMBER "n/total" fallback for total_tracks (tagger.rs:367-375)
        if field.key == "total_tracks":
            raw = self.get_first("track")
            if raw and "/" in raw:
                try:
                    return int(raw.split("/")[1])
                except ValueError:
                    return None
        return None

    def set_field(self, field: Field, value) -> None:
        k = field.key
        if value is None:
            self.remove_all(k)
            return
        if k == "length":
            value = int(value)  # whole seconds, reference interop
        self.set_first(k, str(value))

    def set_chapter(self, index: int, time_secs: float, name: str | None) -> None:
        if not 0 <= index <= 999:
            # the Vorbis chapter extension is CHAPTER000..CHAPTER999 —
            # a 4-digit comment would be written but never read back
            log.warning("opus chapter index %d out of 0..999; skipped", index)
            return
        # idempotent like the ID3 path: replace an existing entry for the
        # same index instead of appending duplicates on every re-tag
        keys = {f"CHAPTER{index:03}", f"CHAPTER{index:03}NAME"}
        self.comments = [
            (k, v) for k, v in self.comments if k.upper() not in keys
        ]
        self.comments.append((f"CHAPTER{index:03}", fmt_hmsm(time_secs)))
        if name is not None:
            self.comments.append((f"CHAPTER{index:03}NAME", name))

    def get_chapters(self) -> list[tuple[int, str, str | None]]:
        chapters = []
        names = {}
        for k, v in self.comments:
            m = re.fullmatch(r"CHAPTER(\d{3})NAME", k.upper())
            if m:
                names[int(m.group(1))] = v
        for k, v in self.comments:
            m = re.fullmatch(r"CHAPTER(\d{3})", k.upper())
            if m:
                idx = int(m.group(1))
                chapters.append((idx, v, names.get(idx)))
        return chapters

    # -- file io ---------------------------------------------------------
    @classmethod
    def read(cls, path: Path) -> "OpusTag":
        pages = _ogg_parse_pages(path.read_bytes())
        packets = _pages_to_packets(pages)
        if len(packets) < 2 or packets[0][:8] != b"OpusHead":
            raise TagError(f"{path} is not an opus stream")
        return cls.from_packet(packets[1])

    def write(self, path: Path) -> None:
        data = path.read_bytes()
        pages = _ogg_parse_pages(data)
        if not pages:
            raise TagError(f"{path} has no ogg pages")
        serial = pages[0].serial
        # pages holding the OpusTags packet: from page 1 until the packet
        # terminates (a lacing value < 255)
        tags_end = 1
        for i, page in enumerate(pages[1:], start=1):
            tags_end = i + 1
            if page.lacing and page.lacing[-1] < 255:
                break
        new_tag_pages = _make_pages_for_packet(self.to_packet(), serial, 1)
        out = bytearray()
        out += pages[0].render()
        seq = 1
        for page in new_tag_pages:
            out += page.render(seq)
            seq += 1
        audio = pages[tags_end:]
        if audio and all(pg.seq == seq + i for i, pg in enumerate(audio)):
            # sequence numbers unchanged (the common same-page-count
            # save): pass the audio bytes through VERBATIM — re-rendering
            # re-CRCs every page byte-by-byte in Python, O(file size) per
            # tag save on a 1-vCPU host
            out += data[audio[0].offset :]
        else:
            for page in audio:
                out += page.render(seq)
                seq += 1
        path.write_bytes(bytes(out))

    ext = "opus"


# ------------------------------------------------------------ TaggedFile
def _format_for(path: Path):
    ext = path.suffix.lower().lstrip(".")
    if ext == "mp3":
        return Id3Tag
    if ext == "opus":
        return OpusTag
    raise UnsupportedFormat(ext or None)


class TaggedFile:
    """Format-erased tag handle with dirty tracking.

    Parity: tagger.rs:505-673 (``TaggedFile``). ``save_changes`` persists
    only when dirty (or forced); ``reload_empty`` re-reads the file and
    fills currently-empty fields; ``fill_all_from`` copies missing fields
    from another handle.
    """

    def __init__(self, inner, path: Path):
        self._inner = inner
        self.path = Path(path)
        self.was_changed = False

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_path(cls, path, default_empty: bool = False) -> "TaggedFile":
        path = Path(path)
        fmt = _format_for(path)
        try:
            inner = fmt.read(path)
        except (TagError, struct.error, IndexError):
            # struct/Index errors: truncated or corrupt tag structures
            # escape the byte-level parsers — for default_empty callers
            # (e.g. tagging freshly exported files) that means "no tags",
            # not a crash
            if not default_empty:
                raise
            log.debug("file %s didn't have tags, using empty", path)
            inner = fmt()
        except FileNotFoundError:
            if not default_empty:
                raise
            inner = fmt()
        return cls(inner, path)

    @classmethod
    def new_empty(cls, path) -> "TaggedFile":
        path = Path(path)
        return cls(_format_for(path)(), path)

    # -- accessors -------------------------------------------------------
    def get(self, field: Field):
        value = self._inner.get_field(field)
        if value is None and hasattr(self._inner, "get_field_fallback"):
            value = self._inner.get_field_fallback(field)
        return value

    def set(self, field: Field, value) -> None:
        current = self.get(field)
        if current == value:
            return
        if (
            field.key == "length"
            and current is not None
            and value is not None
            and float(int(value)) == current
        ):
            # both formats store WHOLE seconds (reference interop) — a
            # fractional duration whose floor is already stored would
            # mark the file dirty and rewrite it byte-identically
            return
        self._inner.set_field(field, value)
        self.was_changed = True

    def set_chapter(self, index: int, time_secs: float, name=None) -> None:
        self._inner.set_chapter(index, time_secs, name)
        self.was_changed = True

    def fill_from(self, field: Field, other: "TaggedFile") -> None:
        if self.get(field) is not None:
            return
        val = other.get(field)
        if val is not None:
            self.set(field, val)

    def fill_all_from(self, other: "TaggedFile") -> None:
        for field in ALL_FIELDS:
            self.fill_from(field, other)

    @property
    def ext(self) -> str:
        return self._inner.ext

    # -- persistence -----------------------------------------------------
    def save_changes(self, force_save: bool = False) -> bool:
        if not (force_save or self.was_changed):
            return False
        self._inner.write(self.path)
        self.was_changed = False
        return True

    def reload(self, default_empty: bool = False) -> None:
        self.was_changed = False
        self._inner = TaggedFile.from_path(self.path, default_empty)._inner

    def reload_empty(self) -> None:
        self.fill_all_from(TaggedFile.from_path(self.path, default_empty=True))

    def drop_changes(self) -> None:
        self.was_changed = False

    def file_moved(self, new_path) -> None:
        self.path = Path(new_path)

    def __del__(self):  # save-on-drop parity (tagger.rs:675-683)
        try:
            if self.save_changes(False):
                log.debug("saved tags for %s", self.path)
        except Exception as exc:  # noqa: BLE001
            log.error("failed to save %s with %s", self.path, exc)
