"""Uncompressed 24-bit AVI read and written with numpy alone.

The card's machine has no OpenCV and no ffmpeg, so the port keeps one video
container it can read and write by itself: RIFF/AVI with one ``vids`` stream
of BI_RGB frames at 24 bits (BGR, each row padded to 4 bytes).

- Reading takes both row orders (a negative ``biHeight`` is top-down) and
  finds the frames through the OpenDML super index (``indx`` -> ``ix##``)
  where the stream has one, else through ``idx1``, else by walking the
  ``movi`` lists; a zero-length chunk (a dropped frame) is skipped.
- Writing puts rows top-down (negative ``biHeight``: OpenCV's FFmpeg backend
  reads those, while it cannot read bottom-up rows), the frame rate as
  ``dwRate / dwScale`` (the smallest fraction that gives back the float
  written), ``00db`` chunks and an ``idx1``. A file whose RIFF would pass
  ``riff_limit`` (1 GiB, AVI 1.0's limit) goes on in ``AVIX`` RIFFs, each
  with its ``ix00`` standard index, listed in the stream's ``indx`` super
  index, with the total in ``odml``/``dmlh``: the layout ffmpeg's AVI muxer
  writes. Before that the super index and ``odml`` lists lie in ``JUNK``
  chunks of their size, as ffmpeg leaves them.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path
from typing import BinaryIO, Iterator

import numpy as np

__all__ = ["AviInfo", "probe", "AviReader", "AviWriter", "RIFF_LIMIT"]

RIFF_LIMIT = 1 << 30
_SUPER_ENTRIES = 256                 # super index entries reserved, as ffmpeg
_KEYFRAME = 0x10                     # AVIIF_KEYFRAME
_AVIF = 0x10 | 0x100 | 0x800         # HASINDEX | ISINTERLEAVED | TRUSTCKTYPE
_DMLH_BYTES = 248


@dataclass(frozen=True)
class AviInfo:
    """The video stream of a raw AVI: its size, rate, row order and index
    among the file's streams (the ``##db`` of its chunks)."""
    width: int
    height: int
    rate: int
    scale: int
    top_down: bool
    stream: int

    @property
    def fps(self) -> float:
        return self.rate / self.scale if self.rate and self.scale else 0.0

    @property
    def row_bytes(self) -> int:
        return (self.width * 3 + 3) & ~3

    @property
    def frame_bytes(self) -> int:
        return self.row_bytes * self.height


def _chunks(f: BinaryIO, start: int,
            end: int) -> Iterator[tuple[bytes, int, int]]:
    """(fourcc, data offset, data size) of each chunk in [start, end)."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(8)
        if len(head) < 8:
            return
        cid, size = head[:4], struct.unpack("<I", head[4:])[0]
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)


def _list_type(f: BinaryIO, offset: int) -> bytes:
    f.seek(offset)
    return f.read(4)


def _read_header(f: BinaryIO) -> tuple[AviInfo, int | None] | None:
    """The first raw 24-bit video stream's header and the offset of its
    super index (None without one); None when the file is not a RIFF/AVI
    with such a stream."""
    f.seek(0)
    head = f.read(12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
        return None
    riff_end = 8 + struct.unpack("<I", head[4:8])[0]
    for cid, off, size in _chunks(f, 12, riff_end):
        if cid == b"LIST" and _list_type(f, off) == b"hdrl":
            return _read_hdrl(f, off + 4, off + size)
    return None


def _read_hdrl(f: BinaryIO, start: int, end: int):
    stream = -1
    for cid, off, size in _chunks(f, start, end):
        if cid != b"LIST" or _list_type(f, off) != b"strl":
            continue
        stream += 1
        strh = strf = None
        indx = None
        for sid, soff, ssize in _chunks(f, off + 4, off + size):
            f.seek(soff)
            if sid == b"strh":
                strh = f.read(ssize)
            elif sid == b"strf":
                strf = f.read(ssize)
            elif sid == b"indx":
                indx = soff
        if (strh is None or strh[:4] != b"vids" or strf is None
                or len(strf) < 40):
            continue
        (_, width, height, _, bits, compression) = struct.unpack(
            "<IiiHHI", strf[:20])
        if compression != 0 or bits != 24 or width <= 0 or height == 0:
            return None              # the first video stream is not ours
        scale, rate = struct.unpack("<II", strh[20:28])
        return AviInfo(width=width, height=abs(height), rate=rate,
                       scale=scale, top_down=height < 0,
                       stream=stream), indx
    return None


def probe(path) -> AviInfo | None:
    """The stream of a raw 24-bit AVI, or None for any other file."""
    try:
        with open(path, "rb") as f:
            found = _read_header(f)
    except (OSError, struct.error):
        return None
    return found[0] if found else None


def _frame_ids(stream: int) -> tuple[bytes, bytes]:
    tag = f"{stream:02d}".encode()
    return tag + b"db", tag + b"dc"


class AviReader:
    """Random access to the frames of a raw 24-bit AVI, as RGB uint8
    ``(H, W, 3)``."""

    def __init__(self, path):
        self.path = str(path)
        self._f = open(self.path, "rb")
        try:
            found = _read_header(self._f)
            if found is None:
                raise IOError(f"not an uncompressed 24-bit AVI: {path}")
            self.info, indx = found
            self._offsets = self._index(indx)
        except BaseException:
            self._f.close()
            raise

    def __len__(self) -> int:
        return len(self._offsets)

    # -- frame table -------------------------------------------------------
    def _index(self, indx: int | None) -> list[int]:
        """File offsets of the frames' data, in order."""
        for build in (lambda: self._odml(indx), self._idx1, self._walk):
            offsets = build()
            if offsets:
                return offsets
        return []

    def _odml(self, indx: int | None) -> list[int] | None:
        if indx is None:
            return None
        f = self._f
        f.seek(indx)
        longs, _, kind, used = struct.unpack("<HBBI", f.read(8))
        if kind != 0 or longs != 4:
            return None
        f.seek(indx + 24)
        table = [struct.unpack("<QII", f.read(16)) for _ in range(used)]
        offsets: list[int] = []
        for ix, _, _ in table:
            f.seek(ix + 8)
            longs, _, kind, n = struct.unpack("<HBBI", f.read(8))
            if kind != 1 or longs != 2:
                return None
            f.seek(ix + 20)
            base = struct.unpack("<Q", f.read(8))[0]
            f.seek(ix + 32)
            entries = np.frombuffer(f.read(8 * n), "<u4").reshape(n, 2)
            offsets += [base + int(o) for o, s in entries
                        if s & 0x7FFFFFFF]
        return offsets

    def _movi(self) -> list[tuple[int, int]]:
        """(data offset, end) of every ``movi`` list, RIFF by RIFF."""
        f, out, pos = self._f, [], 0
        f.seek(0, 2)
        size = f.tell()
        while pos + 12 <= size:
            f.seek(pos)
            head = f.read(12)
            if head[:4] != b"RIFF":
                break
            end = pos + 8 + struct.unpack("<I", head[4:8])[0]
            for cid, off, n in _chunks(f, pos + 12, min(end, size)):
                if cid == b"LIST" and _list_type(f, off) == b"movi":
                    out.append((off, off + n))
            pos = end + (end & 1)
        return out

    def _idx1(self) -> list[int] | None:
        f = self._f
        movi = self._movi()
        if not movi:
            return None
        f.seek(0)
        riff_end = 8 + struct.unpack("<I", f.read(8)[4:])[0]
        ids = _frame_ids(self.info.stream)
        for cid, off, size in _chunks(f, 12, riff_end):
            if cid != b"idx1":
                continue
            f.seek(off)
            raw = f.read(size - size % 16)
            rows = np.frombuffer(raw, dtype=np.dtype(
                [("id", "S4"), ("flags", "<u4"), ("off", "<u4"),
                 ("size", "<u4")]))
            rows = rows[np.isin(rows["id"], ids) & (rows["size"] > 0)]
            if not len(rows):
                return None
            # offsets count from the 'movi' fourcc, or (some writers) from
            # the start of the file: the first entry's chunk header says
            base = movi[0][0]
            f.seek(base + int(rows["off"][0]))
            if f.read(4) not in ids:
                base = 0
            return [base + int(o) + 8 for o in rows["off"]]
        return None

    def _walk(self) -> list[int]:
        ids = _frame_ids(self.info.stream)
        offsets = []
        for start, end in self._movi():
            stack = [(start + 4, end)]
            while stack:
                lo, hi = stack.pop()
                for cid, off, size in _chunks(self._f, lo, hi):
                    if cid == b"LIST":          # 'rec ' lists
                        stack.append((off + 4, off + size))
                    elif cid in ids and size:
                        offsets.append(off)
        return offsets

    # -- frames ------------------------------------------------------------
    def frame(self, i: int) -> np.ndarray:
        info = self.info
        self._f.seek(self._offsets[i])
        raw = self._f.read(info.frame_bytes)
        if len(raw) < info.frame_bytes:
            raise IOError(f"frame {i} of {self.path} is truncated")
        rows = np.frombuffer(raw, np.uint8).reshape(info.height,
                                                    info.row_bytes)
        if not info.top_down:
            rows = rows[::-1]
        bgr = rows[:, :info.width * 3].reshape(info.height, info.width, 3)
        return np.ascontiguousarray(bgr[..., ::-1])

    def frames(self, start: int = 0, count: int | None = None
               ) -> Iterator[np.ndarray]:
        stop = len(self) if count is None else min(len(self), start + count)
        for i in range(start, stop):
            yield self.frame(i)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _rate_scale(fps: float) -> tuple[int, int]:
    """``(dwRate, dwScale)``: the fraction of the smallest denominator
    (1001 covers the NTSC rates) whose quotient is the float ``fps``."""
    if not fps > 0:
        raise ValueError(f"fps must be positive, got {fps}")
    for bound in (1001, 1 << 16, 1 << 24):
        q = Fraction(fps).limit_denominator(bound)
        if q.numerator / q.denominator == fps:
            break
    if q.numerator >= 1 << 32:
        raise ValueError(f"fps {fps} does not fit dwRate / dwScale")
    return q.numerator, q.denominator


class AviWriter:
    """Streaming writer of RGB uint8 frames of ``size_hw`` into a raw 24-bit
    AVI (top-down rows). ``riff_limit`` is the largest RIFF, in bytes,
    before the file goes on in an ``AVIX`` RIFF (tests lower it)."""

    def __init__(self, path, size_hw: tuple[int, int], fps: float = 30.0,
                 riff_limit: int = RIFF_LIMIT):
        h, w = (int(v) for v in size_hw)
        if h <= 0 or w <= 0:
            raise ValueError(f"bad frame size {size_hw}")
        self.path = str(path)
        self.size_hw = (h, w)
        self.rate, self.scale = _rate_scale(float(fps))
        self.riff_limit = int(riff_limit)
        self._row = (w * 3 + 3) & ~3
        self._chunk = 8 + self._row * h
        self.frames_written = 0
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self._riffs: list[dict] = []      # riff/movi offsets and frames
        self._super: list[tuple[int, int, int]] = []
        try:
            self._write_header()
            self._start_riff(b"AVI ")
        except BaseException:
            self._f.close()
            raise

    # -- layout ------------------------------------------------------------
    def _write_header(self) -> None:
        f = self._f
        h, w = self.size_hw
        f.write(b"RIFF\0\0\0\0AVI ")
        hdrl = self._open_list(b"hdrl")
        usec = round(1e6 * self.scale / self.rate)
        rate_bytes = round(self._row * h * self.rate / self.scale)
        self._avih = f.tell() + 8
        f.write(b"avih" + struct.pack("<I", 56) + struct.pack(
            "<14I", usec, min(rate_bytes, 0xFFFFFFFF), 0, _AVIF, 0, 0, 1,
            self._chunk, w, h, 0, 0, 0, 0))
        strl = self._open_list(b"strl")
        self._strh = f.tell() + 8
        f.write(b"strh" + struct.pack("<I", 56) + b"vids" + b"\0\0\0\0"
                + struct.pack("<IHHIIIIIIII4h", 0, 0, 0, 0, self.scale,
                              self.rate, 0, 0, self._chunk, 0xFFFFFFFF, 0,
                              0, 0, w, h))
        f.write(b"strf" + struct.pack("<I", 40) + struct.pack(
            "<IiiHHIIiiII", 40, w, -h, 1, 24, 0, self._row * h, 0, 0, 0, 0))
        # the super index, a JUNK chunk until a second RIFF enables it
        self._indx = f.tell()
        body = 24 + 16 * _SUPER_ENTRIES
        f.write(b"JUNK" + struct.pack("<I", body)
                + struct.pack("<HBBI4s", 4, 0, 0, 0, b"00db")
                + bytes(body - 12))
        self._close_list(strl)
        # odml/dmlh (the total of frames), likewise JUNK until then
        self._odml = f.tell()
        f.write(b"JUNK" + struct.pack("<I", 12 + _DMLH_BYTES) + b"odml"
                + b"dmlh" + struct.pack("<I", _DMLH_BYTES)
                + bytes(_DMLH_BYTES))
        self._close_list(hdrl)

    def _open_list(self, kind: bytes) -> int:
        pos = self._f.tell()
        self._f.write(b"LIST\0\0\0\0" + kind)
        return pos

    def _close_list(self, pos: int) -> None:
        f = self._f
        end = f.tell()
        f.seek(pos + 4)
        f.write(struct.pack("<I", end - pos - 8))
        f.seek(end)

    def _start_riff(self, kind: bytes) -> None:
        f = self._f
        riff = 0 if kind == b"AVI " else f.tell()
        if riff:
            f.write(b"RIFF\0\0\0\0" + kind)
        movi = self._open_list(b"movi")
        self._riffs.append({"riff": riff, "movi": movi, "frames": []})

    def _end_riff(self, last: bool) -> None:
        """Ends the current RIFF: its ``ix00`` once the file has an OpenDML
        index (or will have one), and the first RIFF's ``idx1``."""
        cur = self._riffs[-1]
        odml = not last or len(self._riffs) > 1
        if odml:
            self._write_ix(cur)
        self._close_list(cur["movi"])
        if len(self._riffs) == 1:
            self._write_idx1(cur)
        self._close_list(cur["riff"])

    def _write_ix(self, cur: dict) -> None:
        f = self._f
        pos = f.tell()
        base = cur["movi"] + 8                 # the 'movi' fourcc
        n = len(cur["frames"])
        f.write(b"ix00" + struct.pack("<I", 24 + 8 * n)
                + struct.pack("<HBBI4sQI", 2, 0, 1, n, b"00db", base, 0))
        table = np.empty((n, 2), "<u4")
        table[:, 0] = np.asarray(cur["frames"], np.int64) + 8 - base
        table[:, 1] = self._chunk - 8
        f.write(table.tobytes())
        if len(self._super) == _SUPER_ENTRIES:
            raise IOError(f"{self.path}: more than {_SUPER_ENTRIES} RIFFs")
        self._super.append((pos, f.tell() - pos, n))

    def _write_idx1(self, cur: dict) -> None:
        n = len(cur["frames"])
        rows = np.zeros(n, np.dtype([("id", "S4"), ("flags", "<u4"),
                                     ("off", "<u4"), ("size", "<u4")]))
        rows["id"] = b"00db"
        rows["flags"] = _KEYFRAME
        rows["off"] = np.asarray(cur["frames"], np.int64) - (cur["movi"] + 8)
        rows["size"] = self._chunk - 8
        self._f.write(b"idx1" + struct.pack("<I", 16 * n) + rows.tobytes())

    # -- frames ------------------------------------------------------------
    def write(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        h, w = self.size_hw
        if frame.shape != (h, w, 3) or frame.dtype != np.uint8:
            raise ValueError(f"frame {frame.shape} {frame.dtype}; want "
                             f"({h}, {w}, 3) uint8")
        cur = self._riffs[-1]
        # the RIFF so far, this frame, its index entries and (first RIFF)
        # the ix00 header and idx1 must stay within the limit
        riff_bytes = (self._f.tell() - cur["riff"] + self._chunk
                      + 24 * (len(cur["frames"]) + 1) + 40)
        if cur["frames"] and riff_bytes > self.riff_limit:
            self._end_riff(last=False)
            self._start_riff(b"AVIX")
            cur = self._riffs[-1]
        row = np.zeros((h, self._row), np.uint8)
        row[:, :w * 3] = frame[..., ::-1].reshape(h, w * 3)
        cur["frames"].append(self._f.tell())
        self._f.write(b"00db" + struct.pack("<I", self._chunk - 8)
                      + row.tobytes())
        self.frames_written += 1

    def close(self) -> None:
        if self._f.closed:
            return
        f = self._f
        try:
            self._end_riff(last=True)
            end = f.tell()
            n = self.frames_written
            f.seek(self._avih + 16)
            f.write(struct.pack("<I", n))
            f.seek(self._strh + 32)
            f.write(struct.pack("<I", n))
            if self._super:
                f.seek(self._indx)
                f.write(b"indx")
                f.seek(self._indx + 12)
                f.write(struct.pack("<I", len(self._super)))
                f.seek(self._indx + 32)
                for entry in self._super:
                    f.write(struct.pack("<QII", *entry))
                f.seek(self._odml)
                f.write(b"LIST")
                f.seek(self._odml + 20)
                f.write(struct.pack("<I", n))
            f.seek(end)
        finally:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
