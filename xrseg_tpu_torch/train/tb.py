"""TensorBoard scalar event writer with no dependencies (counterpart of
xrseg_tpu/train/tb.py, the port's own copy: the port imports nothing of the
JAX package).

The trainer's observability sink: standard tfevents files any TensorBoard
install can read, written by hand. Format:

  TFRecord framing:  [len u64le][masked_crc32c(len) u32le]
                     [payload][masked_crc32c(payload) u32le]
  payload:           tensorflow.Event proto
                       1: wall_time (double)   2: step (int64)
                       3: file_version (string, first record only)
                       5: summary { 1: repeated Value { 1: tag (string),
                                                        2: simple_value } }

CRC32c is the Castagnoli polynomial (NOT zlib.crc32), masked per the
TFRecord spec. `read_events` is the round-trip reader the tests use; the
JAX package's reader reads these files too.
"""
from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

# --------------------------------------------------------------------------
# CRC32c (Castagnoli), table-driven
# --------------------------------------------------------------------------

_POLY = 0x82F63B78
_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# minimal proto writer (same varint/wire helpers style as io/onnx_export)
# --------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int = 0,
           file_version: Optional[str] = None,
           scalars: Optional[Dict[str, float]] = None) -> bytes:
    msg = _f_double(1, wall_time) + _f_varint(2, step)
    if file_version is not None:
        msg += _f_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _f_bytes(1, _f_bytes(1, tag.encode()) + _f_float(2, float(v)))
            for tag, v in scalars.items())
        msg += _f_bytes(5, summary)
    return msg


class TBWriter:
    """Append scalar events to a tfevents file in `logdir`.

    >>> w = TBWriter("/tmp/run1")
    >>> w.add_scalars({"train/loss": 0.5}, step=1)
    >>> w.close()
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{os.uname().nodename}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr)) + payload
                      + struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step, scalars={tag: value}))

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        """One event carrying every tag (one record per logging step)."""
        clean = {k: float(v) for k, v in scalars.items()
                 if isinstance(v, (int, float)) or hasattr(v, "item")}
        self._write(_event(time.time(), step, scalars=clean))

    def close(self) -> None:
        self._f.close()


# --------------------------------------------------------------------------
# reader (round-trip verification; also handy for tooling/tests)
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[i]
        v |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return v, i
        shift += 7


def read_events(path: str) -> Iterator[Dict]:
    """Yield {wall_time, step, scalars: {tag: value}} per event record,
    verifying both TFRecord CRCs."""
    data = open(path, "rb").read()
    i = 0
    while i < len(data):
        (ln,) = struct.unpack_from("<Q", data, i)
        (hcrc,) = struct.unpack_from("<I", data, i + 8)
        if _masked_crc(data[i:i + 8]) != hcrc:
            raise ValueError(f"bad length crc at byte {i}")
        payload = data[i + 12:i + 12 + ln]
        (pcrc,) = struct.unpack_from("<I", data, i + 12 + ln)
        if _masked_crc(payload) != pcrc:
            raise ValueError(f"bad payload crc at byte {i}")
        i += 12 + ln + 4

        ev: Dict = {"wall_time": 0.0, "step": 0, "scalars": {}}
        j = 0
        while j < len(payload):
            key, j = _read_varint(payload, j)
            field, wire = key >> 3, key & 7
            if field == 1 and wire == 1:
                (ev["wall_time"],) = struct.unpack_from("<d", payload, j)
                j += 8
            elif field == 2 and wire == 0:
                ev["step"], j = _read_varint(payload, j)
            elif wire == 2:
                ln2, j = _read_varint(payload, j)
                blob = payload[j:j + ln2]
                j += ln2
                if field == 5:                      # summary
                    k = 0
                    while k < len(blob):
                        vkey, k = _read_varint(blob, k)
                        vlen, k = _read_varint(blob, k)
                        val = blob[k:k + vlen]
                        k += vlen
                        if vkey >> 3 != 1:
                            continue
                        tag, sv = "", None
                        m = 0
                        while m < len(val):
                            fk, m = _read_varint(val, m)
                            if fk >> 3 == 1 and fk & 7 == 2:
                                tl, m = _read_varint(val, m)
                                tag = val[m:m + tl].decode()
                                m += tl
                            elif fk >> 3 == 2 and fk & 7 == 5:
                                (sv,) = struct.unpack_from("<f", val, m)
                                m += 4
                            else:       # skip unknown
                                w = fk & 7
                                if w == 0:
                                    _, m = _read_varint(val, m)
                                elif w == 1:
                                    m += 8
                                elif w == 5:
                                    m += 4
                                else:
                                    sl, m = _read_varint(val, m)
                                    m += sl
                        if tag and sv is not None:
                            ev["scalars"][tag] = sv
            elif wire == 0:
                _, j = _read_varint(payload, j)
            elif wire == 1:
                j += 8
            elif wire == 5:
                j += 4
        yield ev
