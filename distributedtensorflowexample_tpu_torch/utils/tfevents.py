"""TensorBoard event-file scalar writer — pure Python, no TF dependency.

(a copy of the JAX package's stdlib-only ``utils/tfevents.py``;
``training/metrics.MetricsLogger`` writes one beside ``scalars.jsonl``.)

The reference logged ``tf.summary`` scalars that TensorBoard reads from
tfevents files (SURVEY.md §5 metrics row [RECONSTRUCTED]).  JSONL scalars
(training/metrics.py) cover grep/scripting; this module restores the
TensorBoard-compatible artifact itself: a tfevents file is a sequence of
TFRecord-framed, masked-CRC32C-checksummed ``Event`` protobufs, and both
formats are simple enough to emit by hand —

  record  := len:u64le | masked_crc32c(len):u32le | data | masked_crc32c(data):u32le
  Event   := 1: wall_time (double) | 2: step (int64)
             | 3: file_version (string)  -- first record only
             | 5: summary { 1: Value { 1: tag (string), 2: simple_value (float) } }

Only the scalar subset is implemented — exactly what the reference's
``tf.summary.scalar`` calls produced.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), as used by TFRecord framing.

_CRC_TABLE = []
for _i in range(256):
    _crc = _i
    for _ in range(8):
        _crc = (_crc >> 1) ^ (0x82F63B78 if _crc & 1 else 0)
    _CRC_TABLE.append(_crc)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding (only what Event/Summary scalars need).

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(field: int, value: int) -> bytes:
    # Proto int64: negatives are 10-byte two's complement on the wire.
    return _varint(field << 3) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _field_double(field: int, value: float) -> bytes:
    return _varint((field << 3) | 1) + struct.pack("<d", value)


_FLT_MAX = 3.4028234663852886e38


def _field_float(field: int, value: float) -> bytes:
    # Saturate finite float64 overflow to inf like a float32 cast would —
    # a diverged loss must log as inf, not crash the run mid-train.
    if value > _FLT_MAX:
        value = float("inf")
    elif value < -_FLT_MAX:
        value = float("-inf")
    return _varint((field << 3) | 5) + struct.pack("<f", value)


def _field_bytes(field: int, value: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(value)) + value


def encode_scalar_event(wall_time: float, step: int, tag: str,
                        value: float) -> bytes:
    scalar = _field_bytes(1, tag.encode("utf-8")) + _field_float(2, value)
    summary = _field_bytes(1, scalar)
    return (_field_double(1, wall_time) + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def encode_file_version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def frame_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header))
            + data + struct.pack("<I", masked_crc32c(data)))


class TFEventsWriter:
    """Append-only scalar writer producing a TensorBoard-readable logdir.

    One file per writer, named the way TensorBoard discovers them
    (``events.out.tfevents.<ts>.<host>``); the version header is the first
    record, exactly as TF's own ``EventsWriter`` emits it.
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = (f"events.out.tfevents.{now:.6f}."
                f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._f.write(frame_record(encode_file_version_event(now)))
        self._f.flush()

    def scalar(self, step: int, tag: str, value: float,
               wall_time: float | None = None) -> None:
        wall_time = time.time() if wall_time is None else wall_time
        self._f.write(frame_record(
            encode_scalar_event(wall_time, step, tag, float(value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------------
# Reader — used by tests and available for offline inspection of logs.

def read_events(path: str) -> list[dict]:
    """Parse a tfevents file back into dicts, verifying both CRCs.

    Returns entries like ``{"wall_time": t, "step": n, "tag": s, "value": v}``
    (scalar events) or ``{"file_version": "..."}``.

    A truncated final record (killed writer, concurrent read during a
    flush) ends the parse and returns the valid prefix — TF's reader does
    the same.  A CRC mismatch on a *complete* record raises ValueError.
    """
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (length,) = struct.unpack("<Q", header)
            hcrc_raw = f.read(4)
            if len(hcrc_raw) < 4:
                return out
            if struct.unpack("<I", hcrc_raw)[0] != masked_crc32c(header):
                raise ValueError(f"bad length crc at offset {f.tell()}")
            data = f.read(length)
            dcrc_raw = f.read(4)
            if len(data) < length or len(dcrc_raw) < 4:
                return out
            if struct.unpack("<I", dcrc_raw)[0] != masked_crc32c(data):
                raise ValueError(f"bad data crc at offset {f.tell()}")
            out.append(_decode_event(data))


def _decode_fields(data: bytes) -> list[tuple[int, int, object]]:
    fields, i = [], 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(data, i)
        elif wire == 1:
            value = struct.unpack_from("<d", data, i)[0]
            i += 8
        elif wire == 5:
            value = struct.unpack_from("<f", data, i)[0]
            i += 4
        elif wire == 2:
            n, i = _read_varint(data, i)
            value = data[i:i + n]
            i += n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.append((field, wire, value))
    return fields


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _decode_event(data: bytes) -> dict:
    event: dict = {}
    for field, _wire, value in _decode_fields(data):
        if field == 1:
            event["wall_time"] = value
        elif field == 2:
            event["step"] = value
        elif field == 3:
            event["file_version"] = value.decode("utf-8")
        elif field == 5:
            for f2, _w2, v2 in _decode_fields(value):
                if f2 == 1:  # Summary.value
                    for f3, _w3, v3 in _decode_fields(v2):
                        if f3 == 1:
                            event["tag"] = v3.decode("utf-8")
                        elif f3 == 2:
                            event["value"] = v3
    return event
