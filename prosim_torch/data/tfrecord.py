"""Minimal standalone TFRecord reader/writer (no TensorFlow dependency; the
port's copy of prosim_tpu/data/tfrecord.py).

The reference loads raw Waymo `Scenario` protos from TFRecord shards for
WOSAC packaging (reference: prosim/rollout/waymo_utils.py:38-57). The format
is trivial: per record
    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)
This module implements it host-side in pure Python so the rollout farm can
read Waymo scenario shards and write submission shards anywhere.
"""

import struct
from typing import Iterable, Iterator

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def read_tfrecords(path: str, check_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if check_crc and _masked_crc(header[:8]) != len_crc:
                raise IOError(f"corrupt length crc at offset {f.tell() - 12}")
            data = f.read(length)
            if len(data) < length:
                raise IOError("truncated record")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if check_crc and _masked_crc(data) != data_crc:
                raise IOError(f"corrupt data crc at offset {f.tell() - 4}")
            yield data


def write_tfrecords(path: str, records: Iterable[bytes]) -> int:
    """Write payloads as a TFRecord file; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
            n += 1
    return n


def index_waymo_scenarios(path: str) -> dict:
    """Map scenario_id -> raw Scenario proto bytes for a Waymo shard.

    Parses only the scenario_id field (field 5, wire type 2 in
    waymo.open_dataset.Scenario) so no waymo-open-dataset install is needed.
    """
    out = {}
    for rec in read_tfrecords(path):
        sid = _read_scenario_id(rec)
        if sid is not None:
            out[sid] = rec
    return out


def _read_scenario_id(buf: bytes):
    """Extract field 5 (scenario_id, string) from a serialized Scenario."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 5 and wire == 2:
            ln, i = _varint(buf, i)
            return buf[i:i + ln].decode("utf-8", "replace")
        if wire == 0:
            _, i = _varint(buf, i)
        elif wire == 1:
            i += 8
        elif wire == 2:
            ln, i = _varint(buf, i)
            i += ln
        elif wire == 5:
            i += 4
        else:
            return None
    return None


def _varint(buf: bytes, i: int):
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
