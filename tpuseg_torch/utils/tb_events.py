"""TensorBoard event files in pure Python: no protobuf, no tensorboard.

The JAX package writes its training curves with tensorboardX; neither it
nor protobuf is installed beside the card, so the port writes the same
files itself. An event file is a TFRecord stream:

    u64 length (little-endian) | u32 masked CRC32C of those 8 bytes |
    payload | u32 masked CRC32C of the payload

whose payloads are ``tensorflow.Event`` messages, hand-encoded here:
``wall_time`` (field 1, double), ``step`` (2, int64), then either
``file_version`` (3, the first event: ``"brain.Event:2"``) or ``summary``
(5) holding one ``Summary.Value`` with ``tag`` (1) and ``simple_value``
(2, float). TensorBoard's ``EventAccumulator`` reads them as scalars.

:func:`read_events` parses such a file back (checking every CRC), so the
files can be checked where no TensorBoard is installed.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Optional

from tpuseg_torch.utils.tf_bundle import (crc32c, encode_varint, mask_crc, proto_bytes,
                                          proto_fields, proto_key, unmask_crc)

FILE_VERSION = "brain.Event:2"


def _frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", mask_crc(crc32c(header))) + payload
            + struct.pack("<I", mask_crc(crc32c(payload))))


def encode_event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
                 tag: Optional[str] = None, value: Optional[float] = None) -> bytes:
    out = proto_key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += proto_key(2, 0) + encode_varint(int(step))
    if file_version is not None:
        out += proto_bytes(3, file_version.encode("utf-8"))
    if tag is not None:
        val = proto_bytes(1, tag.encode("utf-8")) + proto_key(2, 5) + struct.pack("<f", value)
        out += proto_bytes(5, proto_bytes(1, val))
    return out


class EventFileWriter:
    """Writes ``<logdir>/events.out.tfevents.<time>.<host>``, tensorboardX's
    name, starting with the file-version event. Each scalar is flushed
    when written, so a reader sees every logged window."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}")
        self._f = open(self.path, "wb")
        self._write(encode_event(time.time(), file_version=FILE_VERSION))

    def _write(self, payload: bytes) -> None:
        self._f.write(_frame(payload))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write(encode_event(time.time() if wall_time is None else wall_time, step,
                                 tag=tag, value=float(value)))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_events(path: str) -> List[Dict]:
    """Every event of an event file, in order, as ``{"wall_time",
    "step"}`` plus ``"file_version"`` or ``"tag"`` and ``"value"``; a
    frame whose length or payload CRC does not check raises ``IOError``."""
    with open(path, "rb") as f:
        data = f.read()
    events, pos = [], 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise IOError(f"{path}: truncated record header at {pos}")
        header = data[pos:pos + 8]
        n, = struct.unpack("<Q", header)
        if unmask_crc(struct.unpack_from("<I", data, pos + 8)[0]) != crc32c(header):
            raise IOError(f"{path}: length CRC mismatch at {pos}")
        payload = data[pos + 12:pos + 12 + n]
        if len(payload) != n or pos + 16 + n > len(data):
            raise IOError(f"{path}: truncated record at {pos}")
        if unmask_crc(struct.unpack_from("<I", data, pos + 12 + n)[0]) != crc32c(payload):
            raise IOError(f"{path}: payload CRC mismatch at {pos}")
        pos += 16 + n
        event: Dict = {"wall_time": 0.0, "step": 0}
        for field, _, value in proto_fields(payload):
            if field == 1:
                event["wall_time"], = struct.unpack("<d", struct.pack("<Q", value))
            elif field == 2:
                event["step"] = value
            elif field == 3:
                event["file_version"] = value.decode("utf-8")
            elif field == 5:
                for f1, _, v in proto_fields(value):
                    if f1 != 1:
                        continue
                    for f2, _, x in proto_fields(v):
                        if f2 == 1:
                            event["tag"] = x.decode("utf-8")
                        elif f2 == 2:
                            event["value"], = struct.unpack("<f", struct.pack("<I", x))
        events.append(event)
    return events
