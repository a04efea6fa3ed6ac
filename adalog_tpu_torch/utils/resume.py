"""Framed append-only resume log, the counterpart of
``adalog_tpu.utils.resume``, in the same file format: a file written by
either package resumes in the other.

A sequence of frames, each ``MAGIC || u64-le length || encode_bytes(record)``
where a record is a ``(tag, name, payload)`` tuple whose payload is a tree
of arrays (utils/checkpoint.py npz framing, no pickle). Appending after
every finished unit of work makes the log truncation-tolerant: a reader
keeps every complete frame and drops a torn tail, so a killed run resumes at
the last finished site. Records are returned as decoded: numpy arrays, and
every dataclass as a ``utils.interop.Node``.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("adalog_tpu_torch")

RESUME_MAGIC = b"ALRS2\x00"
_HDR_N = len(RESUME_MAGIC) + 8


def resume_scan(path: str | None):
    """Read all complete records. A torn tail (a run killed mid-write) is
    cut off the file with a warning, so that records appended after it can
    be read back."""
    if not path or not os.path.exists(path):
        return []
    from adalog_tpu_torch.utils.checkpoint import decode_bytes
    recs, end = [], 0
    with open(path, "rb") as f:
        first = True
        while True:
            hdr = f.read(_HDR_N)
            if not hdr:
                break
            if len(hdr) < _HDR_N or hdr[:len(RESUME_MAGIC)] != RESUME_MAGIC:
                if first:
                    raise ValueError(
                        f"{path} is not a v2 resume file (the pickle resume "
                        "format is not supported) — delete it or pass a "
                        "fresh path")
                log.warning("resume file %s: truncated record header; "
                            "ignoring the tail", path)
                break
            n = int.from_bytes(hdr[len(RESUME_MAGIC):], "little")
            blob = f.read(n)
            if len(blob) < n:
                log.warning("resume file %s: truncated record; ignoring "
                            "the tail", path)
                break
            recs.append(decode_bytes(blob))
            end = f.tell()
            first = False
    if end < os.path.getsize(path):
        os.truncate(path, end)
    return recs


def resume_append(path: str | None, records):
    """Append records. Device tensors are copied to the host by the
    encoder, so this is also a point where the host waits for the device."""
    if not path or not records:
        return
    from adalog_tpu_torch.utils.checkpoint import encode_bytes
    frames = []
    for rec in records:
        blob = encode_bytes(rec)
        frames.append(RESUME_MAGIC + len(blob).to_bytes(8, "little") + blob)
    with open(path, "ab") as f:
        f.write(b"".join(frames))
