"""
Reader and writer for NAIF DAF (Double-precision Array File) binary files,
the container format of SPK ephemeris kernels.

From-scratch implementation of the DAF layout (per the NAIF "DAF Required
Reading" document): 1024-byte records, a file record holding ND/NI and the
summary-record linked list, and packed segment summaries. This replaces the
CSPICE file layer behind ``spice.furnsh``/``spkezr`` in the reference
(planetmapper/base.py:828).

A C++ fast-path reader (``native/daf_reader.cpp``) provides the same data via
ctypes when built; this module is the always-available pure-Python path and
the reference implementation for tests. :func:`write_daf` writes
little-endian files that both readers (and CSPICE) accept.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

RECORD_SIZE = 1024
WORDS_PER_RECORD = 128


class DAFError(ValueError):
    pass


@dataclass(frozen=True)
class DAFSummary:
    doubles: tuple[float, ...]
    integers: tuple[int, ...]


@dataclass
class DAFFile:
    """Parsed DAF file: summaries plus raw access to the double-word array."""

    path: str
    idword: str
    nd: int
    ni: int
    summaries: list[DAFSummary]
    _data: np.ndarray  # all file bytes viewed as little/big-endian float64

    def words(self, start: int, end: int) -> np.ndarray:
        """Double-precision words ``start``..``end`` (1-indexed, inclusive)."""
        return self._data[start - 1 : end]


def read_daf(path: str) -> DAFFile:
    """
    Read a DAF file, preferring the native C++ reader when built (see
    ``native/daf_reader.cpp``; disable with ``PLANETMAPPER_TPU_NATIVE=0``).
    """
    from . import daf_native

    if daf_native.native_enabled():
        native = daf_native.read_daf_native(path)
        if native is not None:
            return native
    return read_daf_python(path)


def read_daf_python(path: str) -> DAFFile:
    """Pure-Python DAF parser (reference implementation for parity tests)."""
    with open(path, 'rb') as f:
        raw = f.read()
    if len(raw) < RECORD_SIZE:
        raise DAFError(f'File too small to be a DAF: {path!r}')
    idword = raw[0:8].decode('ascii', errors='replace')
    if not idword.startswith('DAF/') and idword != 'NAIF/DAF':
        raise DAFError(f'Not a DAF file (ID word {idword!r}): {path!r}')

    locfmt = raw[88:96].decode('ascii', errors='replace')
    if 'LTL' in locfmt:
        endian = '<'
    elif 'BIG' in locfmt:
        endian = '>'
    else:
        # Pre-N0050 files don't have LOCFMT; sniff from ND plausibility
        nd_le = struct.unpack('<i', raw[8:12])[0]
        endian = '<' if 0 < nd_le < 125 else '>'

    nd, ni = struct.unpack(endian + 'ii', raw[8:16])
    fward, bward, free = struct.unpack(endian + 'iii', raw[76:88])
    if not (0 < nd < 125 and 0 < ni < 251):
        raise DAFError(f'Implausible DAF ND/NI ({nd}, {ni}) in {path!r}')

    n_words = len(raw) // 8
    data = np.frombuffer(raw[: n_words * 8], dtype=endian + 'f8')

    ss = nd + (ni + 1) // 2  # summary size in double words
    summaries: list[DAFSummary] = []
    record = fward
    int_dtype = endian + 'i4'
    while record > 0:
        rec_words = data[(record - 1) * WORDS_PER_RECORD : record * WORDS_PER_RECORD]
        next_rec = int(rec_words[0])
        nsum = int(rec_words[2])
        for i in range(nsum):
            s = rec_words[3 + i * ss : 3 + (i + 1) * ss]
            doubles = tuple(float(v) for v in s[:nd])
            ints = tuple(
                int(v) for v in s[nd:].view(int_dtype)[:ni]
            )
            summaries.append(DAFSummary(doubles, ints))
        record = next_rec

    return DAFFile(
        path=path, idword=idword, nd=nd, ni=ni, summaries=summaries, _data=data
    )


# FTP validation string every DAF file record carries (detects files
# mangled by ASCII-mode transfers)
_FTPSTR = b'FTPSTR:\r:\n:\r\n:\r\x00:\x81:\x10\xce:ENDFTP'


def write_daf(
    path: str,
    arrays: list[tuple[tuple[float, ...], tuple[int, ...], np.ndarray]],
    *,
    idword: str = 'DAF/SPK',
    nd: int = 2,
    ni: int = 6,
    ifname: str = '',
    names: list[str] | None = None,
) -> None:
    """
    Write a little-endian DAF file.

    ``arrays`` holds one ``(doubles, integers, data)`` triple per array.
    ``doubles`` are the ND summary doubles; ``integers`` are the first
    NI - 2 summary integers (for an SPK: target, center, frame, type) -
    the last two, the array's initial and final word addresses, are
    filled in here. ``names`` are the per-array names of the name
    records (default: empty).

    Layout: the file record, then one (summary, name) record pair per
    ``floor(125 / SS)`` arrays, then every array's data back to back.
    The output depends only on the arguments, so equal inputs give
    byte-identical files.
    """
    ss = nd + (ni + 1) // 2
    per_record = (WORDS_PER_RECORD - 3) // ss
    nc = 8 * ss
    n = len(arrays)
    names = names if names is not None else [''] * n
    groups = [
        list(range(i, min(i + per_record, n)))
        for i in range(0, max(n, 1), per_record)
    ]
    first_data_record = 2 + 2 * len(groups)
    addr = (first_data_record - 1) * WORDS_PER_RECORD + 1

    addresses = []
    for _, _, data in arrays:
        size = int(np.asarray(data).size)
        addresses.append((addr, addr + size - 1))
        addr += size
    free = addr

    summary_records = []
    for g, members in enumerate(groups):
        record = 2 + 2 * g
        nxt = record + 2 if g + 1 < len(groups) else 0
        prev = record - 2 if g > 0 else 0
        words = bytearray(struct.pack('<3d', nxt, prev, len(members)))
        for i in members:
            doubles, ints, _ = arrays[i]
            summary = struct.pack(f'<{nd}d', *doubles)
            summary += struct.pack(f'<{ni}i', *ints, *addresses[i])
            summary += b'\0' * (8 * ss - len(summary))
            words += summary
        words += b'\0' * (RECORD_SIZE - len(words))
        name_rec = b''.join(
            names[i].encode('ascii')[:nc].ljust(nc) for i in members
        )
        name_rec += b' ' * (RECORD_SIZE - len(name_rec))
        summary_records.append(bytes(words) + name_rec)

    file_record = (
        idword.encode('ascii').ljust(8)
        + struct.pack('<2i', nd, ni)
        + ifname.encode('ascii')[:60].ljust(60)
        + struct.pack('<3i', 2, 2 + 2 * (len(groups) - 1), free)
        + b'LTL-IEEE'
        + b'\0' * 603
        + _FTPSTR
    )
    file_record += b'\0' * (RECORD_SIZE - len(file_record))

    payload = b''.join(
        np.ascontiguousarray(data, dtype='<f8').tobytes()
        for _, _, data in arrays
    )
    payload += b'\0' * (-len(payload) % RECORD_SIZE)
    with open(path, 'wb') as f:
        f.write(file_record)
        for rec in summary_records:
            f.write(rec)
        f.write(payload)
