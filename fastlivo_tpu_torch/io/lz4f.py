"""Pure-Python LZ4 frame codec (decompression + a minimal compressor); a
copy of fastlivo_tpu/io/lz4f.py.

Closes the rosbag lz4-chunk gap (reference: rosbag chunks may be
`compression=lz4`; the reference reads them through roslz4) without an
external `lz4` package: this environment ships none, and bag replay is a
cold host path where Python-speed decompression is acceptable (chunks are
~768 KB).

Implements the LZ4 Frame format v1 (magic 0x184D2204) — the format ROS's
roslz4 writes — and the LZ4 block format for the payload:
  token = (literal_len << 4) | match_len; 255-extension bytes; 2-byte LE
  match offset; matches may overlap (run-length style copies).
Checksums (xxHash32) are verified for content/blocks when present.

The compressor is for tests/fixtures: greedy hash-table matcher producing
standard-conformant frames (one block, block-independent). It is NOT a
performance path.
"""

from __future__ import annotations

import struct

_MAGIC = 0x184D2204
_U32 = struct.Struct("<I")


# ---------------------------------------------------------------------------
# xxHash32 (for frame header HC byte and optional content checksums)
# ---------------------------------------------------------------------------

_P1, _P2, _P3, _P4, _P5 = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393
)
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed
        v4 = (seed - _P1) & _M32
        while i <= n - 16:
            a, b, c, d = struct.unpack_from("<IIII", data, i)
            v1 = (_rotl((v1 + a * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + b * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + c * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + d * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i <= n - 4:
        (k,) = _U32.unpack_from(data, i)
        h = (_rotl((h + k * _P3) & _M32, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M32, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


# ---------------------------------------------------------------------------
# Block (raw LZ4) codec
# ---------------------------------------------------------------------------


def _decompress_block(src: bytes, dst: bytearray) -> None:
    """Decode one LZ4 block, appending to dst (dst may hold prior history
    for dependent blocks)."""
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            dst += src[i : i + lit]
            i += lit
        if i >= n:
            break  # last sequence has no match
        off = src[i] | (src[i + 1] << 8)
        i += 2
        if off == 0:
            raise ValueError("lz4: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - off
        if start < 0:
            raise ValueError("lz4: match offset beyond output start")
        if off >= mlen:
            dst += dst[start : start + mlen]
        else:
            # overlapping match: byte-wise (run-length) copy
            for k in range(mlen):
                dst.append(dst[start + k])


def _compress_block(src: bytes) -> bytes:
    """Greedy LZ4 block compressor (hash table over 4-byte windows)."""
    n = len(src)
    out = bytearray()
    table: dict = {}
    anchor = 0
    i = 0
    # The spec requires the last 5 bytes to be literals and matches to
    # start at least 12 bytes before the end.
    limit = n - 12

    def emit(lit_start: int, lit_end: int, mlen: int, off: int) -> None:
        nonlocal out
        lit = lit_end - lit_start
        t_lit = 15 if lit >= 15 else lit
        if mlen:
            m = mlen - 4
            t_m = 15 if m >= 15 else m
        else:
            t_m = 0
        out.append((t_lit << 4) | t_m)
        rem = lit - 15
        while rem >= 0:
            out.append(min(rem, 255))
            if rem < 255:
                break
            rem -= 255
        out += src[lit_start:lit_end]
        if mlen:
            out.append(off & 0xFF)
            out.append(off >> 8)
            rem = (mlen - 4) - 15
            while rem >= 0:
                out.append(min(rem, 255))
                if rem < 255:
                    break
                rem -= 255

    while i <= limit:
        key = src[i : i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j <= 0xFFFF and src[j : j + 4] == key:
            mlen = 4
            while i + mlen < n - 5 and src[j + mlen] == src[i + mlen]:
                mlen += 1
            emit(anchor, i, mlen, i - j)
            i += mlen
            anchor = i
        else:
            i += 1
    emit(anchor, n, 0, 0)  # trailing literals
    return bytes(out)


# ---------------------------------------------------------------------------
# Frame codec
# ---------------------------------------------------------------------------


def decompress(buf: bytes) -> bytes:
    """Decode one LZ4 frame (lz4.frame.decompress equivalent)."""
    if len(buf) < 7:
        raise ValueError("lz4: truncated frame")
    (magic,) = _U32.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"lz4: bad magic {magic:#x}")
    flg = buf[4]
    version = flg >> 6
    if version != 1:
        raise ValueError(f"lz4: unsupported frame version {version}")
    block_indep = bool(flg & 0x20)
    block_checksum = bool(flg & 0x10)
    has_content_size = bool(flg & 0x08)
    content_checksum = bool(flg & 0x04)
    has_dict_id = bool(flg & 0x01)
    i = 6  # magic + FLG + BD
    content_size = None
    if has_content_size:
        (content_size,) = struct.unpack_from("<Q", buf, i)
        i += 8
    if has_dict_id:
        i += 4
    # HC byte: xxh32 of the descriptor (FLG..dictID), byte 1 of the hash
    hc = buf[i]
    i += 1
    want = (xxh32(buf[4 : i - 1]) >> 8) & 0xFF
    if hc != want:
        raise ValueError("lz4: frame descriptor checksum mismatch")

    out = bytearray()
    while True:
        (bsize,) = _U32.unpack_from(buf, i)
        i += 4
        if bsize == 0:  # EndMark
            break
        uncompressed = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = buf[i : i + bsize]
        i += bsize
        if block_checksum:
            (bchk,) = _U32.unpack_from(buf, i)
            i += 4
            if xxh32(block) != bchk:
                raise ValueError("lz4: block checksum mismatch")
        if uncompressed:
            out += block
        elif block_indep:
            # decode into a fresh window, then append (matches cannot
            # reference prior blocks)
            sub = bytearray()
            _decompress_block(block, sub)
            out += sub
        else:
            _decompress_block(block, out)
    if content_checksum:
        (cchk,) = _U32.unpack_from(buf, i)
        if xxh32(bytes(out)) != cchk:
            raise ValueError("lz4: content checksum mismatch")
    if content_size is not None and len(out) != content_size:
        raise ValueError("lz4: content size mismatch")
    return bytes(out)


def compress(data: bytes, content_checksum: bool = True) -> bytes:
    """Encode one LZ4 frame (single block, block-independent)."""
    out = bytearray()
    out += _U32.pack(_MAGIC)
    flg = (1 << 6) | 0x20 | (0x04 if content_checksum else 0)
    bd = 0x70  # 4 MB max block size
    out.append(flg)
    out.append(bd)
    out.append((xxh32(bytes([flg, bd])) >> 8) & 0xFF)
    comp = _compress_block(data)
    if len(comp) < len(data):
        out += _U32.pack(len(comp))
        out += comp
    else:
        out += _U32.pack(len(data) | 0x80000000)
        out += data
    out += _U32.pack(0)  # EndMark
    if content_checksum:
        out += _U32.pack(xxh32(data))
    return bytes(out)
