"""Pure-Python LZ4 frame codec (no lz4 wheel in this image).

Reference: src/common/compress (lz4 via async-compression). Decompression
implements the full LZ4 frame + block formats, so real `.lz4` files load;
compression emits spec-conformant frames with UNCOMPRESSED blocks (the
high bit of the block size set), which every LZ4 reader accepts — the
point here is format interop, not ratio.

Frame format: magic 0x184D2204, FLG/BD descriptor (+optional content
size) + HC byte, then blocks of [u32 size | data], size high-bit =
stored; terminated by a zero size word (+optional content checksum).
"""

from __future__ import annotations

import struct

_MAGIC = 0x184D2204


class LZ4Error(ValueError):
    pass


def _decompress_block(src: bytes, max_out: int = 1 << 31) -> bytes:
    """LZ4 block format: token(lit len | match len), literals,
    2-byte offset, match copy (overlap allowed)."""
    out = bytearray()
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
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break  # last sequence: literals only
        off = src[i] | (src[i + 1] << 8)
        i += 2
        if off == 0:
            raise LZ4Error("zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - off
        if start < 0:
            raise LZ4Error("match offset before output start")
        # overlapping copy must proceed byte-wise from the back-reference
        if off >= mlen:
            out += out[start:start + mlen]
        else:
            for k in range(mlen):
                out.append(out[start + k])
        if len(out) > max_out:
            raise LZ4Error("output exceeds limit")
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Decode one (or more concatenated) LZ4 frames."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        if n - pos >= 4 and struct.unpack_from("<I", data, pos)[0] \
                in range(0x184D2A50, 0x184D2A60):
            # skippable frame
            size = struct.unpack_from("<I", data, pos + 4)[0]
            pos += 8 + size
            continue
        magic = struct.unpack_from("<I", data, pos)[0]
        if magic != _MAGIC:
            raise LZ4Error(f"bad LZ4 magic {magic:#x}")
        pos += 4
        flg = data[pos]
        pos += 2  # FLG + BD
        version = flg >> 6
        if version != 1:
            raise LZ4Error(f"unsupported frame version {version}")
        b_checksum = (flg >> 4) & 1
        c_size = (flg >> 3) & 1
        c_checksum = (flg >> 2) & 1
        dict_id = flg & 1
        if c_size:
            pos += 8
        if dict_id:
            pos += 4
        pos += 1  # HC byte (not verified: no xxhash in stdlib)
        while True:
            bsize = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            if bsize == 0:
                break
            stored = bool(bsize & 0x80000000)
            bsize &= 0x7FFFFFFF
            block = data[pos:pos + bsize]
            pos += bsize
            if b_checksum:
                pos += 4
            out += block if stored else _decompress_block(block)
        if c_checksum:
            pos += 4
    return bytes(out)


def compress(data: bytes, block_size: int = 4 << 20) -> bytes:
    """Spec-conformant frame of stored (uncompressed) blocks."""
    out = bytearray()
    out += struct.pack("<I", _MAGIC)
    flg = (1 << 6) | (1 << 5)  # version 1, block-independent
    bd = 0x70  # 4 MB max block size
    out.append(flg)
    out.append(bd)
    out.append(_header_checksum_byte(bytes([flg, bd])))
    for i in range(0, len(data), block_size):
        chunk = data[i:i + block_size]
        out += struct.pack("<I", 0x80000000 | len(chunk))
        out += chunk
    out += struct.pack("<I", 0)
    return bytes(out)


def _header_checksum_byte(desc: bytes) -> int:
    """(xxh32(desc) >> 8) & 0xFF — a tiny xxhash32 for the header byte so
    strict readers (lz4 CLI) accept our frames."""
    prime1, prime2, prime3 = 2654435761, 2246822519, 3266489917
    prime4, prime5 = 668265263, 374761393
    mask = 0xFFFFFFFF
    h = (0 + prime5) & mask
    h = (h + len(desc)) & mask
    i = 0
    while i + 4 <= len(desc):
        k = int.from_bytes(desc[i:i + 4], "little")
        h = (h + k * prime3) & mask
        h = ((h << 17 | h >> 15) * prime4) & mask
        i += 4
    while i < len(desc):
        h = (h + desc[i] * prime5) & mask
        h = ((h << 11 | h >> 21) * prime1) & mask
        i += 1
    h ^= h >> 15
    h = (h * prime2) & mask
    h ^= h >> 13
    h = (h * prime3) & mask
    h ^= h >> 16
    return (h >> 8) & 0xFF
